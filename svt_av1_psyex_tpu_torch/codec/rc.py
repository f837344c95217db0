"""Rate control: single-pass VBR/CBR qindex selection.

Counterpart: the reference's rate-control process (rc_process.c) reduced
to its single-pass core: per-frame bit targets from the GOP structure's
layer weights, an online inverse-quantizer rate model, and virtual-buffer
feedback. CRF/CQP bypasses this module entirely.

Model: bits-per-pixel ~ K / qstep. K is tracked per frame category
(key / layer) with exponential smoothing from actual outcomes; the buffer
term nudges q to hold the long-run average at the target (VBR) or to keep
a one-second virtual buffer centered (CBR).
"""

from __future__ import annotations

from ..bitstream.tables import ac_q

# relative bit weights per category: key, layer0 (P/ARF), layer1, layer2
_LAYER_WEIGHT = {None: 6.0, 0: 3.0, 1: 1.2, 2: 0.7}


class RateControl:
    def __init__(self, width: int, height: int, fps: float,
                 target_bps: int, mode: int, bit_depth: int = 8,
                 start_qindex: int = 120, min_qindex: int = 1,
                 max_qindex: int = 255, keyint: int = -1,
                 low_delay: bool = False, vbv_bufsize: int = 0,
                 over_shoot_pct: int = 25, under_shoot_pct: int = 25,
                 max_bit_rate: int = 0, two_pass: bool = False,
                 vbr_bias_pct: int = 50, vbr_min_section_pct: int = 0,
                 vbr_max_section_pct: int = 2000):
        self.pixels = width * height
        self.fps = max(fps, 1e-6)
        self.target_bps = target_bps
        self.mode = mode  # 1 VBR, 2 CBR
        self.bit_depth = bit_depth
        self.avg_bits = target_bps / self.fps
        self.min_qindex = max(1, min_qindex)
        self.max_qindex = min(255, max_qindex)
        # online model constants per category: bits = k * pixels / qstep
        self._k = {}
        self._q = start_qindex
        self.buffer = 0.0  # bits ahead (+) / behind (-) of target
        # virtual buffer window: --vbv-bufsize when given, else 1 second
        self.buf_cap = vbv_bufsize if vbv_bufsize > 0 else target_bps
        # overshoot/undershoot tolerance scales the feedback clamps
        self.over_pct = max(over_shoot_pct, 1) / 100.0
        self.under_pct = max(under_shoot_pct, 1) / 100.0
        # --mbr: hard per-frame target ceiling (capped-CRF/VBR shape)
        self.max_frame_bits = (max_bit_rate / self.fps
                               if max_bit_rate > 0 else 0.0)
        # --bias-pct (pass2_strategy.c calculate_modified_err): 100 =
        # full complexity-proportional allocation, 0 = flat CBR-like
        # spend; intermediate values blend via err^(bias/100)
        self.vbr_bias = max(0, min(100, vbr_bias_pct)) / 100.0
        # --minsection-pct / --maxsection-pct: per-frame target clamp as
        # a percentage of the average frame budget (av1_rc_pick_q...
        # vbr_rate_correction bounds)
        self.vbr_min_pct = max(0, vbr_min_section_pct) / 100.0
        self.vbr_max_pct = max(1, vbr_max_section_pct) / 100.0
        # two-pass: per-frame allocation comes entirely from the stats
        # weights (pass2_frame_weights, mean 1.0 incl. kf boost) so the
        # layer-weight split is skipped — multiplying both double-counts
        # the keyframe and makes targets sum past the budget.
        self.two_pass = two_pass
        self.norm = self._gop_norm(keyint, low_delay)

    @staticmethod
    def _gop_norm(keyint: int, low_delay: bool) -> float:
        """Mean layer weight over one keyint window, from the actual GOP
        composition (low-delay: all layer0; RA: dyadic 4-frame mini-GOPs =
        1x layer0 + 1x layer1 + 2x layer2), so steady-state targets sum to
        the bitrate without leaning on the buffer feedback (ADVICE.md r1)."""
        mg = (_LAYER_WEIGHT[0] if low_delay
              else (_LAYER_WEIGHT[0] + _LAYER_WEIGHT[1] + 2 * _LAYER_WEIGHT[2]) / 4)
        if keyint < 0:  # single key frame up front: its weight amortizes out
            return mg
        window = keyint + 1
        return (_LAYER_WEIGHT[None] + mg * (window - 1)) / window

    def _category(self, is_key: bool, layer: int):
        return None if is_key else min(layer, 2)

    def _weighted_target(self, cat) -> float:
        return self.avg_bits * _LAYER_WEIGHT[cat] / self.norm

    def pick_qindex(self, is_key: bool, layer: int = 0,
                    complexity: float = 1.0) -> int:
        """complexity: per-frame relative weight from two-pass stats
        (codec/firstpass.py complexity_weights); 1.0 = single-pass."""
        cat = self._category(is_key, layer)
        if self.two_pass:
            # bias-pct shapes how strongly the stats weights steer the
            # per-frame split (calculate_modified_err's err^bias blend)
            target = self.avg_bits * (complexity ** self.vbr_bias
                                      if complexity > 0 else 0.0)
        else:
            target = self._weighted_target(cat) * complexity
        if self.mode == 1:  # VBR section bounds (min/max-section-pct)
            target = min(max(target, self.avg_bits * self.vbr_min_pct),
                         self.avg_bits * self.vbr_max_pct)
        # buffer = accumulated savings; negative (overspent) shrinks targets
        if self.mode == 2:  # CBR: hard pull toward center
            adj = 1.0 + max(-2 * self.under_pct,
                            min(2 * self.over_pct,
                                self.buffer / max(self.buf_cap, 1)))
        else:  # VBR: long-run correction — strong enough to repay a
            # persistent model bias within ~1s of video
            adj = 1.0 + max(-2 * self.under_pct,
                            min(2 * self.over_pct,
                                self.buffer / max(self.buf_cap, 1)))
        target *= adj
        if self.max_frame_bits > 0:
            target = min(target, self.max_frame_bits)
        k = self._k.get(cat)
        if k is None:
            # bootstrap from the running q
            q = self._q
        else:
            # invert the model: qstep = k * pixels / target_bits
            qstep_t = k * self.pixels / max(target, 1.0)
            q = self._nearest_qindex(qstep_t)
        q = int(min(max(q, self.min_qindex), self.max_qindex))
        self._last = (cat, q, target)
        return q

    def _nearest_qindex(self, qstep_target: float) -> int:
        lo, hi = 1, 255
        while lo < hi:
            mid = (lo + hi) // 2
            if ac_q(mid, self.bit_depth) < qstep_target:
                lo = mid + 1
            else:
                hi = mid
        # round to the closer qstep — always rounding q up systematically
        # undershoots the bit target by half a qstep ratio (~3%)
        if lo > 1 and (qstep_target - ac_q(lo - 1, self.bit_depth)
                       < ac_q(lo, self.bit_depth) - qstep_target):
            lo -= 1
        return lo

    def recode_qindex(self, actual_bits: int) -> int | None:
        """Overshoot re-encode decision (rc_process.c recode loop):
        when a frame blows its budget beyond the overshoot tolerance,
        return the higher qindex to retry with, else None.  Call before
        update(); the caller re-encodes and asks again (bounded)."""
        cat, q, target = self._last
        limit = target * (1.0 + 2.0 * self.over_pct)
        if self.max_frame_bits > 0:
            limit = min(limit, self.max_frame_bits * (1.0 + self.over_pct))
        if target <= 0 or actual_bits <= limit or q >= self.max_qindex:
            return None
        # invert the model at the observed operating point
        qstep_new = ac_q(q, self.bit_depth) * actual_bits / max(target, 1.0)
        q_new = max(self._nearest_qindex(qstep_new), q + 4)
        q_new = int(min(q_new, self.max_qindex))
        if q_new <= q:
            return None
        self._last = (cat, q_new, target)
        return q_new

    def update(self, actual_bits: int) -> None:
        cat, q, target = self._last
        qstep = ac_q(q, self.bit_depth)
        k_obs = actual_bits * qstep / max(self.pixels, 1)
        prev = self._k.get(cat)
        self._k[cat] = k_obs if prev is None else 0.6 * prev + 0.4 * k_obs
        # lightweight cross-seeding so unseen categories start sane
        for other, w in _LAYER_WEIGHT.items():
            if other not in self._k and cat in self._k:
                scale = w / _LAYER_WEIGHT[cat]
                self._k[other] = self._k[cat] * scale
        self.buffer += self.avg_bits - actual_bits
        self.buffer = max(-2 * self.buf_cap, min(2 * self.buf_cap, self.buffer))
        self._q = q


class CappedCrf:
    """Capped CRF (EbSvtAv1Enc.h:640-649 max_bit_rate + the capped-CRF
    re-encode in rc_process.c): CRF picks q as usual; a virtual buffer
    filled at max_bit_rate enforces the ceiling. Every frame deposits
    max_bit_rate/fps and withdraws its coded bits; a frame that would
    overdraw the buffer (beyond --mbr-overshoot-pct slack) is re-encoded
    at a model-inverted higher q, and a low buffer raises an ambient
    qindex floor for subsequent frames so the cap holds without
    oscillating."""

    def __init__(self, fps: float, max_bit_rate: int, bit_depth: int = 8,
                 vbv_bufsize: int = 0, mbr_over_shoot_pct: int = 50):
        self.per_frame = max_bit_rate / max(fps, 1e-6)
        # buffer window: --vbv-bufsize when given, else 2 seconds at the
        # cap (keyframes legitimately spend several frame budgets)
        self.cap = float(vbv_bufsize if vbv_bufsize > 0
                         else 2 * max_bit_rate)
        self.buf = self.cap
        self.bit_depth = bit_depth
        self.over = max(mbr_over_shoot_pct, 0) / 100.0
        self.q_offset = 0

    def adjust_q(self, q: int) -> int:
        """Ambient qindex floor from the buffer fill level (the capped
        CRF ambient-QP push): empty buffer -> up to +64 qindex."""
        fill = self.buf / max(self.cap, 1.0)
        self.q_offset = 0 if fill >= 0.5 else int(round((0.5 - fill)
                                                        * 2 * 64))
        return int(min(q + self.q_offset, 255))

    def recode_qindex(self, q: int, actual_bits: int) -> int | None:
        """Higher q to retry with when the frame overdraws the buffer
        (mbr_over_shoot_pct slack on one frame budget), else None."""
        allowed = max(self.buf + self.per_frame,
                      self.per_frame) * (1.0 + self.over)
        if actual_bits <= allowed or q >= 255:
            return None
        qstep_new = (ac_q(q, self.bit_depth) * actual_bits
                     / max(allowed, 1.0))
        lo, hi = 1, 255
        while lo < hi:
            mid = (lo + hi) // 2
            if ac_q(mid, self.bit_depth) < qstep_new:
                lo = mid + 1
            else:
                hi = mid
        q_new = min(max(lo, q + 4), 255)
        return q_new if q_new > q else None

    def update(self, actual_bits: int) -> None:
        self.buf = min(self.cap,
                       self.buf + self.per_frame - actual_bits)
        self.buf = max(self.buf, 0.0)


def luminance_qp_bias_offset(qindex: int, avg_luma: float, layer: int,
                             bias: int) -> int:
    """Frame-level luminance qindex adjustment (rc_process.c:3439-3452):
    darker frames get more bits at the higher temporal layers. avg_luma
    in 8-bit units; returns a (negative or zero) qindex offset."""
    import math

    if bias <= 0 or layer <= 0:
        return 0
    denom = 1024.0 / (layer * 4 * (0.01 * bias))
    return int(round(-math.pow((255.0 - avg_luma) / denom, 0.5)
                     * (qindex / 8.0)))
