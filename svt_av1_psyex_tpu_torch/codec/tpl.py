"""TPL synthesizer + r0/beta and the TPL-driven q ladder (host side).

Consumes the per-block stats grids produced by the device dispenser
(device/tpl.py) and reproduces the reference's temporal-dependency
model:

  * backprop — tpl_model_update_b (src_ops_process.c:1483): each inter
    block propagates (recrf - srcrf) distortion/rate into the up-to-4
    reference blocks it straddles, proportional to overlap area;
  * r0 / per-SB beta — svt_aom_generate_r0beta (src_ops_process.c:1585)
    and generate_lambda_scaling_factor (:178);
  * frame q from r0 — the qstep-ratio scaling of crf_qindex_calc
    (rc_process.c:781-975): qstep_ratio = sqrt(r0) * weight *
    (1 + qp_scale_compress_strength/8), frame qindex picked so its AC
    qstep hits that ratio; non-base layers interpolate toward the worst
    quality per temporal layer (rc_process.c:900-912).

Propagation runs over the display-order chain (block in frame i
predicts from frame i-1), matching the device dispenser's reference
structure. `run_tpl` runs the dispenser on the device the caller names
and builds the model.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.tables import dc_q
from ..device.intra import qp_row_for
from ..device.me import _pad64
from ..device.tpl import tpl_group_stats
from ..runtime import resolve_device, upload_lumas
from .rd import compute_rdmult

BLK = 16
PIX = BLK * BLK
TPL_RDMULT_SCALING_FACTOR = 6       # src_ops_process.c:376
TPL_DEP_COST_SCALE_LOG2 = 4         # definitions.h:49
RDDIV_BITS = 7
PROB_COST_SHIFT = 9

# rc_process.c:44-48 (indexed by hierarchical_levels)
_ISLICE_DIV = (1, 2, 2, 1, 1, 0.7)
_BASE_DIV = (1, 3, 3, 2, 1, 1)
_W_REF = (100, 100, 100, 100, 100, 100)
_W_WQ = (100, 100, 300, 100, 100, 100)
_R0_WEIGHT = (0.75, 0.9, 1.0)       # I / BASE / NON-BASE (rc_process.c:775)


def _rdcost(rdmult: int, rate, dist):
    return ((rate.astype(np.int64) * rdmult + (1 << (PROB_COST_SHIFT - 1)))
            >> PROB_COST_SHIFT) + (dist.astype(np.int64) << RDDIV_BITS)


def _delta_rate_cost(mc_dep_rate, recrf_dist, srcrf_dist, pix_num: int):
    """delta_rate_cost (src_ops_process.c:1452), vectorized."""
    out = mc_dep_rate.astype(np.float64).copy()
    valid = srcrf_dist > 128
    beta = np.where(recrf_dist > 0,
                    srcrf_dist / np.maximum(recrf_dist, 1), 1.0)
    beta = np.maximum(beta, 1e-12)
    dr = (mc_dep_rate / (1 << (TPL_DEP_COST_SCALE_LOG2 + PROB_COST_SHIFT))
          / pix_num)
    log_den = np.log2(beta) + 2.0 * dr
    big = log_den > np.log2(10.0)
    rc_big = np.log2(1.0 / beta) * pix_num / 2.0
    num = np.exp2(np.minimum(log_den, 30))
    den = num * beta + (1 - beta) * beta
    rc_gen = pix_num * np.log2(np.maximum(num / np.maximum(den, 1e-12),
                                          1e-12)) / 2.0
    rate_cost = np.where(big, rc_big, rc_gen)
    rate_cost = rate_cost * (1 << (TPL_DEP_COST_SCALE_LOG2
                                   + PROB_COST_SHIFT))
    return np.where(valid, rate_cost, out)


class TplModel:
    """Host model over one lookahead group's device stats."""

    def __init__(self, stats: np.ndarray, base_qindex: int,
                 bit_depth: int = 8, compute_rate: bool = True):
        # stats (F, 7, nh, nw) f32 — see device.tpl.STAT_FIELDS
        self.f, _, self.nh, self.nw = stats.shape
        self.srcrf_dist = stats[:, 0].astype(np.int64)
        self.recrf_dist = stats[:, 1].astype(np.int64)
        self.srcrf_rate = stats[:, 2].astype(np.int64)
        self.recrf_rate = stats[:, 3].astype(np.int64)
        self.mv_y = stats[:, 4].astype(np.int32)
        self.mv_x = stats[:, 5].astype(np.int32)
        self.is_inter = stats[:, 6] > 0.5
        self.mc_dep_dist = np.zeros_like(self.srcrf_dist)
        self.mc_dep_rate = np.zeros_like(self.srcrf_rate)
        self.base_qindex = base_qindex
        self.bit_depth = bit_depth
        # TPL distortions are scaled << TPL_DEP_COST_SCALE_LOG2 (4) to
        # pair with the UNDIVIDED libaom rdmult; compute_rdmult carries
        # a /16 for the raw-SSE MD convention, so restore it here
        self.base_rdmult = max(
            1, compute_rdmult(base_qindex, 8) * 16
            // TPL_RDMULT_SCALING_FACTOR)
        self.compute_rate = compute_rate
        self._synthesize()

    # ---- synthesizer (tpl_model_update_b, vectorized scatter) -----------
    def _synthesize(self) -> None:
        nh, nw = self.nh, self.nw
        by = np.repeat(np.arange(nh), nw)
        bx = np.tile(np.arange(nw), nh)
        for i in range(self.f - 1, 0, -1):
            m = self.is_inter[i].reshape(-1)
            if not m.any():
                continue
            rec = self.recrf_dist[i].reshape(-1)
            src = self.srcrf_dist[i].reshape(-1)
            cur_dep = rec - src
            with np.errstate(divide="ignore", invalid="ignore"):
                mc_dep = np.where(
                    rec > 0,
                    self.mc_dep_dist[i].reshape(-1) * cur_dep
                    // np.maximum(rec, 1), 0)
            delta_rate = (self.recrf_rate[i] - self.srcrf_rate[i]).reshape(-1)
            if self.compute_rate:
                mc_rate = _delta_rate_cost(
                    self.mc_dep_rate[i].reshape(-1).astype(np.float64),
                    rec.astype(np.float64), src.astype(np.float64),
                    PIX).astype(np.int64)
            else:
                mc_rate = np.zeros_like(delta_rate)

            dist_prop = cur_dep + mc_dep
            rate_prop = delta_rate + mc_rate
            ref_y = by * BLK + self.mv_y[i].reshape(-1)
            ref_x = bx * BLK + self.mv_x[i].reshape(-1)
            g_y = np.floor_divide(ref_y, BLK) * BLK
            g_x = np.floor_divide(ref_x, BLK) * BLK
            for block in range(4):
                gy = g_y + BLK * (block >> 1)
                gx = g_x + BLK * (block & 1)
                # overlap area (get_overlap_area, src_ops_process.c:1413)
                if block == 0:
                    ww = gx + BLK - ref_x; hh = gy + BLK - ref_y
                elif block == 1:
                    ww = ref_x + BLK - gx; hh = gy + BLK - ref_y
                elif block == 2:
                    ww = gx + BLK - ref_x; hh = ref_y + BLK - gy
                else:
                    ww = ref_x + BLK - gx; hh = ref_y + BLK - gy
                ov = ww * hh
                ok = (m & (gy >= 0) & (gy < nh * BLK)
                      & (gx >= 0) & (gx < nw * BLK) & (ov > 0))
                if not ok.any():
                    continue
                iy = (gy[ok] // BLK)
                ix = (gx[ok] // BLK)
                np.add.at(self.mc_dep_dist[i - 1], (iy, ix),
                          dist_prop[ok] * ov[ok] // PIX)
                np.add.at(self.mc_dep_rate[i - 1], (iy, ix),
                          rate_prop[ok] * ov[ok] // PIX)

    # ---- r0 / beta (svt_aom_generate_r0beta) -----------------------------
    def r0(self, i: int) -> float:
        rec_sum = int(self.recrf_dist[i].sum())
        delta = _rdcost(self.base_rdmult, self.mc_dep_rate[i],
                        self.mc_dep_dist[i])
        delta_sum = int(delta.sum())
        base = (rec_sum << RDDIV_BITS) + delta_sum
        if base == 0:
            return 1.0
        r0 = (rec_sum << RDDIV_BITS) / base
        count = delta.size
        mx = int(delta.max())
        if count and mx > (delta_sum / max(count, 1)) * 100 \
                and mx > delta_sum * 9 / 10:
            return 1.0
        return r0

    def sb_beta(self, i: int, width: int, height: int,
                sb: int = 64) -> np.ndarray:
        """Per-SB beta = r0 / rk (generate_r0beta second pass,
        src_ops_process.c:1665): the TPL QPM input (raw r0, before the
        crf_qindex_calc adjust/div scaling)."""
        r0 = self.r0(i)
        nsy = (height + sb - 1) // sb
        nsx = (width + sb - 1) // sb
        g = sb // BLK
        out = np.ones((nsy, nsx))
        delta = _rdcost(self.base_rdmult, self.mc_dep_rate[i],
                        self.mc_dep_dist[i])
        for sy in range(nsy):
            for sx in range(nsx):
                rs = int(self.recrf_dist[i][sy * g : (sy + 1) * g,
                                            sx * g : (sx + 1) * g].sum())
                ds = int(delta[sy * g : (sy + 1) * g,
                               sx * g : (sx + 1) * g].sum())
                if rs > 0:
                    rk = (rs << RDDIV_BITS) / ((rs << RDDIV_BITS) + ds)
                    out[sy, sx] = r0 / rk
        return out

    def sb_rdmult_scale(self, i: int, width: int, height: int,
                        sb: int = 64) -> np.ndarray:
        """Per-SB lambda scaling factors = 1.2 + rk/r0
        (generate_lambda_scaling_factor, src_ops_process.c:178)."""
        r0 = self.r0(i)
        nsy = (height + sb - 1) // sb
        nsx = (width + sb - 1) // sb
        g = sb // BLK
        out = np.full((nsy, nsx), 1.2)
        delta = _rdcost(self.base_rdmult, self.mc_dep_rate[i],
                        self.mc_dep_dist[i])
        for sy in range(nsy):
            for sx in range(nsx):
                rs = self.recrf_dist[i][sy * g : (sy + 1) * g,
                                        sx * g : (sx + 1) * g].sum()
                ds = delta[sy * g : (sy + 1) * g,
                           sx * g : (sx + 1) * g].sum()
                if rs > 0:
                    rk = (int(rs) << RDDIV_BITS) / ((int(rs) << RDDIV_BITS)
                                                    + int(ds))
                    out[sy, sx] = 1.2 + rk / max(r0, 1e-9)
        return out


def qindex_from_qstep_ratio(leaf_qindex: int, ratio: float,
                            bit_depth: int) -> int:
    """svt_av1_get_q_index_from_qstep_ratio (rc_process.c:758): the
    directional scan from leaf_qindex to the first qindex whose DC
    qstep crosses ratio * dc_qstep(leaf_qindex)."""
    target = dc_q(leaf_qindex, bit_depth) * ratio
    q = leaf_qindex
    if ratio < 1.0:
        while q > 0 and dc_q(q, bit_depth) > target:
            q -= 1
    else:
        while q < 255 and dc_q(q, bit_depth) < target:
            q += 1
    return q


def get_deltaq_offset(qindex: int, beta: float, is_intra: bool,
                      bit_depth: int = 8) -> int:
    """svt_av1_get_deltaq_offset (rc_process.c:567): per-SB TPL QPM
    qindex offset from beta, via a DC-qstep walk."""
    q = dc_q(qindex, bit_depth)
    if not is_intra and beta > 1:
        newq = int(round(q / np.sqrt(np.sqrt(beta))))
    else:
        newq = int(round(q / np.sqrt(beta)))
    orig = qindex
    if newq == q:
        return 0
    if newq < q:
        while qindex > 0:
            qindex -= 1
            if newq >= dc_q(qindex, bit_depth):
                break
    else:
        while qindex < 255:
            qindex += 1
            if newq <= dc_q(qindex, bit_depth):
                break
    return qindex - orig


def reduced_tpl_group_level(preset: int, hl: int, is_intra: bool,
                            is_small_res: bool = True) -> int:
    """tpl_ctrls.reduced_tpl_group (svt_aom_set_tpl_group,
    initial_rc_process.c:182-236): the highest temporal layer whose
    frames participate in TPL (-1 = all layers)."""
    if preset <= 5:
        rtg = -1
    elif preset <= 8:
        rtg = 4 if hl == 5 else 3
    else:
        if hl == 5:
            rtg = 2 if is_intra else (3 if is_small_res else 1)
        elif hl == 4:
            rtg = 2 if is_intra else (2 if is_small_res else 1)
        else:
            rtg = 3 if is_intra else (2 if is_small_res else 0)
    if hl <= rtg:
        rtg = -1
    return rtg


def r0_adjust_factor(rtg: int, hl: int, is_intra: bool,
                     has_lookahead: bool = True) -> float:
    """tpl_ctrls.r0_adjust_factor (initial_rc_process.c:238-278):
    compensates r0 for TPL seeing only layers <= reduced_tpl_group."""
    if rtg >= 0:
        d = hl - rtg
        if d == 1:
            adj = 0.4 if hl <= 2 else (0.8 if hl <= 3 else 1.6)
        elif d == 2:
            adj = 0.6 if hl <= 2 else (1.2 if hl <= 3 else 2.4)
        elif d == 3:
            adj = 1.4 if hl <= 3 else 2.8
        elif d == 4:
            adj = 4.0
        elif d == 5:
            adj = 6.0
        else:
            adj = 0.0
        if not has_lookahead:
            adj *= 1.25
    else:
        adj = 0.0
        if not has_lookahead and is_intra:
            adj = 0.4 if hl <= 2 else (0.8 if hl <= 3 else 1.6)
    return adj


def uses_qstep_calc(layer: int, hl: int, rtg: int) -> bool:
    """r0_based_qps_qpm for CRF (initial_rc_process.c:700-710)."""
    use = layer == 0 or ((hl == 5 and layer <= 2)
                         or (hl >= 4 and layer <= 1))
    if use and rtg >= 0 and layer > rtg:
        use = False
    return use


def crf_qindex_calc(cq_qindex: int, *, is_intra: bool, layer: int,
                    hl: int, leaf: bool, r0: float | None,
                    adj: float, tpl_group_size: int,
                    ref_qs: tuple = (), ref_layers: tuple = (),
                    use_qstep: bool = True, ref_intra_pct: int = 0,
                    bit_depth: int = 8,
                    qp_scale_compress_strength: float = 1.0,
                    has_lookahead: bool = True) -> int:
    """One-pass CRF per-frame qindex (crf_qindex_calc,
    rc_process.c:781-975), host-side mirror:

      * I / base / eligible mid-layers: qstep-ratio path — r0 scaled by
        r0_adjust_factor + the GOP div tables, sqrt(r0)-weighted DC
        qstep ratio, scanned into a qindex;
      * other non-leaf layers: interpolate the refs' actual q toward
        the CRF level, one step per temporal-layer delta vs the refs;
      * leaves: the CRF level itself;
      * every non-base frame is floored at its refs' q (MAX(abq, arf_q)).

    ref_qs / ref_layers describe the frame's nearest list0/list1 refs
    (ref_pic_qp_array[x][0]); the qp round-trip through the 0-63
    quantizer scale is mirrored with the qpscs != 0 exact conversion
    (rc_process.c:806-815)."""
    hl = min(hl, 5)
    cq = int(cq_qindex)
    # rc->arf_q from the refs' coded q (qp-quantized round trip)
    arf_q = 0
    for rq in ref_qs:
        arf_q = max(arf_q, (int(rq) >> 2) << 2)

    if use_qstep and r0 is not None:
        if is_intra:
            if adj:
                r0 = r0 / adj
            r0 = r0 / _ISLICE_DIV[hl]
            weight = _R0_WEIGHT[0]
        else:
            if adj:
                r0 = r0 / adj
                r0 = r0 / _BASE_DIV[hl]
            weight = _R0_WEIGHT[1] if layer == 0 else _R0_WEIGHT[2]
            if has_lookahead and tpl_group_size < (2 << hl):
                weight = min(weight + 0.1, 1.0)
        qstep_ratio = float(np.sqrt(r0)) * weight \
            * (1.0 + qp_scale_compress_strength * 0.125)
        if qp_scale_compress_strength:
            qstep_ratio = min(weight, qstep_ratio)
        q = qindex_from_qstep_ratio(cq, qstep_ratio, bit_depth)
        if not is_intra:
            arf_q = q
        abq = int(np.clip(q, 1, cq))
    else:
        abq = cq
        if layer > 0 and not leaf and not is_intra:
            w1, w2 = _W_REF[hl], _W_WQ[hl]
            if hl == 5:
                w1 += ref_intra_pct
            abq = arf_q
            delta = layer - (max(ref_layers) if ref_layers else 0)
            for _ in range(max(delta, 0)):
                abq = (w1 * abq + w2 * cq + (w1 + w2) // 2) // (w1 + w2)
    if layer:
        abq = max(abq, arf_q)
    return int(np.clip(abq, 1, 255))


def tpl_frame_qindex(base_qindex: int, r0: float, layer: int,
                     hierarchical_levels: int, is_intra: bool,
                     bit_depth: int = 8,
                     qp_scale_compress_strength: float = 1.0,
                     arf_q: int | None = None) -> int:
    """Legacy per-layer ladder shim over crf_qindex_calc (kept for the
    VBR/two-pass paths that don't track per-frame ref q)."""
    if is_intra or layer == 0:
        return crf_qindex_calc(
            base_qindex, is_intra=is_intra, layer=layer,
            hl=hierarchical_levels, leaf=False, r0=r0, adj=0.0,
            tpl_group_size=1 << hierarchical_levels,
            bit_depth=bit_depth,
            qp_scale_compress_strength=qp_scale_compress_strength)
    assert arf_q is not None
    return crf_qindex_calc(
        base_qindex, is_intra=False, layer=layer,
        hl=hierarchical_levels, leaf=False, r0=None, adj=0.0,
        tpl_group_size=1 << hierarchical_levels,
        ref_qs=(arf_q,), ref_layers=(0,), use_qstep=False,
        bit_depth=bit_depth,
        qp_scale_compress_strength=qp_scale_compress_strength)


# groups longer than this drop their tail lookahead (diminishing
# propagation); it changes the output, so the cap stays
TPL_MAX_FRAMES = 32


def run_tpl(group_lumas: list, base_qindex: int, bit_depth: int = 8,
            compute_rate: bool = False, *, device,
            kernels: str = "hand") -> TplModel:
    """Pad the group's source lumas to 64, run the dispenser on `device`
    through `kernels`, build the host model. The group is not padded to
    a bucket length: since the dispenser runs forward, repeated tail
    frames would never reach the rows that are read."""
    dev = resolve_device(device)
    srcs = np.stack([_pad64(np.asarray(p))
                     for p in group_lumas[:TPL_MAX_FRAMES]])
    qp = qp_row_for(int(np.clip(base_qindex, 1, 255)), 0, 0, bit_depth)
    stats = tpl_group_stats(upload_lumas(srcs, bit_depth, dev), qp,
                            bit_depth=bit_depth, kernels=kernels)
    return TplModel(stats.cpu().numpy(), base_qindex, bit_depth,
                    compute_rate=compute_rate)
