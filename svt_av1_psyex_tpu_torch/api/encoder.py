"""Encoder handle & lifecycle — the EbSvtAv1Enc library surface.

Mirrors the exported API set (EbSvtAv1Enc.h:1086-1202):
svt_av1_enc_init_handle / set_parameter / parse_parameter / init /
stream_header / send_picture / get_packet / release_out_buffer /
get_recon / get_stream_info / deinit / deinit_handle, plus version
queries. Pythonic object API (SvtAv1Encoder) with thin function wrappers
for source compatibility of call shapes.

Pipeline: send_picture enqueues; frames are encoded as low-delay or
random-access mini-GOPs; packets carry the TU bytes + pts + frame type,
output-ordered like the reference's packetization reorder queue.

The device stages (the encoder's analysis, temporal filtering, TPL) run
in PyTorch on the handle's `device` ("cuda" by default, or "cpu"),
through the hand kernels or, with kernels="plain", their plain
versions.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .. import SVT_VERSION
from ..bitstream.headers import SequenceConfig, write_sequence_header
from ..bitstream.obu import ObuType, wrap_obu
from ..codec.encoder import Av1Encoder
from ..codec.gop import plan_key, plan_minigop
from ..codec.tf import temporal_filter
from ..codec.tpl import (
    crf_qindex_calc,
    r0_adjust_factor,
    reduced_tpl_group_level,
    run_tpl,
    uses_qstep_calc,
)
from ..runtime import check_kernels, resolve_device
from .config import EncoderConfig
from .params import parse_parameter as _parse_parameter

__all__ = ["EncoderConfig", "Packet", "Recon", "SvtAv1Encoder",
           "SvtAv1Error", "svt_av1_enc_get_packet", "svt_av1_enc_init",
           "svt_av1_enc_init_handle", "svt_av1_enc_send_picture",
           "svt_av1_enc_set_parameter", "svt_av1_get_version",
           "svt_psy_get_version"]


def _timing() -> bool:
    return os.environ.get("SVT_TPU_TIMING") == "1"


class SvtAv1Error(Exception):
    pass


@dataclass
class Packet:
    data: bytes
    pts: int
    dts: int
    frame_type: int  # 0 KEY, 1 INTER
    is_eos: bool = False


@dataclass
class Recon:
    planes: list
    pts: int


class SvtAv1Encoder:
    """Handle object (EbComponentType equivalent) whose device stages run
    in PyTorch on `device` ("cuda", the default, "cuda:N" or "cpu";
    asking for CUDA where there is none raises). `kernels="plain"` runs
    the plain PyTorch version of every kernel instead of the hand kernel,
    to compare the two on the card."""

    def __init__(self, *, device="cuda", kernels: str = "hand") -> None:
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        self.config = EncoderConfig()
        self._initialized = False
        self._in_q: deque = deque()
        self._out_q: deque = deque()
        self._recon_q: deque = deque()
        self._pts = 0
        self._eos_sent = False
        self._eos_emitted = False
        self._enc: Av1Encoder | None = None
        self._seq: SequenceConfig | None = None
        # per-DPB-slot (qindex, temporal layer) of the picture held there
        # (the reference's ref_pic_qp_array source; crf_qindex_calc reads
        # the nearest list0/list1 refs' coded q through this)
        self._slot_q: dict = {}

    # ---- configuration -------------------------------------------------------
    def set_parameter(self, config: EncoderConfig) -> None:
        errs = config.validate()
        if errs:
            raise SvtAv1Error("; ".join(errs))
        self.config.copy_from(config)

    def parse_parameter(self, name: str, value: str) -> None:
        _parse_parameter(self.config, name, value)

    # ---- init ------------------------------------------------------------------
    def init(self) -> None:
        cfg = self.config
        errs = cfg.validate()
        if errs:
            raise SvtAv1Error("; ".join(errs))
        # init banner + leveled logging (svt_av1_print_version /
        # svt_log_init, enc_handle.c:5759 + svt_log.c) — SVT_LOG=<level>
        # and SVT_LOG_FILE env switches match the reference
        from .. import __version__
        from ..utils import log

        log.info("-------------------------------------------")
        log.info("SVT [version]:\tSVT-AV1-PSYEX-TPU Encoder Lib %s",
                 __version__)
        rc_name = {0: "CRF", 1: "VBR", 2: "CBR"}.get(
            cfg.rate_control_mode, "?")
        rc_val = (cfg.crf if cfg.rate_control_mode == 0
                  else cfg.target_bit_rate)
        log.info("SVT [config]:\t%dx%d %d-bit, preset %d, %s %s",
                 cfg.source_width, cfg.source_height,
                 cfg.encoder_bit_depth, cfg.enc_mode, rc_name,
                 "?" if rc_val is None else rc_val)
        log.info("-------------------------------------------")
        pend = cfg.pending_overrides()
        if pend:
            import warnings

            log.warn("parameters accepted but not yet honored: %s",
                     ", ".join(pend))
            warnings.warn(
                "parameters accepted but not yet honored: " + ", ".join(pend),
                stacklevel=2)
        # EB_YUV400 = 0, EB_YUV420 = 1, EB_YUV422 = 2, EB_YUV444 = 3
        mono = cfg.encoder_color_format == 0
        if cfg.encoder_color_format == 3:
            prof, ssx, ssy = 1, 0, 0
        elif cfg.encoder_color_format == 2:
            raise SvtAv1Error("4:2:2 (profile 2) not supported yet")
        else:
            prof, ssx, ssy = 0, 1, 1
        self._seq = SequenceConfig(
            width=cfg.source_width,
            height=cfg.source_height,
            profile=prof, subsampling_x=ssx, subsampling_y=ssy,
            mono_chrome=mono,
            bit_depth=cfg.encoder_bit_depth,
            color_primaries=0 if cfg.color_primaries == 2 else cfg.color_primaries,
            transfer_characteristics=0 if cfg.transfer_characteristics == 2 else cfg.transfer_characteristics,
            matrix_coefficients=0 if cfg.matrix_coefficients == 2 else cfg.matrix_coefficients,
            color_range=cfg.color_range,
            chroma_sample_position=cfg.chroma_sample_position,
        )
        # compound tool gates (get_inter_compound_level,
        # enc_mode_config.c:8024/2113): dist-wtd + masked compound ride
        # the low presets only
        if cfg.enc_mode <= 2:
            self._seq.enable_jnt_comp = True
            self._seq.enable_masked_compound = True
            # inter-intra rides the same presets (base-layer pictures,
            # svt_aom_get_inter_intra_level enc_mode_config.c:8050)
            self._seq.enable_interintra_compound = True
        # HDR metadata OBUs (prepended to every keyframe TU for seek
        # robustness; metadata_handle.c:50-110 string formats)
        self._metadata = b""
        if cfg.content_light_level:
            from ..bitstream.obu import metadata_hdr_cll

            cll, fall = (int(x) for x in cfg.content_light_level.split(","))
            self._metadata += metadata_hdr_cll(cll, fall)
        if cfg.mastering_display:
            from ..bitstream.obu import (
                metadata_hdr_mdcv,
                parse_mastering_display,
            )

            prim, wp, lmax, lmin = parse_mastering_display(
                cfg.mastering_display)
            self._metadata += metadata_hdr_mdcv(prim, wp, lmax, lmin)
        self._rc = None
        self._fp_weights = None
        if cfg.pass_ == 2 and cfg.rc_stats_buffer:
            from ..codec.firstpass import (
                parse,
                pass2_frame_weights,
            )

            self._fp_weights = pass2_frame_weights(
                parse(cfg.rc_stats_buffer), cfg.intra_period_length)
        if cfg.rate_control_mode in (1, 2):
            from ..codec.rc import RateControl

            fps = cfg.frame_rate_numerator / max(cfg.frame_rate_denominator, 1) \
                if getattr(cfg, "frame_rate_numerator", 0) else 30.0
            keyint = cfg.intra_period_length
            self._rc = RateControl(cfg.source_width, cfg.source_height, fps,
                                   cfg.target_bit_rate, cfg.rate_control_mode,
                                   cfg.encoder_bit_depth,
                                   min_qindex=cfg.min_qp_allowed * 4,
                                   max_qindex=max(cfg.max_qp_allowed * 4, 1),
                                   keyint=(60 if keyint == -2 else keyint),
                                   low_delay=cfg.pred_structure == 1,
                                   vbv_bufsize=cfg.vbv_bufsize,
                                   over_shoot_pct=cfg.over_shoot_pct,
                                   under_shoot_pct=cfg.under_shoot_pct,
                                   max_bit_rate=cfg.max_bit_rate,
                                   two_pass=self._fp_weights is not None,
                                   vbr_bias_pct=cfg.vbr_bias_pct,
                                   vbr_min_section_pct=cfg.vbr_min_section_pct,
                                   vbr_max_section_pct=cfg.vbr_max_section_pct)
        # capped CRF (max_bit_rate in CRF mode, EbSvtAv1Enc.h:640-649):
        # virtual buffer at the cap + ambient q floor + overshoot recode
        self._cap = None
        if cfg.rate_control_mode == 0 and cfg.max_bit_rate > 0:
            from ..codec.rc import CappedCrf

            fps = cfg.frame_rate_numerator / max(cfg.frame_rate_denominator, 1) \
                if getattr(cfg, "frame_rate_numerator", 0) else 30.0
            self._cap = CappedCrf(fps, cfg.max_bit_rate,
                                  cfg.encoder_bit_depth,
                                  vbv_bufsize=cfg.vbv_bufsize,
                                  mbr_over_shoot_pct=cfg.mbr_over_shoot_pct)
        self._enc = Av1Encoder(
            self._seq, preset=cfg.enc_mode,
            device=self.device, kernels=self.kernels,
            enable_variance_boost=cfg.enable_variance_boost,
            variance_boost_strength=cfg.variance_boost_strength,
            variance_octile=cfg.variance_octile,
            variance_boost_curve=cfg.variance_boost_curve,
            psy_rd=cfg.psy_rd, tune=cfg.tune,
            enable_restoration=(None if cfg.enable_restoration_filtering < 0
                                else bool(cfg.enable_restoration_filtering)),
            tile_cols_log2=cfg.tile_columns,
            film_grain=cfg.film_grain_denoise_strength,
            qm=((cfg.min_qm_level, cfg.max_qm_level,
                 cfg.min_chroma_qm_level, cfg.max_chroma_qm_level)
                if cfg.enable_qm else None),
            noise_norm_strength=cfg.noise_norm_strength,
            max_32_tx_size=bool(cfg.max_32_tx_size),
            seg_aq=cfg.enable_adaptive_quantization == 1,
            low_q_taper=bool(cfg.low_q_taper)
            and cfg.rate_control_mode == 0,
            adaptive_film_grain=bool(cfg.adaptive_film_grain),
            sharpness=cfg.sharpness, sharp_tx=bool(cfg.sharp_tx),
            delta_q_offsets=(cfg.luma_y_dc_qindex_offset,
                             cfg.chroma_u_dc_qindex_offset,
                             cfg.chroma_u_ac_qindex_offset),
            spy_rd=cfg.spy_rd,
            enable_mfmv=cfg.enable_mfmv != 0,
            screen_content_mode=cfg.screen_content_mode,
            complex_hvs=cfg.complex_hvs, hbd_mds=cfg.hbd_mds,
            superres_denom=(cfg.superres_denom if cfg.superres_mode == 1
                            else 8))
        self._initialized = True

    def _temporal_filter(self, planes, nbrs, strength: int) -> list:
        """The port's temporal filter at the encode's q and bit depth, on
        self.device; its seconds go to the "tf" stage under
        SVT_TPU_TIMING=1."""
        t0 = time.perf_counter()
        out = temporal_filter(planes, nbrs, self.config.qindex,
                              self.config.encoder_bit_depth,
                              strength=strength, device=self.device)
        if _timing():
            self._enc._tick("tf", t0)
        return out

    def _run_tpl(self, look: list, base_qindex: int):
        """The port's TPL dispenser on self.device through self.kernels."""
        return run_tpl(look, base_qindex, self.config.encoder_bit_depth,
                       compute_rate=self.config.enc_mode <= 2,
                       device=self.device, kernels=self.kernels)

    def stream_header(self) -> bytes:
        """svt_av1_enc_stream_header: TD + sequence header OBUs."""
        if not self._initialized:
            raise SvtAv1Error("not initialized")
        return wrap_obu(ObuType.SEQUENCE_HEADER, write_sequence_header(self._seq))

    # ---- frame push/pull -----------------------------------------------------------
    def send_picture(self, planes: list | None, pts: int | None = None,
                     force_key: bool = False, qp: int | None = None) -> None:
        """planes=None signals EOS (like a NULL/EOS buffer header).
        qp: per-picture QP honored when config.use_qp_file (the
        EbBufferHeaderType qp field / --qp-file app flow)."""
        if not self._initialized:
            raise SvtAv1Error("not initialized")
        if qp is not None and planes is not None and self.config.use_qp_file:
            p0 = self._pts if pts is None else pts
            if not hasattr(self, "_qp_map"):
                self._qp_map = {}
            self._qp_map[p0] = int(qp)
        if planes is None:
            self._eos_sent = True
        else:
            if self._eos_sent:
                raise SvtAv1Error("picture after EOS")
            p = self._pts if pts is None else pts
            if self.config.pass_ == 1:
                # first pass: open-loop stats only, no encode
                from ..codec.firstpass import FrameStats, analyze_frame

                ie, pe, cut, dec = analyze_frame(
                    np.asarray(planes[0]), getattr(self, "_fp_dec", None),
                    self.config.encoder_bit_depth)
                self._fp_dec = dec
                if not hasattr(self, "_fp_stats"):
                    self._fp_stats = []
                self._fp_stats.append(FrameStats(p, ie, pe, cut))
                self._pts += 1
                return
            if self.config.scene_change_detection:
                from ..codec.scd import decimate_luma, scene_cut

                dec = decimate_luma(planes[0], self.config.encoder_bit_depth)
                if scene_cut(getattr(self, "_scd_prev", None), dec):
                    force_key = True
                self._scd_prev = dec
            self._in_q.append((planes, p, force_key))
            self._pts += 1
        self._drain()

    def _encode_rc(self, planes, q: int, **kw) -> bytes:
        """Encode one frame under rate control with the overshoot recode
        loop (rc_process.c recode): when the frame blows the tolerance,
        roll the DPB back and re-encode at the model-inverted higher q
        (bounded at 2 recodes; --recode-loop 0 disables re-encodes).
        Also feeds the RC bit feedback."""
        if self._rc is None:
            return self._encode_capped(planes, q, **kw)
        snap = self._enc.state_snapshot()
        tu = self._enc.encode_frame(planes, q, **kw)
        if self.config.recode_loop != 0:
            for _ in range(2):
                q2 = self._rc.recode_qindex(len(tu) * 8)
                if q2 is None:
                    break
                self._enc.state_restore(snap)
                tu = self._enc.encode_frame(planes, q2, **kw)
        self._rc.update(len(tu) * 8)
        return tu

    def _encode_capped(self, planes, q: int, **kw) -> bytes:
        """Capped-CRF encode (max_bit_rate in CRF mode): ambient q floor
        from the virtual buffer fill, plus a bounded overshoot re-encode
        when one frame would overdraw the buffer."""
        if self._cap is None:
            return self._enc.encode_frame(planes, q, **kw)
        q = self._cap.adjust_q(q)
        snap = self._enc.state_snapshot()
        tu = self._enc.encode_frame(planes, q, **kw)
        if self.config.recode_loop != 0:
            for _ in range(2):
                q2 = self._cap.recode_qindex(q, len(tu) * 8)
                if q2 is None:
                    break
                q = q2
                self._enc.state_restore(snap)
                tu = self._enc.encode_frame(planes, q, **kw)
        self._cap.update(len(tu) * 8)
        return tu

    def _q_override(self, disp_idx: int, q: int, layer: int = 0,
                    is_key: bool = False) -> int:
        """Per-frame q overrides, applied after RC/TPL: qp-file value
        (use-q-file), fixed per-layer qindex offsets
        (use-fixed-qindex-offsets), startup mini-GOP offset."""
        cfg = self.config
        if cfg.use_qp_file and getattr(self, "_qp_map", {}).get(disp_idx) \
                is not None:
            return int(np.clip(self._qp_map[disp_idx] * 4, 1, 255))
        if cfg.use_fixed_qindex_offsets:
            offs = cfg.qindex_offsets or (0,)
            off = (cfg.key_frame_qindex_offset if is_key
                   else offs[min(layer, len(offs) - 1)])
            q = int(np.clip(cfg.qindex + off, 1, 255))
        if cfg.startup_qp_offset and not is_key and disp_idx < 16:
            q = int(np.clip(q + cfg.startup_qp_offset * 4, 1, 255))
        return q

    def _chroma_layer_offset(self, layer: int, is_key: bool) -> int:
        cfg = self.config
        if is_key:
            return cfg.key_frame_chroma_qindex_offset \
                if cfg.use_fixed_qindex_offsets else 0
        offs = cfg.chroma_qindex_offsets
        if not cfg.use_fixed_qindex_offsets or not offs:
            return 0
        return offs[min(layer, len(offs) - 1)]

    def _fp_w(self, poc: int) -> float:
        w = self._fp_weights
        if w is None or poc >= len(w):
            return 1.0
        return float(w[poc])

    def _keyframe_due(self, frame_idx: int) -> bool:
        period = self.config.intra_period_length
        if period == -1:
            return frame_idx == 0
        if period == -2:
            period = 60  # auto placeholder (~2s at 30fps)
        return frame_idx % (period + 1) == 0

    def _gap_to_next_key(self, disp: int) -> int:
        period = self.config.intra_period_length
        if period == -1:
            return 1 << 30
        if period == -2:
            period = 60
        return (period + 1) - (disp % (period + 1))

    def _drain(self) -> None:
        if self.config.pred_structure == 1:
            # low-delay IPPP: keyframes per keyint, no reordering
            while self._in_q:
                planes, pts, force_key = self._in_q.popleft()
                key = force_key or self._keyframe_due(pts)
                q = (self._rc.pick_qindex(key, 0,
                                           complexity=self._fp_w(pts))
                     if self._rc else self.config.qindex)
                q = self._q_override(pts, q, 0, key)
                tu = self._encode_rc(planes, q, force_key=key)
                if key:
                    tu = self._with_metadata(tu)
                self._out_q.append(Packet(tu, pts, pts, frame_type=0 if key else 1))
                if self.config.recon_enabled:
                    self._recon_q.append(Recon(self._enc.last_recon, pts))
        else:
            self._drain_ra()
        if self._eos_sent and not self._eos_emitted and not self._in_q:
            self._out_q.append(Packet(b"", self._pts, self._pts, 0, is_eos=True))
            self._eos_emitted = True

    def _drain_ra(self) -> None:
        """Random access: dyadic mini-GOPs with backward refs
        (picture-decision counterpart; the in-queue is the lookahead)."""
        if not hasattr(self, "_anchor_slot"):
            self._anchor_slot = 0
            self._dts = 0
        while self._in_q:
            disp0 = self._in_q[0][1]
            if self._in_q[0][2] or self._keyframe_due(disp0):
                # TPL needs the lookahead window buffered behind the key
                # frame before it can measure propagation into it (the
                # reference's IRC lad queue fills before QPS runs); don't
                # pop until it's there or EOS bounds it.
                if self._tpl_on() and not self._rc and not self._eos_sent:
                    la = self.config.look_ahead_distance
                    la = 11 if la < 0 else min(la, 32)
                    if len(self._in_q) - 1 < la:
                        return
                planes, pts, _ = self._in_q.popleft()
                if (self.config.enable_tf and self.config.kf_tf_strength > 0
                        and self.config.enc_mode <= 9 and self._in_q):
                    nbrs = [p for p, _, _ in list(self._in_q)[:3]]
                    planes = self._temporal_filter(
                        planes, nbrs, self.config.kf_tf_strength)
                if self._rc:
                    q = self._rc.pick_qindex(True, 0,
                                              complexity=self._fp_w(pts))
                else:
                    q = self.config.qindex
                    if self._tpl_on():
                        la = self.config.look_ahead_distance
                        la = 11 if la < 0 else min(la, 32)
                        look = [planes[0]] + [p[0] for p, _, _ in
                                              list(self._in_q)[:la]]
                        hl = max(self._max_minigop().bit_length() - 1, 1)
                        rtg = reduced_tpl_group_level(
                            self.config.enc_mode, hl, True,
                            self._small_res())
                        # reduced TPL group: drop layers > rtg from the
                        # propagation chain (validate_pic_for_tpl) — the
                        # anchor is offset 0, so keep offsets divisible
                        # by the layer stride
                        stride = 1 << max(0, hl - rtg) if rtg >= 0 else 1
                        full_n = len(look)
                        if stride > 1:
                            look = [look[0]] + [look[j] for j in
                                                range(stride, full_n,
                                                      stride)]
                        tpl = self._run_tpl(look, q)
                        q = crf_qindex_calc(
                            q, is_intra=True, layer=0, hl=hl, leaf=False,
                            r0=tpl.r0(0),
                            adj=r0_adjust_factor(rtg, hl, True),
                            tpl_group_size=full_n,
                            bit_depth=self.config.encoder_bit_depth,
                            qp_scale_compress_strength=self.config
                            .qp_scale_compress_strength)
                        self._kf_q = q
                        self._kf_betas = tpl.sb_beta(
                            0, self.config.source_width,
                            self.config.source_height)
                q = self._q_override(pts, q, 0, True)
                self._slot_q = {s: (q, 0) for s in range(8)}  # KF refreshes all
                kplan = plan_key(pts)
                kplan.tpl_betas = getattr(self, "_kf_betas", None)
                self._kf_betas = None
                kplan.chroma_q_offset = self._chroma_layer_offset(0, True)
                tu = self._encode_rc(planes, q, plan=kplan)
                self._emit(tu, pts, 0, shown=True)
                self._anchor_slot = 0
                continue
            gap = self._gap_to_next_key(disp0)
            avail = len(self._in_q)
            max_mg = self._max_minigop()
            # scene cut inside the lookahead bounds the mini-GOP (the cut
            # frame was flagged force-key at ingest)
            cut = next((k for k in range(1, avail) if self._in_q[k][2]),
                       None)
            want = min(max_mg, gap)
            if self._tpl_on() and not self._rc:
                # buffer a TPL lookahead window past the mini-GOP so the
                # ARF's r0 sees its dependents (the reference's lad_mg
                # minigop(s) in the lad queue)
                la = self.config.look_ahead_distance
                want += 8 if la < 0 else min(la, 32)
            if cut is None and avail < want and not self._eos_sent:
                return  # wait for more lookahead
            length = min(max_mg, gap, avail)
            if cut is not None:
                length = min(length, cut)
            while length & (length - 1):
                length &= length - 1  # dyadic lengths only; leftover follows
            if length == 0:
                return
            future = 1 - self._anchor_slot
            plans = plan_minigop(self._anchor_slot, disp0, length,
                                 future_slot=future, mid_slot=2)
            srcs = {}
            for _ in range(length):
                planes, pts, _fk = self._in_q.popleft()
                srcs[pts] = planes
            # temporal filtering of the ARF source (temporal_filtering.c):
            # the anchor is coded from a motion-compensated average of the
            # mini-GOP window, giving the B frames a denoised reference
            if (length > 1 and self.config.enable_tf
                    and self.config.enc_mode <= 9
                    and not plans[0].show_frame
                    and plans[0].show_existing_slot is None):
                arf = plans[0].disp_idx
                # the reference's base TF window is the nearest +-few
                # pictures (tf_params_per_type[1] num_past/future_pics,
                # enc_handle.c:2697), NOT the whole mini-GOP: distant
                # frames exceed the full-pel search range and only ghost
                nbrs = [v for k, v in
                        sorted(srcs.items(), key=lambda kv: abs(kv[0] - arf))
                        if k != arf][:6]
                srcs[arf] = self._temporal_filter(srcs[arf], nbrs,
                                                  self.config.tf_strength)
            # TPL over the mini-GOP + queued lookahead: the display-order
            # chain lets future frames propagate dependency back into
            # this group's ARF (its group index = length-1)
            tpl_q = None
            if self._tpl_on() and not self._rc and length > 1:
                _t0 = time.perf_counter()
                ordered = [srcs[d][0] for d in sorted(srcs)]
                la = self.config.look_ahead_distance
                la = 8 if la < 0 else min(la, 32)
                look = ordered + [p[0] for p, _, _ in list(self._in_q)[:la]]
                hl = max(length.bit_length() - 1, 1)  # 4 -> 2 layers
                rtg = reduced_tpl_group_level(
                    self.config.enc_mode, hl, False, self._small_res())
                adj = r0_adjust_factor(rtg, hl, False)
                group_sz = len(look)
                # reduced TPL group (validate_pic_for_tpl): keep frames
                # whose offset from the anchor (group index + 1) rides a
                # layer <= rtg; the chain then predicts across the kept
                # frames only, like the reference's reduced dispenser
                stride = 1 << max(0, hl - rtg) if rtg >= 0 else 1
                if stride > 1:
                    look = [look[j] for j in range(stride - 1, group_sz,
                                                   stride)]
                tpl = self._run_tpl(look, self.config.qindex)
                if _timing():
                    self._enc._tick("tpl", _t0)
                cfg_q = self.config.qindex
                bd = self.config.encoder_bit_depth
                qpscs = self.config.qp_scale_compress_strength

                def tpl_q(pl) -> int:  # noqa: F811 — per-frame ladder
                    """crf_qindex_calc per frame: own r0 for qstep-
                    eligible layers, nearest-ref q/layer otherwise."""
                    gi = pl.disp_idx - disp0
                    # reduced-group stats index: offset gi+1 -> chain pos
                    ti = min((gi + 1) // stride - 1 if stride > 1 else gi,
                             len(look) - 1)
                    ti = max(ti, 0)
                    refs = [pl.refs.get(n) for n in (1, 5, 7)]  # LAST,
                    refs = [s for s in refs if s is not None]   # BWD, ALT
                    rq = [self._slot_q[s] for s in refs[:2]
                          if s in self._slot_q]
                    if uses_qstep_calc(pl.layer, hl, rtg):
                        pl.tpl_betas = tpl.sb_beta(
                            ti, self.config.source_width,
                            self.config.source_height)
                    return crf_qindex_calc(
                        cfg_q, is_intra=False, layer=pl.layer, hl=hl,
                        leaf=pl.layer >= hl and not pl.refresh_flags,
                        r0=tpl.r0(ti), adj=adj,
                        tpl_group_size=group_sz,
                        ref_qs=tuple(q for q, _l in rq),
                        ref_layers=tuple(_l for q, _l in rq),
                        use_qstep=uses_qstep_calc(pl.layer, hl, rtg),
                        bit_depth=bd, qp_scale_compress_strength=qpscs)
            # resolve per-plan q up front, then walk the coded order in
            # layer runs: all frames of a run are begun together (their
            # device analyses queue asynchronously) and resumed in order,
            # overlapping device compute with the host commit/entropy
            # tail of earlier frames. plan_minigop's BFS slot discipline
            # guarantees same-layer frames never reference each other.
            def pick_q(pl, src, is_se) -> int:
                """Per-frame q: RC feedback / TPL ladder / CRF, plus the
                luminance bias. With RC this MUST run in coded order
                right before the frame encodes (bit feedback)."""
                if self._rc and not is_se:
                    q = self._rc.pick_qindex(False, pl.layer,
                                              complexity=self._fp_w(pl.disp_idx))
                    pl.q_offset = 0  # RC owns the per-layer allocation
                elif tpl_q is not None and not is_se:
                    q = tpl_q(pl)
                    pl.q_offset = 0  # TPL owns the per-frame ladder
                else:
                    q = self.config.qindex
                if not is_se:
                    q = self._q_override(pl.disp_idx, q, pl.layer, False)
                    if (self.config.use_qp_file
                            or self.config.use_fixed_qindex_offsets):
                        pl.q_offset = 0
                    pl.chroma_q_offset = self._chroma_layer_offset(
                        pl.layer, False)
                if (self.config.luminance_qp_bias and not is_se
                        and src is not None):
                    from ..codec.rc import (
                        luminance_qp_bias_offset,
                    )

                    avg = float(np.asarray(src[0]).mean()) \
                        / (1 << (self.config.encoder_bit_depth - 8))
                    q = int(np.clip(
                        q + pl.q_offset + luminance_qp_bias_offset(
                            q + pl.q_offset, avg, pl.layer,
                            self.config.luminance_qp_bias) - pl.q_offset,
                        1, 255))
                if not is_se and pl.refresh_flags:
                    for s in range(8):
                        if pl.refresh_flags & (1 << s):
                            self._slot_q[s] = (q + pl.q_offset, pl.layer)
                return q

            items = [(pl, srcs.get(pl.disp_idx),
                      pl.show_existing_slot is not None) for pl in plans]
            i = 0
            while i < len(items):
                pl, src, is_se = items[i]
                if is_se or self._rc is not None or self._cap is not None:
                    # show_existing, or RC/capped-CRF sequential feedback
                    q = pick_q(pl, src, is_se)
                    if is_se:
                        tu = self._enc.encode_frame(None, q, plan=pl)
                    else:
                        tu = self._encode_rc(src, q, plan=pl)
                    self._emit(tu, pl.disp_idx, 1,
                               shown=pl.show_frame or is_se)
                    i += 1
                    continue
                # maximal run: same-layer coded frames, show_existing
                # entries allowed in between (they touch no DPB slot)
                j, run = i, []
                while j < len(items):
                    plj, _, sej = items[j]
                    if not sej and plj.layer != pl.layer:
                        break
                    run.append(j)
                    j += 1
                while items[run[-1]][2]:  # leave trailing se's to the
                    run.pop()             # sequential path (next GOP's
                j = run[-1] + 1           # key could follow)
                sts = {k: self._enc.begin_frame(
                           items[k][1], pick_q(*items[k]), plan=items[k][0])
                       for k in run if not items[k][2]}
                for k in run:
                    plk, srck, sek = items[k]
                    if sek:
                        tu = self._enc.encode_frame(None, self.config.qindex,
                                                    plan=plk)
                    else:
                        tu = self._enc.resume_frame(sts.pop(k))
                    self._emit(tu, plk.disp_idx, 1,
                               shown=plk.show_frame or sek)
                i = j
            if length > 1:
                self._anchor_slot = future

    def _max_minigop(self) -> int:
        """Mini-GOP size from hierarchical_levels (0 = auto by preset;
        the reference scales pyramid depth down at the fastest presets,
        pd_process.c mini-GOP assembly)."""
        hl = self.config.hierarchical_levels
        if hl > 0:
            return 1 << min(hl, 4)
        return 16 if self.config.enc_mode <= 10 else 8

    def _small_res(self) -> bool:
        """input_resolution <= INPUT_SIZE_480p_RANGE (reference
        resolution bands; 480p band tops out at 832x480 pixels)."""
        return (self.config.source_width * self.config.source_height
                <= 832 * 480)

    def _tpl_on(self) -> bool:
        return bool(self.config.enable_tpl_la) and self.config.enc_mode <= 11

    def _with_metadata(self, tu: bytes) -> bytes:
        """Insert HDR metadata OBUs after the 2-byte temporal delimiter."""
        if not self._metadata:
            return tu
        return tu[:2] + self._metadata + tu[2:]

    def _emit(self, tu: bytes, pts: int, ftype: int, shown: bool) -> None:
        if ftype == 0:
            tu = self._with_metadata(tu)
        self._out_q.append(Packet(tu, pts, self._dts, frame_type=ftype))
        self._dts += 1
        if shown and self.config.recon_enabled:
            self._recon_q.append(Recon(self._enc.last_recon, pts))

    def get_packet(self, blocking: bool = False) -> Packet | None:
        if self._out_q:
            return self._out_q.popleft()
        return None

    def release_out_buffer(self, packet: Packet) -> None:
        pass  # no pooled buffers in this implementation

    def get_recon(self) -> Recon | None:
        if not self.config.recon_enabled:
            raise SvtAv1Error("recon not enabled")
        return self._recon_q.popleft() if self._recon_q else None

    def get_stream_info(self, info_id: int):
        if info_id == 0:  # SVT_AV1_STREAM_INFO_FIRST_PASS_STATS_OUT
            if self.config.pass_ != 1:
                raise SvtAv1Error("stats only produced in pass 1")
            if not self._eos_sent:
                raise SvtAv1Error("stats available after EOS")
            from ..codec.firstpass import serialize

            return serialize(getattr(self, "_fp_stats", []))
        raise SvtAv1Error(f"unknown stream info {info_id}")

    # ---- teardown ----------------------------------------------------------------
    def deinit(self) -> None:
        self._initialized = False

    def deinit_handle(self) -> None:
        self._enc = None
        self._in_q.clear()
        self._out_q.clear()


# ---- C-shaped convenience wrappers ------------------------------------------------


def svt_av1_enc_init_handle(*, device="cuda", kernels: str = "hand"
                            ) -> tuple[SvtAv1Encoder, EncoderConfig]:
    h = SvtAv1Encoder(device=device, kernels=kernels)
    return h, h.config


def svt_av1_enc_set_parameter(handle: SvtAv1Encoder, config: EncoderConfig) -> None:
    handle.set_parameter(config)


def svt_av1_enc_init(handle: SvtAv1Encoder) -> None:
    handle.init()


def svt_av1_enc_send_picture(handle: SvtAv1Encoder, planes, pts=None) -> None:
    handle.send_picture(planes, pts)


def svt_av1_enc_get_packet(handle: SvtAv1Encoder, pic_send_done: bool = False):
    return handle.get_packet(blocking=pic_send_done)


def svt_av1_get_version() -> str:
    return SVT_VERSION


def svt_psy_get_version() -> str:
    return "tpu-rebuild-r1"
