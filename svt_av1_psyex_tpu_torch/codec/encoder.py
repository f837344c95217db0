"""The port's encoder: the JAX package's Av1Encoder with its device tier
replaced by the port's.

`Av1Encoder` subclasses svt_av1_psyex_tpu/codec/encoder.py's class and
overrides only what reaches JAX:

* the constructor takes the analysis `device` (and `kernels`) and does
  not arm the JAX persistent compile cache;
* `_begin_frame_impl` is a copy of the base method, whose two calls into
  the device tier go to the port (see its docstring);
* `encode_keyframes` runs one batched analysis on the device for the
  whole group, then the host tail per frame;
* `_pick_cdef` picks the native C backend through the port's cdefc, or
  the numpy one; there is no device CDEF.

`begin_frame`, `resume_frame` and `encode_frame` are inherited: key and
inter frames (FramePlan from codec.gop.plan_minigop) run through the
port's device mode decision at presets >= 6, and through the host mode
decision on the port's motion field below. Loop restoration, whose
search runs on the JAX device tier, raises NotImplementedError.
"""

from __future__ import annotations

import os
import time

import numpy as np

from svt_av1_psyex_tpu.bitstream.coeff_writer import CoeffWriter
from svt_av1_psyex_tpu.bitstream.headers import (
    FrameConfig,
    SequenceConfig,
    compute_tile_info,
)
from svt_av1_psyex_tpu.bitstream.tables import FrameCdfs
from svt_av1_psyex_tpu.bitstream.tile_writer import TileWriter
from svt_av1_psyex_tpu.codec import encoder as ref_encoder
from svt_av1_psyex_tpu.codec.constants import BlockSize
from svt_av1_psyex_tpu.codec.encoder import _PlaneCtx
from svt_av1_psyex_tpu.codec.rd import cdf_costs, compute_rdmult
from svt_av1_psyex_tpu.utils import tunnel

from ..device.intra import DEVICE_MODES, intra_analysis_batch, qp_row_for
from ..native import cdefc
from ..runtime import check_kernels, resolve_device
from .md_device import DeviceIntraMD, upload_lumas

__all__ = ["Av1Encoder", "SequenceConfig"]


class Av1Encoder(ref_encoder.Av1Encoder):
    """Encoder whose device analysis runs in PyTorch on `device` ("cpu"
    or "cuda"). `kernels="plain"` runs the plain PyTorch version of every
    kernel instead of the hand kernel, to compare the two on the card;
    the default "hand" launches the CUDA kernels on a CUDA device (on the
    CPU there are none, and the plain versions run)."""

    def __init__(self, seq, preset: int = 10, *, device,
                 kernels: str = "hand", **kwargs):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        # the inherited constructor arms the JAX package's persistent
        # compile cache, which imports jax; the port compiles nothing
        # through XLA, so the one-shot hook is marked as done
        tunnel._cache_armed = True
        super().__init__(seq, preset, **kwargs)
        if seq.enable_restoration:
            raise NotImplementedError(
                "loop restoration is not ported yet (its search runs on "
                "the JAX device tier): pass enable_restoration=False or a "
                "preset above 6")
        self.stage_seconds: dict = {}

    def _begin_frame_impl(self, planes, base_q_idx=80, force_key=False,
                          plan=None, _analysis_row=None, _group=None):
        """A copy of the base class's method
        (svt_av1_psyex_tpu/codec/encoder.py:438-879), which has no seam
        for the device tier. Two calls differ, both into device/:

        * the host-MD motion field (base :776-782) is the port's
          device.me.run_device_me, on self.device through self.kernels;
        * the device MD (base :860-874) is the port's DeviceInterMD or
          DeviceIntraMD, on self.device through self.kernels; the
          multi-device `mesh` the base attaches is not ported.

        Its imports of the host tier name the JAX package's modules."""
        seq = self.seq
        if not hasattr(self, "slots"):
            self.slots = [None] * 8
        if plan is None:
            from svt_av1_psyex_tpu.codec.gop import FramePlan, LAST, ALTREF

            is_key = force_key or self.slots[0] is None
            if is_key:
                plan = FramePlan(self.frame_count, 0, True,
                                 refresh_flags=0xFF)
            else:
                plan = FramePlan(self.frame_count, 1, True,
                                 refs={LAST: 0}, refresh_flags=0xFF,
                                 primary_ref_name=LAST)
        if plan.show_existing_slot is not None:
            return self._show_existing_tu(plan.show_existing_slot)
        is_key = plan.frame_type == 0
        base_q_idx = int(np.clip(base_q_idx + plan.q_offset, 1, 255))
        fr = FrameConfig(frame_type=plan.frame_type,
                         show_frame=plan.show_frame,
                         base_q_idx=base_q_idx,
                         order_hint=plan.disp_idx & ((1 << seq.order_hint_bits) - 1))
        if seq.enable_superres and seq.superres_upscaled_width:
            # superres frames are coded at seq.width (downscaled); the
            # source arrives at display width — downscale it here
            # (non-normative, resize.c av1_resize_and_extend_frame role)
            assert fr.frame_is_intra, \
                "superres: all-intra streams only (ref scaling pending)"
            if planes is not None and planes[0].shape[1] > seq.width:
                from svt_av1_psyex_tpu.ops.resize import downscale_horiz

                ssx = seq.subsampling_x
                cws = [seq.width] + [(seq.width + ssx) >> ssx] * 2
                planes = [downscale_horiz(np.asarray(p), cws[i],
                                          seq.bit_depth)
                          for i, p in enumerate(planes)]
        if self.screen_content_mode:
            if (is_key and self.screen_content_mode == 2
                    and planes is not None):
                from svt_av1_psyex_tpu.ops.palette import is_screen_content

                self._allow_sc = is_screen_content(np.asarray(planes[0]))
            fr.allow_screen_content_tools = self._allow_sc
            # intra block copy on SC intra frames (spec: intra frames
            # only; the frame then runs no in-loop filters)
            if (self._allow_sc and fr.frame_is_intra
                    and os.environ.get("SVT_TPU_NO_INTRABC") != "1"):
                fr.allow_intrabc = True
        dq_y, dq_udc, dq_uac = self.delta_q_offsets
        coff = getattr(plan, "chroma_q_offset", 0)
        if dq_y or dq_udc or dq_uac or coff:
            clip63 = lambda v: int(np.clip(v, -63, 63))  # noqa: E731
            fr.delta_q_y_dc = clip63(dq_y)
            fr.delta_q_u_dc = clip63(dq_udc + coff)
            fr.delta_q_u_ac = clip63(dq_uac + coff)
        fr.refresh_frame_flags = plan.refresh_flags
        # TX_MODE_SELECT at the slower presets (the reference's tx-depth
        # search levels, product_coding_loop.c tx_size search); faster
        # presets stay TX_MODE_LARGEST. Device-MD frames run the tx-depth
        # search inside the conformant commit (native/frame_enc.c depth
        # trial / md_device._luma_tx_trial) so p6-9 keeps the preset's
        # toolset on the device path too. SVT_TPU_NO_TXSELECT=1 ablates.
        import os as _os_txs

        fr.tx_mode_select = (self.preset <= 9
                             and _os_txs.environ.get("SVT_TPU_NO_TXSELECT")
                             != "1")
        if not is_key:
            # map each named ref (LAST..ALTREF = 1..7) to a DPB slot;
            # unspecified names alias the first specified slot
            default_slot = next(iter(plan.refs.values()))
            fr.ref_frame_idx = tuple(plan.refs.get(name, default_slot)
                                     for name in range(1, 8))

        sb_qmap = None
        seg_sb_map = None
        if self.seg_aq and planes is not None and base_q_idx > 0:
            # segmentation AQ: per-SB variance quartiles -> 4 segments
            # with fixed ALT_Q deltas (segmentation.c aq-mode analog)
            from svt_av1_psyex_tpu.codec.psy import sb_variances_8x8

            luma = self._pad_plane(np.asarray(planes[0]), self.aligned_w,
                                   self.aligned_h).astype(np.int64)
            nsy = (self.mi_rows + 15) // 16
            nsx = (self.mi_cols + 15) // 16
            var = np.zeros((nsy, nsx))
            for sy in range(nsy):
                for sx in range(nsx):
                    var[sy, sx] = float(np.median(
                        sb_variances_8x8(luma, sx, sy)))
            qs = np.quantile(var, [0.25, 0.5, 0.75])
            seg_sb_map = np.digitize(var, qs).astype(np.int8)  # 0..3
            fr.seg_qdeltas = (-10, -5, 0, 5)
        elif self.enable_variance_boost and planes is not None and base_q_idx > 0:
            from svt_av1_psyex_tpu.codec.psy import variance_adjust_qp

            luma = self._pad_plane(np.asarray(planes[0]), self.aligned_w,
                                   self.aligned_h).astype(np.int64)
            # TPL QPM offsets precede the boost for r0-based frames
            # (svt_aom_sb_qp_derivation_tpl_la, rc_process.c:1626)
            qpm = None
            betas = getattr(plan, "tpl_betas", None) if plan is not None \
                else None
            if betas is not None:
                from svt_av1_psyex_tpu.codec.tpl import get_deltaq_offset

                qpm = np.array(
                    [[get_deltaq_offset(base_q_idx, float(b), is_key,
                                        seq.bit_depth) for b in row]
                     for row in np.asarray(betas)], np.int32)
            new_base, sb_qmap, res = variance_adjust_qp(
                luma, base_q_idx, self.vb_strength, self.vb_octile,
                self.vb_curve, seq.bit_depth, qpm_offsets=qpm)
            fr.base_q_idx = new_base
            if self.low_q_taper and sb_qmap is not None:
                from svt_av1_psyex_tpu.codec.psy import low_q_taper as _taper

                sb_qmap = _taper(sb_qmap, base_q_idx)
            if np.any(sb_qmap != new_base):
                fr.delta_q_present = True
                fr.delta_q_res = res
            else:
                sb_qmap = None
        if self.film_grain > 0:
            fg = None
            if self.adaptive_film_grain and planes is not None:
                fg = self._grain_model_params(planes, plan.disp_idx, is_key)
            if fg is not None:
                fr.film_grain = fg
            else:
                noise = None
                if self.adaptive_film_grain and planes is not None:
                    from svt_av1_psyex_tpu.codec.tf import estimate_noise_mad

                    noise = estimate_noise_mad(
                        np.asarray(planes[0]).astype(np.int64)
                        >> (seq.bit_depth - 8))
                fr.film_grain = self._film_grain_params(plan.disp_idx, noise)
        if self.qm is not None:
            from svt_av1_psyex_tpu.ops.quant import get_qmlevel

            mn, mx, cmn, cmx = self.qm
            fr.using_qmatrix = True
            fr.qm_y = get_qmlevel(fr.base_q_idx, mn, mx)
            fr.qm_u = get_qmlevel(fr.base_q_idx, cmn, cmx)
            fr.qm_v = fr.qm_u
        if seg_sb_map is not None:
            # per-SB effective qindex for the MD quantizers (the decoder
            # derives it from base + seg ALT_Q)
            sb_qmap = np.clip(
                fr.base_q_idx
                + np.asarray(fr.seg_qdeltas, np.int32)[seg_sb_map],
                1, 255).astype(np.int32)
        fr.tile = compute_tile_info(seq, cols_log2=self.tile_cols_log2)
        assert fr.tile.tile_rows == 1, "tile rows later"
        n_tiles = fr.tile.tile_cols

        # CDF forwarding (spec 7.20 load_cdfs): inter frames start from the
        # primary reference slot's end-of-tile adapted state
        cdfs = None
        if not is_key and plan.primary_ref_name is not None:
            pr_idx = plan.primary_ref_name - 1  # index into ref_frame_idx
            slot = self.slots[fr.ref_frame_idx[pr_idx]]
            if slot is not None and slot.get("cdfs") is not None:
                cdfs = slot["cdfs"].clone()
                fr.primary_ref_frame = pr_idx
        if cdfs is None:
            cdfs = FrameCdfs(fr.base_q_idx)
        tw = TileWriter(seq, fr, cdfs, self.mi_rows, self.mi_cols)
        if seg_sb_map is not None:
            # expand the per-SB segment choice to per-mi targets
            tgt = np.zeros((self.mi_rows, self.mi_cols), np.int8)
            for sy in range(seg_sb_map.shape[0]):
                for sx in range(seg_sb_map.shape[1]):
                    tgt[sy * 16:(sy + 1) * 16, sx * 16:(sx + 1) * 16] = \
                        seg_sb_map[sy, sx]
            tw.seg_target = tgt
            tw.seg_last_active = len(fr.seg_qdeltas) - 1
            self._seg_target = tgt
        else:
            self._seg_target = None
            tw.sb_qindex_map = sb_qmap
        tw.coeff_writer = CoeffWriter(tw, self.mi_rows, self.mi_cols,
                                      seq.subsampling_x, seq.subsampling_y)
        sign_bias = np.zeros(8, bool)
        if fr.frame_is_intra and fr.allow_intrabc:
            # intra-BC DV prediction replays through the writer-side
            # MiState (ref 0 = INTRA_FRAME entries)
            from svt_av1_psyex_tpu.codec.mvp import MiState

            tw.mi_state = MiState(self.mi_rows, self.mi_cols)
        if not is_key:
            from svt_av1_psyex_tpu.codec.mvp import MiState

            tw.mi_state = MiState(self.mi_rows, self.mi_cols)
            # RefFrameSignBias: ref displays after the current frame
            # (get_relative_dist with order-hint wraparound, spec 7.8)
            bits = seq.order_hint_bits
            half = 1 << (bits - 1)

            def rel_dist(a, b):
                diff = (a - b) & ((1 << bits) - 1)
                return (diff & (half - 1)) - (diff & half)

            hints = []
            for name in range(1, 8):
                slot = self.slots[fr.ref_frame_idx[name - 1]]
                hint = slot["order_hint"] if slot is not None else 0
                hints.append(hint)
                if slot is not None:
                    sign_bias[name] = rel_dist(hint, fr.order_hint) > 0
            fr.ref_order_hints = tuple(hints)
            tw.mi_state.sign_bias = sign_bias
            # MFMV (spec 7.9): project the refs' saved motion fields and
            # attach the temporal grid + per-ref offsets to the MVP state
            # (single-tile frames; tile-local MVP coords keep it off for
            # tile columns — a legal encoder choice)
            import os as _os_mfmv

            from svt_av1_psyex_tpu.codec.mfmv import projection_safe

            if (seq.enable_ref_frame_mvs and n_tiles == 1
                    and _os_mfmv.environ.get("SVT_TPU_NO_MFMV") != "1"
                    and projection_safe(fr, self.slots,
                                        seq.order_hint_bits)):
                from svt_av1_psyex_tpu.codec.mfmv import rel_dist as _rel_dist
                from svt_av1_psyex_tpu.codec.mfmv import setup_motion_field

                fr.use_ref_frame_mvs = True
                tw.mi_state.tpl = setup_motion_field(
                    fr, self.slots, self.mi_rows, self.mi_cols,
                    seq.order_hint_bits)
                off = np.zeros(8, np.int32)
                for name in range(1, 8):
                    off[name] = _rel_dist(seq.order_hint_bits,
                                          fr.order_hint,
                                          fr.ref_order_hints[name - 1])
                tw.mi_state.tpl_cur_off = off
            # compound prediction possible when the plan provides both a
            # past and a future reference
            named = list(plan.refs.keys())
            has_fwd = any(not sign_bias[n] for n in named)
            has_bwd = any(sign_bias[n] for n in named)
            fr.reference_select = has_fwd and has_bwd

        sb_mi = 32 if seq.use_128x128_superblock else 16
        sb_bsize = BlockSize.B128X128 if seq.use_128x128_superblock else BlockSize.B64X64

        if planes is None:
            planes = [np.full((seq.height, seq.width), 128, np.uint8)]
            if not seq.mono_chrome:
                ch = (seq.height + seq.subsampling_y) >> seq.subsampling_y
                cw = (seq.width + seq.subsampling_x) >> seq.subsampling_x
                planes += [np.full((ch, cw), 128, np.uint8)] * 2

        pctx = []
        for i, p in enumerate(planes):
            ss_x = 0 if i == 0 else seq.subsampling_x
            ss_y = 0 if i == 0 else seq.subsampling_y
            aw = self.aligned_w >> ss_x
            ah = self.aligned_h >> ss_y
            # chroma margin: sub-4-row/col blocks (4-way partitions) carry
            # 4-px-min chroma that can overhang the aligned grid at the
            # bottom/right edge; the decoder's padded buffers absorb this
            if i > 0:
                aw += 4
                ah += 4
            src = self._pad_plane(np.asarray(p), aw, ah).astype(np.int32)
            pctx.append(_PlaneCtx(src=src, recon=np.zeros((ah, aw), np.int32),
                                  ss_x=ss_x, ss_y=ss_y))

        # pass 1: mode decision + recon (MD-local contexts); pass 2: syntax
        from svt_av1_psyex_tpu.codec.md import ModeDecision
        from svt_av1_psyex_tpu.codec.rd import compute_rdmult

        # spec 7.11.3.3: MC sample clamping is to the reference's DISPLAY
        # dims (RefUpscaledWidth), not the coded/aligned area — crop the DPB
        # views so the clipped gathers in ops.mc clamp at the right bound
        ref_planes = None
        if not is_key:
            def crop(planes_full):
                out = []
                for i, p in enumerate(planes_full):
                    sx = 0 if i == 0 else seq.subsampling_x
                    sy = 0 if i == 0 else seq.subsampling_y
                    out.append(p[: (seq.height + sy) >> sy,
                                 : (seq.width + sx) >> sx])
                return out

            ref_planes = {}
            for name, slot_idx in plan.refs.items():
                slot = self.slots[slot_idx]
                assert slot is not None, f"ref {name} slot {slot_idx} empty"
                ref_planes[name] = crop(slot["recon"])

        # device-MD eligibility (shared gates): fused inter lattice for
        # inter frames, intra lattice for key frames
        # QM / noise-norm frames fall back to the host txb chain inside
        # the device commit (md_device._mk_commit_ctx) and seg-AQ rides
        # the per-SB qmap plumbing — none of them gate the lattice
        dev_ok = (self._device_md_precheck()
                  and not fr.allow_screen_content_tools
                  and n_tiles == 1)
        use_device_inter = dev_ok and not fr.frame_is_intra and bool(ref_planes)

        # local warped motion + OBMC (motion_mode syntax): host MD
        # searches WARPED_CAUSAL/OBMC candidates; device-MD frames run a
        # commit-time motion-mode trial per winning block
        # (md_device._commit_inter_leaf). Layer gating mirrors the
        # reference: all layers at the host presets (wm_level 1-2,
        # enc_mode_config.c:8225-8236), base layer only at M4-9
        # (wm_level 3/4 + obmc_level 4 at is_base, :8237-8243, :8065-8075)
        if (not fr.frame_is_intra and bool(ref_planes)
                and seq.enable_warped_motion
                and (self.preset <= 5 or plan.layer == 0)
                and os.environ.get("SVT_TPU_NO_LWARP") != "1"):
            fr.allow_warped_motion = True
            fr.is_motion_mode_switchable = True

        # switchable interpolation filters: inter frames at the slower
        # presets search REG/SMOOTH/SHARP per block
        # (enc_inter_prediction.c:2276 interpolation_filter_search).
        # Host path searches in MD; device-path frames run the same
        # trial per winning block at commit time (md_device
        # _commit_inter_leaf), keeping the p6 toolset on the device path.
        if (not fr.frame_is_intra and bool(ref_planes)
                and self.preset <= 6
                and os.environ.get("SVT_TPU_NO_IFS") != "1"):
            fr.interp_filter = 4  # SWITCHABLE

        # device full-pel motion field: ONE batched HME/ME call over all
        # refs replaces the per-block host raster (device/me.py); skipped
        # when the fused inter lattice (which embeds ME) will run.
        # Multi-tile: the device lattices/fields are frame-global while
        # tile MD must honor tile-edge availability — host path per tile.
        me_field = None
        if ref_planes and not use_device_inter and n_tiles == 1:
            if os.environ.get("SVT_TPU_HOST_ME") != "1":
                from ..device.me import run_device_me

                me_field = run_device_me(
                    pctx[0].src, {n: p[0] for n, p in ref_planes.items()},
                    bit_depth=seq.bit_depth, device=self.device,
                    kernels=self.kernels)
        # global motion estimation (codec/gm.py; reference
        # global_motion.c:368 RANSAC pipeline redesigned as IRLS over the
        # device ME field). Host-MD inter frames only: the device lattice
        # and native commit assume identity gm. Full model set:
        # TRANSLATION (gm MV coding) + ROTZOOM/AFFINE (warp prediction).
        if (self.enable_global_motion and me_field is not None
                and not fr.frame_is_intra and not use_device_inter):
            from svt_av1_psyex_tpu.bitstream.headers import GM_AFFINE
            from svt_av1_psyex_tpu.codec.gm import estimate_global_motion

            gm_list = [None] * 7
            src_crop = pctx[0].src[:seq.height, :seq.width]
            for name, pl in ref_planes.items():
                g = estimate_global_motion(
                    src_crop, pl[0], me_field.maps.get(name, {}),
                    max_type=GM_AFFINE)
                if not g.is_identity:
                    gm_list[name - 1] = (g.gm_type, g.mat)
            if any(e is not None for e in gm_list):
                fr.gm = tuple(gm_list)
                if fr.primary_ref_frame != 7:
                    slot = self.slots[
                        fr.ref_frame_idx[fr.primary_ref_frame]]
                    if slot is not None and slot.get("gm_mats"):
                        fr.gm_prev = slot["gm_mats"]

        psy_factor = 0.0
        if self.psy_rd > 0.0:
            from svt_av1_psyex_tpu.ops.psy_dist import hvs_modulation_factor

            psy_factor = hvs_modulation_factor(self.psy_rd, is_key,
                                               plan.layer)
        rdoq_frame = None
        if self.rdoq_level:
            from svt_av1_psyex_tpu.codec.rdoq import RdoqFrame

            # the trellis dist is coefficient-domain (8x-orthonormal, so
            # 64x pixel SSE >> 2*shift) — it pairs with the UNDIVIDED
            # libaom rdmult; compute_rdmult carries /16 for raw-SSE MD
            rdoq_frame = RdoqFrame(
                cdfs, fr.base_q_idx,
                compute_rdmult(fr.base_q_idx, seq.bit_depth) * 16,
                sharpness=self.sharpness, sharp_tx=self.sharp_tx,
                use_sharpness=(self.rdoq_use_sharpness
                               and fr.delta_q_present))

        def make_md(p_list, mi_cols, me_f, x_off=0):
            m = ModeDecision(seq, fr, p_list, self.mi_rows, mi_cols,
                             rdmult=compute_rdmult(fr.base_q_idx, seq.bit_depth),
                             min_bsize=self._min_partition_bsize,
                             n_full_rd=3 if self.preset <= 6 else 2,
                             angle_deltas=self.preset <= 9,
                             ref_planes=ref_planes,
                             try_rect=self.preset <= 8,
                             try_ext=self.preset <= 5,
                             try_4way=self.preset <= 5,
                             cdfs=cdfs.clone(), me_field=me_f,
                             psy_factor=psy_factor,
                             filter_intra=seq.enable_filter_intra,
                             cfl=self.preset <= 6, tile_x_off=x_off,
                             noise_norm=self.noise_norm_strength,
                             max_32_tx=self.max_32_tx_size,
                             rdoq=rdoq_frame, spy_rd=self.spy_rd,
                             temporal_layer=plan.layer,
                             complex_hvs=self.complex_hvs,
                             hbd_mds=self.hbd_mds)
            if m.mi_state is not None:
                m.mi_state.sign_bias = sign_bias
                if tw.mi_state is not None:
                    m.mi_state.tpl = tw.mi_state.tpl
                    m.mi_state.tpl_cur_off = tw.mi_state.tpl_cur_off
            return m

        md = make_md(pctx, self.mi_cols, me_field) if n_tiles == 1 else None
        # device MD path: whole-frame candidate analysis on TPU (intra
        # lattice for key frames, fused ME+inter lattice for inter
        # frames), host does argmin + conformant commit
        use_device = dev_ok and fr.frame_is_intra
        dmd = None
        if use_device or use_device_inter:
            from .md_device import DeviceInterMD, DeviceIntraMD

            if use_device_inter:
                dmd = DeviceInterMD(md, seq, fr, sb_qmap,
                                    ref_names=sorted(ref_planes),
                                    device=self.device, kernels=self.kernels)
                dmd.analyze_dispatch()
            else:
                dmd = DeviceIntraMD(md, seq, fr, sb_qmap, device=self.device,
                                    kernels=self.kernels)
                if _analysis_row is None:
                    dmd.analyze_dispatch()
        return {"fr": fr, "tw": tw, "cdfs": cdfs, "pctx": pctx, "md": md,
                "dmd": dmd, "sb_qmap": sb_qmap, "ref_planes": ref_planes,
                "n_tiles": n_tiles, "sb_mi": sb_mi, "sb_bsize": sb_bsize,
                "make_md": make_md, "is_key": is_key,
                "analysis_row": _analysis_row, "group": _group}

    @staticmethod
    def _pick_cdef():
        """CDEF backend: native C when it builds, else numpy. Both share
        the full-grid search contract."""
        if cdefc.available():
            return cdefc.cdef_search_frame_c
        from svt_av1_psyex_tpu.ops.cdef import cdef_search_frame

        return cdef_search_frame

    def keyframe_depths(self) -> tuple:
        """Lattice depths of this encoder's keyframes."""
        return DeviceIntraMD.depths_for(
            self._min_partition_bsize, self.mi_rows, self.mi_cols)

    def analyze_keyframes(self, frames: list, base_q_idx: int
                          ) -> np.ndarray:
        """The batched device analysis of a keyframe group: (F, P) packed
        (J, mode) rows on the host, as device.intra.intra_analysis_batch
        returns them (unpack with unpack_rd_analysis at
        self.keyframe_depths())."""
        bd = self.seq.bit_depth
        lumas = np.stack([
            DeviceIntraMD.pad_src(self._pad_plane(
                np.asarray(f[0]), self.aligned_w, self.aligned_h))
            for f in frames])
        q0 = int(np.clip(base_q_idx, 1, 255))
        qp = qp_row_for(q0, 0, 0, bd)
        # RD reduction constants (frame CDF snapshot costs)
        cdfs0 = FrameCdfs(q0)
        mode_rate = cdf_costs(cdfs0.kf_y_mode[0][0, 0])[list(DEVICE_MODES)]
        sk = cdf_costs(cdfs0.skip[0][0])
        psy_fixed = 0
        if self.psy_rd > 0.0:
            from svt_av1_psyex_tpu.ops.psy_dist import hvs_modulation_factor

            psy_fixed = int(round(
                hvs_modulation_factor(self.psy_rd, True, 0) * 256))
        rd = np.concatenate([
            [compute_rdmult(q0, bd), sk[0], sk[1]],
            mode_rate, [psy_fixed]]).astype(np.int32)
        n = len(frames)
        packed = intra_analysis_batch(
            upload_lumas(lumas, bd, self.device),
            np.broadcast_to(qp, (n, qp.size)),
            np.broadcast_to(rd, (n, rd.size)),
            depths=self.keyframe_depths(), bit_depth=bd,
            psy=psy_fixed > 0, kernels=self.kernels)
        return packed.cpu().numpy()

    def encode_keyframes(self, frames: list, base_q_idx: int = 80
                         ) -> list[bytes]:
        """Group-encode consecutive keyframes: ONE batched device
        analysis serves the whole group (frames folded into the block
        batch), then the conformant commit, in-loop filters and entropy
        coding run per frame on the host. frames: per frame, the list of
        planes (numpy arrays). Sets self.recons to each frame's
        reconstruction (what a decoder must output) and
        self.stage_seconds to wall times: "device_analysis" (upload,
        lattice, fetch), "frames" (per-frame set-up, partition DP,
        commit, DLF), "cdef", "finalize" (entropy coding, packing) and
        "host", the sum of the last three."""
        t0 = time.perf_counter()
        self.recons = []
        if not self._device_md_precheck() or len(frames) <= 1:
            tus = []
            for f in frames:
                tus.append(self.encode_frame(f, base_q_idx, force_key=True))
                self.recons.append(self.last_recon)
            host = time.perf_counter() - t0
            self.stage_seconds = {"device_analysis": 0.0, "frames": host,
                                  "cdef": 0.0, "finalize": 0.0,
                                  "host": host}
            return tus
        rows = self.analyze_keyframes(frames, base_q_idx)
        t1 = time.perf_counter()
        bd = self.seq.bit_depth
        group: list = []
        for i, f in enumerate(frames):
            self.encode_frame(f, base_q_idx, force_key=True,
                              _analysis_row=rows[i], _group=group)
        t2 = time.perf_counter()
        jobs = [st["cdef_job"] for st in group if st["cdef_job"] is not None]
        if jobs:
            _cdef = self._pick_cdef()
            results = [
                _cdef(j["recon_planes"], j["src_planes"], j["skip_g"],
                      j["mi_rows"], j["mi_cols"], j["base_q_idx"],
                      j["rdcost_fn"], level=self._cdef_search_level,
                      bit_depth=bd)
                for j in jobs]
            it = iter(results)
            for st in group:
                if st["cdef_job"] is not None:
                    self._apply_cdef_result(st["fr"], st["tw"], next(it))
        t3 = time.perf_counter()
        tus = []
        for st in group:
            tus.append(self._finalize_frame(st))
            self.recons.append(self.last_recon)
        t4 = time.perf_counter()
        self.stage_seconds = {"device_analysis": t1 - t0, "frames": t2 - t1,
                              "cdef": t3 - t2, "finalize": t4 - t3,
                              "host": t4 - t1}
        return tus


def encode_plans(enc: Av1Encoder, plans: list, sources: dict,
                 qindex: int) -> tuple[list, list]:
    """Encode coded-order frame plans (codec.gop.plan_minigop) as the JAX
    package's API drives them (api/encoder.py:673-713, at a fixed qindex,
    without rate control): each maximal run of same-layer coded frames is
    begun first, every frame's device analysis queued, then resumed in
    coding order; a show-existing plan emits its TU in turn. `sources`:
    display index -> planes. Returns the TUs in coded order and, for each
    TU that displays a frame, its reconstruction, in display order."""
    tus, recons = [], []

    def emit(tu, shown):
        tus.append(tu)
        if shown:
            recons.append(enc.last_recon)

    items = [(pl, sources.get(pl.disp_idx),
              pl.show_existing_slot is not None) for pl in plans]
    i = 0
    while i < len(items):
        pl, src, is_se = items[i]
        if is_se:
            emit(enc.encode_frame(None, qindex, plan=pl), True)
            i += 1
            continue
        # maximal run: same-layer coded frames, show-existing entries
        # allowed in between (they touch no DPB slot); trailing ones are
        # left to the sequential branch above
        run, j = [], i
        while j < len(items) and (items[j][2]
                                  or items[j][0].layer == pl.layer):
            run.append(j)
            j += 1
        while items[run[-1]][2]:
            run.pop()
        states = {k: enc.begin_frame(items[k][1], qindex, plan=items[k][0])
                  for k in run if not items[k][2]}
        for k in run:
            plk, _, sek = items[k]
            if sek:
                emit(enc.encode_frame(None, qindex, plan=plk), True)
            else:
                emit(enc.resume_frame(states.pop(k)), plk.show_frame)
        i = run[-1] + 1
    return tus, recons
