"""Frame encoder orchestration: mode decision -> recon -> OBUs.

Two-pass structure per frame:
  1. Analysis/recon pass — walks superblocks in coding order, picks intra
     modes against reconstructed neighbors, runs the device compute chain
     (predict -> residual -> fwd txfm -> quantize -> dequant -> inv txfm
     -> recon). This pass is the seam that moves onto TPU (batched per
     candidate/block); contexts/entropy are untouched here.
  2. Bitstream pass — tile writer emits syntax with CDF adaptation.

Counterpart: the reference's MD + encode-pass pipeline (enc_dec_process.c,
coding_loop.c) collapsed into its minimal intra form.

The device analysis (the keyframe and inter lattices, the motion field
of the host mode decision) runs in PyTorch on the encoder's `device`
("cuda" by default, or "cpu"), through the hand-written kernels or, with
kernels="plain", their plain PyTorch versions.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np

from ..bitstream.bitw import BitWriter
from ..bitstream.coeff_writer import CoeffWriter
from ..bitstream.headers import (
    FrameConfig,
    SequenceConfig,
    compute_tile_info,
    write_frame_header,
    write_sequence_header,
)
from ..bitstream.obu import ObuType, temporal_delimiter, wrap_obu
from ..bitstream.tables import FrameCdfs, scan_table
from ..bitstream.tile_writer import LeafBlock, PartitionNode, TileWriter
from ..device.intra import DEVICE_MODES, intra_analysis_sharded, qp_row_for
from ..native import cdefc
from ..ops import intra as intra_ops
from ..ops.quant import build_plane_quant, quantize_b
from ..ops.txfm import forward_txfm2d, inverse_txfm2d
from .constants import (
    BLOCK_H,
    BLOCK_W,
    MAX_TX_SIZE_RECT,
    TX_H,
    TX_W,
    BlockSize,
    IntraMode,
    Partition,
    TxType,
    block_size_of,
    subsize,
    tx_size_sqr_up,
)
from ..parallel.mesh import DeviceMesh
from ..runtime import check_kernels, resolve_device
from .md_device import DeviceIntraMD
from .rd import cdf_costs, compute_rdmult

# tx scale (spec av1_get_tx_scale): 0 for <=16, 1 for 32-class, 2 for 64-class
def tx_log_scale(tx_size: int) -> int:
    """Dequant shift (av1_get_tx_scale): AREA-based, not square-up-based —
    they differ for 32x8/8x32 (0 not 1) and 64x16/16x64 (1 not 2)."""
    pels = int(TX_W[tx_size]) * int(TX_H[tx_size])
    return int(pels > 256) + int(pels > 1024)


# spec intra_mode_to_tx_type (chroma tx type derivation)
_MODE_TO_TXTYPE = {
    IntraMode.DC: TxType.DCT_DCT, IntraMode.V: TxType.ADST_DCT,
    IntraMode.H: TxType.DCT_ADST, IntraMode.D45: TxType.DCT_DCT,
    IntraMode.D135: TxType.ADST_ADST, IntraMode.D113: TxType.ADST_DCT,
    IntraMode.D157: TxType.DCT_ADST, IntraMode.D203: TxType.DCT_ADST,
    IntraMode.D67: TxType.ADST_DCT, IntraMode.SMOOTH: TxType.ADST_ADST,
    IntraMode.SMOOTH_V: TxType.ADST_DCT, IntraMode.SMOOTH_H: TxType.DCT_ADST,
    IntraMode.PAETH: TxType.ADST_ADST,
}


def chroma_tx_type(uv_mode: int, tx_size: int) -> int:
    """Decoder-derived chroma tx type (compute_tx_type for intra chroma)."""
    if tx_size_sqr_up(tx_size) > 2:  # > TX_16X16: DCT only set
        return TxType.DCT_DCT
    t = _MODE_TO_TXTYPE[IntraMode(uv_mode)]
    return t  # members of DTT4 sets are always allowed for <=16


@dataclass
class _PlaneCtx:
    src: np.ndarray  # aligned source
    recon: np.ndarray
    ss_x: int
    ss_y: int


class Av1Encoder:
    """The frame encoder. Its device analysis runs in PyTorch on `device`
    ("cuda", the default, "cuda:N" or "cpu"; asking for CUDA where there
    is none raises). `kernels="plain"` runs the plain PyTorch version of
    every kernel instead of the hand kernel, to compare the two on the
    card; the default "hand" launches the CUDA kernels on a CUDA device
    (on the CPU there are none, and the plain versions run).

    `mesh` (a parallel.mesh.DeviceMesh whose first device is `device`,
    also settable as enc.mesh; by default the (1, 1) mesh on `device`)
    shards the device mode-decision analysis: a keyframe group's frames
    over its dp axis and every analysis' superblock rows over its sp
    axis. TPL, temporal filtering, CDEF and loop restoration stay on
    `device`. On the CPU the streams equal the unsharded encode's byte
    for byte at any shard size. On a CUDA device they do wherever the
    analysis rows do: at a few superblocks a shard, cuBLAS and torch's
    reductions may sum a block's float terms in another order, and a J
    that moves in its last bits may move a decision (parallel/mesh.py)."""

    CANDIDATE_MODES = [IntraMode.DC, IntraMode.V, IntraMode.H,
                       IntraMode.SMOOTH, IntraMode.PAETH]

    def __init__(self, seq: SequenceConfig, preset: int = 10,
                 enable_variance_boost: bool = False,
                 variance_boost_strength: int = 2, variance_octile: int = 6,
                 variance_boost_curve: int = 0, enable_dlf: bool = True,
                 psy_rd: float = 0.0, tune: int = 1,
                 enable_restoration: bool | None = None,
                 tile_cols_log2: int = 0, film_grain: int = 0,
                 qm: tuple | None = None, noise_norm_strength: int = 0,
                 max_32_tx_size: bool = False, seg_aq: bool = False,
                 low_q_taper: bool = False, adaptive_film_grain: bool = True,
                 rdoq: int | None = None, sharpness: int = 0,
                 sharp_tx: bool = True, spy_rd: int = 0,
                 enable_global_motion: bool = True,
                 delta_q_offsets: tuple = (0, 0, 0),
                 enable_mfmv: bool = True,
                 screen_content_mode: int = 0, complex_hvs: int = 0,
                 hbd_mds: int = 0, superres_denom: int = 8, *,
                 device="cuda", kernels: str = "hand", mesh=None):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        self.mesh = self._check_mesh(mesh)
        self.stage_seconds: dict = {}
        self.seq = seq
        self.preset = preset
        # screen-content tools: 0 off / 1 force / 2 auto-detect per KF
        # (svt_aom_is_screen_content_psy); SELECT-mode seq header bit
        self.screen_content_mode = int(screen_content_mode)
        # --complex-hvs: SA8D stage-0 ranking (enc_mode_config.c:8517);
        # --hbd-mds 3: 8-bit analysis tier for 10-bit content (hbd_md=0)
        self.complex_hvs = int(complex_hvs)
        self.hbd_mds = int(hbd_mds)
        self._allow_sc = screen_content_mode == 1
        if screen_content_mode:
            seq.force_screen_content_tools = 2
        # 4:4:4 (profile 1): the CDEF search/filter backends are still
        # 4:2:0-shaped — CDEF is signaled off for non-subsampled chroma
        # (DLF/restoration/grain are subsampling-generic)
        if not (seq.subsampling_x and seq.subsampling_y) and not seq.mono_chrome:
            seq.enable_cdef = False
        # loop restoration defaults on at the slower presets (the
        # reference enables it for enc_mode <= M6-class configs)
        if enable_restoration is None:
            enable_restoration = preset <= 6
        seq.enable_restoration = bool(enable_restoration)
        # recursive filter intra searched (and therefore signaled) at the
        # slower presets (sig_deriv md_filter_intra_level gating)
        seq.enable_filter_intra = preset <= 6
        # local warped motion (WARPED_CAUSAL): the reference keeps
        # wm_level nonzero up to M9 — base-layer frames only at M4-9
        # (enc_mode_config.c:8237-8243); per-frame gating in begin_frame
        seq.enable_warped_motion = preset <= 9
        # tile columns (log2): each tile is an independent MD + entropy
        # partition (ec_process.c per-tile loop); 0 = single tile
        self.tile_cols_log2 = tile_cols_log2
        # MFMV temporal MV prediction (spec 7.9; EbSvtAv1Enc.h
        # enable_mfmv, reference default auto/on): sequence-level gate;
        # per-frame use_ref_frame_mvs derived in begin_frame
        seq.enable_ref_frame_mvs = bool(enable_mfmv)
        # film grain synthesis strength (--film-grain 0..50): display-side
        # grain parameters signaled per frame; refs stay pre-grain
        self.film_grain = int(film_grain)
        self.adaptive_film_grain = bool(adaptive_film_grain)
        seq.film_grain_params_present = self.film_grain > 0
        # quantizer matrices: (min_qm, max_qm, min_chroma_qm,
        # max_chroma_qm) level ranges interpolated by frame q
        # (aom_get_qmlevel; svt_av1_qm_init md_config_process.c:258)
        self.qm = qm
        # PSYEX noise normalization (AC coefficient revival/boost)
        self.noise_norm_strength = int(noise_norm_strength)
        # forbid 64-class transforms (tx split forced under tx select)
        self.max_32_tx_size = bool(max_32_tx_size)
        # segmentation-based adaptive quantization (aq-mode 1 analog):
        # variance-quartile segments with ALT_Q deltas instead of delta-q
        self.seg_aq = bool(seg_aq)
        # dampen variance-boost q drops at very low q (CRF only)
        self.low_q_taper = bool(low_q_taper)
        # psy-rd acts whenever set and tune is not PSNR (enc_settings.c:1270)
        self.psy_rd = psy_rd if tune != 1 else 0.0
        # global motion (EbSvtAv1Enc.h enable_global_motion; reference
        # default 1): estimated on host-MD inter frames (codec/gm.py)
        self.enable_global_motion = bool(enable_global_motion)
        # direct quantizer deltas (luma-y-dc / chroma-u-dc / chroma-u-ac
        # qindex offsets -> frame header delta_q_* fields)
        self.delta_q_offsets = tuple(delta_q_offsets)
        # RDOQ trellis: reference rdoq_level = 1 at every non-rtc preset
        # (enc_mode_config.c:7481); SVT_TPU_NO_RDOQ=1 or rdoq=0 disables
        self.rdoq_level = (1 if rdoq is None else int(rdoq))
        if os.environ.get("SVT_TPU_NO_RDOQ") == "1":
            self.rdoq_level = 0
        # PSYEX sharp-tx (default 1, enc_settings.c:1111) + --sharpness;
        # the rdoq sharpness gate needs tune 0/3 (derive_vq_params)
        self.sharpness = int(sharpness)
        self.sharp_tx = bool(sharp_tx)
        self.rdoq_use_sharpness = tune in (0, 3)
        self.tune = tune
        # PSYEX spy-rd (0 off / 1 full / 2 partial): alternate psy RD
        # pathways — mode-class distortion biases (Parameters.md:104)
        self.spy_rd = int(spy_rd)
        self.enable_dlf = enable_dlf
        self.enable_variance_boost = enable_variance_boost
        self.vb_strength = variance_boost_strength
        self.vb_octile = variance_octile
        self.vb_curve = variance_boost_curve
        # super-resolution (spec 7.16; super_res.c fixed mode): code the
        # frame at a horizontally downscaled width, the decoder upscales
        # the recon normatively.  seq.width becomes the CODED width for
        # the whole pipeline; only the headers signal UpscaledWidth.
        # v1 scope: all-intra streams (scaled inter prediction /
        # reference scaling pending); loop restoration stays off (LR
        # runs post-upscale per spec — not plumbed yet).
        self.superres_denom = int(superres_denom)
        if self.superres_denom > 8:
            from ..ops.resize import scaled_size

            seq.superres_upscaled_width = seq.width
            seq.superres_denom = self.superres_denom
            seq.width = scaled_size(seq.width, self.superres_denom)
            seq.enable_superres = True
            seq.enable_restoration = False
        self.mi_cols = 2 * ((seq.width + 7) >> 3)
        self.mi_rows = 2 * ((seq.height + 7) >> 3)
        self.aligned_w = self.mi_cols * 4
        self.aligned_h = self.mi_rows * 4
        self.frame_count = 0

    @property
    def _cdef_search_level(self) -> int:
        """Preset -> CDEF candidate set (enc_mode_config.c:1736-1750)."""
        if self.preset <= 1:
            return 1
        if self.preset <= 2:
            return 2
        if self.preset <= 8:
            return 5
        return 7

    def _device_md_precheck(self) -> bool:
        """Frame-independent device-MD eligibility — the same gates as
        begin_frame's per-frame dev_ok minus the frame-dependent SC bit
        (one predicate; VERDICT r4 weak #5). QM / noise-norm frames fall
        back to the host txb chain inside the device commit and seg-AQ
        rides the per-SB qmap plumbing, so none of them gate group
        batching either. Presets 6+ ride the device lattice (config 3's
        psy tools — psy-rd, variance boost, CDEF, restoration — all run
        with it); presets <= 5 still need host-only tools (ext/4-way
        partitions, filter-intra/CfL search)."""
        import os

        seq = self.seq
        return (self.preset >= 6 and not seq.use_128x128_superblock
                and self.tile_cols_log2 == 0
                and self.screen_content_mode != 1  # forced-SC: host tools
                and (seq.mono_chrome
                     or (seq.subsampling_x and seq.subsampling_y))
                and os.environ.get("SVT_TPU_HOST_MD") != "1")

    @property
    def _min_partition_bsize(self) -> int:
        """Preset -> smallest searched square bsize (depth ladder)."""
        if self.preset >= 12:
            return BlockSize.B64X64
        if self.preset >= 10:
            return BlockSize.B32X32
        if self.preset >= 7:
            return BlockSize.B16X16
        return BlockSize.B8X8

    # ---- source preparation ---------------------------------------------------
    def _pad_plane(self, plane: np.ndarray, aw: int, ah: int) -> np.ndarray:
        h, w = plane.shape
        out = np.empty((ah, aw), plane.dtype)
        out[:h, :w] = plane
        if w < aw:
            out[:h, w:] = plane[:, -1:]
        if h < ah:
            out[h:, :] = out[h - 1 : h, :]
        return out

    # ---- frame encode --------------------------------------------------------------
    def encode_keyframe(self, planes: list[np.ndarray] | None,
                        base_q_idx: int = 80) -> bytes:
        return self.encode_frame(planes, base_q_idx, force_key=True)

    def state_snapshot(self):
        """Reference state for the recode loop: slot entries are replaced
        (never mutated) on refresh, so a shallow slot-list copy + the
        frame counter fully captures the DPB/CDF-forwarding state."""
        return (list(getattr(self, "slots", [None] * 8)), self.frame_count)

    def state_restore(self, snap) -> None:
        slots, count = snap
        self.slots = list(slots)
        self.frame_count = count

    def encode_frame(self, planes: list[np.ndarray] | None, base_q_idx: int = 80,
                     force_key: bool = False, plan=None,
                     _analysis_row=None, _group=None) -> bytes:
        """Encode one frame (begin + resume in one step). See
        begin_frame for the pipeline-parallel two-step form."""
        st = self.begin_frame(planes, base_q_idx, force_key=force_key,
                              plan=plan, _analysis_row=_analysis_row,
                              _group=_group)
        if isinstance(st, (bytes, bytearray)):
            return st
        return self.resume_frame(st)

    def begin_frame(self, planes: list[np.ndarray] | None, base_q_idx: int = 80,
                    force_key: bool = False, plan=None,
                    _analysis_row=None, _group=None):
        """First half of a frame encode: header/config derivation, MD
        construction and the *dispatch* of the device analysis (async —
        nothing blocks on the device). Returns a state dict for
        resume_frame, or TU bytes for show_existing plans.

        The split is the TPU-native pipeline-parallelism seam (SURVEY
        §2.1 process pipeline): the caller begins several independent
        frames (same GOP layer — no mutual references), letting the
        device work through their lattices while the host runs the
        commit/filter/entropy tail of earlier frames.

        `plan` (codec.gop.FramePlan) selects refs/refresh/show semantics;
        None = legacy low-delay IPPP (LAST in every slot, refresh all).

        Group-pipeline hooks (encode_keyframes): `_analysis_row` is a
        precomputed device MD lattice row; `_group` is a list collector —
        when set, CDEF search and the bitstream pass are deferred (the
        state dict is appended and returned instead of TU bytes)."""
        import os as _os
        import time as _time

        _timing = _os.environ.get("SVT_TPU_TIMING") == "1"
        _t0 = _time.perf_counter() if _timing else 0.0
        try:
            return self._begin_frame_impl(planes, base_q_idx, force_key,
                                          plan, _analysis_row, _group)
        finally:
            if _timing:
                self._tick("begin", _t0)

    def _begin_frame_impl(self, planes, base_q_idx=80, force_key=False,
                          plan=None, _analysis_row=None, _group=None):
        """begin_frame's work: header and config derivation, MD
        construction, and the dispatch of the device analysis (the port's
        DeviceInterMD / DeviceIntraMD lattice, or the motion field of the
        host mode decision) on self.device through self.kernels."""
        seq = self.seq
        if not hasattr(self, "slots"):
            self.slots = [None] * 8
        if plan is None:
            from .gop import FramePlan, LAST, ALTREF

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
                from ..ops.resize import downscale_horiz

                ssx = seq.subsampling_x
                cws = [seq.width] + [(seq.width + ssx) >> ssx] * 2
                planes = [downscale_horiz(np.asarray(p), cws[i],
                                          seq.bit_depth)
                          for i, p in enumerate(planes)]
        if self.screen_content_mode:
            if (is_key and self.screen_content_mode == 2
                    and planes is not None):
                from ..ops.palette import is_screen_content

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
            from .psy import sb_variances_8x8

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
            from .psy import variance_adjust_qp

            luma = self._pad_plane(np.asarray(planes[0]), self.aligned_w,
                                   self.aligned_h).astype(np.int64)
            # TPL QPM offsets precede the boost for r0-based frames
            # (svt_aom_sb_qp_derivation_tpl_la, rc_process.c:1626)
            qpm = None
            betas = getattr(plan, "tpl_betas", None) if plan is not None \
                else None
            if betas is not None:
                from .tpl import get_deltaq_offset

                qpm = np.array(
                    [[get_deltaq_offset(base_q_idx, float(b), is_key,
                                        seq.bit_depth) for b in row]
                     for row in np.asarray(betas)], np.int32)
            new_base, sb_qmap, res = variance_adjust_qp(
                luma, base_q_idx, self.vb_strength, self.vb_octile,
                self.vb_curve, seq.bit_depth, qpm_offsets=qpm)
            fr.base_q_idx = new_base
            if self.low_q_taper and sb_qmap is not None:
                from .psy import low_q_taper as _taper

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
                    from .tf import estimate_noise_mad

                    noise = estimate_noise_mad(
                        np.asarray(planes[0]).astype(np.int64)
                        >> (seq.bit_depth - 8))
                fr.film_grain = self._film_grain_params(plan.disp_idx, noise)
        if self.qm is not None:
            from ..ops.quant import get_qmlevel

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
            from .mvp import MiState

            tw.mi_state = MiState(self.mi_rows, self.mi_cols)
        if not is_key:
            from .mvp import MiState

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

            from .mfmv import projection_safe

            if (seq.enable_ref_frame_mvs and n_tiles == 1
                    and _os_mfmv.environ.get("SVT_TPU_NO_MFMV") != "1"
                    and projection_safe(fr, self.slots,
                                        seq.order_hint_bits)):
                from .mfmv import rel_dist as _rel_dist
                from .mfmv import setup_motion_field

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
        from .md import ModeDecision
        from .rd import compute_rdmult

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
            from ..bitstream.headers import GM_AFFINE
            from .gm import estimate_global_motion

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
            from ..ops.psy_dist import hvs_modulation_factor

            psy_factor = hvs_modulation_factor(self.psy_rd, is_key,
                                               plan.layer)
        rdoq_frame = None
        if self.rdoq_level:
            from .rdoq import RdoqFrame

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
                                    device=self.device, kernels=self.kernels,
                                    mesh=self.mesh)
                dmd.analyze_dispatch()
            else:
                dmd = DeviceIntraMD(md, seq, fr, sb_qmap, device=self.device,
                                    kernels=self.kernels, mesh=self.mesh)
                if _analysis_row is None:
                    dmd.analyze_dispatch()
        return {"fr": fr, "tw": tw, "cdfs": cdfs, "pctx": pctx, "md": md,
                "dmd": dmd, "sb_qmap": sb_qmap, "ref_planes": ref_planes,
                "n_tiles": n_tiles, "sb_mi": sb_mi, "sb_bsize": sb_bsize,
                "make_md": make_md, "is_key": is_key,
                "analysis_row": _analysis_row, "group": _group}

    def _tick(self, key: str, t0: float) -> float:
        """SVT_TPU_TIMING=1 stage profiler: accumulate seconds per stage
        into self.timing (the JAX-profiler-lite of SURVEY §5 tracing)."""
        import time

        t1 = time.perf_counter()
        tm = getattr(self, "timing", None)
        if tm is None:
            tm = self.timing = {}
        tm[key] = tm.get(key, 0.0) + (t1 - t0)
        return t1

    def resume_frame(self, st: dict):
        """Second half of a frame encode: fetch the device lattice,
        argmin + conformant commit, in-loop filters, then the bitstream
        pass (or group deferral). Must run in coding order."""
        import os
        import time

        from .rd import compute_rdmult

        timing = os.environ.get("SVT_TPU_TIMING") == "1"
        t0 = time.perf_counter() if timing else 0.0

        seq = self.seq
        fr, tw, cdfs = st["fr"], st["tw"], st["cdfs"]
        pctx, md, dmd = st["pctx"], st["md"], st["dmd"]
        sb_qmap, ref_planes = st["sb_qmap"], st["ref_planes"]
        n_tiles, sb_mi, sb_bsize = st["n_tiles"], st["sb_mi"], st["sb_bsize"]
        is_key = st["is_key"]
        _group = st["group"]

        sb_plans = []
        if dmd is not None:
            dmd.analyze(st["analysis_row"])
            if timing:
                t0 = self._tick("device_wait", t0)
            # whole-frame native commit (native/frame_enc.c): flatten the
            # argmin plans and run the entire conformant tail in one C
            # call; SVT_TPU_PY_COMMIT=1 keeps the per-leaf oracle path
            from ..native import frame_enc as native_frame

            # the C committer quantizes plain (no QM / noise-norm); those
            # frames take the per-leaf host chain (md._txb_rd has both).
            # Motion-mode frames (base-layer OBMC/warp trials,
            # md_device._commit_inter_leaf) also run per-leaf until the
            # warp/OBMC predictors land in native/frame_enc.c.
            use_frame_c = (native_frame.available()
                           and not fr.using_qmatrix
                           and self.noise_norm_strength == 0
                           and not self.max_32_tx_size  # C trial lacks
                           # the 64-class tx cap; per-leaf path has it
                           and not getattr(fr, "is_motion_mode_switchable",
                                           False)
                           and os.environ.get("SVT_TPU_PY_COMMIT") != "1")
            plans = []
            # whole-frame partition DP (md_device.plan_frame): one
            # vectorized pass replaces the per-SB recursive pick
            from .md_device import _hbd8

            nsby, nsbx = dmd._hp // 64, dmd._wp // 64
            rdg = np.full((nsby, nsbx), dmd.pick_rdmult(), np.int64)
            if sb_qmap is not None:
                for q in np.unique(sb_qmap):
                    v = compute_rdmult(int(q), seq.bit_depth)
                    if _hbd8(dmd):
                        v = max(1, v // 16)
                    rdg[sb_qmap == q] = v
            dmd.plan_frame(rdg)
            for r in range(0, self.mi_rows, sb_mi):
                for c in range(0, self.mi_cols, sb_mi):
                    if sb_qmap is not None:
                        md.cur_qindex = int(sb_qmap[r // sb_mi, c // sb_mi])
                        md.rdmult = compute_rdmult(md.cur_qindex, seq.bit_depth)
                    plan = dmd.extract_plan(r, c, sb_bsize)
                    if use_frame_c:
                        plans.append((plan, r, c, md.cur_qindex))
                    else:
                        node = dmd._commit_plan(plan, r, c)
                        sb_plans.append((node, r, c))
            if timing:
                t0 = self._tick("pick", t0)
            if use_frame_c:
                fc = native_frame.FrameCommitter(md, seq, fr, ref_planes)
                sb_plans = fc.commit(plans)
            if timing:
                t0 = self._tick("commit", t0)
        elif n_tiles == 1:
            for r in range(0, self.mi_rows, sb_mi):
                for c in range(0, self.mi_cols, sb_mi):
                    if sb_qmap is not None:
                        md.cur_qindex = int(sb_qmap[r // sb_mi, c // sb_mi])
                        md.rdmult = compute_rdmult(md.cur_qindex, seq.bit_depth)
                    _, node = md.pick_partition(r, c, sb_bsize)
                    sb_plans.append((node, r, c))
        else:
            # tile columns: per-tile MD over column-sliced plane views —
            # tile edges become frame edges for every availability rule
            # (intra neighbors, MVP scans, contexts), matching read_lr/
            # decode_tile semantics; sb_plans keep frame-absolute coords
            tc_mi = [min(sb * sb_mi, self.mi_cols)
                     for sb in fr.tile.col_starts_sb]
            for t in range(n_tiles):
                c0, c1 = tc_mi[t], tc_mi[t + 1]
                x0 = c0 * 4
                tview = [
                    _PlaneCtx(src=p.src[:, (c0 * 4) >> p.ss_x : (c1 * 4) >> p.ss_x],
                              recon=p.recon[:, (c0 * 4) >> p.ss_x : (c1 * 4) >> p.ss_x],
                              ss_x=p.ss_x, ss_y=p.ss_y)
                    for p in pctx]
                md_t = st["make_md"](tview, c1 - c0, None, x_off=x0)
                for r in range(0, self.mi_rows, sb_mi):
                    for c in range(c0, c1, sb_mi):
                        if sb_qmap is not None:
                            md_t.cur_qindex = int(sb_qmap[r // sb_mi, c // sb_mi])
                            md_t.rdmult = compute_rdmult(md_t.cur_qindex,
                                                         seq.bit_depth)
                        _, node = md_t.pick_partition(r, c - c0, sb_bsize)
                        sb_plans.append((node, r, c))

        # in-loop filters on the final recon: DLF (spec 7.14) then CDEF
        # (spec 7.15) then loop restoration (spec 7.17); intra prediction
        # above already used the unfiltered recon, references/output use
        # the filtered one.
        deblock_planes = None
        if fr.allow_intrabc:
            # spec 5.9.11/5.9.19/5.9.20: intrabc frames run no in-loop
            # filters (the causal recon IS the reference the DVs read)
            fr.lf_level = (0, 0, 0, 0)
            fr.cdef_bits = 0
            fr.cdef_y_strengths = (0,)
            fr.cdef_uv_strengths = (0,)
            fr.lr_frame_types = None
        elif self.enable_dlf or seq.enable_cdef or seq.enable_restoration:
            from ..ops.dlf import (
                collect_lf_grids,
                loop_filter_frame,
                pick_filter_level_by_q,
            )

            bsize_g, skip_inter_g, skip_g, txd_g = collect_lf_grids(
                sb_plans, self.mi_rows, self.mi_cols, sb_mi)
            if timing:
                t0 = self._tick("lf_grids", t0)
            if self.enable_dlf:
                if self.preset <= 6 and os.environ.get(
                        "SVT_TPU_NO_DLF_SEARCH") != "1":
                    # frame-level level search (enable_dlf_flag=2 quality
                    # mode): SSE-scored halving descent (ops/dlf.py)
                    from ..ops.dlf import search_filter_level

                    levels = search_filter_level(
                        pctx[0].src, [p.recon for p in pctx], seq.width,
                        seq.height, fr.base_q_idx, is_key,
                        fr.lf_sharpness, bsize_g, skip_inter_g,
                        seq.subsampling_x, seq.subsampling_y,
                        seq.bit_depth, txd_g=txd_g)
                else:
                    levels = pick_filter_level_by_q(fr.base_q_idx, is_key,
                                                    seq.bit_depth,
                                                    seq.width * seq.height)
                if any(levels):
                    fr.lf_level = tuple(levels)
                    loop_filter_frame([p.recon for p in pctx], seq.width,
                                      seq.height, levels, fr.lf_sharpness,
                                      bsize_g, skip_inter_g,
                                      seq.subsampling_x, seq.subsampling_y,
                                      seq.bit_depth, txd_g=txd_g)
                if timing:
                    t0 = self._tick("dlf", t0)
            if seq.enable_restoration:
                # loop restoration reads 2 deblocked rows at each stripe
                # boundary (save_deblock_boundary_lines); snapshot the
                # pre-CDEF recon
                deblock_planes = [p.recon.copy() for p in pctx]
            if seq.enable_cdef:
                from .rd import rdcost

                rdm = compute_rdmult(fr.base_q_idx, seq.bit_depth)
                rd_fn = lambda rate, dist: rdcost(rdm, rate, dist)  # noqa: E731
                if _group is not None:
                    # group pipeline: defer to one batched device call
                    st = {"tw": tw, "fr": fr, "cdfs": cdfs,
                          "sb_plans": sb_plans, "pctx": pctx,
                          "deblock": deblock_planes,
                          "cdef_job": dict(
                              recon_planes=[p.recon for p in pctx],
                              src_planes=[p.src for p in pctx],
                              skip_g=skip_g, mi_rows=self.mi_rows,
                              mi_cols=self.mi_cols,
                              base_q_idx=fr.base_q_idx, rdcost_fn=rd_fn)}
                    _group.append(st)
                    return st

                _cdef = self._pick_cdef()
                res = _cdef(
                    [p.recon for p in pctx], [p.src for p in pctx], skip_g,
                    self.mi_rows, self.mi_cols, fr.base_q_idx, rd_fn,
                    level=self._cdef_search_level, bit_depth=seq.bit_depth)
                self._apply_cdef_result(fr, tw, res)
                if timing:
                    t0 = self._tick("cdef", t0)

        if timing:
            t0 = self._tick("filters", t0)
        st = {"tw": tw, "fr": fr, "cdfs": cdfs, "sb_plans": sb_plans,
              "pctx": pctx, "cdef_job": None, "deblock": deblock_planes}
        if _group is not None:
            _group.append(st)
            return st
        return self._finalize_frame(st)

    def _pick_cdef(self):
        """CDEF backend: the device search and apply on self.device with
        SVT_TPU_DEVICE_CDEF=1, else native C when it builds (unless
        SVT_TPU_HOST_CDEF=1), else numpy. All share the full-grid search
        contract."""
        if os.environ.get("SVT_TPU_DEVICE_CDEF") == "1":
            from ..device.cdef import cdef_search_frame_device

            return partial(cdef_search_frame_device, device=self.device)
        if os.environ.get("SVT_TPU_HOST_CDEF") != "1" and cdefc.available():
            return cdefc.cdef_search_frame_c
        from ..ops.cdef import cdef_search_frame

        return cdef_search_frame

    @staticmethod
    def _apply_cdef_result(fr, tw, res) -> None:
        fr.cdef_damping = 3 + (fr.base_q_idx >> 6)
        if res is not None:
            bits, y_str, uv_str, fb_gi, _ = res
            fr.cdef_bits = bits
            fr.cdef_y_strengths = tuple(y_str)
            fr.cdef_uv_strengths = tuple(uv_str)
            tw.cdef_fb_map = fb_gi
        else:
            fr.cdef_bits = 0
            fr.cdef_y_strengths = (0,)
            fr.cdef_uv_strengths = (0,)

    def _finalize_frame(self, st: dict) -> bytes:
        """Bitstream pass + packaging + DPB update (the tail of
        encode_frame; split out so the group pipeline can defer it)."""
        import os
        import time

        timing = os.environ.get("SVT_TPU_TIMING") == "1"
        t0 = time.perf_counter() if timing else 0.0
        seq = self.seq
        tw, fr, cdfs = st["tw"], st["fr"], st["cdfs"]
        pctx = st["pctx"]
        if seq.enable_restoration and st.get("deblock") is not None:
            self._search_apply_lr(st)
            if timing:
                t0 = self._tick("lr", t0)
        if fr.tile.tile_cols == 1:
            for node, r, c in st["sb_plans"]:
                tw.write_superblock(node, r, c)
            tile_payload = tw.finish()
        else:
            tile_payload = self._write_tiles(st)
        if timing:
            t0 = self._tick("ec", t0)
        # frame-context save: keep adapted values, reset visit counters
        if not fr.disable_frame_end_update_cdf:
            cdfs.reset_counters()

        w = BitWriter()
        write_frame_header(seq, fr, w)
        w.byte_align()
        frame_payload = w.data() + tile_payload

        tu = temporal_delimiter()
        if self.frame_count == 0:
            tu += wrap_obu(ObuType.SEQUENCE_HEADER, write_sequence_header(seq))
        tu += wrap_obu(ObuType.FRAME, frame_payload)
        self.frame_count += 1
        maxv = (1 << seq.bit_depth) - 1
        dtype = np.uint8 if seq.bit_depth == 8 else np.uint16
        if seq.enable_superres and seq.superres_upscaled_width:
            # normative superres upscale (spec 7.16): the decoder output
            # (and hence our recon / DPB entry) is the upscaled frame
            from ..ops.resize import upscale_normative

            up = []
            for i, p in enumerate(pctx):
                ssx = 0 if i == 0 else seq.subsampling_x
                cw = (seq.width + ssx) >> ssx
                aw = self.aligned_w >> ssx  # mi-aligned decoded width
                ow = (seq.superres_upscaled_width + ssx) >> ssx
                rec = np.clip(p.recon, 0, maxv).astype(dtype)
                up.append(upscale_normative(rec[:, :aw], ow,
                                            seq.bit_depth, coded_w=cw))
            self.last_recon = up
            entry_recon = [r.copy() for r in up]
        else:
            self.last_recon = [np.clip(p.recon, 0, maxv).astype(dtype) for p in pctx]
            entry_recon = None
        self.last_film_grain = fr.film_grain
        self.last_frame_gm = fr.gm
        self._last_sb_plans = [n for (n, _r, _c) in st.get("sb_plans", [])]
        # reference update: the recon + saved frame context land in every
        # slot selected by refresh_frame_flags
        from ..bitstream.headers import GM_DEFAULT_MAT

        gm_mats = tuple(
            (fr.gm[i][1] if fr.gm and fr.gm[i] is not None
             else GM_DEFAULT_MAT) for i in range(7))
        # MFMV: save this frame's 8x8 motion field for future projection
        # (av1_copy_frame_mvs / spec 7.20 motion vector storage)
        saved_mvs = None
        if tw.mi_state is not None and seq.enable_ref_frame_mvs:
            from .mfmv import compute_ref_frame_side, save_frame_mvs

            side = compute_ref_frame_side(fr, seq.order_hint_bits)
            saved_mvs = save_frame_mvs(tw.mi_state, side)
        entry = {"recon": (entry_recon if entry_recon is not None
                           else [p.recon.copy() for p in pctx]),
                 "order_hint": fr.order_hint,
                 "film_grain": fr.film_grain,
                 "gm_mats": gm_mats,
                 "saved_mvs": saved_mvs,
                 "frame_is_intra": bool(fr.frame_is_intra),
                 "ref_order_hints": tuple(fr.ref_order_hints[:7]),
                 "cdfs": cdfs if not fr.disable_frame_end_update_cdf else None}
        for i in range(8):
            if fr.refresh_frame_flags & (1 << i):
                self.slots[i] = entry
        return tu

    def _write_tiles(self, st: dict) -> bytes:
        """Multi-tile bitstream pass: one independent TileWriter per tile
        column (fresh CDFs from the frame-initial state, tile-local
        contexts/coords), assembled as a full-coverage tile group
        (spec 5.11.1; ec_process.c per-tile loop). Tile 0 carries the
        frame-context save (context_update_tile_id = 0)."""
        seq = self.seq
        tw, fr, cdfs = st["tw"], st["fr"], st["cdfs"]
        sb_mi = 32 if seq.use_128x128_superblock else 16
        tcs = [min(sb * sb_mi, self.mi_cols)
               for sb in fr.tile.col_starts_sb]
        payloads = []
        # every tile starts from the frame-initial CDF state: clone BEFORE
        # any tile adapts (the context_update tile keeps the saved object)
        tile_cdfs = [cdfs if t == fr.tile.context_update_tile_id
                     else cdfs.clone() for t in range(fr.tile.tile_cols)]
        for t in range(fr.tile.tile_cols):
            c0, c1 = tcs[t], tcs[t + 1]
            tw_t = TileWriter(seq, fr, tile_cdfs[t], self.mi_rows, c1 - c0)
            tw_t.coeff_writer = CoeffWriter(tw_t, self.mi_rows, c1 - c0,
                                            seq.subsampling_x,
                                            seq.subsampling_y)
            if tw.mi_state is not None:
                from .mvp import MiState

                tw_t.mi_state = MiState(self.mi_rows, c1 - c0)
                tw_t.mi_state.sign_bias = tw.mi_state.sign_bias
            if tw.sb_qindex_map is not None:
                s0, s1 = c0 // sb_mi, (c1 + sb_mi - 1) // sb_mi
                tw_t.sb_qindex_map = tw.sb_qindex_map[:, s0:s1]
            if tw.cdef_fb_map is not None:
                tw_t.cdef_fb_map = tw.cdef_fb_map[:, c0 >> 4 : (c1 + 15) >> 4]
            if tw.seg_target is not None:
                tw_t.seg_target = tw.seg_target[:, c0:c1]
                tw_t.seg_last_active = tw.seg_last_active
            tw_t.lr_infos = tw.lr_infos
            tw_t.lr_mi_col0 = c0
            for node, r, c in st["sb_plans"]:
                if c0 <= c < c1:
                    tw_t.write_superblock(node, r, c - c0)
            payloads.append(tw_t.finish())
        # tile_group_obu: tile_start_and_end_present_flag = 0 (+ byte
        # alignment), then [tile_size_minus_1 le(n)] payload per non-last
        out = b"\x00"
        for i, p in enumerate(payloads):
            if i < len(payloads) - 1:
                out += (len(p) - 1).to_bytes(fr.tile.tile_size_bytes,
                                             "little")
            out += p
        return out

    def _grain_model_params(self, planes, disp_idx: int, is_key: bool):
        """Content-fitted grain parameters (ops/noise_model.py, the
        reference's denoise_and_model path, noise_model.c:2280): flat
        blocks + AR fit + strength LUT, cached per keyframe interval.
        Returns FilmGrainParams or None (fall back to the flat ladder)."""
        if is_key or not hasattr(self, "_grain_fit"):
            from ..ops.noise_model import estimate_grain_params

            seq = self.seq
            ss = (seq.subsampling_x, seq.subsampling_y)
            try:
                self._grain_fit = estimate_grain_params(
                    [np.asarray(p) for p in planes], seq.bit_depth, ss)
            except np.linalg.LinAlgError:
                self._grain_fit = None
        fit = self._grain_fit
        if fit is None:
            return None
        from ..ops.film_grain import FilmGrainParams

        return FilmGrainParams(
            apply_grain=True,
            grain_seed=(7391 + 3 * disp_idx) & 0xFFFF,
            num_y_points=len(fit["scaling_points_y"]),
            scaling_points_y=list(fit["scaling_points_y"]),
            num_cb_points=len(fit["scaling_points_cb"]),
            scaling_points_cb=list(fit["scaling_points_cb"]),
            num_cr_points=len(fit["scaling_points_cr"]),
            scaling_points_cr=list(fit["scaling_points_cr"]),
            chroma_scaling_from_luma=False,
            scaling_shift=fit["scaling_shift"],
            ar_coeff_lag=fit["ar_coeff_lag"],
            ar_coeffs_y=list(fit["ar_coeffs_y"]),
            ar_coeffs_cb=list(fit["ar_coeffs_cb"]),
            ar_coeffs_cr=list(fit["ar_coeffs_cr"]),
            ar_coeff_shift=fit["ar_coeff_shift"],
            cb_mult=fit["cb_mult"], cb_luma_mult=fit["cb_luma_mult"],
            cb_offset=fit["cb_offset"], cr_mult=fit["cr_mult"],
            cr_luma_mult=fit["cr_luma_mult"], cr_offset=fit["cr_offset"],
            overlap_flag=True)

    def _film_grain_params(self, disp_idx: int, noise: float | None = None):
        """Per-frame grain parameters from the configured strength
        (SVT --film-grain ladder reduced to a flat scaling curve with
        lag-1 AR; seed varies per display frame like fgs_table-less SVT).
        Match: grain param derivation in pic_analysis/noise path."""
        from ..ops.film_grain import FilmGrainParams

        s = min(self.film_grain * 4, 255)
        if noise is not None:
            # adaptive-film-grain: scale the ladder by measured source
            # noise so synthetic grain tracks the denoised content
            s = int(np.clip(s * min(noise / 2.0, 2.0), 1, 255))
        return FilmGrainParams(
            apply_grain=True,
            grain_seed=(7391 + 3 * disp_idx) & 0xFFFF,
            num_y_points=2,
            scaling_points_y=[(0, s), (255, s)],
            chroma_scaling_from_luma=False,
            num_cb_points=0, num_cr_points=0,
            scaling_shift=8,
            ar_coeff_lag=1,
            ar_coeffs_y=[10, 24, 10, 35],
            ar_coeffs_cb=[], ar_coeffs_cr=[],
            ar_coeff_shift=7,
            overlap_flag=True)

    def _search_apply_lr(self, st: dict) -> None:
        """Loop restoration (spec 7.17): per-RU Wiener/SGR search on the
        post-CDEF recon, exact striped apply; updates recon in place and
        fills the lr_params header + per-SB unit syntax state. Match:
        rest_process.c:523 + restoration_pick.c rest_finish_search."""
        from .rd import compute_rdmult
        from .restoration import search_plane, type_cost_tables

        seq = self.seq
        fr, tw, pctx = st["fr"], st["tw"], st["pctx"]
        deblock = st["deblock"]
        rdm = compute_rdmult(fr.base_q_idx, seq.bit_depth)
        tc = type_cost_tables(st["cdfs"])
        unit_y = 256
        uv_shift = 1 if (seq.subsampling_x and seq.subsampling_y
                         and not seq.mono_chrome) else 0
        infos = []
        types = []
        nplanes = 1 if seq.mono_chrome else 3
        for i in range(nplanes):
            p = pctx[i]
            ss_x, ss_y = p.ss_x, p.ss_y
            pw = (seq.width + ss_x) >> ss_x
            ph = (seq.height + ss_y) >> ss_y
            unit = unit_y if i == 0 else unit_y >> uv_shift
            info, restored = search_plane(
                p.src, p.recon, deblock[i], pw, ph, ss_y, unit,
                seq.bit_depth, rdm, chroma=i > 0, preset=self.preset,
                type_costs=tc, device=self.device)
            infos.append(info)
            types.append(info.frame_type)
            if restored is not None:
                p.recon[:restored.shape[0], :restored.shape[1]] = restored
        while len(types) < 3:
            infos.append(None)
            types.append(0)
        fr.lr_frame_types = tuple(types)
        fr.lr_unit_size = unit_y
        fr.lr_uv_shift = uv_shift
        tw.lr_infos = infos
        import os as _os

        if _os.environ.get("SVT_TPU_TIMING") == "1":
            from . import restoration as _restmod

            tm = getattr(self, "timing", None) or {}
            for k, v in _restmod.TICKS.items():
                tm[k] = tm.get(k, 0.0) + v
            _restmod.TICKS.clear()
            self.timing = tm

    def grained_output(self) -> list:
        """Display planes for the last emitted frame: recon + film grain
        synthesis (what a conformant decoder outputs; refs are pre-grain,
        spec 7.18.3)."""
        fg = getattr(self, "last_film_grain", None)
        seq = self.seq
        dw = seq.disp_width  # superres recon is already upscaled
        if fg is None:
            return [p[: (seq.height + (i > 0) * seq.subsampling_y)
                      >> (seq.subsampling_y if i else 0),
                      : (dw + (i > 0) * seq.subsampling_x)
                      >> (seq.subsampling_x if i else 0)]
                    for i, p in enumerate(self.last_recon)]
        from ..ops.film_grain import apply_grain

        return apply_grain(self.last_recon, fg, dw, seq.height,
                           seq.bit_depth, seq.subsampling_x,
                           seq.subsampling_y, seq.mono_chrome)

    def keyframe_depths(self) -> tuple:
        """Lattice depths of this encoder's keyframes."""
        return DeviceIntraMD.depths_for(
            self._min_partition_bsize, self.mi_rows, self.mi_cols)

    def _check_mesh(self, mesh) -> DeviceMesh:
        """`mesh`, which must start on the encoder's device, or for None
        the (1, 1) mesh there (the unsharded analysis)."""
        if mesh is None:
            return DeviceMesh.single(self.device)
        if mesh.first != self.device:
            raise ValueError(f"the mesh starts on {mesh.first}, the "
                             f"encoder runs on {self.device}")
        return mesh

    def analyze_keyframes(self, frames: list, base_q_idx: int,
                          mesh=None) -> np.ndarray:
        """The batched device analysis of a keyframe group: (F, P) packed
        (J, mode) rows on the host, as device.intra.intra_analysis_batch
        returns them (unpack with unpack_rd_analysis at
        self.keyframe_depths()). The frames go over the dp axis of `mesh`
        (by default self.mesh) and the superblock rows over its sp axis
        (device.intra.intra_analysis_sharded)."""
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
            from ..ops.psy_dist import hvs_modulation_factor

            psy_fixed = int(round(
                hvs_modulation_factor(self.psy_rd, True, 0) * 256))
        rd = np.concatenate([
            [compute_rdmult(q0, bd), sk[0], sk[1]],
            mode_rate, [psy_fixed]]).astype(np.int32)
        n = len(frames)
        qps = np.broadcast_to(qp, (n, qp.size))
        rds = np.broadcast_to(rd, (n, rd.size))
        return intra_analysis_sharded(
            lumas, qps, rds,
            self._check_mesh(self.mesh if mesh is None else mesh),
            depths=self.keyframe_depths(), bit_depth=bd, psy=psy_fixed > 0,
            kernels=self.kernels).numpy()

    def encode_keyframes(self, frames: list, base_q_idx: int = 80,
                         mesh=None) -> list[bytes]:
        """Group-encode consecutive keyframes: ONE batched device
        analysis serves the whole group (frames folded into the block
        batch), then the conformant commit, in-loop filters and entropy
        coding run per frame on the host. That analysis is sharded over
        `mesh` (analyze_keyframes), by default over self.mesh: unlike the
        JAX package's, whose mesh=None is unsharded, the encoder's mesh
        holds for every analysis it runs. A group of one frame, or one
        the device analysis cannot take, is encoded frame by frame, each
        analysis over self.mesh. frames: per frame, the list of planes
        (numpy arrays). Sets self.recons to each frame's reconstruction
        (what a decoder must output) and self.stage_seconds to wall
        times: "device_analysis" (upload, lattice, fetch), "frames"
        (per-frame set-up, partition DP, commit, DLF), "cdef", "finalize"
        (entropy coding, packing) and "host", the sum of the last
        three."""
        mesh = self._check_mesh(self.mesh if mesh is None else mesh)
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
        rows = self.analyze_keyframes(frames, base_q_idx, mesh)
        t1 = time.perf_counter()
        bd = self.seq.bit_depth
        group: list = []
        for i, f in enumerate(frames):
            self.encode_frame(f, base_q_idx, force_key=True,
                              _analysis_row=rows[i], _group=group)
        t2 = time.perf_counter()
        jobs = [st["cdef_job"] for st in group if st["cdef_job"] is not None]
        if jobs:
            if os.environ.get("SVT_TPU_DEVICE_CDEF") == "1":
                from ..device.cdef import cdef_group_device

                results = cdef_group_device(jobs, self._cdef_search_level,
                                            bd, device=self.device)
            else:
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

    def _show_existing_tu(self, slot: int) -> bytes:
        """show_existing_frame TU (spec 5.9.2 first branch)."""
        w = BitWriter()
        w.f(1, 1)  # show_existing_frame
        w.f(slot, 3)  # frame_to_show_map_idx
        w.trailing_bits()
        tu = temporal_delimiter()
        tu += wrap_obu(ObuType.FRAME_HEADER, w.data())
        entry = self.slots[slot]
        maxv = (1 << self.seq.bit_depth) - 1
        dtype = np.uint8 if self.seq.bit_depth == 8 else np.uint16
        self.last_recon = [np.clip(p, 0, maxv).astype(dtype)
                           for p in entry["recon"]]
        self.last_film_grain = entry.get("film_grain")
        return tu


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
