"""Sequence and frame header OBU payload writers (AV1 spec 5.5 / 5.9).

Counterpart: write_sequence_header_obu / svt_aom_encode_sps_av1 /
svt_aom_write_frame_header_av1 in the reference
(Source/Lib/Codec/entropy_coding.c:3623,3834,3764); clean-room from spec.

Feature coverage grows with the encoder; every written field is the spec
field name in order. Unsupported features are pinned to their "off"
codepoints and asserted against the config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitw import BitWriter


@dataclass
class SequenceConfig:
    width: int
    height: int
    bit_depth: int = 8
    mono_chrome: bool = False
    subsampling_x: int = 1
    subsampling_y: int = 1
    profile: int = 0
    still_picture: bool = False
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = True
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    order_hint_bits: int = 7
    enable_superres: bool = False
    # superres (spec 7.16): when active, `width` is the CODED
    # (downscaled) width everywhere inside the encoder and
    # superres_upscaled_width carries the display/UpscaledWidth the
    # sequence header + frame_size() signal (super_res.c fixed mode)
    superres_denom: int = 8
    superres_upscaled_width: int = 0
    # 0 off / 1 force on / 2 SELECT (per-frame allow_screen_content_tools)
    force_screen_content_tools: int = 0
    enable_cdef: bool = True
    enable_restoration: bool = False
    film_grain_params_present: bool = False
    timing_info_present: bool = False
    # color description (0 => unspecified, not written)
    color_primaries: int = 0
    transfer_characteristics: int = 0
    matrix_coefficients: int = 0
    color_range: int = 0
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64

    @property
    def disp_width(self) -> int:
        """UpscaledWidth: display width signaled in the headers (equals
        the coded width unless superres is active)."""
        return self.superres_upscaled_width or self.width

    @property
    def num_planes(self) -> int:
        return 1 if self.mono_chrome else 3

    def seq_level_idx(self) -> int:
        """Smallest spec level satisfying picture-size constraints
        (spec A.3; simplified: size-based only)."""
        pic = self.disp_width * self.height
        # (level_idx, MaxPicSize, MaxHSize, MaxVSize)
        levels = [
            (0, 147456, 2048, 1152),
            (1, 278784, 2816, 1584),
            (4, 665856, 4352, 2448),
            (5, 1065024, 5504, 3096),
            (8, 2359296, 6144, 3456),
            (9, 2359296, 6144, 3456),
            (12, 8912896, 8192, 4352),
            (13, 8912896, 8192, 4352),
            (16, 35651584, 16384, 8704),
            (17, 35651584, 16384, 8704),
        ]
        for idx, max_pic, max_h, max_v in levels:
            if pic <= max_pic and self.disp_width <= max_h and self.height <= max_v:
                return idx
        return 19  # 6.3


def write_sequence_header(seq: SequenceConfig) -> bytes:
    w = BitWriter()
    w.f(seq.profile, 3)  # seq_profile
    w.f(1 if seq.still_picture else 0, 1)  # still_picture
    w.f(0, 1)  # reduced_still_picture_header
    w.f(0, 1)  # timing_info_present_flag
    # (no decoder model)
    w.f(0, 1)  # initial_display_delay_present_flag
    w.f(0, 5)  # operating_points_cnt_minus_1
    w.f(0, 12)  # operating_point_idc[0]
    level = seq.seq_level_idx()
    w.f(level, 5)  # seq_level_idx[0]
    if level > 7:
        w.f(0, 1)  # seq_tier[0]

    wbits = max(1, (seq.disp_width - 1).bit_length())
    hbits = max(1, (seq.height - 1).bit_length())
    w.f(wbits - 1, 4)  # frame_width_bits_minus_1
    w.f(hbits - 1, 4)  # frame_height_bits_minus_1
    w.f(seq.disp_width - 1, wbits)  # max_frame_width_minus_1
    w.f(seq.height - 1, hbits)  # max_frame_height_minus_1

    w.f(0, 1)  # frame_id_numbers_present_flag
    w.f(1 if seq.use_128x128_superblock else 0, 1)
    w.f(1 if seq.enable_filter_intra else 0, 1)
    w.f(1 if seq.enable_intra_edge_filter else 0, 1)

    w.f(1 if seq.enable_interintra_compound else 0, 1)
    w.f(1 if seq.enable_masked_compound else 0, 1)
    w.f(1 if seq.enable_warped_motion else 0, 1)
    w.f(1 if seq.enable_dual_filter else 0, 1)
    w.f(1 if seq.enable_order_hint else 0, 1)
    if seq.enable_order_hint:
        w.f(1 if seq.enable_jnt_comp else 0, 1)
        w.f(1 if seq.enable_ref_frame_mvs else 0, 1)
    if seq.force_screen_content_tools == 2:
        w.f(1, 1)  # seq_choose_screen_content_tools -> SELECT(2)
        # seq_force_integer_mv: fixed 0 (no per-frame bit; intra frames
        # derive force_integer_mv = 1 regardless, spec 5.9.2)
        w.f(0, 1)  # seq_choose_integer_mv = 0
        w.f(0, 1)  # seq_force_integer_mv = 0
    else:
        w.f(0, 1)  # seq_choose_screen_content_tools
        w.f(seq.force_screen_content_tools & 1, 1)
        if seq.force_screen_content_tools:
            w.f(0, 1)  # seq_choose_integer_mv = 0
            w.f(0, 1)  # seq_force_integer_mv = 0
    if seq.enable_order_hint:
        w.f(seq.order_hint_bits - 1, 3)  # order_hint_bits_minus_1
    w.f(1 if seq.enable_superres else 0, 1)
    w.f(1 if seq.enable_cdef else 0, 1)
    w.f(1 if seq.enable_restoration else 0, 1)

    # color_config()
    assert seq.bit_depth in (8, 10, 12)
    if seq.profile == 2 and seq.bit_depth == 12:
        w.f(1, 1)  # high_bitdepth
        w.f(1, 1)  # twelve_bit
    else:
        w.f(1 if seq.bit_depth == 10 else 0, 1)  # high_bitdepth
    if seq.profile != 1:
        w.f(1 if seq.mono_chrome else 0, 1)
    described = seq.color_primaries or seq.transfer_characteristics or seq.matrix_coefficients
    w.f(1 if described else 0, 1)  # color_description_present_flag
    if described:
        w.f(seq.color_primaries, 8)
        w.f(seq.transfer_characteristics, 8)
        w.f(seq.matrix_coefficients, 8)
    if seq.mono_chrome:
        w.f(seq.color_range, 1)
    else:
        # identity matrix (RGB) not supported; profile-implied subsampling
        w.f(seq.color_range, 1)
        if seq.profile == 0:
            assert seq.subsampling_x == 1 and seq.subsampling_y == 1
        elif seq.profile == 1:
            assert seq.subsampling_x == 0 and seq.subsampling_y == 0
        else:
            raise NotImplementedError("profile 2 subsampling signaling")
        if seq.subsampling_x and seq.subsampling_y:
            w.f(seq.chroma_sample_position, 2)
        w.f(1 if seq.separate_uv_delta_q else 0, 1)

    w.f(1 if seq.film_grain_params_present else 0, 1)
    w.trailing_bits()
    return w.data()


@dataclass
class TileInfo:
    cols_log2: int = 0
    rows_log2: int = 0
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    # derived at compute time
    min_cols_log2: int = 0
    max_cols_log2: int = 0
    min_rows_log2: int = 0
    max_rows_log2: int = 0
    min_log2_tiles: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    # mi boundaries per tile (start indices plus terminal bound)
    col_starts_sb: list = field(default_factory=list)
    row_starts_sb: list = field(default_factory=list)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def compute_tile_info(seq: SequenceConfig, cols_log2: int = 0, rows_log2: int = 0) -> TileInfo:
    """Uniform tile spacing parameters (spec 5.9.15)."""
    mi_cols = 2 * ((seq.width + 7) >> 3)
    mi_rows = 2 * ((seq.height + 7) >> 3)
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size_log2 = sb_shift + 2  # 6 for 64x64 SBs, 7 for 128x128
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)

    ti = TileInfo()
    ti.min_cols_log2 = _tile_log2(max_tile_width_sb, sb_cols)
    ti.max_cols_log2 = _tile_log2(1, min(sb_cols, 64))
    ti.max_rows_log2 = _tile_log2(1, min(sb_rows, 64))
    ti.min_log2_tiles = max(ti.min_cols_log2, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))

    ti.cols_log2 = min(max(cols_log2, ti.min_cols_log2), ti.max_cols_log2)
    ti.min_rows_log2 = max(ti.min_log2_tiles - ti.cols_log2, 0)
    ti.rows_log2 = max(rows_log2, ti.min_rows_log2)

    # uniform spacing boundaries (in superblocks)
    tile_width_sb = (sb_cols + (1 << ti.cols_log2) - 1) >> ti.cols_log2
    ti.col_starts_sb = list(range(0, sb_cols, tile_width_sb)) + [sb_cols]
    tile_height_sb = (sb_rows + (1 << ti.rows_log2) - 1) >> ti.rows_log2
    ti.row_starts_sb = list(range(0, sb_rows, tile_height_sb)) + [sb_rows]
    ti.tile_cols = len(ti.col_starts_sb) - 1
    ti.tile_rows = len(ti.row_starts_sb) - 1
    return ti


@dataclass
class FrameConfig:
    frame_type: int = 0  # 0 KEY, 1 INTER, 2 INTRA_ONLY, 3 SWITCH
    show_frame: bool = True
    base_q_idx: int = 80
    disable_cdf_update: bool = False
    order_hint: int = 0
    tx_mode_select: bool = False  # False => TX_MODE_LARGEST
    reduced_tx_set: bool = False
    # loop filter (level search lands later)
    lf_level: tuple = (0, 0, 0, 0)
    lf_sharpness: int = 0
    # quant deltas
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    # per-SB delta q (variance boost / TPL)
    delta_q_present: bool = False
    delta_q_res: int = 1
    # refs (inter path)
    primary_ref_frame: int = 7  # PRIMARY_REF_NONE
    reference_select: bool = False  # compound prediction enabled
    ref_order_hints: tuple = (0,) * 7  # order hints of the 7 named refs
    # 0 => saved frame context is the post-tile adapted state (CDF
    # forwarding via primary_ref_frame); 1 => frame-initial state
    disable_frame_end_update_cdf: bool = False
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: tuple = (0, 1, 2, 3, 4, 5, 6)
    ref_order_hints: tuple = (0,) * 8
    error_resilient_mode: bool = False
    allow_screen_content_tools: bool = False
    allow_intrabc: bool = False
    interp_filter: int = 0  # EIGHTTAP
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: tuple = (0,)
    cdef_uv_strengths: tuple = (0,)
    # loop restoration (lr_params): per-plane frame restoration types
    # (0 NONE / 1 WIENER / 2 SGRPROJ / 3 SWITCHABLE), luma RU size,
    # chroma shift (uv size = luma size >> lr_uv_shift)
    lr_frame_types: tuple | None = None
    lr_unit_size: int = 64
    lr_uv_shift: int = 0
    # film grain synthesis parameters (ops/film_grain.py FilmGrainParams)
    film_grain: object = None
    # segmentation (spec 5.9.14): ALT_Q deltas per segment, None = off
    seg_qdeltas: tuple | None = None
    # quantizer matrices (spec 5.9.12)
    using_qmatrix: bool = False
    qm_y: int = 15
    qm_u: int = 15
    qm_v: int = 15
    tile: TileInfo | None = None
    # global motion (spec 5.9.24): 7 entries for LAST..ALTREF, each None
    # (identity) or (gm_type, mat6 model units); gm_prev = PrevGmParams
    # (primary ref's saved params, defaults when PRIMARY_REF_NONE)
    gm: tuple | None = None
    gm_prev: tuple | None = None
    # local warped motion (WARPED_CAUSAL) allowed this frame
    allow_warped_motion: bool = False

    @property
    def frame_is_intra(self) -> bool:
        return self.frame_type in (0, 2)


def _write_delta_q(w: BitWriter, v: int) -> None:
    if v:
        w.f(1, 1)
        w.su(v, 7)
    else:
        w.f(0, 1)


def write_frame_header(seq: SequenceConfig, fr: FrameConfig, w: BitWriter) -> None:
    """uncompressed_header for the supported feature set, written into `w`.

    Caller byte-aligns (OBU_FRAME) or writes trailing bits (OBU_FRAME_HEADER).
    """
    w.f(0, 1)  # show_existing_frame
    w.f(fr.frame_type, 2)
    w.f(1 if fr.show_frame else 0, 1)
    if not fr.show_frame:
        w.f(1, 1)  # showable_frame
    key_shown = fr.frame_type == 0 and fr.show_frame
    if not (fr.frame_type == 3 or key_shown):
        w.f(1 if fr.error_resilient_mode else 0, 1)
    w.f(1 if fr.disable_cdf_update else 0, 1)
    if seq.force_screen_content_tools == 2:
        w.f(1 if fr.allow_screen_content_tools else 0, 1)
    # (seq_force != SELECT -> allow_screen_content_tools implied)
    if fr.frame_type != 3:
        w.f(0, 1)  # frame_size_override_flag = 0
    if seq.enable_order_hint:
        w.f(fr.order_hint, seq.order_hint_bits)
    if not (fr.frame_is_intra or fr.error_resilient_mode):
        w.f(fr.primary_ref_frame, 3)
    if not key_shown:
        if fr.frame_type == 3:
            pass  # refresh all implied
        else:
            w.f(fr.refresh_frame_flags, 8)

    if fr.frame_is_intra:
        _write_frame_size(w, seq)
        if fr.allow_screen_content_tools:
            w.f(1 if fr.allow_intrabc else 0, 1)
        else:
            assert not fr.allow_intrabc
    else:
        # frame_refs_short_signaling (only when order hint): write 0
        if seq.enable_order_hint:
            w.f(0, 1)
        for i in range(7):
            w.f(fr.ref_frame_idx[i], 3)
        # frame_size_override_flag == 0: frame_size() + render_size()
        # (frame_size_with_refs / found_ref bits are only coded when the
        # override flag is set)
        _write_frame_size(w, seq)
        # allow_high_precision_mv (force_integer_mv==0)
        w.f(0, 1)
        # read_interpolation_filter (4 == SWITCHABLE)
        if fr.interp_filter == 4:
            w.f(1, 1)  # is_filter_switchable
        else:
            w.f(0, 1)
            w.f(fr.interp_filter, 2)
        w.f(1 if fr.is_motion_mode_switchable else 0, 1)
        if not fr.error_resilient_mode and seq.enable_ref_frame_mvs:
            w.f(1 if fr.use_ref_frame_mvs else 0, 1)

    if not fr.disable_cdf_update:
        w.f(1 if fr.disable_frame_end_update_cdf else 0, 1)

    _write_tile_info(w, seq, fr)
    _write_quantization_params(w, seq, fr)
    # segmentation_params (spec 5.9.14; ALT_Q feature only)
    if fr.seg_qdeltas is None:
        w.f(0, 1)  # segmentation_enabled
    else:
        w.f(1, 1)
        if fr.primary_ref_frame != 7:
            w.f(1, 1)  # segmentation_update_map
            w.f(0, 1)  # segmentation_temporal_update
            w.f(1, 1)  # segmentation_update_data
        for seg in range(8):
            d = fr.seg_qdeltas[seg] if seg < len(fr.seg_qdeltas) else None
            w.f(1 if d is not None else 0, 1)  # ALT_Q enabled
            if d is not None:
                w.su(int(d), 9)  # su(1 + 8) signed feature value
            for _ in range(7):  # remaining features off
                w.f(0, 1)
    # delta_q_params
    if fr.base_q_idx > 0:
        w.f(1 if fr.delta_q_present else 0, 1)
        if fr.delta_q_present:
            w.f(fr.delta_q_res.bit_length() - 1, 2)  # log2(delta_q_res)
    # delta_lf_params (not coded at all when allow_intrabc, spec 5.9.18)
    if fr.delta_q_present and not fr.allow_intrabc:
        w.f(0, 1)  # delta_lf_present
    _write_loop_filter_params(w, seq, fr)
    _write_cdef_params(w, seq, fr)
    # lr_params (spec 5.9.20; entropy_coding.c:2168 encode_restoration_mode)
    if seq.enable_restoration and not fr.allow_intrabc:
        lr_types = fr.lr_frame_types or (0, 0, 0)
        uses_lr = any(t != 0 for t in lr_types)
        uses_chroma_lr = any(t != 0 for t in lr_types[1:])
        for t in lr_types[: (1 if seq.mono_chrome else 3)]:
            # 2-bit lr_type: NONE=00 SWITCHABLE=01 WIENER=10 SGRPROJ=11
            code = {0: 0, 3: 1, 1: 2, 2: 3}[t]
            w.f(code >> 1, 1)
            w.f(code & 1, 1)
        if uses_lr:
            size = fr.lr_unit_size
            if not seq.use_128x128_superblock:
                w.f(1 if size > 64 else 0, 1)
            if size > 64:
                w.f(1 if size > 128 else 0, 1)
        if uses_chroma_lr and seq.subsampling_x and seq.subsampling_y:
            w.f(1 if fr.lr_uv_shift else 0, 1)
    # read_tx_mode
    w.f(1 if fr.tx_mode_select else 0, 1)
    # frame_reference_mode
    if not fr.frame_is_intra:
        w.f(1 if fr.reference_select else 0, 1)
    # skip_mode_params (spec 5.9.22): when compound is possible with both
    # a past and a future reference, skip_mode_present must be coded (0:
    # this encoder does not use skip mode yet)
    if _skip_mode_allowed(seq, fr):
        w.f(0, 1)  # skip_mode_present
    if not (fr.frame_is_intra or fr.error_resilient_mode) and seq.enable_warped_motion:
        w.f(1 if fr.allow_warped_motion else 0, 1)
    w.f(1 if fr.reduced_tx_set else 0, 1)
    # global_motion_params (spec 5.9.24)
    if not fr.frame_is_intra:
        _write_global_motion_params(w, fr)
    # film_grain_params (spec 5.9.30)
    if seq.film_grain_params_present:
        _write_film_grain_params(w, seq, fr)


# Global motion parameter coding (spec 5.9.24-5.9.27). ------------------------
# The encoder-side inverses of decode_subexp / decode_unsigned_subexp_with_ref
# / decode_signed_subexp_with_ref; counterpart entropy_coding.c
# write_global_motion_params + bitstream_unit aom_wb_write_signed_primitive_
# refsubexpfin, re-derived from the spec decode processes.
GM_IDENTITY, GM_TRANSLATION, GM_ROTZOOM, GM_AFFINE = 0, 1, 2, 3
GM_DEFAULT_MAT = (0, 0, 1 << 16, 0, 0, 1 << 16)
_GM_ABS_ALPHA_BITS = 12
_GM_ALPHA_PREC_BITS = 15
_GM_ABS_TRANS_BITS = 12
_GM_TRANS_PREC_BITS = 6
_GM_ABS_TRANS_ONLY_BITS = 9
_GM_TRANS_ONLY_PREC_BITS = 3
_WM_PREC_BITS = 16


def _write_ns(w: BitWriter, v: int, n: int) -> None:
    """spec 4.10.7 ns(n) nonsymmetric coding of v in [0, n)."""
    width = n.bit_length()
    m = (1 << width) - n
    if v < m:
        w.f(v, width - 1)
    else:
        w.f((v + m) >> 1, width - 1)
        w.f((v + m) & 1, 1)


def _write_subexp(w: BitWriter, v: int, num_syms: int) -> None:
    """Inverse of spec 5.9.26 decode_subexp (k = 3)."""
    i = 0
    mk = 0
    k = 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            _write_ns(w, v - mk, num_syms - mk)
            return
        if v < mk + a:
            w.f(0, 1)  # subexp_more_bits = 0
            w.f(v - mk, b2)
            return
        w.f(1, 1)
        i += 1
        mk += a


def _recenter(r: int, x: int) -> int:
    """recenter_nonneg (libaom/reference entropy_coding.c:2800, matching
    dav1d): even codes x >= r, odd codes x < r."""
    if x > 2 * r:
        return x
    if x >= r:
        return (x - r) << 1
    return ((r - x) << 1) - 1


def _write_signed_subexp_ref(w: BitWriter, x: int, low: int, high: int,
                             r: int) -> None:
    """Inverse of decode_signed_subexp_with_ref(low, high, r)."""
    mx = high - low
    xs, rs = x - low, r - low
    if (rs << 1) <= mx:
        _write_subexp(w, _recenter(rs, xs), mx)
    else:
        _write_subexp(w, _recenter(mx - 1 - rs, mx - 1 - xs), mx)


def _write_global_param(w: BitWriter, gm_type: int, idx: int, val: int,
                        prev: int, allow_hp: bool) -> None:
    """spec 5.9.25 read_global_param inverse; val/prev in model units."""
    abs_bits = _GM_ABS_ALPHA_BITS
    prec_bits = _GM_ALPHA_PREC_BITS
    if idx < 2:
        if gm_type == GM_TRANSLATION:
            abs_bits = _GM_ABS_TRANS_ONLY_BITS - (0 if allow_hp else 1)
            prec_bits = _GM_TRANS_ONLY_PREC_BITS - (0 if allow_hp else 1)
        else:
            abs_bits = _GM_ABS_TRANS_BITS
            prec_bits = _GM_TRANS_PREC_BITS
    prec_diff = _WM_PREC_BITS - prec_bits
    rnd = (1 << _WM_PREC_BITS) if (idx % 3) == 2 else 0
    sub = (1 << prec_bits) if (idx % 3) == 2 else 0
    mx = 1 << abs_bits
    r = (prev >> prec_diff) - sub
    v = (val - rnd) >> prec_diff  # must round-trip exactly
    assert (v << prec_diff) + rnd == val, \
        f"gm param {val} not representable (idx {idx}, type {gm_type})"
    assert -mx <= v <= mx, (val, v, mx)
    _write_signed_subexp_ref(w, v, -mx, mx + 1, r)


def quantize_gm_param(gm_type: int, idx: int, val: int,
                      allow_hp: bool = False) -> int:
    """Clamp+round a model-unit value to what read_global_param can carry."""
    abs_bits = _GM_ABS_ALPHA_BITS
    prec_bits = _GM_ALPHA_PREC_BITS
    if idx < 2:
        if gm_type == GM_TRANSLATION:
            abs_bits = _GM_ABS_TRANS_ONLY_BITS - (0 if allow_hp else 1)
            prec_bits = _GM_TRANS_ONLY_PREC_BITS - (0 if allow_hp else 1)
        else:
            abs_bits = _GM_ABS_TRANS_BITS
            prec_bits = _GM_TRANS_PREC_BITS
    prec_diff = _WM_PREC_BITS - prec_bits
    rnd = (1 << _WM_PREC_BITS) if (idx % 3) == 2 else 0
    mx = 1 << abs_bits
    v = (val - rnd + (1 << (prec_diff - 1))) >> prec_diff
    v = max(-mx, min(mx, v))
    return (v << prec_diff) + rnd


def _write_global_motion_params(w: BitWriter, fr: FrameConfig) -> None:
    """fr.gm: 7 entries for refs LAST..ALTREF, each None (identity) or
    (gm_type, mat6). fr.gm_prev: 7 mat6 used as coding references
    (PrevGmParams: defaults unless forwarded from the primary ref)."""
    gm = fr.gm or (None,) * 7
    prev = fr.gm_prev or (GM_DEFAULT_MAT,) * 7
    for ref in range(7):
        ent = gm[ref]
        if ent is None or ent[0] == GM_IDENTITY:
            w.f(0, 1)  # is_global
            continue
        gm_type, mat = ent
        w.f(1, 1)                                  # is_global
        w.f(1 if gm_type == GM_ROTZOOM else 0, 1)  # is_rot_zoom
        if gm_type != GM_ROTZOOM:
            w.f(1 if gm_type == GM_TRANSLATION else 0, 1)  # is_translation
        pm = prev[ref]
        if gm_type >= GM_ROTZOOM:
            _write_global_param(w, gm_type, 2, mat[2], pm[2], False)
            _write_global_param(w, gm_type, 3, mat[3], pm[3], False)
            if gm_type == GM_AFFINE:
                _write_global_param(w, gm_type, 4, mat[4], pm[4], False)
                _write_global_param(w, gm_type, 5, mat[5], pm[5], False)
            else:
                assert mat[4] == -mat[3] and mat[5] == mat[2]
        _write_global_param(w, gm_type, 0, mat[0], pm[0], False)
        _write_global_param(w, gm_type, 1, mat[1], pm[1], False)


def _skip_mode_allowed(seq: SequenceConfig, fr: FrameConfig) -> bool:
    """spec 5.9.22 skipModeAllowed derivation (single forward+backward)."""
    if fr.frame_is_intra or not fr.reference_select or not seq.enable_order_hint:
        return False
    bits = seq.order_hint_bits
    half = 1 << (bits - 1)

    def rel(a, b):
        diff = (a - b) & ((1 << bits) - 1)
        return (diff & (half - 1)) - (diff & half)

    fwd_idx, fwd_hint = -1, 0
    bwd_idx, bwd_hint = -1, 0
    for i in range(7):
        hint = fr.ref_order_hints[i]
        if rel(hint, fr.order_hint) < 0:
            if fwd_idx < 0 or rel(hint, fwd_hint) > 0:
                fwd_idx, fwd_hint = i, hint
        elif rel(hint, fr.order_hint) > 0:
            if bwd_idx < 0 or rel(hint, bwd_hint) < 0:
                bwd_idx, bwd_hint = i, hint
    if fwd_idx < 0:
        return False
    if bwd_idx >= 0:
        return True
    # second-closest forward
    snd_idx = -1
    snd_hint = 0
    for i in range(7):
        hint = fr.ref_order_hints[i]
        if rel(hint, fwd_hint) < 0:
            if snd_idx < 0 or rel(hint, snd_hint) > 0:
                snd_idx, snd_hint = i, hint
    return snd_idx >= 0


def _write_frame_size(w: BitWriter, seq: SequenceConfig) -> None:
    # frame_size_override == 0: FrameWidth starts at max_frame_width
    # (= UpscaledWidth); superres_params (spec 5.9.8) then derives the
    # coded width = (UpscaledWidth*8 + denom/2) / denom == seq.width
    if seq.enable_superres:
        if seq.superres_upscaled_width and seq.superres_denom > 8:
            from ..ops.resize import SUPERRES_DENOM_MIN, scaled_size

            assert seq.width == scaled_size(seq.superres_upscaled_width,
                                            seq.superres_denom)
            w.f(1, 1)  # use_superres
            w.f(seq.superres_denom - SUPERRES_DENOM_MIN, 3)  # coded_denom
        else:
            w.f(0, 1)  # use_superres
    # render_size (RenderWidth = UpscaledWidth):
    w.f(0, 1)  # render_and_frame_size_different


def _write_film_grain_params(w: BitWriter, seq: SequenceConfig,
                             fr: FrameConfig) -> None:
    """film_grain_params (spec 5.9.30): fresh parameters per frame
    (update_grain always 1 — no ref-param reuse yet)."""
    p = fr.film_grain
    # no-show frames are always coded showable (show_existing targets),
    # so grain params are present for every frame we emit
    if p is None or not p.apply_grain:
        w.f(0, 1)  # apply_grain
        return
    w.f(1, 1)
    w.f(p.grain_seed, 16)
    if fr.frame_type == 1:  # INTER_FRAME
        w.f(1, 1)  # update_grain
    w.f(p.num_y_points, 4)
    for v, s in p.scaling_points_y:
        w.f(v, 8)
        w.f(s, 8)
    if not seq.mono_chrome:
        w.f(1 if p.chroma_scaling_from_luma else 0, 1)
    if seq.mono_chrome or p.chroma_scaling_from_luma or (
            seq.subsampling_x and seq.subsampling_y and p.num_y_points == 0):
        assert p.num_cb_points == 0 and p.num_cr_points == 0
    else:
        w.f(p.num_cb_points, 4)
        for v, s in p.scaling_points_cb:
            w.f(v, 8)
            w.f(s, 8)
        w.f(p.num_cr_points, 4)
        for v, s in p.scaling_points_cr:
            w.f(v, 8)
            w.f(s, 8)
    w.f(p.scaling_shift - 8, 2)
    w.f(p.ar_coeff_lag, 2)
    for c in p.ar_coeffs_y:
        w.f(c + 128, 8)
    if p.chroma_scaling_from_luma or p.num_cb_points:
        for c in p.ar_coeffs_cb:
            w.f(c + 128, 8)
    if p.chroma_scaling_from_luma or p.num_cr_points:
        for c in p.ar_coeffs_cr:
            w.f(c + 128, 8)
    w.f(p.ar_coeff_shift - 6, 2)
    w.f(p.grain_scale_shift, 2)
    if p.num_cb_points:
        w.f(p.cb_mult, 8)
        w.f(p.cb_luma_mult, 8)
        w.f(p.cb_offset, 9)
    if p.num_cr_points:
        w.f(p.cr_mult, 8)
        w.f(p.cr_luma_mult, 8)
        w.f(p.cr_offset, 9)
    w.f(1 if p.overlap_flag else 0, 1)
    w.f(1 if p.clip_to_restricted_range else 0, 1)


def _write_tile_info(w: BitWriter, seq: SequenceConfig, fr: FrameConfig) -> None:
    ti = fr.tile or compute_tile_info(seq)
    fr.tile = ti
    w.f(1, 1)  # uniform_tile_spacing_flag
    k = ti.min_cols_log2
    while k < ti.max_cols_log2:
        if k < ti.cols_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    k = ti.min_rows_log2
    while k < ti.max_rows_log2:
        if k < ti.rows_log2:
            w.f(1, 1)
            k += 1
        else:
            w.f(0, 1)
            break
    if ti.cols_log2 or ti.rows_log2:
        w.f(ti.context_update_tile_id, ti.rows_log2 + ti.cols_log2)
        w.f(ti.tile_size_bytes - 1, 2)


def _write_quantization_params(w: BitWriter, seq: SequenceConfig, fr: FrameConfig) -> None:
    w.f(fr.base_q_idx, 8)
    _write_delta_q(w, fr.delta_q_y_dc)
    if seq.num_planes > 1:
        if seq.separate_uv_delta_q:
            w.f(0, 1)  # diff_uv_delta
        _write_delta_q(w, fr.delta_q_u_dc)
        _write_delta_q(w, fr.delta_q_u_ac)
    w.f(1 if fr.using_qmatrix else 0, 1)  # using_qmatrix
    if fr.using_qmatrix:
        w.f(fr.qm_y, 4)
        w.f(fr.qm_u, 4)
        if seq.separate_uv_delta_q:
            w.f(fr.qm_v, 4)


def _write_loop_filter_params(w: BitWriter, seq: SequenceConfig, fr: FrameConfig) -> None:
    if fr.allow_intrabc:
        return  # spec 5.9.11: levels forced 0, nothing coded
    lf = fr.lf_level
    w.f(lf[0], 6)
    w.f(lf[1], 6)
    if seq.num_planes > 1 and (lf[0] or lf[1]):
        w.f(lf[2], 6)
        w.f(lf[3], 6)
    w.f(fr.lf_sharpness, 3)
    w.f(0, 1)  # loop_filter_delta_enabled


def _write_cdef_params(w: BitWriter, seq: SequenceConfig, fr: FrameConfig) -> None:
    if not seq.enable_cdef or fr.allow_intrabc:
        return  # spec 5.9.19: intrabc frames code no cdef params
    w.f(fr.cdef_damping - 3, 2)
    w.f(fr.cdef_bits, 2)
    for i in range(1 << fr.cdef_bits):
        w.f(fr.cdef_y_strengths[i] // 4, 4)
        w.f(fr.cdef_y_strengths[i] % 4, 2)
        if seq.num_planes > 1:
            w.f(fr.cdef_uv_strengths[i] // 4, 4)
            w.f(fr.cdef_uv_strengths[i] % 4, 2)
