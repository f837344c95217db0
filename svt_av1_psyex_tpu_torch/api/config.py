"""Encoder configuration — the EbSvtAv1EncConfiguration equivalent.

Field set mirrors the reference's public struct
(Source/API/EbSvtAv1Enc.h:219-1080, ~90 fields) including the PSY fork
additions (EbSvtAv1Enc.h:895-1077). Every field is carried and validated;
fields not yet honored by the pipeline are marked [pending] in their
comment and tracked in FEATURE_STATUS.

Validation mirrors svt_av1_verify_settings (enc_settings.c:946+).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields


# Fields accepted (API parity) but not yet consumed by the pipeline.
# Shrinks as consumers land; SvtAv1Encoder.init warns when a user sets one.
_PENDING_FIELDS = frozenset({
    "sframe_dist", "sframe_mode",
    "noise_adaptive_filtering",
    "lossless",
    "avif", "enable_overlays",
    "film_grain_denoise_apply",
    "resize_mode", "enable_dg", "startup_mg_size",
    "tile_rows", "gop_constraint_rc",
    "buf_initial_sz", "buf_optimal_sz", "buf_sz",
    "lambda_scale_factors", "forced_max_frame_width",
    "forced_max_frame_height",
})


@dataclass
class EncoderConfig:
    # ---- input / geometry ----
    source_width: int = 0
    source_height: int = 0
    encoder_bit_depth: int = 8
    encoder_color_format: int = 1  # EB_YUV420
    frame_rate_numerator: int = 60
    frame_rate_denominator: int = 1
    profile: int = 0
    level: int = 0  # auto
    tier: int = 0

    # ---- coding structure ----
    enc_mode: int = 10  # preset -3..13
    intra_period_length: int = -2  # -2 auto, -1 infinite, >=0 period
    intra_refresh_type: int = 2  # 1 FWD_FRAME (open GOP), 2 KEY_FRAME (closed)
    hierarchical_levels: int = 0  # 0 auto; 1-4 = mini-GOP 2^n (codec/gop.py)
    pred_structure: int = 2  # 1 low delay, 2 random access [pending]
    force_key_frames: bool = False
    sframe_dist: int = 0  # [pending]
    sframe_mode: int = 2  # [pending]

    # ---- rate control ----
    rate_control_mode: int = 0  # 0 CRF/CQP, 1 VBR, 2 CBR
    qp: int = 35
    crf: int | None = None
    use_qp_file: bool = False
    target_bit_rate: int = 2000000
    max_bit_rate: int = 0  # capped CRF ceiling (codec/rc.py CappedCrf)
    min_qp_allowed: int = 1  # enforced by RateControl (VBR/CBR)
    max_qp_allowed: int = 63
    vbv_bufsize: int = 0  # virtual buffer window (RC + capped CRF)
    over_shoot_pct: int = 25  # RC feedback clamp scale
    under_shoot_pct: int = 25
    recode_loop: int = 4  # 0 disables overshoot re-encodes
    vbr_bias_pct: int = 50  # two-pass complexity-bias blend
    vbr_min_section_pct: int = 0  # VBR per-frame target floor %
    vbr_max_section_pct: int = 2000  # VBR per-frame target cap %
    enable_adaptive_quantization: int = 2  # 0 off, 1 segmentation AQ, 2 delta-q (variance boost)
    pass_: int = 0  # 0 single, 1 stats-out, 2 stats-in (codec/firstpass.py)
    rc_stats_buffer: bytes = b""  # pass-1 stats for pass 2
    mbr_over_shoot_pct: int = 50  # capped-CRF per-frame slack
    gop_constraint_rc: bool = False  # [pending]
    buf_initial_sz: int = 6000  # [pending decoder model]
    buf_optimal_sz: int = 5000  # [pending]
    buf_sz: int = 6000  # [pending]
    startup_qp_offset: int = 0  # extra q for the first mini-GOP
    # fixed per-layer qindex offsets (rc_process.c use_fixed_qindex_offsets):
    # replaces the hierarchical q ladder when enabled; arrays indexed by
    # temporal layer (missing tail entries repeat the last value)
    use_fixed_qindex_offsets: int = 0
    qindex_offsets: tuple = ()
    key_frame_qindex_offset: int = 0
    chroma_qindex_offsets: tuple = ()
    key_frame_chroma_qindex_offset: int = 0
    # direct quantizer deltas (frame-header delta_q_* fields)
    luma_y_dc_qindex_offset: int = 0
    chroma_u_dc_qindex_offset: int = 0
    chroma_u_ac_qindex_offset: int = 0
    chroma_v_dc_qindex_offset: int = 0
    chroma_v_ac_qindex_offset: int = 0
    lambda_scale_factors: tuple = ()  # [pending]
    forced_max_frame_width: int = 0  # [pending]
    forced_max_frame_height: int = 0  # [pending]

    # ---- quality/psy (fork additions) ----
    enable_variance_boost: bool = True
    enable_tf: bool = True  # alt-ref temporal filtering (RA anchors)
    variance_boost_strength: int = 2
    variance_octile: int = 5  # enc_settings.c:1095
    variance_boost_curve: int = 0
    tune: int = 0  # 0 VQ (PSYEX default, enc_settings.c:1050), 1 PSNR,
    #                2 SSIM, 3 Subjective SSIM, 4 Still [partial]
    sharpness: int = 0
    luminance_qp_bias: int = 0  # 0-100: more bits for darker frames
    psy_rd: float = 1.0  # SA8D energy-delta distortion (ops/psy_dist.py);
    # reference default 1.0 (enc_settings.c:1108); inert under tune 1
    spy_rd: int = 0  # PSYEX alternate psy RD (0 off / 1 full / 2 partial)
    sharp_tx: int = 1  # keeps luma detail: disables RDOQ down-rounding
    hbd_mds: int = 0  # 0 auto / 1 full-10bit MD / 2 hybrid / 3 8-bit analysis
    complex_hvs: int = 0  # 1: SA8D stage-0 candidate ranking (full HVS cost)
    adaptive_film_grain: bool = True  # [pending]
    noise_adaptive_filtering: bool = False  # [pending]
    noise_norm_strength: int = 0  # 0 off, 1-4 AC revival aggressiveness
    tf_strength: int = 1  # alt-ref TF decay scale (0 weakest..4 strongest)
    kf_tf_strength: int = 1  # keyframe TF strength (0 off .. 4)
    qp_scale_compress_strength: float = 1.0  # TPL qstep-ratio compression
    max_32_tx_size: bool = False  # cap luma TX at 32x32 (PSYEX)
    min_chroma_qm_level: int = 8
    max_chroma_qm_level: int = 15
    low_q_taper: bool = False  # dampen VB q drops at low q (CRF)
    lossless: bool = False  # [pending]
    avif: bool = False  # [pending]
    extended_crf_qindex_offset: int = 0  # [pending]

    # ---- features ----
    enable_dlf_flag: int = 1
    cdef_level: int = -1  # -1 auto (preset-derived search level)
    enable_restoration_filtering: int = -1  # -1 auto (on at preset<=6)
    enable_mfmv: int = -1  # -1 auto(on) / 0 off / 1 on
    enable_overlays: bool = False  # [pending]
    tile_columns: int = 0  # log2 tile columns (independent MD+EC per tile)
    tile_rows: int = 0
    screen_content_mode: int = 0  # 0 off / 1 on / 2 auto (palette; intra-BC pending)
    enable_qm: bool = False  # quantizer matrices (spec 5.9.12)
    min_qm_level: int = 8
    max_qm_level: int = 15
    film_grain_denoise_strength: int = 0  # 0-50 grain synthesis strength
    film_grain_denoise_apply: int = 1  # [pending]
    # superres (spec 7.16; super_res.c): 0 off, 1 fixed-denominator.
    # v1 scope: all-intra streams (intra_period_length == 0) — scaled
    # inter prediction / modes 2-4 (random/qthresh/auto) pending
    superres_mode: int = 0
    superres_denom: int = 8
    superres_kf_denom: int = 8
    superres_qthres: int = 43
    superres_kf_qthres: int = 43
    resize_mode: int = 0  # [pending]
    resize_denom: int = 8
    resize_kf_denom: int = 8
    fast_decode: int = 0
    enable_dg: bool = True  # dynamic gop [pending]
    startup_mg_size: int = 0  # [pending]
    enable_tpl_la: int = 1  # TPL lookahead q ladder (codec/tpl.py)
    scene_change_detection: bool = True  # keyframe at cuts (codec/scd.py)
    look_ahead_distance: int = -1  # TPL lookahead window (-1 auto)

    # ---- color description ----
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    chroma_sample_position: int = 0
    mastering_display: str = ""  # HDR10 MDCV metadata OBU
    content_light_level: str = ""  # HDR10 CLL metadata OBU

    # ---- system ----
    channel_id: int = 0
    active_channel_count: int = 1
    level_of_parallelism: int = 0
    pin_threads: int = 0
    target_socket: int = -1
    use_cpu_flags: int = -1  # asm level; TPU build: selects device/host kernels
    recon_enabled: bool = False
    stat_report: int = 0

    def pending_overrides(self) -> list[str]:
        """Names of [pending] (accepted-but-not-yet-honored) fields the
        user set to a non-default value. The reference acts on every
        accepted name (enc_settings.c:1354-1708); until a consumer exists
        we warn instead of silently ignoring (ADVICE.md round 1)."""
        defaults = EncoderConfig()
        out = []
        for name in _PENDING_FIELDS:
            if getattr(self, name) != getattr(defaults, name):
                out.append(name)
        return out

    def validate(self) -> list[str]:
        """Returns list of error strings (empty = valid). Mirrors
        svt_av1_verify_settings ranges."""
        errs = []
        if not (64 <= self.source_width <= 16384):
            errs.append(f"source_width {self.source_width} out of [64, 16384]")
        if not (64 <= self.source_height <= 8704):
            errs.append(f"source_height {self.source_height} out of [64, 8704]")
        if self.source_width % 2 or self.source_height % 2:
            errs.append("dimensions must be even")
        if self.encoder_bit_depth not in (8, 10):
            errs.append(f"bit depth {self.encoder_bit_depth} not in (8, 10)")
        if not (-3 <= self.enc_mode <= 13):
            errs.append(f"preset {self.enc_mode} out of [-3, 13]")
        if not (0 <= self.qp <= 63):
            errs.append(f"qp {self.qp} out of [0, 63]")
        if self.crf is not None and not (0 <= self.crf <= 70):
            errs.append(f"crf {self.crf} out of [0, 70]")
        if (self.chroma_v_dc_qindex_offset != self.chroma_u_dc_qindex_offset
                or self.chroma_v_ac_qindex_offset
                != self.chroma_u_ac_qindex_offset):
            errs.append("v qindex offsets must equal u offsets "
                        "(separate_uv_delta_q signaling not supported)")
        if self.superres_mode not in (0, 1):
            errs.append(f"superres_mode {self.superres_mode} not "
                        "implemented (0 off / 1 fixed)")
        elif self.superres_mode == 1:
            if not (9 <= self.superres_denom <= 16):
                errs.append(f"superres_denom {self.superres_denom} "
                            "out of [9, 16]")
            if self.intra_period_length != 0:
                errs.append("superres_mode 1 requires all-intra "
                            "(intra-period 0): scaled inter prediction "
                            "is not implemented yet")
        if self.rate_control_mode not in (0, 1, 2):
            errs.append(f"rate_control_mode {self.rate_control_mode} invalid")
        if self.rate_control_mode != 0 and self.target_bit_rate <= 0:
            errs.append("VBR/CBR requires target_bit_rate > 0")
        if not (0 <= self.variance_boost_strength <= 4):
            errs.append("variance_boost_strength out of [0, 4]")
        if not (1 <= self.variance_octile <= 8):
            errs.append("variance_octile out of [1, 8]")
        if not (0 <= self.tune <= 4):
            errs.append(f"tune {self.tune} out of [0, 4]")
        if not (-7 <= self.sharpness <= 7):
            errs.append("sharpness out of [-7, 7]")
        if self.encoder_color_format != 1:
            errs.append("only 4:2:0 supported yet (pending 4:2:2/4:4:4)")
        return errs

    @property
    def qindex(self) -> int:
        crf = self.crf if self.crf is not None else self.qp
        return min(255, int(crf) * 4 + self.extended_crf_qindex_offset)

    def copy_from(self, other: "EncoderConfig") -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(other, f.name))
