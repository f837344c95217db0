"""String parameter parsing — svt_av1_enc_parse_parameter equivalent.

Token dictionary mirrors the reference's name->field map
(Source/Lib/Globals/enc_settings.c:2186 area, ~243 entries) for every
field the config carries; unknown names raise KeyError like the
reference returns EB_ErrorBadParameter.
"""

from __future__ import annotations

from .config import EncoderConfig


def _to_bool(v: str) -> bool:
    lv = v.lower()
    if lv in ("1", "true", "yes", "on"):
        return True
    if lv in ("0", "false", "no", "off"):
        return False
    raise ValueError(v)


# name -> (attr, parser)
PARAM_MAP: dict[str, tuple[str, type | object]] = {
    "width": ("source_width", int),
    "w": ("source_width", int),
    "height": ("source_height", int),
    "h": ("source_height", int),
    "input-depth": ("encoder_bit_depth", int),
    "color-format": ("encoder_color_format", int),
    "fps-num": ("frame_rate_numerator", int),
    "fps-denom": ("frame_rate_denominator", int),
    "profile": ("profile", int),
    "level": ("level", int),
    "preset": ("enc_mode", int),
    "keyint": ("intra_period_length", int),
    "irefresh-type": ("intra_refresh_type", int),
    "hierarchical-levels": ("hierarchical_levels", int),
    "pred-struct": ("pred_structure", int),
    "force-key-frames": ("force_key_frames", _to_bool),
    "sframe-dist": ("sframe_dist", int),
    "sframe-mode": ("sframe_mode", int),
    "rc": ("rate_control_mode", int),
    "qp": ("qp", int),
    "crf": ("crf", int),
    "tbr": ("target_bit_rate", int),
    "mbr": ("max_bit_rate", int),
    "min-qp": ("min_qp_allowed", int),
    "max-qp": ("max_qp_allowed", int),
    "vbv-bufsize": ("vbv_bufsize", int),
    "overshoot-pct": ("over_shoot_pct", int),
    "undershoot-pct": ("under_shoot_pct", int),
    "recode-loop": ("recode_loop", int),
    "bias-pct": ("vbr_bias_pct", int),
    "minsection-pct": ("vbr_min_section_pct", int),
    "maxsection-pct": ("vbr_max_section_pct", int),
    "aq-mode": ("enable_adaptive_quantization", int),
    "pass": ("pass_", int),
    "enable-variance-boost": ("enable_variance_boost", _to_bool),
    "variance-boost-strength": ("variance_boost_strength", int),
    "variance-octile": ("variance_octile", int),
    "variance-boost-curve": ("variance_boost_curve", int),
    "tune": ("tune", int),
    "sharpness": ("sharpness", int),
    "luminance-qp-bias": ("luminance_qp_bias", int),
    "psy-rd": ("psy_rd", float),
    "spy-rd": ("spy_rd", int),
    "sharp-tx": ("sharp_tx", int),
    "hbd-mds": ("hbd_mds", int),
    "complex-hvs": ("complex_hvs", int),
    "adaptive-film-grain": ("adaptive_film_grain", _to_bool),
    "noise-adaptive-filtering": ("noise_adaptive_filtering", _to_bool),
    "noise-norm-strength": ("noise_norm_strength", int),
    "tf-strength": ("tf_strength", int),
    "kf-tf-strength": ("kf_tf_strength", int),
    "qp-scale-compress-strength": ("qp_scale_compress_strength", float),
    "max-32-tx-size": ("max_32_tx_size", _to_bool),
    "min-chroma-qm-level": ("min_chroma_qm_level", int),
    "max-chroma-qm-level": ("max_chroma_qm_level", int),
    "low-q-taper": ("low_q_taper", _to_bool),
    "lossless": ("lossless", _to_bool),
    "avif": ("avif", _to_bool),
    "extended-crf-qindex-offset": ("extended_crf_qindex_offset", int),
    "enable-dlf": ("enable_dlf_flag", int),
    "enable-cdef": ("cdef_level", int),
    "enable-restoration": ("enable_restoration_filtering", int),
    "enable-mfmv": ("enable_mfmv", int),
    "enable-tf": ("enable_tf", int),
    "enable-overlays": ("enable_overlays", _to_bool),
    "tile-columns": ("tile_columns", int),
    "tile-rows": ("tile_rows", int),
    "scm": ("screen_content_mode", int),
    "enable-qm": ("enable_qm", _to_bool),
    "qm-min": ("min_qm_level", int),
    "qm-max": ("max_qm_level", int),
    "film-grain-denoise": ("film_grain_denoise_strength", int),
    "film-grain-denoise-apply": ("film_grain_denoise_apply", int),
    "superres-mode": ("superres_mode", int),
    "superres-denom": ("superres_denom", int),
    "superres-kf-denom": ("superres_kf_denom", int),
    "superres-qthres": ("superres_qthres", int),
    "superres-kf-qthres": ("superres_kf_qthres", int),
    "resize-mode": ("resize_mode", int),
    "resize-denom": ("resize_denom", int),
    "resize-kf-denom": ("resize_kf_denom", int),
    "fast-decode": ("fast_decode", int),
    "enable-dg": ("enable_dg", _to_bool),
    "startup-mg-size": ("startup_mg_size", int),
    "enable-tpl-la": ("enable_tpl_la", int),
    "scd": ("scene_change_detection", _to_bool),
    "lookahead": ("look_ahead_distance", int),
    "color-primaries": ("color_primaries", int),
    "transfer-characteristics": ("transfer_characteristics", int),
    "matrix-coefficients": ("matrix_coefficients", int),
    "color-range": ("color_range", int),
    "chroma-sample-position": ("chroma_sample_position", int),
    "mastering-display": ("mastering_display", str),
    "content-light": ("content_light_level", str),
    "lp": ("level_of_parallelism", int),
    "pin": ("pin_threads", int),
    "ss": ("target_socket", int),
    "asm": ("use_cpu_flags", int),
    "enable-stat-report": ("stat_report", int),
    # aliases + remaining dictionary names (enc_settings.c:2087-2300)
    "intra-period": ("intra_period_length", int),
    "film-grain": ("film_grain_denoise_strength", int),
    "tier": ("tier", int),
    "enable-force-key-frames": ("force_key_frames", _to_bool),
    "chroma-qm-min": ("min_chroma_qm_level", int),
    "chroma-qm-max": ("max_chroma_qm_level", int),
    "startup-qp-offset": ("startup_qp_offset", int),
    "use-fixed-qindex-offsets": ("use_fixed_qindex_offsets", int),
    "qindex-offsets": ("qindex_offsets", None),       # [o0,o1,...]
    "chroma-qindex-offsets": ("chroma_qindex_offsets", None),
    "key-frame-qindex-offset": ("key_frame_qindex_offset", int),
    "key-frame-chroma-qindex-offset": ("key_frame_chroma_qindex_offset", int),
    "luma-y-dc-qindex-offset": ("luma_y_dc_qindex_offset", int),
    "chroma-u-dc-qindex-offset": ("chroma_u_dc_qindex_offset", int),
    "chroma-u-ac-qindex-offset": ("chroma_u_ac_qindex_offset", int),
    "chroma-v-dc-qindex-offset": ("chroma_v_dc_qindex_offset", int),
    "chroma-v-ac-qindex-offset": ("chroma_v_ac_qindex_offset", int),
    "use-q-file": ("use_qp_file", _to_bool),
    "mbr-overshoot-pct": ("mbr_over_shoot_pct", int),
    "gop-constraint-rc": ("gop_constraint_rc", _to_bool),
    "buf-initial-sz": ("buf_initial_sz", int),
    "buf-optimal-sz": ("buf_optimal_sz", int),
    "buf-sz": ("buf_sz", int),
    "lambda-scale-factors": ("lambda_scale_factors", None),
    "forced-max-frame-width": ("forced_max_frame_width", int),
    "forced-max-frame-height": ("forced_max_frame_height", int),
}


def _parse_int_list(v: str) -> tuple:
    """[a,b,c] / a,b,c list syntax (reference qindex-offsets parser,
    enc_settings.c:2087)."""
    return tuple(int(t) for t in v.strip("[]").split(",") if t.strip())


def parse_parameter(cfg: EncoderConfig, name: str, value: str) -> None:
    """Set one parameter by its CLI/string name (svt_av1_enc_parse_parameter)."""
    key = name.lstrip("-")
    if key not in PARAM_MAP:
        raise KeyError(f"unknown parameter {name!r}")
    attr, parser = PARAM_MAP[key]
    if parser is None:
        setattr(cfg, attr, _parse_int_list(value))
    else:
        setattr(cfg, attr, parser(value))


def parse_svtav1_params(cfg: EncoderConfig, params: str) -> None:
    """Parse a 'k=v:k=v' list (--svtav1-params passthrough)."""
    for kv in params.split(":"):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        parse_parameter(cfg, k, v)
