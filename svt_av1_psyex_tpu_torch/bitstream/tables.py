"""Runtime access to normative AV1 constant tables + per-frame CDF context.

Tables are loaded from tables/av1_tables.npz (produced by
tools/extract_spec_tables.py — normative constants from the AV1 spec;
see that tool's docstring for provenance).

CDF orientation: increasing cumulative probabilities ending at 32768
(spec orientation). Ragged families are stored padded with -1; `trim`
cuts a row at its 32768 terminator.

The FrameCdfs class is this codebase's equivalent of the reference's
FRAME_CONTEXT (Source/Lib/Codec/cabac_context_model.h): a mutable copy of
the default CDFs plus adaptation counters, cloned per frame and updated
symbol-by-symbol during tile coding.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_NPZ = Path(__file__).parent / "tables" / "av1_tables.npz"

_cache: dict[str, np.ndarray] | None = None


def load_tables() -> dict[str, np.ndarray]:
    global _cache
    if _cache is None:
        with np.load(_NPZ) as z:
            _cache = {k: z[k] for k in z.files}
    return _cache


def get(name: str) -> np.ndarray:
    return load_tables()[name]


def trim(cdf_row: np.ndarray) -> np.ndarray:
    """Cut a (possibly -1 padded) CDF row at its 32768 terminator."""
    idx = int(np.argmax(cdf_row == (1 << 15)))
    return cdf_row[: idx + 1]


# Quantizer lookups (spec 7.12.2 dc_q / ac_q). ---------------------------------
def dc_q(qindex: int, bit_depth: int = 8) -> int:
    t = get(f"dc_qlookup_{bit_depth}")
    return int(t[int(np.clip(qindex, 0, 255))])


def ac_q(qindex: int, bit_depth: int = 8) -> int:
    t = get(f"ac_qlookup_{bit_depth}")
    return int(t[int(np.clip(qindex, 0, 255))])


# Scan orders -------------------------------------------------------------------
# AV1 tx sizes (spec enum): index -> (width, height)
TX_SIZE_DIMS = {
    0: (4, 4), 1: (8, 8), 2: (16, 16), 3: (32, 32), 4: (64, 64),
    5: (4, 8), 6: (8, 4), 7: (8, 16), 8: (16, 8), 9: (16, 32),
    10: (32, 16), 11: (32, 64), 12: (64, 32), 13: (4, 16), 14: (16, 4),
    15: (8, 32), 16: (32, 8), 17: (16, 64), 18: (64, 16),
}
TX_SIZES_ALL = 19

# 64-wide/tall transforms only code the top-left 32x32 region; spec aliases
# their scans to the 32-sized ones (mirrors coefficients.h defines).
_SCAN_ALIAS = {
    "32x64": "32x32", "64x32": "32x32", "64x64": "32x32",
    "16x64": "16x32", "64x16": "32x16",
}

_scan_cache: dict[tuple[int, str], np.ndarray] = {}


def scan_table(tx_size: int, scan_kind: str) -> np.ndarray:
    """scan_kind in {'default','mrow','mcol'}; returns scan->raster index map."""
    key = (tx_size, scan_kind)
    if key not in _scan_cache:
        w, h = TX_SIZE_DIMS[tx_size]
        # table naming is <w>x<h> in raster sense: name WxH means W cols? The
        # reference names are default_scan_<rows>x<cols> per libaom convention
        # tx4x8 => 4 wide 8 tall stored as default_scan_4x8 (32 entries).
        nm = f"{w}x{h}"
        nm = _SCAN_ALIAS.get(nm, nm)
        prefix = "default_scan" if scan_kind == "default" else f"{scan_kind}_scan"
        _scan_cache[key] = get(f"{prefix}_{nm}")
    return _scan_cache[key]


# Frame CDF context ---------------------------------------------------------------
class Cdf:
    """One adaptive CDF: values + visit counter."""

    __slots__ = ("v", "cnt")

    def __init__(self, values: np.ndarray):
        self.v = values.astype(np.uint16)
        self.cnt = np.zeros(1, dtype=np.int32)


class FrameCdfs:
    """Mutable per-frame CDF set (subset grows as syntax coverage grows).

    Layout mirrors the spec's per-frame context: indexing by the same
    context variables the syntax uses. Only the fields needed by the
    currently-implemented syntax are materialized.
    """

    def __init__(self, base_q_idx: int):
        t = load_tables()
        self.qctx = self._q_ctx(base_q_idx)

        def clone(name):
            return t[name].copy()

        # intra / partition / skip
        self.kf_y_mode = self._wrap(clone("svt_aom_default_kf_y_mode_cdf"))
        self.uv_mode = self._wrap(clone("default_uv_mode_cdf"))
        self.partition = self._wrap(clone("default_partition_cdf"))
        self.skip = self._wrap(clone("default_skip_cdfs"))
        self.angle_delta = self._wrap(clone("default_angle_delta_cdf"))
        self.filter_intra_mode = self._wrap(clone("default_filter_intra_mode_cdf"))
        self.filter_intra = self._wrap(clone("default_filter_intra_cdfs"))
        self.cfl_sign = self._wrap(clone("default_cfl_sign_cdf"))
        self.cfl_alpha = self._wrap(clone("default_cfl_alpha_cdf"))
        self.tx_size = self._wrap(clone("default_tx_size_cdf"))
        self.txfm_partition = self._wrap(clone("default_txfm_partition_cdf"))
        self.intra_ext_tx = self._wrap(clone("default_intra_ext_tx_cdf"))
        self.inter_ext_tx = self._wrap(clone("default_inter_ext_tx_cdf"))
        self.y_mode = self._wrap(clone("default_if_y_mode_cdf"))
        self.intrabc = self._wrap(clone("default_intrabc_cdf")) if "default_intrabc_cdf" in t else None
        self.delta_q = self._wrap(clone("default_delta_q_cdf"))

        # palette (screen-content tools)
        self.palette_y_mode = self._wrap(clone("default_palette_y_mode_cdf"))
        self.palette_uv_mode = self._wrap(clone("default_palette_uv_mode_cdf"))
        self.palette_y_size = self._wrap(clone("default_palette_y_size_cdf"))
        self.palette_uv_size = self._wrap(clone("default_palette_uv_size_cdf"))
        self.palette_y_color_index = self._wrap(
            clone("default_palette_y_color_index_cdf"))
        self.palette_uv_color_index = self._wrap(
            clone("default_palette_uv_color_index_cdf"))

        # segmentation (spec 5.11.15 read_segment_id)
        self.spatial_seg = self._wrap(clone("default_spatial_pred_seg_tree_cdf"))

        # loop restoration unit types (spec read_lr_unit)
        self.switchable_restore = self._wrap(clone("default_switchable_restore_cdf"))
        self.wiener_restore = self._wrap(clone("default_wiener_restore_cdf"))
        self.sgrproj_restore = self._wrap(clone("default_sgrproj_restore_cdf"))

        # inter
        self.intra_inter = self._wrap(clone("default_intra_inter_cdf"))
        self.single_ref = self._wrap(clone("default_single_ref_cdf"))
        self.comp_inter = self._wrap(clone("default_comp_inter_cdf"))
        self.comp_ref_type = self._wrap(clone("default_comp_ref_type_cdf"))
        self.comp_ref = self._wrap(clone("default_comp_ref_cdf"))
        self.comp_bwdref = self._wrap(clone("default_comp_bwdref_cdf"))
        self.inter_compound_mode = self._wrap(clone("default_inter_compound_mode_cdf"))
        # compound type group (read_compound_type): dist-wtd / masked
        self.comp_group_idx = self._wrap(clone("default_comp_group_idx_cdfs"))
        self.compound_idx = self._wrap(clone("default_compound_idx_cdfs"))
        self.compound_type = self._wrap(clone("default_compound_type_cdf"))
        self.wedge_idx = self._wrap(clone("default_wedge_idx_cdf"))
        self.interintra = self._wrap(clone("default_interintra_cdf"))
        self.interintra_mode = self._wrap(clone("default_interintra_mode_cdf"))
        self.wedge_interintra = self._wrap(clone("default_wedge_interintra_cdf"))
        self.switchable_interp = self._wrap(
            clone("default_switchable_interp_cdf"))
        self.newmv = self._wrap(clone("default_newmv_cdf"))
        self.zeromv = self._wrap(clone("default_zeromv_cdf"))
        self.refmv = self._wrap(clone("default_refmv_cdf"))
        self.drl = self._wrap(clone("default_drl_cdf"))
        self.skip_mode = self._wrap(clone("default_skip_mode_cdfs"))
        self.motion_mode = self._wrap(clone("default_motion_mode_cdf"))
        self.obmc = self._wrap(clone("default_obmc_cdf"))
        self.nmv_joints = self._wrap(clone("nmv_joints_cdf"))
        # per-component (0 vertical/row, 1 horizontal/col)
        self.nmv_sign = self._wrap(clone("nmv_sign_cdf"))
        self.nmv_classes = self._wrap(clone("nmv_classes_cdf"))
        self.nmv_class0 = self._wrap(clone("nmv_class0_cdf"))
        self.nmv_class0_fp = self._wrap(clone("nmv_class0_fp_cdf"))
        self.nmv_fp = self._wrap(clone("nmv_fp_cdf"))
        self.nmv_class0_hp = self._wrap(clone("nmv_class0_hp_cdf"))
        self.nmv_hp = self._wrap(clone("nmv_hp_cdf"))
        self.nmv_bits = self._wrap(clone("nmv_bits_cdf"))
        # intra-BC DV context: a second, independently-adapted copy of
        # the default nmv set (the spec's ndvc; fr.allow_intrabc frames)
        self.ndv_joints = self._wrap(clone("nmv_joints_cdf"))
        self.ndv_sign = self._wrap(clone("nmv_sign_cdf"))
        self.ndv_classes = self._wrap(clone("nmv_classes_cdf"))
        self.ndv_class0 = self._wrap(clone("nmv_class0_cdf"))
        self.ndv_bits = self._wrap(clone("nmv_bits_cdf"))

        # coefficients (quality-context dependent)
        q = self.qctx
        self.txb_skip = self._wrap(clone("av1_default_txb_skip_cdfs")[q])
        self.eob_extra = self._wrap(clone("av1_default_eob_extra_cdfs")[q])
        self.dc_sign = self._wrap(clone("av1_default_dc_sign_cdfs")[q])
        self.coeff_br = self._wrap(clone("av1_default_coeff_lps_multi_cdfs")[q])
        self.coeff_base = self._wrap(clone("av1_default_coeff_base_multi_cdfs")[q])
        self.coeff_base_eob = self._wrap(clone("av1_default_coeff_base_eob_multi_cdfs")[q])
        self.eob_flag = {
            16: self._wrap(clone("av1_default_eob_multi16_cdfs")[q]),
            32: self._wrap(clone("av1_default_eob_multi32_cdfs")[q]),
            64: self._wrap(clone("av1_default_eob_multi64_cdfs")[q]),
            128: self._wrap(clone("av1_default_eob_multi128_cdfs")[q]),
            256: self._wrap(clone("av1_default_eob_multi256_cdfs")[q]),
            512: self._wrap(clone("av1_default_eob_multi512_cdfs")[q]),
            1024: self._wrap(clone("av1_default_eob_multi1024_cdfs")[q]),
        }

    @staticmethod
    def _q_ctx(base_q_idx: int) -> int:
        """Quality context for coefficient CDFs (spec get_q_ctx thresholds)."""
        if base_q_idx <= 20:
            return 0
        if base_q_idx <= 60:
            return 1
        if base_q_idx <= 120:
            return 2
        return 3

    def reset_counters(self) -> None:
        """Zero every CDF's visit counter — the frame-context save process
        resets counts (spec: symbol counters are not carried across frames;
        dav1d cdf_thread_update zeroes the count element on save)."""
        for val in self.__dict__.values():
            if isinstance(val, list) and len(val) == 3 and isinstance(val[1], np.ndarray):
                val[1][...] = 0
            elif isinstance(val, dict):
                for v in val.values():
                    if isinstance(v, list) and len(v) == 3:
                        v[1][...] = 0

    def clone(self) -> "FrameCdfs":
        """Deep copy of the adaptive state (CDF forwarding: load_cdfs from
        the primary reference, spec 7.20)."""
        import copy

        out = object.__new__(FrameCdfs)
        for name, val in self.__dict__.items():
            if isinstance(val, list) and val and isinstance(val[0], np.ndarray):
                out.__dict__[name] = [v.copy() for v in val]
            elif isinstance(val, dict):
                out.__dict__[name] = {
                    k: [x.copy() for x in v] if isinstance(v, list) else copy.deepcopy(v)
                    for k, v in val.items()}
            else:
                out.__dict__[name] = val
        return out

    @staticmethod
    def _wrap(arr: np.ndarray):
        """Attach per-row counters and trimmed symbol counts: returns
        [values, counters, nsyms] where counters has the same leading shape
        with last dim 1 and nsyms holds each row's alphabet size (CDF rows
        may be -1 padded past the 32768 terminator)."""
        arr = np.ascontiguousarray(arr, np.int32)
        cnt = np.zeros(arr.shape[:-1] + (1,), dtype=np.int32)
        nsyms = (np.argmax(arr == (1 << 15), axis=-1) + 1).astype(np.int32)
        return [arr, cnt, nsyms]
