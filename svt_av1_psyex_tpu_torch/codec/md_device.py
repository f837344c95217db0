"""Device-backed mode decision of the port, intra and inter.

`DeviceIntraMD` and `DeviceInterMD` subclass the JAX package's classes
(svt_av1_psyex_tpu/codec/md_device.py) and replace only what reaches
the JAX device tier: the constructors (which import device.intra for
DEVICE_MODES), `analyze_dispatch`, `analyze` and, for inter frames,
`_leaf_j` (which imports device.inter for the candidate codes). The
partition DP (`plan_frame`, `extract_plan`), `pick_rdmult`, `rd_row`
and the conformant commit are inherited unchanged.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from svt_av1_psyex_tpu.codec import md_device as ref_md_device
from svt_av1_psyex_tpu.codec.md_device import _BSL_CTX, _hbd8
from svt_av1_psyex_tpu.codec.rd import cdf_costs

from ..device.inter import (
    CAND_COMP_NEW,
    CAND_COMP_ZERO,
    CAND_INTER0,
    inter_analysis,
    unpack_inter_analysis,
)
from ..device.intra import (
    DEVICE_MODES,
    intra_analysis_batch,
    qp_row_for,
    unpack_rd_analysis,
)
from ..runtime import check_kernels, resolve_device


def upload_lumas(lumas: np.ndarray, bit_depth: int,
                 device: torch.device) -> torch.Tensor:
    """Luma planes ((H, W) or (F, H, W)) -> tensor on `device`, in a
    narrow type: uint8 at 8 bits, int16 above (torch's uint16 has few
    ops). The lattices cast to int32 on the device."""
    lum_dt = np.uint8 if bit_depth == 8 else np.int16
    return torch.from_numpy(np.ascontiguousarray(lumas, lum_dt)).to(device)


class DeviceIntraMD(ref_md_device.DeviceIntraMD):
    """The JAX package's DeviceIntraMD with the analysis lattice computed
    by the port on `device`, through `kernels` ("hand" or "plain")."""

    def __init__(self, md, seq, fr, sb_qmap=None, *, device,
                 kernels: str = "hand"):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        self.md = md
        self.seq = seq
        self.fr = fr
        self.sb_qmap = sb_qmap
        self.mi_rows, self.mi_cols = md.mi_rows, md.mi_cols
        self.DEPTHS = self.depths_for(getattr(md, "min_bsize", 3),
                                      self.mi_rows, self.mi_cols)
        self.modes = np.array(DEVICE_MODES, np.int32)
        self.psy_fixed = int(round(getattr(md, "psy_factor", 0.0) * 256))
        cacheable = (fr.frame_is_intra
                     and getattr(fr, "primary_ref_frame", 7) == 7)
        key = (fr.base_q_idx, self.psy_fixed)
        ent = self._rd_cache.get(key) if cacheable else None
        if ent is None:
            kv = md.cdfs.kf_y_mode[0]
            mode_rate = cdf_costs(kv[0, 0])[self.modes].astype(np.int64)
            sk = cdf_costs(md.cdfs.skip[0][0])
            pvals = md.cdfs.partition[0]
            part_costs = {blk: cdf_costs(pvals[_BSL_CTX[blk] * 4])
                          for blk in (16, 32, 64)}
            ent = (mode_rate, int(sk[0]), int(sk[1]), part_costs)
            if cacheable:
                self._rd_cache[key] = ent
        self.mode_rate, self.skip0, self.skip1, self.part_costs = ent
        self.stats: dict = {}
        self._commit_ctx = None
        self.tx_select = bool(getattr(fr, "tx_mode_select", False))
        self._txd_tabs = None
        self._pending = None

    def analyze_dispatch(self) -> None:
        """Queue the device analysis of this frame without waiting for it
        (CUDA runs it asynchronously); analyze() fetches the result."""
        src = self.pad_src(self.md.pctx[0].src)
        self._hp, self._wp = src.shape
        a_bd = 8 if _hbd8(self) else self.seq.bit_depth
        if a_bd != self.seq.bit_depth:
            src = src >> (self.seq.bit_depth - 8)
        qp = qp_row_for(self.fr.base_q_idx, self.fr.delta_q_y_dc, 0, a_bd)
        self._pending = intra_analysis_batch(
            upload_lumas(src[None], a_bd, self.device), qp[None],
            self.rd_row()[None], depths=self.DEPTHS, bit_depth=a_bd,
            psy=self.psy_fixed > 0, kernels=self.kernels)

    def analyze(self, packed_row: np.ndarray | None = None) -> None:
        """Pull the device (J, mode) lattice. `packed_row` = precomputed
        row from intra_analysis_batch (group path); None = fetch the
        dispatched call (dispatching now if needed)."""
        if packed_row is None:
            if self._pending is None:
                self.analyze_dispatch()
            packed_row = self._pending[0].cpu().numpy()
            self._pending = None
            hp, wp = self._hp, self._wp
        else:
            hp, wp = self.pad_src(self.md.pctx[0].src).shape
            self._hp, self._wp = hp, wp  # plan_frame reads these
        self.stats = unpack_rd_analysis(packed_row, hp, wp, self.DEPTHS)


class DeviceInterMD(ref_md_device.DeviceInterMD):
    """The JAX package's DeviceInterMD (the fused ME + candidate lattice
    decides intra vs inter, mode/ref and the full-pel MV of every block;
    the host maps the winners onto the MVP stack and commits) with the
    lattice computed by the port on `device`, through `kernels`.

    Overrides what reaches the JAX device tier: the constructor,
    `analyze_dispatch`, `analyze` and `_leaf_j`. `rd_row`, the partition
    DP and the conformant (compound) commit are inherited. The lattice
    covers only the real refs: the JAX package pads the stack to
    REFS_CANON slots to keep one compiled TPU program, and a padded slot
    (ref 0 again, at the 1<<28 base cost of rd_row) can never win."""

    def __init__(self, md, seq, fr, sb_qmap=None, ref_names=None, *,
                 device, kernels: str = "hand"):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        self.md = md
        self.seq = seq
        self.fr = fr
        self.sb_qmap = sb_qmap
        self.mi_rows, self.mi_cols = md.mi_rows, md.mi_cols
        self.DEPTHS = self.depths_for(getattr(md, "min_bsize", 3),
                                      self.mi_rows, self.mi_cols)
        # lattice ref index -> named ref (1..7); the legal (forward,
        # backward) compound pair rides slots 0 and 1 (device/inter.py).
        # SVT_TPU_NO_COMP=1 is the JAX package's ablation of compound.
        names = list(ref_names)
        self.comp_pair = None
        if (getattr(fr, "reference_select", False) and md.mi_state is not None
                and os.environ.get("SVT_TPU_NO_COMP") != "1"):
            bias = md.mi_state.sign_bias
            fwds = [n for n in names if not bias[n]]
            bwds = [n for n in names if bias[n]]
            if fwds and bwds:
                pair = (fwds[0], bwds[-1])
                names = [pair[0], pair[1]] + [n for n in names
                                              if n not in pair]
                self.comp_pair = pair
        self.ref_names = names
        self.modes = np.array(DEVICE_MODES, np.int32)
        self.stats = {}
        self._commit_ctx = None
        pvals = md.cdfs.partition[0]
        self.part_costs = {blk: cdf_costs(pvals[_BSL_CTX[blk] * 4])
                           for blk in (16, 32, 64)}
        sk = cdf_costs(md.cdfs.skip[0][0])
        self.skip0, self.skip1 = int(sk[0]), int(sk[1])
        self.psy_fixed = int(round(getattr(md, "psy_factor", 0.0) * 256))
        self.tx_select = bool(getattr(fr, "tx_mode_select", False))
        self._txd_tabs = None
        self._pending = None

    def analyze_dispatch(self) -> None:
        """Queue the fused inter lattice of this frame without waiting for
        it; analyze() fetches the result."""
        src = self.pad_src(self.md.pctx[0].src)
        hp, wp = src.shape
        self._hp, self._wp = hp, wp

        def pad(p):
            h, w = p.shape
            if h != hp or w != wp:
                p = np.pad(p, ((0, hp - h), (0, wp - w)), mode="edge")
            return p

        a_bd = 8 if _hbd8(self) else self.seq.bit_depth
        refs = np.stack([pad(np.ascontiguousarray(self.md.ref_planes[n][0]))
                         for n in self.ref_names])
        if a_bd != self.seq.bit_depth:
            src = src >> (self.seq.bit_depth - 8)
            refs = refs >> (self.seq.bit_depth - 8)
        qp = qp_row_for(self.fr.base_q_idx, self.fr.delta_q_y_dc, 0, a_bd)
        self._pending = inter_analysis(
            upload_lumas(src, a_bd, self.device),
            upload_lumas(refs, a_bd, self.device), qp, self.rd_row(),
            depths=self.DEPTHS, bit_depth=a_bd, psy=self.psy_fixed > 0,
            kernels=self.kernels)

    def analyze(self, packed_row: np.ndarray | None = None) -> None:
        """Pull the packed inter lattice (dispatching now if needed)."""
        if packed_row is None:
            if self._pending is None:
                self.analyze_dispatch()
            packed_row = self._pending.cpu().numpy()
            self._pending = None
        self.stats = unpack_inter_analysis(packed_row, self._hp, self._wp,
                                           self.DEPTHS)

    def _leaf_j(self, blk: int, by: int, bx: int, rdmult: int):
        s = self.stats[blk]
        j = int(s["j"][by, bx])
        cand = int(s["cand"][by, bx])
        if cand < CAND_INTER0:
            return j, int(self.modes[cand])
        if cand >= CAND_COMP_NEW:
            if cand == CAND_COMP_ZERO:
                mv0 = mv1 = (0, 0)
            else:
                mv0 = (int(s["mv_y"][by, bx]) * 8,
                       int(s["mv_x"][by, bx]) * 8)
                mv1 = (int(s["mv_y1"][by, bx]) * 8,
                       int(s["mv_x1"][by, bx]) * 8)
            return j, ("comp", self.comp_pair, mv0, mv1)
        ri, is_zero = divmod(cand - CAND_INTER0, 2)
        mv = (0, 0) if is_zero else (int(s["mv_y"][by, bx]) * 8,
                                     int(s["mv_x"][by, bx]) * 8)
        return j, ("inter", self.ref_names[ri], mv)
