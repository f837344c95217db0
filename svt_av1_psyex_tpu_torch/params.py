"""The encoder's device state: its constant tables.

The encoder has no learned weights. What lives on the device besides
the frames is a handful of constant tables, built here from the numpy
sources of the host tier (bitstream/tables.py, ops/txfm.py through
device/matdct.py), which are the JAX package's, so that both packages
compute from identical inputs:

* fwd_mats / inv_mats: the probed DCT matrices (device/matdct.py) for
  n in {4, 8, 16, 32, 64};
* scan_pos: the default-scan position of each row-major coefficient,
  for cn in {4, 8, 16, 32} (the gather-free eob of the fullloop kernel);
* sm_weights: the SMOOTH predictor weights for blk in {8, 16, 32, 64};
* had8: the 8x8 Hadamard matrix of the psy SA8D energy.

The per-frame rows (qp_row, rd_row) are made on the host for each frame:
device.intra.qp_row_for and codec.md_device.DeviceIntraMD.rd_row.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bitstream.tables import get as table_get
from .bitstream.tables import scan_table
from .device.matdct import fwd_mats, inv_mats

TRANSFORM_SIZES = (4, 8, 16, 32, 64)
BLOCK_SIZES = (8, 16, 32, 64)


@lru_cache(maxsize=None)
def scan_pos(cn: int) -> np.ndarray:
    """(cn^2,) int32: default-scan position of each row-major
    coefficient (counterpart of ops/pallas/fullloop.py scan_pos)."""
    tx = {4: 0, 8: 1, 16: 2, 32: 3}[cn]
    scan = scan_table(tx, "default").astype(np.int64)
    pos = np.empty(cn * cn, np.int32)
    pos[scan] = np.arange(cn * cn, dtype=np.int32)
    return pos


@lru_cache(maxsize=None)
def had8() -> np.ndarray:
    """(8, 8) float32 Sylvester Hadamard matrix."""
    h = np.array([[1]], np.int64)
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


def reference_numpy() -> dict:
    """The constant tables as numpy arrays."""
    sm = table_get("sm_weight_arrays")
    return {
        "fwd_mats": {n: fwd_mats(n) for n in TRANSFORM_SIZES},
        "inv_mats": {n: inv_mats(n) for n in TRANSFORM_SIZES},
        "scan_pos": {cn: scan_pos(cn) for cn in (4, 8, 16, 32)},
        "sm_weights": {blk: np.asarray(sm[blk: 2 * blk], np.int32)
                       for blk in BLOCK_SIZES},
        "had8": had8(),
    }


@lru_cache(maxsize=None)
def _constants(device: str) -> dict:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ref = reference_numpy()
    return {
        "fwd_mats": {n: tuple(put(m) for m in ms)
                     for n, ms in ref["fwd_mats"].items()},
        "inv_mats": {n: tuple(put(m) for m in ms)
                     for n, ms in ref["inv_mats"].items()},
        "scan_pos": {cn: put(p) for cn, p in ref["scan_pos"].items()},
        "sm_weights": {blk: put(w) for blk, w in ref["sm_weights"].items()},
        "had8": put(ref["had8"]),
    }


def reference_constants(device) -> dict:
    """The constant tables as tensors on `device` (made once per device
    and shared: callers must not write to them)."""
    return _constants(str(torch.device(device)))
