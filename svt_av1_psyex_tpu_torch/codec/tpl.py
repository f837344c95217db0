"""TPL's device dispenser for the port (counterpart of
svt_av1_psyex_tpu/codec/tpl.py `run_tpl`).

The host synthesizer, r0/beta and the TPL q ladder are the JAX package's
(numpy-only at import) and are re-exported here; only `run_tpl`, which
calls into the device tier, is the port's. Unlike the JAX package it
does not pad the group to a bucket length: the padding only kept one
compiled TPU program, and since the dispenser runs forward, repeated
tail frames never reach the rows that are read. The cap at
TPL_MAX_FRAMES frames stays, because it changes the output.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psyex_tpu.codec.tpl import (
    TplModel,
    crf_qindex_calc,
    r0_adjust_factor,
    reduced_tpl_group_level,
    uses_qstep_calc,
)

from ..device.intra import qp_row_for
from ..device.me import _pad64
from ..device.tpl import tpl_group_stats
from ..runtime import resolve_device
from .md_device import upload_lumas

__all__ = ["TPL_MAX_FRAMES", "TplModel", "crf_qindex_calc",
           "r0_adjust_factor", "reduced_tpl_group_level", "run_tpl",
           "uses_qstep_calc"]

# groups longer than this drop their tail lookahead (the JAX package's
# largest bucket, codec/tpl.py:407,445-449)
TPL_MAX_FRAMES = 32


def run_tpl(group_lumas: list, base_qindex: int, bit_depth: int = 8,
            compute_rate: bool = False, *, device,
            kernels: str = "hand") -> TplModel:
    """Pad the group's source lumas to 64, run the dispenser on `device`
    through `kernels`, build the host model."""
    dev = resolve_device(device)
    srcs = np.stack([_pad64(np.asarray(p))
                     for p in group_lumas[:TPL_MAX_FRAMES]])
    qp = qp_row_for(int(np.clip(base_qindex, 1, 255)), 0, 0, bit_depth)
    stats = tpl_group_stats(upload_lumas(srcs, bit_depth, dev), qp,
                            bit_depth=bit_depth, kernels=kernels)
    return TplModel(stats.cpu().numpy(), base_qindex, bit_depth,
                    compute_rate=compute_rate)
