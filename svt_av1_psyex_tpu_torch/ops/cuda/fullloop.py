"""Launcher of the hand-written Hopper fullloop kernel (fullloop.cu).

Replaces the Pallas TPU kernel svt_av1_psyex_tpu/ops/pallas/fullloop.py
`fullloop`, with the same signature and outputs. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain PyTorch
version (ops/fullloop_ref.py), because there is no kernel there.
`launches` counts the kernel launches, so that a run can show that its
main path went through the kernel (`warm_launches` those of a warm-up
thread: ops/cuda/__init__.py).

The kernel reads its transform matrices from constant memory: they are
written once per device and size, at the first launch there, from the
same float32 tables the plain version uses (params.reference_numpy).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...params import reference_numpy
from ..fullloop_ref import fullloop_ref
from . import build, is_warming

SIZES = (4, 8, 16, 32)

launches = 0
warm_launches = 0

_bound = None
_ready: set = set()   # (device index, n) whose constants are written


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("fullloop")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.svt_fullloop_launch.argtypes = (
            [vp, i, ctypes.c_longlong, i] + [f] * 6 + [i, vp, vp, vp])
        lib.svt_fullloop_launch.restype = i
        lib.svt_fullloop_set_constants.argtypes = [i] + [vp] * 5
        lib.svt_fullloop_set_constants.restype = i
        lib.svt_cuda_error_string.argtypes = [i]
        lib.svt_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fullloop kernel {what} failed: "
                           + lib.svt_cuda_error_string(err).decode())


def _set_constants(lib, dev: torch.device, n: int) -> None:
    ref = reference_numpy()
    arrs = [np.ascontiguousarray(a) for a in
            (*ref["fwd_mats"][n], *ref["inv_mats"][n], ref["scan_pos"][n])]
    with torch.cuda.device(dev):
        _check(lib, lib.svt_fullloop_set_constants(
            n, *(a.ctypes.data for a in arrs)), "constant upload")
    _ready.add((dev.index, n))


def fullloop(resid: torch.Tensor, qp6, n: int, log_scale: int,
             want_inv: bool = False):
    """resid (B, n, n) int32/f32, n in {4, 8, 16, 32}; qp6 6 host numbers
    = deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac (rnd/zbin
    pre-shifted by log_scale). -> (metrics (B, 8) f32, inv (B, n, n) f32
    or None). Metrics columns: 0 dist, 1 rate (bits<<9), 2 eob, 3 sse."""
    global launches, warm_launches
    if resid.device.type == "cpu":
        return fullloop_ref(resid, qp6, n, log_scale, want_inv)
    if resid.device.type != "cuda":
        raise ValueError(f"fullloop: unsupported device {resid.device}")
    if n not in SIZES:
        raise ValueError(f"fullloop kernel takes n in {SIZES}, not {n}")
    if resid.dim() != 3 or tuple(resid.shape[1:]) != (n, n):
        raise ValueError(f"fullloop: resid must be (B, {n}, {n}), "
                         f"got {tuple(resid.shape)}")
    if resid.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"fullloop: resid must be int32 or float32, "
                        f"got {resid.dtype}")
    if not resid.is_contiguous():
        raise ValueError("fullloop: resid must be contiguous")
    qp = [float(v) for v in qp6]
    if len(qp) != 6:
        raise ValueError("fullloop: qp6 must hold 6 numbers")
    b = resid.shape[0]
    dev = resid.device
    metrics = torch.empty((b, 8), dtype=torch.float32, device=dev)
    inv = (torch.empty((b, n, n), dtype=torch.float32, device=dev)
           if want_inv else None)
    if b == 0:
        return metrics, inv
    lib = _lib()
    if (dev.index, n) not in _ready:
        _set_constants(lib, dev, n)
    with torch.cuda.device(dev):
        err = lib.svt_fullloop_launch(
            resid.data_ptr(), int(resid.dtype == torch.float32), b, n, *qp,
            int(log_scale), metrics.data_ptr(),
            inv.data_ptr() if want_inv else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, "launch")
    if is_warming():
        warm_launches += 1
    else:
        launches += 1
    return metrics, inv
