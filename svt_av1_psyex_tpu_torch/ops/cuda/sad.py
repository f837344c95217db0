"""Launcher of the hand-written Hopper sad_lattice kernel (sad.cu).

Replaces the Pallas TPU kernel svt_av1_psyex_tpu/ops/pallas/sad.py
`sad_lattice`, with the same signature and output. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain PyTorch
version (ops/sad_ref.py), because there is no kernel there. `launches`
counts the kernel launches, so that a run can show that its main path
went through the kernel (`warm_launches` those of a warm-up thread:
ops/cuda/__init__.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..sad_ref import BLK, NOFF, SPAN, sad_lattice_ref
from . import build, is_warming

launches = 0
warm_launches = 0

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("sad")
        vp = ctypes.c_void_p
        lib.svt_sad_launch.argtypes = [vp, vp, ctypes.c_longlong, vp, vp]
        lib.svt_sad_launch.restype = ctypes.c_int
        lib.svt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.svt_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def sad_lattice(tiles: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """tiles (nSB, 64, 64) int32, wins (nSB, 80, 80) int32 (gathered with
    spec MC edge clamping) -> (nSB, 289, 8, 8) int32 SAD lattice, offset
    index dy * 17 + dx."""
    global launches, warm_launches
    if tiles.device.type == "cpu" and wins.device.type == "cpu":
        return sad_lattice_ref(tiles, wins)
    if tiles.device.type != "cuda" or wins.device != tiles.device:
        raise ValueError(f"sad_lattice: tiles on {tiles.device} and wins on "
                         f"{wins.device}; both must be on one CUDA device")
    nsb = tiles.shape[0]
    if (tiles.dim() != 3 or tuple(tiles.shape[1:]) != (BLK, BLK)
            or wins.dim() != 3 or tuple(wins.shape) != (nsb, SPAN, SPAN)):
        raise ValueError(f"sad_lattice: tiles must be (nSB, {BLK}, {BLK}) "
                         f"and wins (nSB, {SPAN}, {SPAN}), got "
                         f"{tuple(tiles.shape)} and {tuple(wins.shape)}")
    if tiles.dtype != torch.int32 or wins.dtype != torch.int32:
        raise TypeError(f"sad_lattice: tiles and wins must be int32, got "
                        f"{tiles.dtype} and {wins.dtype}")
    if not (tiles.is_contiguous() and wins.is_contiguous()):
        raise ValueError("sad_lattice: tiles and wins must be contiguous")
    out = torch.empty((nsb, NOFF, 8, 8), dtype=torch.int32,
                      device=tiles.device)
    if nsb == 0:
        return out
    lib = _lib()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = lib.svt_sad_launch(tiles.data_ptr(), wins.data_ptr(), nsb,
                                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("sad_lattice kernel launch failed: "
                           + lib.svt_cuda_error_string(err).decode())
    if is_warming():
        warm_launches += 1
    else:
        launches += 1
    return out
