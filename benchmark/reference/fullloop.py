"""Plain PyTorch reference of the fullloop kernel's work.

A frozen copy of the arithmetic of the port's ops/fullloop_ref.py (the
analysis tier of the JAX package's device/intra.py): separable float32
DCTs as two matrix products, the analysis quantizer, the integer
dequant, the inverse transform, and per block the distortion
sum (x - inv)^2, the rate proxy (bits << 9), the eob (default-scan
position + 1) and sse = sum x^2.

It imports nothing of the port: the transform matrices, scans and
weights are AV1's, made in tables.py from their definitions (the linear
maps of the specification's DCT networks, n = 4 .. 64, in dct.py; the
default-scan position of each coefficient; the SMOOTH weights; the 8x8
Hadamard matrix).
`precision="tf32"` computes the matrix products as TF32 tensor cores
do (operands rounded to TF32, products summed in float32), on any
device: the control, one step below the float32 that the analysis
states.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .tables import numpy_tables

# rate-proxy constants (bits<<9)
RATE_NZ = 1229
RATE_LOG2 = 614
RATE_ZERO = 154
RATE_EOB = 1946


@lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in numpy_tables().items()}


def tables(device) -> dict:
    return _tables(str(torch.device(device)))


class fp32_matmul:
    """Context: float32 matrix products in full float32 (no TF32),
    restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits,
    ties away from zero), as a tensor core reads its operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32; with precision "tf32" the operands are rounded
    to TF32 first and the products summed in float32, as TF32 tensor
    cores do, on any device."""
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "fp32":
        raise ValueError(f"precision must be fp32 or tf32, not "
                         f"{precision!r}")
    with fp32_matmul():
        return a @ b


def sep2d(x: torch.Tensor, mc: torch.Tensor, mr: torch.Tensor,
          precision: str = "fp32"):
    """out[b,i,l] = sum_{j,k} mc[i,j] x[b,j,k] mr[l,k]: the row pass,
    then the column pass, each one float32 product."""
    b, n, _ = x.shape
    cn_r, cn_c = mr.shape[0], mc.shape[0]
    t = mm(x.reshape(b * n, n), mr.T, precision)
    t = t.reshape(b, n, cn_r).transpose(1, 2).reshape(b * cn_r, n)
    o = mm(t, mc.T, precision)
    return o.reshape(b, cn_r, cn_c).transpose(1, 2)


def fwd_dct2d(resid: torch.Tensor, n: int, precision: str = "fp32"):
    t = tables(resid.device)
    return sep2d(resid.to(torch.float32), t[f"fwd_col_{n}"],
                 t[f"fwd_row_{n}"], precision)


def inv_dct2d(dq: torch.Tensor, n: int, precision: str = "fp32"):
    t = tables(dq.device)
    return sep2d(dq.to(torch.float32), t[f"inv_col_{n}"], t[f"inv_row_{n}"],
                 precision)


def quantize(coeffs: torch.Tensor, qp6, log_scale: int):
    """Analysis quantizer: -> (qabs, dq) int32. qp6 = deq_dc, deq_ac,
    rnd_dc, rnd_ac, zbin_dc, zbin_ac (rnd/zbin pre-shifted)."""
    cn = coeffs.shape[-1]
    dev = coeffs.device
    deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac = (float(v)
                                                       for v in qp6)
    is_dc = torch.zeros((cn, cn), dtype=torch.bool, device=dev)
    is_dc[0, 0] = True

    def pick(dc, ac):
        return torch.where(is_dc, torch.tensor(dc, device=dev),
                           torch.tensor(ac, device=dev))

    deq, rnd, zbin = (pick(deq_dc, deq_ac), pick(rnd_dc, rnd_ac),
                      pick(zbin_dc, zbin_ac))
    abs_c = coeffs.abs()
    scale = float(1 << log_scale) / deq
    qabs = torch.floor((abs_c + rnd) * scale).to(torch.int32)
    qabs = torch.where(abs_c >= zbin, qabs.clamp_min(0),
                       torch.zeros_like(qabs))
    sign = torch.where(coeffs < 0, -1, 1).to(torch.int32)
    dq = sign * ((qabs * deq.to(torch.int32)) >> log_scale)
    return qabs, dq


def rate_proxy(qabs: torch.Tensor, spos: torch.Tensor):
    """-> (rate int32 bits<<9, eob int32), both (B,)."""
    b, cn = qabs.shape[0], qabs.shape[-1]
    flat = qabs.reshape(b, cn * cn)
    nz = flat != 0
    eob = torch.where(nz, spos.to(torch.int32) + 1,
                      torch.zeros((), dtype=torch.int32,
                                  device=flat.device)).amax(dim=1)
    nnz = nz.sum(dim=1, dtype=torch.int32)
    log2q = torch.log2(1.0 + flat.to(torch.float32))
    slog = torch.where(nz, log2q, torch.zeros_like(log2q)).sum(dim=1)
    rate = (RATE_NZ * nnz
            + (RATE_LOG2 * slog).to(torch.int32)
            + RATE_ZERO * (eob - nnz).clamp_min(0)
            + (RATE_EOB * torch.log2(1.0 + eob.to(torch.float32)))
            .to(torch.int32))
    return rate, eob


def fullloop(resid: torch.Tensor, qp6, n: int, log_scale: int,
             want_inv: bool = False, precision: str = "fp32"):
    """resid (B, n, n) -> (metrics (B, 8) f32: dist, rate, eob, sse, 0..,
    inv (B, n, n) f32 or None)."""
    x = resid.to(torch.float32)
    coeffs = fwd_dct2d(x, n, precision)
    qabs, dq = quantize(coeffs, qp6, log_scale)
    inv = inv_dct2d(dq, n, precision)
    err = x - inv
    metrics = torch.zeros((x.shape[0], 8), dtype=torch.float32,
                          device=x.device)
    metrics[:, 0] = (err * err).sum(dim=(1, 2))
    rate, eob = rate_proxy(
        qabs, tables(x.device)[f"scan_pos_{min(n, 32)}"])
    metrics[:, 1] = rate.to(torch.float32)
    metrics[:, 2] = eob.to(torch.float32)
    metrics[:, 3] = (x * x).sum(dim=(1, 2))
    return metrics, (inv if want_inv else None)
