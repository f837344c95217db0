"""The plain PyTorch version of the fullloop kernel.

Same signature and outputs as the JAX package's Pallas kernel
(svt_av1_psyex_tpu/ops/pallas/fullloop.py `fullloop`), computed the
way its jnp tier does (svt_av1_psyex_tpu/device/intra.py
_fwd_dct2d -> _quantize_analysis -> _rate_dist, via matdct._sep2d):
separable float32 transforms, the analysis quantizer, the integer
dequant, the inverse transform, and per block dist = sum (x - inv)^2,
the rate proxy (bits<<9), eob (default-scan position + 1) and
sse = sum x^2.

It serves three callers: the CPU path of the port, the blk-64 tier on
every device (the Pallas kernel, too, stops at 32), and chip_smoke.py,
which holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch

from ..device.matdct import fwd_dct2d_mat, inv_dct2d_mat
from ..params import reference_constants

# rate-proxy constants (bits<<9), fit against the exact coefficient
# rate counter; must match svt_av1_psyex_tpu/device/intra.py
RATE_NZ = 1229      # per nonzero coefficient
RATE_LOG2 = 614     # per log2(1+|q|) of each nonzero
RATE_ZERO = 154     # per zero coefficient before eob (scan order)
RATE_EOB = 1946     # per log2(1+eob)


def quantize_analysis(coeffs: torch.Tensor, qp6, log_scale: int):
    """Analysis-tier quantize_b: float32 reciprocal of the dequant step.
    coeffs (B, cn, cn) f32; qp6 = deq_dc, deq_ac, rnd_dc, rnd_ac,
    zbin_dc, zbin_ac (rnd/zbin pre-shifted by log_scale).
    -> (qabs int32, dq int32), both (B, cn, cn)."""
    cn = coeffs.shape[-1]
    dev = coeffs.device
    deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac = (float(v)
                                                       for v in qp6)
    is_dc = torch.zeros((cn, cn), dtype=torch.bool, device=dev)
    is_dc[0, 0] = True

    def pick(dc, ac):
        return torch.where(is_dc, torch.tensor(dc, device=dev),
                           torch.tensor(ac, device=dev))

    deq, rnd, zbin = pick(deq_dc, deq_ac), pick(rnd_dc, rnd_ac), \
        pick(zbin_dc, zbin_ac)
    abs_c = coeffs.abs()
    scale = float(1 << log_scale) / deq
    qabs = torch.floor((abs_c + rnd) * scale).to(torch.int32)
    qabs = torch.where(abs_c >= zbin, qabs.clamp_min(0),
                       torch.zeros_like(qabs))
    sign = torch.where(coeffs < 0, -1, 1).to(torch.int32)
    dq = sign * ((qabs * deq.to(torch.int32)) >> log_scale)
    return qabs, dq


def rate_proxy(qabs: torch.Tensor, spos: torch.Tensor):
    """Coefficient-rate proxy per block. qabs (B, cn, cn) int32; spos
    (cn^2,) default-scan position of each row-major coefficient.
    -> (rate int32 bits<<9, eob int32), both (B,)."""
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


def fullloop_ref(resid: torch.Tensor, qp6, n: int, log_scale: int,
                 want_inv: bool = False):
    """resid (B, n, n) int32/f32; qp6 6 host numbers (see
    quantize_analysis). -> (metrics (B, 8) f32, inv (B, n, n) f32 or
    None). Metrics columns: 0 dist, 1 rate (bits<<9), 2 eob, 3 sse,
    4-7 zero."""
    consts = reference_constants(resid.device)
    b = resid.shape[0]
    x = resid.to(torch.float32)
    coeffs = fwd_dct2d_mat(x, n, consts)
    qabs, dq = quantize_analysis(coeffs, qp6, log_scale)
    inv = inv_dct2d_mat(dq, n, consts)
    err = x - inv
    dist = (err * err).sum(dim=(1, 2))
    sse = (x * x).sum(dim=(1, 2))
    rate, eob = rate_proxy(qabs, consts["scan_pos"][min(n, 32)])
    metrics = torch.zeros((b, 8), dtype=torch.float32, device=x.device)
    metrics[:, 0] = dist
    metrics[:, 1] = rate.to(torch.float32)
    metrics[:, 2] = eob.to(torch.float32)
    metrics[:, 3] = sse
    return metrics, (inv if want_inv else None)
