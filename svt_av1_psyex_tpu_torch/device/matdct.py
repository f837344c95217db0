"""Matmul-form DCTs for the analysis tier (counterpart of
svt_av1_psyex_tpu/device/matdct.py).

The AV1 integer transforms are butterfly networks whose only
nonlinearities are per-stage roundings; their rounding-free linear map
is a dense (n, n) matrix, probed here from the numpy networks in
ops/txfm.py. The analysis tier only decides (the
conformant commit requantizes exactly in C), so it runs the transforms
as float32 matrix products. `_sep2d` is the blk-64 path and the plain
version of the fullloop kernel's transforms. On the card it is a plain
float32 `torch.matmul` (runtime.resolve_device turns TF32 off). On the
CPU it is the same float32 FMA chains evaluated elementwise in a fixed
order (`_fma_chain`), so that one input has one answer: the CPU path is
what holds the port's streams equal to the JAX package's, and a BLAS
call there may pick its kernels by threads and load.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import txfm as txfm_ref

_AMP = 1 << 20


@lru_cache(maxsize=None)
def dct1d_mat(n: int, cos_bit: int, inverse: bool) -> np.ndarray:
    """The (n, n) float64 linear map L of the 1D network: net(v) == L @ v
    (rounding-free). Probed column by column at amplitude 2^20."""
    x = np.eye(n, dtype=np.int64) * _AMP
    y = txfm_ref._run_1d("dct", n, x, cos_bit, 62, inverse)
    # row i of y = net(e_i) = L @ e_i = column i of L
    return y.astype(np.float64).T / _AMP


@lru_cache(maxsize=None)
def fwd_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(F_col (cn, n), F_row (cn, n)), shift gains folded in;
    coeffs[:cn,:cn] = F_col @ resid @ F_row.T (cn = min(n, 32))."""
    i = int(np.log2(n)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[i][i]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[i][i]
    s0, s1, s2 = txfm_ref._FWD_SHIFT[(n, n)]
    cn = min(n, 32)
    fc = dct1d_mat(n, cb_col, False)[:cn] * (2.0 ** (s0 + s1))
    fr = dct1d_mat(n, cb_row, False)[:cn] * (2.0 ** s2)
    return (np.ascontiguousarray(fc, np.float32),
            np.ascontiguousarray(fr, np.float32))


@lru_cache(maxsize=None)
def inv_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(G_col (n, cn), G_row (n, cn)); resid = G_col @ dq @ G_row.T."""
    s0, s1 = txfm_ref._INV_SHIFT[(n, n)]
    cn = min(n, 32)
    li = dct1d_mat(n, txfm_ref.INV_COS_BIT, True)
    gc = li[:, :cn] * (2.0 ** s1)
    gr = li[:, :cn] * (2.0 ** s0)
    return (np.ascontiguousarray(gc, np.float32),
            np.ascontiguousarray(gr, np.float32))


def _fma_chain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m.T for float32 x (M, K), m (N, K): each output the float32
    FMA chain over k = 0..K-1 from 0, which is what sgemm computes at
    these widths, evaluated one k at a time. A product of two float32
    numbers is exact in float64, so each step is fmaf: one rounding to
    float32 of the exact sum (up to a float64 rounding ~2^-29 times
    rarer). No BLAS and no threads decide the order."""
    xt = x.double().T.contiguous()        # (K, M): one row per step
    mt = m.double().T.contiguous()        # (K, N)
    acc = torch.zeros((x.shape[0], m.shape[0]), dtype=torch.float64)
    out = torch.empty(acc.shape, dtype=torch.float32)
    for k in range(x.shape[1]):
        acc.addcmul_(xt[k, :, None], mt[k])
        acc.copy_(out.copy_(acc))         # round to float32
    return out


def _sep2d(x: torch.Tensor, mc: torch.Tensor,
           mr: torch.Tensor) -> torch.Tensor:
    """out[b,i,l] = sum_{j,k} mc[i,j] x[b,j,k] mr[l,k]: the row pass,
    then the column pass, each one flat float32 product with M = B*n
    (the reference's operation order)."""
    b, n, _ = x.shape
    cn_r, cn_c = mr.shape[0], mc.shape[0]
    mul = _fma_chain if x.device.type == "cpu" else (lambda a, m: a @ m.T)
    t = mul(x.reshape(b * n, n), mr)
    t = t.reshape(b, n, cn_r).transpose(1, 2).reshape(b * cn_r, n)
    o = mul(t, mc)
    return o.reshape(b, cn_r, cn_c).transpose(1, 2)


def fwd_dct2d_mat(resid: torch.Tensor, n: int, consts: dict) -> torch.Tensor:
    """(B, n, n) -> (B, cn, cn) float32 DCT_DCT coefficients (analysis).
    consts: params.reference_constants(resid.device)."""
    fc, fr = consts["fwd_mats"][n]
    return _sep2d(resid.to(torch.float32), fc, fr)


def inv_dct2d_mat(dq: torch.Tensor, n: int, consts: dict) -> torch.Tensor:
    """(B, cn, cn) dequantized coeffs -> (B, n, n) float32 residual."""
    gc, gr = consts["inv_mats"][n]
    return _sep2d(dq.to(torch.float32), gc, gr)
