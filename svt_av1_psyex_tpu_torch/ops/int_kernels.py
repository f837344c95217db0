"""Exact integer transforms, the integer analysis quantizer, the integer
analysis full loop and the batched open-loop intra analysis, in PyTorch.

Counterpart of svt_av1_psyex_tpu/ops/jax_kernels.py. The 1D networks of
ops/txfm.py (bitstream/tables/txfm_networks.json) run as integer
`index_select` gathers plus weighted adds over a (batch, N) int32 tensor,
on the device of their input, so that the same exact integers come out
of the card and the CPU. int32 holds the encoder's coefficient ranges
(the C stage-range asserts bound everything below 2^31); where the JAX
functions' int32 products wrap (quantize_jnp's `tmp5 * quant` at small
q), torch's int32 products wrap the same way. CUDA has no int32 matmul,
and a float matmul would round, hence the gathers.

`fullloop_int` is the fullloop kernel's contract computed through these
networks: the chain of the JAX package's device/intra.py with
SVT_TPU_INTDCT=1 (_fwd_dct2d -> _quantize_analysis -> _rate_dist). The
port's device/intra.py, device/inter.py and device/tpl.py take it for
every block size when their `_USE_MATDCT` flag is off.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream.tables import get as table_get
from ..codec.constants import TxType
from ..params import reference_constants
from . import txfm as txfm_ref
from .fullloop_ref import quantize_analysis, rate_proxy


@lru_cache(maxsize=None)
def _stage_consts(net_name: str, cos_bit: int, device: str) -> tuple:
    """Per stage of a 1D network: gather indices and int32 weights of
    both operands, and the masks of the rounded (butterfly) and clamped
    (raw) lanes, as tensors on `device`; plus whether any lane clamps."""
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    net = txfm_ref._load_nets()[net_name]
    stages = []
    for src0, w0s, src1, w1s, kind in net.stages:
        do_clamp = np.array([k == "raw" for k in kind])
        stages.append((put(src0, torch.int64),
                       put(net._weights(w0s, cos_bit), torch.int32),
                       put(src1, torch.int64),
                       put(net._weights(w1s, cos_bit), torch.int32),
                       put([k == "btf" for k in kind], torch.bool),
                       put(do_clamp, torch.bool), bool(do_clamp.any())))
    return tuple(stages)


def _run_net(net_name: str, x: torch.Tensor, cos_bit: int,
             clamp_bit: int) -> torch.Tensor:
    """x: (batch, N) int32."""
    rnd = 1 << (cos_bit - 1)
    for src0, w0, src1, w1, is_btf, do_clamp, any_clamp in _stage_consts(
            net_name, cos_bit, str(x.device)):
        y = x.index_select(1, src0) * w0 + x.index_select(1, src1) * w1
        y = torch.where(is_btf, (y + rnd) >> cos_bit, y)
        if clamp_bit > 0 and any_clamp:
            y = torch.where(do_clamp, y.clamp(-(1 << (clamp_bit - 1)),
                                              (1 << (clamp_bit - 1)) - 1), y)
        x = y
    return x


def _identity(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 4:
        return (x * txfm_ref.NEW_SQRT2 + 2048) >> 12
    if n == 8:
        return x * 2
    if n == 16:
        return (x * 2 * txfm_ref.NEW_SQRT2 + 2048) >> 12
    if n == 32:
        return x * 4
    raise ValueError(n)


def _adst4(x: torch.Tensor, bit: int, inverse: bool) -> torch.Tensor:
    sp = [int(v) for v in txfm_ref.sinpi_arr(bit)]
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    rnd = 1 << (bit - 1)
    if inverse:
        s0 = sp[1] * x0 + sp[4] * x2 + sp[2] * x3
        s1 = sp[2] * x0 - sp[1] * x2 - sp[4] * x3
        s2 = sp[3] * ((x0 - x2) + x3)
        s3 = sp[3] * x1
        o0, o1, o2, o3 = s0 + s3, s1 + s3, s2, (s0 + s1) - s3
    else:
        s0 = sp[1] * x0 + sp[2] * x1 + sp[4] * x3
        s1 = sp[3] * ((x0 + x1) - x3)
        s2 = sp[4] * x0 - sp[1] * x1 + sp[2] * x3
        s3 = sp[3] * x2
        o0, o1, o2, o3 = s0 + s3, s1, s2 - s3, (s2 - s0) + s3
    return torch.stack([(o + rnd) >> bit for o in (o0, o1, o2, o3)], dim=1)


def _round_shift(x: torch.Tensor, bit: int) -> torch.Tensor:
    if bit == 0:
        return x
    if bit < 0:
        return x << (-bit)
    return (x + (1 << (bit - 1))) >> bit


def _run_1d(kind: str, n: int, x: torch.Tensor, cos_bit: int,
            clamp_bit: int, inverse: bool) -> torch.Tensor:
    if kind == "identity":
        return _identity(x, n)
    if kind == "adst" and n == 4:
        return _adst4(x, cos_bit, inverse)
    prefix = ("i" if inverse else "f") + ("dct" if kind == "dct" else "adst")
    return _run_net(f"{prefix}{n}", x, cos_bit, clamp_bit if inverse else 0)


def forward_txfm2d_int(residual: torch.Tensor, tx_w: int, tx_h: int,
                       tx_type: int, bit_depth: int = 8) -> torch.Tensor:
    """residual (B, h, w) int -> (B, min(h, 32), min(w, 32)) int32: the
    exact forward transform of ops/txfm.forward_txfm2d (64-point sizes
    keep their top-left 32x32)."""
    col_kind, row_kind, ud_flip, lr_flip = txfm_ref._TX1D[TxType(tx_type)]
    shift = txfm_ref._FWD_SHIFT[(tx_w, tx_h)]
    wi = int(np.log2(tx_w)) - 2
    hi = int(np.log2(tx_h)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[wi][hi]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[wi][hi]

    b = residual.shape[0]
    x = residual.to(torch.int32)
    if ud_flip:
        x = x.flip(1)
    cols = x.transpose(1, 2).reshape(b * tx_w, tx_h)
    cols = _round_shift(cols, -shift[0])
    cols = _run_1d(col_kind, tx_h, cols, cb_col, 0, inverse=False)
    cols = _round_shift(cols, -shift[1])
    buf = cols.reshape(b, tx_w, tx_h).transpose(1, 2)
    if lr_flip:
        buf = buf.flip(2)
    rows = buf.reshape(b * tx_h, tx_w)
    rows = _run_1d(row_kind, tx_w, rows, cb_row, 0, inverse=False)
    rows = _round_shift(rows, -shift[2])
    if txfm_ref._rect_ratio1(tx_w, tx_h):
        rows = _round_shift(rows * txfm_ref.NEW_SQRT2, txfm_ref.SQRT2_BITS)
    out = rows.reshape(b, tx_h, tx_w)
    return out[:, : min(tx_h, 32), : min(tx_w, 32)]


def inverse_txfm2d_int(coeffs: torch.Tensor, tx_w: int, tx_h: int,
                       tx_type: int, bit_depth: int = 8) -> torch.Tensor:
    """coeffs (B, min(h, 32), min(w, 32)) int -> residual (B, h, w) int32:
    the exact inverse transform of ops/txfm.inverse_txfm2d, with its
    clamps at `bit_depth`."""
    col_kind, row_kind, ud_flip, lr_flip = txfm_ref._TX1D[TxType(tx_type)]
    shift = txfm_ref._INV_SHIFT[(tx_w, tx_h)]
    opt_row = {8: 16, 10: 18, 12: 20}[bit_depth]
    opt_col = {8: 16, 10: 16, 12: 18}[bit_depth]
    b = coeffs.shape[0]
    cw, ch = min(tx_w, 32), min(tx_h, 32)
    x = coeffs.to(torch.int32)
    if cw != tx_w or ch != tx_h:
        x = torch.nn.functional.pad(x, (0, tx_w - cw, 0, tx_h - ch))
    rows = x.reshape(b * tx_h, tx_w)
    if txfm_ref._rect_ratio1(tx_w, tx_h):
        rows = _round_shift(rows * txfm_ref.NEW_INV_SQRT2,
                            txfm_ref.SQRT2_BITS)
    rows = rows.clamp(-(1 << (bit_depth + 7)), (1 << (bit_depth + 7)) - 1)
    rows = _run_1d(row_kind, tx_w, rows, txfm_ref.INV_COS_BIT, opt_row,
                   inverse=True)
    rows = _round_shift(rows, -shift[0])
    buf = rows.reshape(b, tx_h, tx_w)
    if lr_flip:
        buf = buf.flip(2)
    cols = buf.transpose(1, 2).reshape(b * tx_w, tx_h)
    cb = max(bit_depth + 6, 16)
    cols = cols.clamp(-(1 << (cb - 1)), (1 << (cb - 1)) - 1)
    cols = _run_1d(col_kind, tx_h, cols, txfm_ref.INV_COS_BIT, opt_col,
                   inverse=True)
    cols = _round_shift(cols, -shift[1])
    res = cols.reshape(b, tx_w, tx_h).transpose(1, 2)
    if ud_flip:
        res = res.flip(1)
    return res


def quantize_int(coeffs: torch.Tensor, pq_dc, pq_ac, log_scale: int):
    """Batched quantize_b on int32. coeffs (B, n) raster; pq_* = (zbin,
    round, quant, quant_shift, dequant) host integers. Returns (qcoeff,
    dqcoeff), both int32. The analysis tier's int32 approximation: tmp
    is capped at 2^15 - 1, and the products wrap in int32 as the JAX
    function's do."""
    n = coeffs.shape[-1]
    dev = coeffs.device
    is_dc = torch.arange(n, device=dev) == 0

    def sel(i):
        return torch.tensor([int(pq_ac[i]), int(pq_dc[i])],
                            dtype=torch.int32, device=dev)[is_dc.long()]

    def rp2(x, k):
        return x if k == 0 else (x + (1 << (k - 1))) >> k

    zbin = rp2(sel(0), log_scale)
    rnd = rp2(sel(1), log_scale)
    quant, qshift, deq = sel(2), sel(3), sel(4)
    c = coeffs.to(torch.int32)
    sign = torch.where(c < 0, -1, 1).to(torch.int32)
    abs_c = c.abs()
    tmp5 = (abs_c + rnd).clamp(0, (1 << 15) - 1) << 5
    tmp32 = (((tmp5 * quant) >> 16) + tmp5) * qshift >> (16 - log_scale + 5)
    tmp32 = torch.where(abs_c >= zbin, tmp32, torch.zeros_like(tmp32))
    return tmp32 * sign, ((tmp32 * deq) >> log_scale) * sign


def fullloop_int(resid: torch.Tensor, qp6, n: int, log_scale: int,
                 bit_depth: int, want_inv: bool = False):
    """The fullloop contract through the exact integer networks (the JAX
    package's device/intra.py chain with SVT_TPU_INTDCT=1): integer
    forward DCT_DCT to cn = min(n, 32), the analysis quantizer, the
    integer dequant, the integer inverse (clamps at `bit_depth`), and
    per block dist = sum (x - inv)^2, the rate proxy (bits<<9), eob
    (default-scan position + 1) and sse = sum x^2, as float32.

    resid (B, n, n) integer-valued; qp6 as fullloop_ref's. -> (metrics
    (B, 8) f32, inv (B, n, n) int32 or None)."""
    x = resid.to(torch.int32)
    b = x.shape[0]
    coeffs = forward_txfm2d_int(x, n, n, int(TxType.DCT_DCT))
    qabs, dq = quantize_analysis(coeffs, qp6, log_scale)
    inv = inverse_txfm2d_int(dq, n, n, int(TxType.DCT_DCT), bit_depth)
    err = (x - inv).to(torch.float32)
    xf = x.to(torch.float32)
    rate, eob = rate_proxy(
        qabs, reference_constants(x.device)["scan_pos"][min(n, 32)])
    metrics = torch.zeros((b, 8), dtype=torch.float32, device=x.device)
    metrics[:, 0] = (err * err).sum(dim=(1, 2))
    metrics[:, 1] = rate.to(torch.float32)
    metrics[:, 2] = eob.to(torch.float32)
    metrics[:, 3] = (xf * xf).sum(dim=(1, 2))
    return metrics, (inv if want_inv else None)


# ---- batched open-loop intra analysis ------------------------------------


def _extract_blocks(plane: torch.Tensor, blk: int) -> torch.Tensor:
    """(H, W) -> (H/blk * W/blk, blk, blk) tiles in raster order."""
    h, w = plane.shape
    return (plane.reshape(h // blk, blk, w // blk, blk).transpose(1, 2)
            .reshape(-1, blk, blk))


def frame_intra_analysis(luma: torch.Tensor, blk: int = 64,
                         bit_depth: int = 8) -> dict:
    """Batched open-loop intra analysis over all blk x blk blocks of one
    frame: the DC, V, H, SMOOTH and PAETH predictions from *source*
    neighbours (frame edges take the mid value), the SSE and SAD of each
    (int32, wrapping as the JAX function's int32 sums do), the per-block
    8x8 variances (float32) and the DC predictions.

    luma (H, W) integer tensor, H and W multiples of blk. Returns
    {"sse": (5, B), "sad": (5, B), "var8x8": (B, blk*blk/64),
    "pred_dc": (B,)} on luma's device."""
    h, w = luma.shape
    nby, nbx = h // blk, w // blk
    luma = luma.to(torch.int32)
    dev = luma.device
    tiles = _extract_blocks(luma, blk)
    b = tiles.shape[0]
    shape = (b, blk, blk)

    # source neighbours: the row above / column left of each tile (frame
    # edges -> the mid value)
    padded = torch.nn.functional.pad(luma, (1, 0, 1, 0),
                                     value=1 << (bit_depth - 1))
    above = padded[0:h:blk, 1:].reshape(b, blk)
    left = (padded[1:, 0:w:blk].reshape(nby, blk, nbx).transpose(1, 2)
            .reshape(b, blk))
    tl = padded[0:h:blk, 0:w:blk].reshape(b, 1)

    dc = torch.div(above.sum(1, dtype=torch.int32)
                   + left.sum(1, dtype=torch.int32) + blk, 2 * blk,
                   rounding_mode="floor")
    wts = torch.as_tensor(table_get("sm_weight_arrays")[blk: 2 * blk],
                          dtype=torch.int32, device=dev)
    below = left[:, blk - 1][:, None, None]
    right = above[:, blk - 1][:, None, None]
    a3, l3, t3 = above[:, None, :], left[:, :, None], tl[:, :, None]
    smooth = (wts[None, :, None] * a3 + (256 - wts)[None, :, None] * below
              + wts[None, None, :] * l3 + (256 - wts)[None, None, :] * right
              + 256) >> 9
    bse = a3 + l3 - t3
    pa, pl, pt = (bse - a3).abs(), (bse - l3).abs(), (bse - t3).abs()
    paeth = torch.where((pl <= pa) & (pl <= pt), l3.expand(shape),
                        torch.where(pa <= pt, a3.expand(shape),
                                    t3.expand(shape)))
    preds = torch.stack([dc[:, None, None].expand(shape), a3.expand(shape),
                         l3.expand(shape), smooth, paeth])  # (5, B, blk, blk)
    resid = tiles[None] - preds
    # int32 sums mod 2^32, as XLA's int32 reductions
    sse = (resid * resid).sum(dim=(2, 3), dtype=torch.int64).to(torch.int32)
    sad = resid.abs().sum(dim=(2, 3), dtype=torch.int64).to(torch.int32)

    # 8x8 variances (the variance-boost input)
    v8 = (tiles.reshape(b, blk // 8, 8, blk // 8, 8).transpose(2, 3)
          .reshape(b, -1, 64).to(torch.float32))
    mean = v8.mean(dim=2, keepdim=True)
    var8 = ((v8 - mean) ** 2).mean(dim=2)
    return {"sse": sse, "sad": sad, "var8x8": var8, "pred_dc": dc}
