"""Plain PyTorch reference of the device intra analysis that mode
decision reads on a keyframe.

A frozen copy of the arithmetic of the port's device/intra.py
`intra_analysis_batch` (the matmul-DCT tier of the JAX package's
device/intra.py): every block of every depth, seven non-directional
modes predicted from source neighbours (DC, V, H, SMOOTH, SMOOTH_V,
SMOOTH_H, PAETH), the fullloop chain on each residual (reference
fullloop.py), the psy SA8D energy term when psy is on, and the RD
reduction to one (J, mode) pair per block. It returns the packed rows
(F, P): for each depth the J raster, then the mode raster.
"""

from __future__ import annotations

import numpy as np
import torch

from .fullloop import fullloop, mm, tables


def predict_modes(tiles, above, left, tl, blk: int, sm: torch.Tensor):
    """(M, B, blk, blk) int32 predictions of the seven modes."""
    b = tiles.shape[0]
    shape = (b, blk, blk)
    a3 = above[:, None, :]
    l3 = left[:, :, None]
    dc = torch.div(above.sum(1, dtype=torch.int32)
                   + left.sum(1, dtype=torch.int32) + blk, 2 * blk,
                   rounding_mode="floor")
    below = left[:, blk - 1][:, None, None]
    right = above[:, blk - 1][:, None, None]
    wv = sm[None, :, None]
    wh = sm[None, None, :]
    p = wv * a3 + (256 - wv) * below + wh * l3 + (256 - wh) * right
    t3 = tl[:, None, None]
    base = a3 + l3 - t3
    pa = (base - a3).abs()
    pl = (base - l3).abs()
    pt = (base - t3).abs()
    paeth = torch.where((pl <= pa) & (pl <= pt), l3.expand(shape),
                        torch.where(pa <= pt, a3.expand(shape),
                                    t3.expand(shape)))
    return torch.stack([
        dc[:, None, None].expand(shape),
        a3.expand(shape),
        l3.expand(shape),
        (p + 256) >> 9,
        ((wv * a3 + (256 - wv) * below + 128) >> 8).expand(shape),
        ((wh * l3 + (256 - wh) * right + 128) >> 8).expand(shape),
        paeth,
    ]).to(torch.int32)


def block_neighbors(lumas: torch.Tensor, blk: int):
    """Source neighbours of every block, edge-replicated at the frame's
    borders: above/left (F*nby*nbx, blk), tl (F*nby*nbx,)."""
    f, h, w = lumas.shape
    nby, nbx = h // blk, w // blk
    pad = torch.cat([lumas[:, :1], lumas], dim=1)
    pad = torch.cat([pad[:, :, :1], pad], dim=2)
    above = pad[:, 0:h:blk, 1:].reshape(f, nby, nbx, blk).reshape(-1, blk)
    left = (pad[:, 1:, 0:w:blk].reshape(f, nby, blk, nbx)
            .transpose(2, 3).reshape(-1, blk))
    tl = pad[:, 0:h:blk, 0:w:blk].reshape(-1)
    return above, left, tl


def extract_blocks(lumas: torch.Tensor, blk: int) -> torch.Tensor:
    f, h, w = lumas.shape
    t = lumas.reshape(f, h // blk, blk, w // blk, blk).transpose(2, 3)
    return t.reshape(-1, blk, blk).contiguous()


def psy_energy(x: torch.Tensor, blk: int, had: torch.Tensor,
               precision: str = "fp32"):
    """(B, blk, blk) -> (B,) summed per-8x8 SA8D energy (SA8D - SAD/4)."""
    b = x.shape[0]
    n8 = blk // 8
    t = (x.reshape(b, n8, 8, n8, 8).transpose(2, 3).reshape(-1, 8, 8)
         .to(torch.float32))
    tr = mm(mm(had.expand(t.shape[0], 8, 8), t, precision),
            had.T.expand(t.shape[0], 8, 8), precision)
    sa8d = torch.floor((tr.abs().sum(dim=(1, 2)) + 2) / 4)
    sad = t.abs().sum(dim=(1, 2))
    return (sa8d - torch.floor(sad / 4)).reshape(b, n8 * n8).sum(dim=1)


def _rp2(x: int, n: int) -> int:
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def qp6_for(qp_row, log_scale: int) -> list:
    """(deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac) of a luma
    quantizer row (zbin, round, quant, shift, dequant) x (dc, ac)."""
    q = [int(v) for v in qp_row]
    return [q[4], q[9], _rp2(q[1], log_scale), _rp2(q[6], log_scale),
            _rp2(q[0], log_scale), _rp2(q[5], log_scale)]


def analyze_depth(lumas, blk: int, qp_rows, rd_rows, bit_depth: int,
                  psy: bool, precision: str):
    f = lumas.shape[0]
    tab = tables(lumas.device)
    tiles = extract_blocks(lumas, blk)
    above, left, tl = block_neighbors(lumas, blk)
    preds = predict_modes(tiles, above, left, tl, blk,
                          tab[f"sm_weights_{blk}"])
    m, fb = preds.shape[0], preds.shape[1]
    b = fb // f
    resid = (tiles[None] - preds).reshape(m, f, b, blk, blk)
    log_scale = 2 if blk == 64 else (1 if blk == 32 else 0)
    metrics = torch.empty((m, f, b, 8), dtype=torch.float32,
                          device=lumas.device)
    inv = (torch.empty((m, f, b, blk, blk), dtype=torch.float32,
                       device=lumas.device) if psy else None)
    for fi in range(f):
        met, iv = fullloop(resid[:, fi].reshape(-1, blk, blk),
                           qp6_for(qp_rows[fi], log_scale), blk, log_scale,
                           want_inv=psy, precision=precision)
        metrics[:, fi] = met.reshape(m, b, 8)
        if psy:
            inv[:, fi] = iv.reshape(m, b, blk, blk)
    dist, rate, sse = metrics[..., 0], metrics[..., 1], metrics[..., 3]
    rd = rd_rows[:, :, None]
    if psy:
        maxpix = (1 << bit_depth) - 1
        scale = 0.5 if bit_depth == 8 else 4.0
        factor = rd[:, -1].to(torch.float32) / 256.0 * scale
        had = tab["had8"]
        pflat = preds.reshape(m, f, b, blk, blk)
        recon = (pflat + inv).clamp(0, maxpix)
        e_src = psy_energy(tiles, blk, had, precision).reshape(f, b)
        e_rec = psy_energy(recon.reshape(-1, blk, blk), blk, had,
                           precision).reshape(m, f, b)
        e_pred = psy_energy(pflat.reshape(-1, blk, blk), blk, had,
                            precision).reshape(m, f, b)
        dist = dist + (e_src - e_rec).abs() * factor
        sse = sse + (e_src - e_pred).abs() * factor
    rdmult = rd[:, 0].to(torch.float32)
    mode_rate = rd[:, 3: 3 + m].to(torch.float32).transpose(0, 1)
    j_coded = ((rate + mode_rate + rd[:, 1]) * rdmult / 512.0
               + dist * 128.0)
    j_skip = ((mode_rate + rd[:, 2]) * rdmult / 512.0 + sse * 128.0)
    j = torch.minimum(j_coded, j_skip)
    return j.amin(dim=0), j.argmin(dim=0).to(torch.float32)


def intra_analysis(lumas: np.ndarray, qp_rows, rd_rows, depths,
                   bit_depth: int, psy: bool, device,
                   precision: str = "fp32") -> np.ndarray:
    """lumas (F, Hp, Wp) host planes -> (F, P) float32 packed rows."""
    lum = torch.from_numpy(np.ascontiguousarray(lumas).astype(np.int32)) \
        .to(device)
    rd = torch.tensor(np.asarray(rd_rows, np.int32), device=lum.device)
    parts = []
    for blk in depths:
        j, mode = analyze_depth(lum, blk, np.asarray(qp_rows), rd,
                                bit_depth, psy, precision)
        parts += [j, mode]
    return torch.cat(parts, dim=1).cpu().numpy()
