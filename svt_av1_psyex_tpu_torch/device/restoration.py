"""Loop-restoration candidate scoring on the device, in PyTorch.

Counterpart of svt_av1_psyex_tpu/device/restoration.py (an XLA program
there, no Pallas kernel, so plain torch here). The host search
(codec/restoration.py) stacks every restoration unit (RU) of a plane into
fixed-size padded stacks; this module scores them on `pads.device`:

* `wiener_sse` / `wiener_descent`: the plain-pad Wiener convolve
  (ops/restoration.wiener_convolve semantics) and the masked SSE per (RU,
  tap set). The descent scores the T0 initial damped-LS candidates, then
  runs `n_rounds` rounds of the +-1 steepest descent over the 13 (luma)
  or 9 (chroma) one-step variants of `_descent_offsets`, clamped to the
  codable tap range; a step is taken only on a strictly smaller SSE, and
  `argmin` keeps the first of equal SSEs, as the reference's does.
* `sgr_corr`: per (RU, ep) the two guided filters and the projection
  least-squares correlations [h00, h11, h01, c0, c1, ss], with
  svt_get_proj_subspace's scaling (restoration_pick.c:413), masked to
  the RU's real extent.

Arithmetic: exact integers. The JAX module keeps the Wiener SSE, the SGR
box sums, p, z, B, the filtered planes and the correlations in float32,
because the TPU has no int64. On real RUs those pass 2^24 (the box sums
of x^2 of a 1080p luma RU reach about 10^10), so its values are rounded
and depend on the summation order. Here each of them is int64 (the
convolve itself stays int32: its accumulator stays below 2^26): the card
and the CPU give the same bits, the SGR A/B and filtered planes equal the
host's exact `_sgr_ab`/`sgr_flt` (ops/restoration.py), and the SSEs are
the integers the host search (SVT_TPU_HOST_LR=1) ranks by. The bit-depth
rounding of the box sums is the spec's round-half-up, as on the host
(the JAX module's jnp.round rounds half to even).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.restoration import (
    _ONE_BY_X,
    _X_BY_XPLUS1,
    SGR_PARAMS,
    SGRPROJ_MTABLE_BITS,
    SGRPROJ_RECIP_BITS,
    SGRPROJ_RST_BITS,
    SGRPROJ_SGR,
    SGRPROJ_SGR_BITS,
    WIENER_TAPS_MAX,
    WIENER_TAPS_MIN,
)


def _round2(x, n: int):
    """(x + 2^(n-1)) >> n (an arithmetic shift: floor for negatives)."""
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def _kern7(taps: torch.Tensor) -> torch.Tensor:
    """(..., 3) taps -> (..., 7) differential kernel (wiener_kernel7)."""
    t0, t1, t2 = taps[..., 0], taps[..., 1], taps[..., 2]
    return torch.stack([t0, t1, t2, -2 * (t0 + t1 + t2), t2, t1, t0],
                       dim=-1)


def _descent_offsets(chroma: bool) -> np.ndarray:
    """Static (V, 2, 3) +-1 step table: variant 0 = keep, then one step
    per (direction, tap, sign) in the host descent's exact order."""
    first = 1 if chroma else 0
    offs = [np.zeros((2, 3), np.int32)]
    for d in range(2):
        for j in range(first, 3):
            for step in (1, -1):
                o = np.zeros((2, 3), np.int32)
                o[d, j] = step
                offs.append(o)
    return np.stack(offs)


def _wiener_sse(x: torch.Tensor, src: torch.Tensor, msk: torch.Tensor,
                hk: torch.Tensor, vk: torch.Tensor,
                bit_depth: int) -> torch.Tensor:
    """x (N, H+6, W+6), src/msk (N, H, W) int32; hk/vk (N, T, 7) int32
    kernels -> (N, T) int64 masked SSE. The T tap sets run side by side;
    the 7 taps accumulate one shifted slice at a time."""
    bd = bit_depth
    round0 = 3 + (2 if bd == 12 else 0)
    round1 = 11 - (2 if bd == 12 else 0)
    clamp_lim = 1 << (bd + 1 + 7 - round0)
    h, w = x.shape[1] - 6, x.shape[2] - 6
    xt = x[:, None]
    acc = (xt[..., 3:3 + w] << 7) + (1 << (bd + 7 - 1))
    acc = acc.expand(-1, hk.shape[1], -1, -1).clone()
    for k in range(7):
        acc += hk[:, :, k, None, None] * xt[..., k:k + w]
    mid = _round2(acc, round0).clamp_(0, clamp_lim - 1)
    acc = (mid[:, :, 3:3 + h] << 7) - (1 << (bd + round1 - 1))
    for k in range(7):
        acc += vk[:, :, k, None, None] * mid[:, :, k:k + h]
    out = _round2(acc, round1).clamp_(0, (1 << bd) - 1)
    err = (src[:, None] - out) * msk[:, None]
    return (err * err).sum(dim=(2, 3), dtype=torch.int64)


def wiener_sse(pads: torch.Tensor, srcs: torch.Tensor, masks: torch.Tensor,
               hks: torch.Tensor, vks: torch.Tensor,
               bit_depth: int = 8) -> torch.Tensor:
    """pads (N, H+6, W+6) plain-padded RUs; srcs/masks (N, H, W), any
    integer dtype; hks/vks (N, T, 7) int32 Wiener kernels. Returns (N, T)
    int64 masked SSE of the bit-exact plain-pad convolve."""
    i32 = torch.int32
    return _wiener_sse(pads.to(i32), srcs.to(i32), masks.to(i32),
                       hks.to(i32), vks.to(i32), bit_depth)


def wiener_descent(pads: torch.Tensor, srcs: torch.Tensor,
                   masks: torch.Tensor, init_taps: torch.Tensor,
                   bit_depth: int, n_rounds: int, chroma: bool):
    """The Wiener search of every RU: score the T0 initial candidates
    init_taps (N, T0, 2, 3) int32 (h, v) tap triples, then `n_rounds`
    rounds of the +-1 steepest descent. pads/srcs/masks as wiener_sse.
    Returns (taps (N, 2, 3) int32, best SSE (N,) int64)."""
    i32 = torch.int32
    x, src, msk = pads.to(i32), srcs.to(i32), masks.to(i32)
    dev = x.device

    def score(cands):
        return _wiener_sse(x, src, msk, _kern7(cands[:, :, 0]),
                           _kern7(cands[:, :, 1]), bit_depth)

    init_taps = init_taps.to(dev, i32)
    idx = torch.arange(x.shape[0], device=dev)
    sse = score(init_taps)
    arg = sse.argmin(dim=1)
    taps, best = init_taps[idx, arg], sse[idx, arg]
    offs = torch.as_tensor(_descent_offsets(chroma), device=dev)
    tmin = torch.tensor(WIENER_TAPS_MIN, dtype=i32, device=dev)
    tmax = torch.tensor(WIENER_TAPS_MAX, dtype=i32, device=dev)
    for _ in range(n_rounds):
        cands = torch.minimum(torch.maximum(taps[:, None] + offs[None],
                                            tmin), tmax)
        sse = score(cands)
        arg = sse.argmin(dim=1)
        sse_min = sse[idx, arg]
        impr = sse_min < best
        taps = torch.where(impr[:, None, None], cands[idx, arg], taps)
        best = torch.where(impr, sse_min, best)
    return taps, best


def _box(a: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W) -> (N, H-2r, W-2r) (2r+1)^2 window sums (valid region)."""
    k = 2 * r + 1
    c = a.cumsum(dim=1)
    v = torch.cat([c[:, k - 1:k], c[:, k:] - c[:, :-k]], dim=1)
    c = v.cumsum(dim=2)
    return torch.cat([c[:, :, k - 1:k], c[:, :, k:] - c[:, :, :-k]], dim=2)


def _sgr_ab(pad: torch.Tensor, r: int, s: int, bit_depth: int,
            rows: np.ndarray):
    """ops/restoration._sgr_ab over N RUs: pad (N, H+6, W+6) int64, rows
    (R,) row indices (-1..H). Returns A, B (N, R, W+2) int64 over columns
    -1..W."""
    dev = pad.device
    w = pad.shape[2] - 6
    nn = (2 * r + 1) * (2 * r + 1)
    sel_r = torch.as_tensor(np.asarray(rows) + 3 - r, device=dev)
    sel_c = torch.arange(-1, w + 1, device=dev) + 3 - r
    b_raw = _box(pad, r)[:, sel_r][:, :, sel_c]
    a = _round2(_box(pad * pad, r)[:, sel_r][:, :, sel_c],
                2 * (bit_depth - 8))
    b = _round2(b_raw, bit_depth - 8)
    p = (a * nn - b * b).clamp_(min=0)
    z = _round2(p * s, SGRPROJ_MTABLE_BITS)
    A = torch.as_tensor(_X_BY_XPLUS1, device=dev)[z.clamp_(max=255)]
    B = _round2((SGRPROJ_SGR - A) * b_raw * int(_ONE_BY_X[nn - 1]),
                SGRPROJ_RECIP_BITS)
    return A, B


def _sgr_flt(pad: torch.Tensor, ep: int, bit_depth: int):
    """ops/restoration.sgr_flt over N RUs: pad (N, H+6, W+6) int64 ->
    (flt0, flt1), each (N, H, W) int64, None for a radius-0 pass."""
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    dev = pad.device
    n, h, w = pad.shape[0], pad.shape[1] - 6, pad.shape[2] - 6
    dgd = pad[:, 3:3 + h, 3:3 + w]
    flt0 = flt1 = None
    if r0 > 0:
        A, B = _sgr_ab(pad, r0, s0, bit_depth, np.arange(-1, h + 1, 2))
        a_mid, b_mid = A[:, :, 1:w + 1], B[:, :, 1:w + 1]
        a_l, a_r = A[:, :, 0:w], A[:, :, 2:w + 2]
        b_l, b_r = B[:, :, 0:w], B[:, :, 2:w + 2]
        # even rows: the A/B rows above and below (6 centre, 5 diagonal)
        ev = torch.arange(0, h, 2, device=dev)
        up = (ev + 1) // 2
        dn = up + 1
        a_e = ((a_mid[:, up] + a_mid[:, dn]) * 6
               + (a_l[:, up] + a_l[:, dn] + a_r[:, up] + a_r[:, dn]) * 5)
        b_e = ((b_mid[:, up] + b_mid[:, dn]) * 6
               + (b_l[:, up] + b_l[:, dn] + b_r[:, up] + b_r[:, dn]) * 5)
        # odd rows: their own A/B row
        od = torch.arange(1, h, 2, device=dev)
        own = (od + 1) // 2
        a_o = a_mid[:, own] * 6 + (a_l[:, own] + a_r[:, own]) * 5
        b_o = b_mid[:, own] * 6 + (b_l[:, own] + b_r[:, own]) * 5
        flt0 = torch.empty((n, h, w), dtype=torch.int64, device=dev)
        flt0[:, ev] = _round2(a_e * dgd[:, ev] + b_e,
                              SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
        flt0[:, od] = _round2(a_o * dgd[:, od] + b_o,
                              SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
    if r1 > 0:
        A, B = _sgr_ab(pad, r1, s1, bit_depth, np.arange(-1, h + 1))

        def cross(m):
            mid = m[:, 1:h + 1, 1:w + 1]
            return ((mid + m[:, 1:h + 1, 0:w] + m[:, 1:h + 1, 2:w + 2]
                     + m[:, 0:h, 1:w + 1] + m[:, 2:h + 2, 1:w + 1]) * 4
                    + (m[:, 0:h, 0:w] + m[:, 0:h, 2:w + 2]
                       + m[:, 2:h + 2, 0:w] + m[:, 2:h + 2, 2:w + 2]) * 3)

        flt1 = _round2(cross(A) * dgd + cross(B),
                       SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    return flt0, flt1


def sgr_corr(pads: torch.Tensor, srcs: torch.Tensor, masks: torch.Tensor,
             eps: tuple, bit_depth: int = 8) -> torch.Tensor:
    """Projection-LS correlations per (RU, ep): (N, len(eps), 6) int64
    [h00, h11, h01, c0, c1, ss], each summed over the RU's real extent
    (masks). pads/srcs/masks as wiener_sse."""
    i64 = torch.int64
    h, w = pads.shape[1] - 6, pads.shape[2] - 6
    pad, m = pads.to(i64), masks.to(i64)
    u = pad[:, 3:3 + h, 3:3 + w] << SGRPROJ_RST_BITS
    s = ((srcs.to(i64) << SGRPROJ_RST_BITS) - u) * m
    zero = torch.zeros_like(u)

    def total(a, b):
        return (a * b).sum(dim=(1, 2))

    out = []
    for ep in eps:
        flt0, flt1 = _sgr_flt(pad, ep, bit_depth)
        f0 = zero if flt0 is None else (flt0 - u) * m
        f1 = zero if flt1 is None else (flt1 - u) * m
        out.append(torch.stack([total(f0, f0), total(f1, f1), total(f0, f1),
                                total(f0, s), total(f1, s), total(s, s)],
                               dim=1))
    return torch.stack(out, dim=1)
