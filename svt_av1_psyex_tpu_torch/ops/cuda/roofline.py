"""The least time an NVIDIA H100 SXM could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's memory
rate, and its operations over the card's peak rate for their type. The
peaks are NVIDIA's data-sheet numbers for the SXM part at its 700 W limit;
a card set below that limit runs slower under load, so a share of the
bound is stated beside the card's power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_FMA_PER_S = 66.9e12 / 2   # CUDA cores, outside the tensor cores
# int32 lanes: 64 per SM (half the fp32 lanes), 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _bound(nbytes: float, ops_s: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def fullloop_bound(b: int, n: int, want_inv: bool = False,
                   in_bytes: int = 4) -> dict:
    """fullloop on B blocks of n x n: reads B n^2 samples, writes B rows
    of 8 float32 metrics (and the B n^2 float32 inverse); four 1-D passes
    of n FMAs per coefficient."""
    nbytes = b * n * n * in_bytes + b * 32 + (b * n * n * 4 if want_inv
                                              else 0)
    return _bound(nbytes, b * n * n * 4 * n / FP32_FMA_PER_S)


def sad_bound(nsb: int) -> dict:
    """sad_lattice on nSB superblocks: reads a 64x64 tile and an 80x80
    window of int32 per superblock, writes 289 x 8 x 8 int32 sums; each of
    the 289 x 64 x 64 differences is an absolute difference and an add,
    two int32 operations."""
    nbytes = nsb * (64 * 64 + 80 * 80 + 289 * 64) * 4
    return _bound(nbytes, nsb * 289 * 64 * 64 * 2 / INT32_OPS_PER_S)
