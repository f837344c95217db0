"""Plain PyTorch reference of the sad_lattice kernel's work.

A frozen copy of the port's ops/sad_ref.py: for each superblock and
each of the 289 full-pel offsets (dy, dx) in [0, 16]^2 of its 80x80
search window (offset index dy * 17 + dx), the 8x8 grid of 8x8-box sums
of |tile - win[dy:dy+64, dx:dx+64]|, in int32. `precision="bf16"` takes
the box sums in bfloat16: the control, a step below the exact integer
sums that motion search states.
"""

from __future__ import annotations

import torch

BLK = 64
N = 17
NOFF = N * N
SPAN = BLK + N - 1


def sad_lattice(tiles: torch.Tensor, wins: torch.Tensor,
                precision: str = "int32") -> torch.Tensor:
    """tiles (nSB, 64, 64), wins (nSB, 80, 80) -> (nSB, 289, 8, 8) int32."""
    if precision not in ("int32", "bf16"):
        raise ValueError(f"precision must be int32 or bf16, not "
                         f"{precision!r}")
    nsb = tiles.shape[0]
    t = tiles.to(torch.int32)[:, :, None, :]
    w = wins.to(torch.int32)
    out = torch.empty((nsb, N, N, 8, 8), dtype=torch.int32,
                      device=tiles.device)
    for dy in range(N):
        cand = w[:, dy: dy + BLK].unfold(2, BLK, 1)  # (nSB, 64, 17, 64)
        d = (t - cand).abs().reshape(nsb, 8, 8, N, 8, 8)
        if precision == "bf16":
            s = d.to(torch.bfloat16).sum(dim=(2, 5), dtype=torch.bfloat16)
            s = s.to(torch.float32).round().to(torch.int32)
        else:
            s = d.sum(dim=(2, 5), dtype=torch.int32)
        out[:, dy] = s.permute(0, 2, 1, 3)
    return out.reshape(nsb, NOFF, 8, 8)
