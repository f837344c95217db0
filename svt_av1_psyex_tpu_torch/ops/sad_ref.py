"""The plain PyTorch version of the sad_lattice kernel.

Same signature and output as the JAX package's Pallas kernel
(svt_av1_psyex_tpu/ops/pallas/sad.py `sad_lattice`) and its jnp tier
(device/me.py fullpel_lattice, L2): for each superblock and each of the
289 full-pel offsets (dy, dx) in [0, 16]^2 of its 80x80 search window,
offset index o = dy * 17 + dx, the 8x8 grid of 8x8-box sums of
|tile - win[dy:dy+64, dx:dx+64]|. Integer arithmetic throughout, so the
kernel must equal it bit for bit.

It loops over dy and takes the 17 dx shifts of one dy at once: stacking
all 289 offsets would hold 289 copies of every tile (about 1.1 GB at
720p). It serves the CPU path of the port and chip_smoke.py, which holds
the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch

BLK = 64          # superblock size
R = 8             # +- full-pel search range (device/me.py R2)
N = 2 * R + 1     # shifts per axis
NOFF = N * N      # offsets per superblock
SPAN = BLK + 2 * R


def sad_lattice_ref(tiles: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """tiles (nSB, 64, 64) int, wins (nSB, 80, 80) int (gathered with
    spec MC edge clamping) -> (nSB, 289, 8, 8) int32 SAD lattice."""
    nsb = tiles.shape[0]
    t = tiles.to(torch.int32)[:, :, None, :]                # (nSB, 64, 1, 64)
    w = wins.to(torch.int32)
    out = torch.empty((nsb, N, N, 8, 8), dtype=torch.int32,
                      device=tiles.device)
    for dy in range(N):
        # (nSB, 64 rows, 17 dx, 64 cols): every dx shift of these rows
        cand = w[:, dy: dy + BLK].unfold(2, BLK, 1)
        d = (t - cand).abs().reshape(nsb, 8, 8, N, 8, 8)
        # (nSB, by, r, dx, bx, c) -> box sums (nSB, dx, by, bx)
        out[:, dy] = d.sum(dim=(2, 5), dtype=torch.int32).permute(0, 2, 1, 3)
    return out.reshape(nsb, NOFF, 8, 8)
