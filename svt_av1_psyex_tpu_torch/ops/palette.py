"""Palette mode search (screen-content tools).

Counterpart: palette.c svt_av1_rd_pick_palette_intra_sby (:561) — the
reference forms candidate palettes from the block color histogram and
k-means refinement. This implementation keeps the decisive cases:

  * exact palettes when the block has <= 8 distinct sample values (the
    dominant screen-content case: flat fills, text, UI), and
  * dominant-color palettes (top-8 histogram bins, nearest mapping)
    when the count is moderately above 8 — the k-means seeding without
    the Lloyd iterations (they move colors by ~1 LSB on SC content).

Returns (colors ascending, index map) or None when palette can't win.
"""

from __future__ import annotations

import numpy as np

PALETTE_MAX_SIZE = 8


def count_colors(block: np.ndarray) -> int:
    return int(np.unique(block).size)


def palette_search(block: np.ndarray, bit_depth: int = 8,
                   max_colors: int = PALETTE_MAX_SIZE):
    """block: (h, w) integer samples. Returns (colors int64 ascending,
    map uint8 (h, w)) or None."""
    vals, counts = np.unique(block, return_counts=True)
    n = int(vals.size)
    if n < 2:
        return None
    if n <= max_colors:
        colors = vals.astype(np.int64)
        cmap = np.searchsorted(colors, block).astype(np.uint8)
        return colors, cmap
    if n > 6 * max_colors:
        return None  # too tonal for palette (the reference's
        #              count_colors threshold region)
    top = vals[np.argsort(counts)[-max_colors:]]
    colors = np.sort(top.astype(np.int64))
    # de-duplicate (sort of distinct values — already unique) and map
    # every sample to the nearest palette color
    idx = np.abs(block.astype(np.int64)[..., None]
                 - colors[None, None, :]).argmin(axis=-1)
    return colors, idx.astype(np.uint8)


def is_screen_content(luma: np.ndarray) -> bool:
    """svt_aom_is_screen_content_psy (pic_analysis_process.c:2088)
    simplified: fraction of palettizable 16x16 blocks (<= 6 colors,
    the complex_final threshold; the dilation refinement is skipped)
    minus a photo-block penalty must exceed 10%."""
    h, w = luma.shape
    counts1 = photo = total = 0
    for r in range(0, h - 15, 16):
        for c in range(0, w - 15, 16):
            blk = luma[r : r + 16, c : c + 16]
            n = int(np.unique(blk).size)
            if 2 <= n <= 6:
                counts1 += 1
            elif n > 40:
                photo += 1
            total += 1
    return (counts1 - photo / 24.0) * 10 > total


def palette_tokens_rate(cmap: np.ndarray, n: int) -> int:
    """Map-rate proxy in 1/512 bits: first-symbol uniform bits + the
    empirical entropy of the remaining wavefront symbols (the CDF-coded
    tail adapts toward exactly this)."""
    h, w = cmap.shape
    npix = h * w
    counts = np.bincount(cmap.reshape(-1), minlength=n).astype(np.float64)
    p = counts / max(npix, 1)
    ent = float(-(p[p > 0] * np.log2(p[p > 0])).sum())
    first_bits = max(n - 1, 1).bit_length()
    return int((first_bits + ent * (npix - 1)) * 512)


def palette_colors_rate(n_new: int, bit_depth: int = 8) -> int:
    """Colors-rate proxy in 1/512 bits (cache bits + delta coding)."""
    if n_new <= 0:
        return 8 * 512
    return (8 + bit_depth + 2 + (n_new - 1) * (bit_depth - 2)) * 512
