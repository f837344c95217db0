"""Plain reference of the partition decision that mode decision takes on
every frame from the device analysis' J lattices.

The quadtree argmin, one superblock at a time, recursively: a block
inside the frame costs its lattice J (truncated to an integer) plus the
PARTITION_NONE symbol's cost times the superblock's lambda, >> 9 (none
at the smallest depth); splitting costs its four children's best plus
the PARTITION_SPLIT symbol's cost. An inside block splits when it is
larger than the preset's smallest block and splitting costs less; a
block that straddles the frame's edge always splits; a block wholly
outside costs nothing. It returns the split decision of every block of
every depth but the smallest, the grids that the program's whole-frame
DP (codec/md_device.py `plan_frame`) fills. `precision="fp32"` rounds
every cost and every sum to float32, the control one step below the
integer sums; "bf16" rounds them to bfloat16.
"""

from __future__ import annotations

import numpy as np

INF = 1 << 60


def decide(rec: dict, precision: str = "int64") -> dict:
    """rec: {"j": {blk: (H/blk, W/blk) J}, "rdmult_sb": (H/64, W/64),
    "costs": {blk: (none, split)}, "h", "w" (the frame), "hp", "wp"
    (the lattice), "depths", "pmin"} -> {blk: bool grid}."""
    if precision == "int64":
        def num(v):
            return int(v)
    elif precision == "fp32":
        def num(v):
            return float(np.float32(v))
    elif precision == "bf16":
        def num(v):     # float32, then to the nearest bfloat16 (even ties)
            i = int(np.array(v, np.float32).view(np.uint32))
            i = (i + 0x7FFF + ((i >> 16) & 1)) & 0xFFFF0000
            return float(np.array(i, np.uint32).view(np.float32))
    else:
        raise ValueError(f"precision must be int64, fp32 or bf16, not "
                         f"{precision!r}")
    depths = sorted(rec["depths"])
    small = depths[0]
    h, w = rec["h"], rec["w"]
    j = {b: np.asarray(rec["j"][b]).astype(np.int64) for b in depths}
    split = {b: np.zeros((rec["hp"] // b, rec["wp"] // b), bool)
             for b in depths[1:]}

    def best(blk: int, by: int, bx: int, rdm: int):
        y0, x0 = by * blk, bx * blk
        if y0 >= h or x0 >= w:
            return num(0)
        inside = y0 + blk <= h and x0 + blk <= w
        leaf = num(INF)
        if inside:
            leaf = num(j[blk][by, bx])
            if blk > 8:
                leaf = num(leaf + num((rec["costs"][blk][0] * rdm) >> 9))
        if blk == small:
            return leaf
        s = num((rec["costs"][blk][1] * rdm) >> 9) if inside else num(0)
        for dy in (0, 1):
            for dx in (0, 1):
                s = num(s + best(blk // 2, 2 * by + dy, 2 * bx + dx, rdm))
        use = (inside and blk > rec["pmin"] and s < leaf) or not inside
        split[blk][by, bx] = use
        return s if use else leaf

    rdg = np.asarray(rec["rdmult_sb"], np.int64)
    top = depths[-1]
    for sy in range(rec["hp"] // 64):
        for sx in range(rec["wp"] // 64):
            f = 64 // top
            for by in range(sy * f, sy * f + f):
                for bx in range(sx * f, sx * f + f):
                    best(top, by, bx, int(rdg[sy, sx]))
    return split
