"""Mode decision's per-leaf host commit, in milliseconds per frame coded in
the traced window: `_commit_plan` over every superblock of the frames the
whole-frame C commit declines (the base-layer inter frames at presets 4-9,
whose motion-mode trials it lacks).

From the port's stage clock (SVT_TPU_TIMING=1): the `commit_leaf` stage."""


def read(record):
    st = record["stages"]
    if not record["frames"] or "commit_leaf" not in st:
        return None
    return st["commit_leaf"] * 1e3 / record["frames"]
