"""Loop restoration's host tier, in milliseconds per frame coded in the
traced window: the restoration units' stacks and Wiener seeds, and the
exact evaluation of the device search's winners. The rest of the `lr`
stage is the device search and its fetches.

From the port's stage clock (SVT_TPU_TIMING=1): `lr.build` + `lr.exact`,
parts of the `lr` stage (LR only at presets <= 6)."""


def read(record):
    st = record["stages"]
    keys = ("lr.build", "lr.exact")
    if not record["frames"] or not any(k in st for k in keys):
        return None
    return sum(st.get(k, 0.0) for k in keys) * 1e3 / record["frames"]
