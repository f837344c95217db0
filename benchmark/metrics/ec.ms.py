"""Entropy coding of the frame's tiles, in milliseconds per frame coded in
the traced window.

From the port's stage clock (SVT_TPU_TIMING=1): the `ec` stage."""


def read(record):
    st = record["stages"]
    keys = ("ec",)
    if not record["frames"] or not any(k in st for k in keys):
        return None
    return sum(st.get(k, 0.0) for k in keys) * 1e3 / record["frames"]
