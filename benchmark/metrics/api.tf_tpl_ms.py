"""The API's temporal filtering and TPL, in milliseconds per frame coded in
the traced window.

From the port's stage clock (SVT_TPU_TIMING=1): the `tf` and `tpl`
stages of SvtAv1Encoder (keyframe and ARF filtering, the TPL dispenser)."""


def read(record):
    st = record["stages"]
    keys = ("tf", "tpl")
    if not record["frames"] or not any(k in st for k in keys):
        return None
    return sum(st.get(k, 0.0) for k in keys) * 1e3 / record["frames"]
