"""The host blocked on the device analysis' rows, in milliseconds per frame
coded in the traced window.

From the port's stage clock (SVT_TPU_TIMING=1): the `device_wait` stage
of resume_frame."""


def read(record):
    st = record["stages"]
    keys = ("device_wait",)
    if not record["frames"] or not any(k in st for k in keys):
        return None
    return sum(st.get(k, 0.0) for k in keys) * 1e3 / record["frames"]
