"""The frame loop's begin_frame, in milliseconds per frame coded in the
traced window.

From the port's stage clock (SVT_TPU_TIMING=1): the `begin` stage: frame
set-up, the dispatch and the uploads of the device analysis (it only
enqueues: device time shows in device_wait)."""


def read(record):
    st = record["stages"]
    keys = ("begin",)
    if not record["frames"] or not any(k in st for k in keys):
        return None
    return sum(st.get(k, 0.0) for k in keys) * 1e3 / record["frames"]
