"""The dispatch of the device analysis inside begin_frame, in milliseconds
of host time per frame coded in the traced window: the device mode
decision's construction and `analyze_dispatch` (uploads and launches;
it only enqueues, device time shows in device_wait).

From the port's stage clock (SVT_TPU_TIMING=1): `begin.dispatch`, a part
of the `begin` stage."""


def read(record):
    st = record["stages"]
    if not record["frames"] or "begin.dispatch" not in st:
        return None
    return st["begin.dispatch"] * 1e3 / record["frames"]
