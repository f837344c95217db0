"""The share of the traced window's coded frames whose CDEF search and
apply ran through the port's CUDA kernel (ops/cuda/cdef.py), in percent.

From the port's stage clock (SVT_TPU_TIMING=1): the counts
`n.cdef_device` over `n.cdef_frames`, noted once a frame
(Av1Encoder._cdef_frame). A program whose clock does not count CDEF
frames reads None."""


def read(record):
    st = record["stages"]
    if not st.get("n.cdef_frames"):
        return None
    return 100.0 * st.get("n.cdef_device", 0) / st["n.cdef_frames"]
