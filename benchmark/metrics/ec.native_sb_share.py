"""The share of the superblocks coded in the traced window that the port's
C superblock writer coded in one call each (the rest went through the
Python walk symbol by symbol), in percent.

From the port's stage clock (SVT_TPU_TIMING=1): the counts
`n.ec_sbs_native` over `n.ec_sbs`, noted at each tile's end
(Av1Encoder._finish_tile). A window in which the C writer coded nothing
has no `n.ec_sbs_native` key and reads 0."""


def read(record):
    st = record["stages"]
    if not st.get("n.ec_sbs"):
        return None
    return 100.0 * st.get("n.ec_sbs_native", 0) / st["n.ec_sbs"]
