"""Symbols the arithmetic coder coded per call from Python into the C
coder (a symbol, a literal, a whole transform block's coefficients), over
the traced window: how much work each crossing into C carries.

From the port's stage clock (SVT_TPU_TIMING=1): the counts `n.ec_symbols`
over `n.ec_calls`, both counted in the port's C coder
(svt_av1_psyex_tpu_torch/native/ecenc.c)."""


def read(record):
    st = record["stages"]
    if not st.get("n.ec_symbols") or not st.get("n.ec_calls"):
        return None
    return st["n.ec_symbols"] / st["n.ec_calls"]
