"""Entropy coding's time per symbol, in microseconds: the `ec` stage's
seconds in the traced window over the symbols the arithmetic coder coded
there (each bit of a literal one).

From the port's stage clock (SVT_TPU_TIMING=1): `ec` over the count
`n.ec_symbols`, counted in the port's C coder
(svt_av1_psyex_tpu_torch/native/ecenc.c) and read at each
tile's end."""


def read(record):
    st = record["stages"]
    if not st.get("n.ec_symbols") or "ec" not in st:
        return None
    return st["ec"] * 1e6 / st["n.ec_symbols"]
