"""svt_av1_psyex_tpu_torch — the PyTorch + CUDA port of svt_av1_psyex_tpu.

The JAX package beside it stays the reference. This package imports
torch and never jax:

* device/  the analysis lattices (open-loop intra candidates, matmul
           DCTs, hierarchical motion estimation, the fused inter
           candidates) as plain torch functions on tensors, with an
           explicit `device` argument threaded from the encoder down;
* ops/     the kernels: the plain PyTorch version of each one
           (`*_ref.py`) and its hand-written Hopper kernel (`cuda/`);
* codec/   the encoder and device mode decision, as subclasses of the
           JAX package's host-tier classes;
* native/  C backends the port wraps without the JAX device tier.

The host tier (bitstream, partition DP, native commit, DLF, CDEF,
entropy coding) is imported from the JAX package wherever it is
jax-free at import time.

Ported so far: the device mode-decision path of `Av1Encoder` at presets
>= 6, keyframes (`encode_keyframes`) and inter frames (`begin_frame` /
`resume_frame` with codec.gop frame plans; `codec.encoder.encode_plans`
drives a mini-GOP as the JAX package's API does), and the port's motion
field for the host mode decision below. Loop restoration, temporal
filtering, TPL and the API/CLI are not ported yet.
"""

__version__ = "0.1.0"
