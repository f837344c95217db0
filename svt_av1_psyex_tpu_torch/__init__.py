"""svt_av1_psyex_tpu_torch — the PyTorch + CUDA port of svt_av1_psyex_tpu.

The JAX package beside it stays the reference. This package imports
torch and never jax:

* device/  the analysis lattices (open-loop intra candidates, matmul
           DCTs, hierarchical motion estimation, the fused inter
           candidates), TPL's dispenser and the temporal filter, as
           plain torch functions on tensors, with an explicit `device`
           argument threaded from the encoder down;
* ops/     the kernels: the plain PyTorch version of each one
           (`*_ref.py`) and its hand-written Hopper kernel (`cuda/`);
* codec/   the encoder and device mode decision, as subclasses of the
           JAX package's host-tier classes, and the host side of TPL
           and temporal filtering;
* api/     `SvtAv1Encoder`, the JAX package's API class with its device
           stages on the port;
* app/     the SvtAv1EncApp-shaped CLI
           (`python -m svt_av1_psyex_tpu_torch.app.main ... --device`);
* native/  C backends the port wraps without the JAX device tier.

The host tier (bitstream, partition DP, native commit, DLF, CDEF,
entropy coding, GOP planning, the TPL synthesizer and q ladder) is
imported from the JAX package wherever it is jax-free at import time.

Ported so far: the API and CLI over the device mode-decision path at
presets >= 6 (keyframes and inter frames), with keyframe and ARF
temporal filtering and TPL, and the port's motion field for the host
mode decision below. Loop restoration (on at presets <= 6) is not
ported yet.
"""

__version__ = "0.1.0"
