"""Device handling and the kernel registry.

Counterpart of the JAX package's `use_pallas`/`_interpret` switch
(svt_av1_psyex_tpu/ops/pallas/fullloop.py) and of its device package
set-up. Differences that are deliberate:

* the caller names the device; there is no global default, and asking
  for "cuda" where there is no card raises;
* float32 matrix products stay in full float32: the reference pins
  Precision.HIGHEST on every analysis matmul because TF32-class
  precision skews the transforms enough to flip quantize decisions;
* the kernel in use follows from the tensor's device (hand kernel on
  CUDA, plain PyTorch version on the CPU); only an explicit
  `kernels="plain"` selects the plain version on CUDA, so that a run can
  compare the two on the card. No environment variable swaps them.
"""

from __future__ import annotations

import torch

KERNELS = ("hand", "plain")


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", a
    torch.device). Raises if CUDA is asked for and absent."""
    if device is None:
        raise ValueError("device is required: pass 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def check_kernels(kernels: str) -> str:
    if kernels not in KERNELS:
        raise ValueError(f"kernels must be one of {KERNELS}, not "
                         f"{kernels!r}")
    return kernels


def fullloop_impl(kernels: str = "hand"):
    """The fullloop implementation for `kernels`: "hand" is the wrapper
    that launches the CUDA kernel on CUDA tensors (and runs the plain
    version on CPU tensors); "plain" is the plain PyTorch version."""
    check_kernels(kernels)
    if kernels == "plain":
        from .ops.fullloop_ref import fullloop_ref

        return fullloop_ref
    from .ops.cuda.fullloop import fullloop

    return fullloop
