"""Hand-written Hopper kernels (CUDA C++ for sm_90a), built at first use.

Each kernel's wrapper counts its launches in its module's `launches`;
a launch made on a thread inside `warming()` (Av1Encoder.warm_device's
thread) counts in its `warm_launches` instead, so that a warm-up leaves
the counts of the encode beside it alone.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_local = threading.local()


@contextmanager
def warming():
    """Count this thread's kernel launches as warm-up launches."""
    _local.warming = True
    try:
        yield
    finally:
        _local.warming = False


def is_warming() -> bool:
    return getattr(_local, "warming", False)
