"""Build of the hand-written CUDA kernels at first use.

Each `<name>.cu` beside this file is compiled by nvcc for Hopper
(sm_90a) into a shared library with a plain C interface, loaded with
ctypes: no PyTorch headers, so a build takes seconds, and no ninja.
Output goes to build/torch_kernels/ at the repository root (ignored by
git); a library is rebuilt when it is missing or older than its source,
like the gcc-at-first-use native backends (native/ecenc.py). A failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (no CUDA toolkit): the CUDA kernels "
                       "cannot be built")


def build(name: str) -> Path:
    """Compile `<name>.cu` into build/torch_kernels/lib<name>.so unless an
    up-to-date library is there. Returns the library's path."""
    src = SRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    build_logs[name] = (f"built {out.name} in "
                        f"{time.perf_counter() - t0:.3f} s\n{log}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib
