"""Launchers of the hand-written Hopper CDEF kernel (cdef.cu), and the
frame runner that runs an encoder's CDEF through them.

The kernel replaces no Pallas kernel (the JAX package's CDEF is an XLA
program, its host path native/cdef.c): it moves the C's direction search,
strength-candidate search and apply onto the card, bit for bit, because
that C was the largest stage the card sat idle behind. Its integer
arithmetic bounds the search and the apply, its bytes the direction
search (ops/cuda/roofline.py cdef_bound; cdef.cu says more).

`cdef_dirs`, `cdef_search` and `cdef_apply` launch the kernel on CUDA
tensors and run the plain PyTorch version (ops/cdef_ref.py) on CPU
tensors, because there is no kernel there; anything else raises.
`launches` counts the kernel launches (three a frame), so that a run can
show that its main path went through the kernel (`warm_launches` those of
a warm-up thread: ops/cuda/__init__.py).

`CdefFrames.search_frame` has native/cdefc.py `cdef_search_frame_c`'s
contract: the same arguments, the same result and the recon planes
filtered in place, with the host's strength selection (device/cdef.py
`_select_strengths`) between the search and the apply.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ...device.cdef import _select_strengths
from ...runtime import cdef_impl, check_kernels
from ..cdef import candidate_strengths
from ..cdef_ref import (
    cdef_apply_ref,
    cdef_dirs_ref,
    cdef_search_ref,
    search_units,
    unit_mask,
)
from . import build, is_warming

launches = 0
warm_launches = 0

_bound = None


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load("cdef")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.svt_cdef_dirs_launch.argtypes = [vp] + [ci] * 6 + [vp] * 3
        lib.svt_cdef_search_launch.argtypes = (
            [vp, ci, vp, vp, ci, vp, ci, vp, vp, ci, ci, ci, vp]
            + [ci] * 4 + [vp] * 3 + [ci] * 5 + [vp] * 3)
        lib.svt_cdef_apply_launch.argtypes = (
            [vp, ci, vp, vp, ci, vp, vp, vp] + [ci] * 6 + [vp, ci, ci]
            + [vp] * 4 + [ci] * 4 + [vp])
        for fn in (lib.svt_cdef_dirs_launch, lib.svt_cdef_search_launch,
                   lib.svt_cdef_apply_launch):
            fn.restype = ctypes.c_int
        lib.svt_cdef_error_string.argtypes = [ci]
        lib.svt_cdef_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _on_card(name: str, tensors, int32=()) -> bool:
    """False when every tensor lies on the CPU (the plain version runs);
    True when all lie on one CUDA device, contiguous, the ones named in
    `int32` (positions) of type int32; raises otherwise."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}; "
                         "all must be on one CUDA device")
    for i in int32:
        if tensors[i].dtype != torch.int32:
            raise TypeError(f"{name}: argument {i} must be int32, got "
                            f"{tensors[i].dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _check_planes(name, planes, coded):
    """Each plane (luma, then chroma at half the coded area) 2-D and as
    large as its coded area."""
    if len(planes) not in (1, 3):
        raise ValueError(f"{name}: 1 or 3 planes, got {len(planes)}")
    for k, p in enumerate(planes):
        ch, cw = (coded if k == 0 else (coded[0] >> 1, coded[1] >> 1))
        if p.dim() != 2 or p.shape[0] < ch or p.shape[1] < cw:
            raise ValueError(f"{name}: plane {k} of shape {tuple(p.shape)} "
                             f"does not cover its coded area {(ch, cw)}")


def _launched(err: int) -> None:
    global launches, warm_launches
    if err != 0:
        raise RuntimeError("CDEF kernel launch failed: "
                           + _lib().svt_cdef_error_string(err).decode())
    if is_warming():
        warm_launches += 1
    else:
        launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cdef_dirs(y: torch.Tensor, coded, grid, cs: int):
    """ops/cdef_ref.py `cdef_dirs_ref`: each unit's direction and
    variance, (nv8p * nh8p,) int32 each."""
    if not _on_card("cdef_dirs", [y], int32=(0,)):
        return cdef_dirs_ref(y, coded, grid, cs)
    _check_planes("cdef_dirs", [y], coded)
    n = grid[0] * grid[1]
    dirs = torch.empty(n, dtype=torch.int32, device=y.device)
    var = torch.empty_like(dirs)
    with torch.cuda.device(y.device):
        _launched(_lib().svt_cdef_dirs_launch(
            y.data_ptr(), y.shape[1], coded[0], coded[1], grid[0], grid[1],
            cs, dirs.data_ptr(), var.data_ptr(), _stream(y)))
    return dirs, var


def cdef_search(planes, srcs, coded, units: torch.Tensor, grid,
                dirs: torch.Tensor, var: torch.Tensor, cands: torch.Tensor,
                ydamp: int, cdamp: int, cs: int):
    """ops/cdef_ref.py `cdef_search_ref`: the (nfb, n_cand) int64 luma and
    chroma distortion tables."""
    ts = [*planes, *srcs, units, dirs, var, cands]
    if not _on_card("cdef_search", ts, int32=range(len(ts))):
        return cdef_search_ref(planes, srcs, coded, units, grid, dirs, var,
                               cands, ydamp, cdamp, cs)
    _check_planes("cdef_search", planes, coded)
    _check_planes("cdef_search", srcs, coded)
    nv8p, nh8p = grid
    if len(srcs) != len(planes) or dirs.numel() != nv8p * nh8p:
        raise ValueError("cdef_search: one source plane per plane and one "
                         "direction per unit of the grid")
    nfb = (nv8p // 8) * (nh8p // 8)
    mse0 = torch.empty((nfb, cands.numel()), dtype=torch.int64,
                       device=units.device)
    mse1 = torch.empty_like(mse0)
    chroma = len(planes) > 1
    u, v = (planes[1], planes[2]) if chroma else (planes[0], planes[0])
    su, sv = (srcs[1], srcs[2]) if chroma else (srcs[0], srcs[0])
    with torch.cuda.device(units.device):
        _launched(_lib().svt_cdef_search_launch(
            planes[0].data_ptr(), planes[0].shape[1], u.data_ptr(),
            v.data_ptr(), u.shape[1], srcs[0].data_ptr(), srcs[0].shape[1],
            su.data_ptr(), sv.data_ptr(), su.shape[1], coded[0], coded[1],
            units.data_ptr(), units.numel(), nh8p, nh8p // 8, nfb,
            dirs.data_ptr(), var.data_ptr(), cands.data_ptr(), cands.numel(),
            ydamp, cdamp, cs, int(chroma), mse0.data_ptr(), mse1.data_ptr(),
            _stream(units)))
    return mse0, mse1


def cdef_apply(planes, coded, mask: torch.Tensor, dirs: torch.Tensor,
               var: torch.Tensor, y_gi: torch.Tensor, uv_gi: torch.Tensor,
               ydamp: int, cdamp: int, cs: int):
    """ops/cdef_ref.py `cdef_apply_ref`: the filtered planes, new tensors
    of the planes' shapes."""
    ts = [*planes, mask, dirs, var, y_gi, uv_gi]
    n = len(planes)
    if not _on_card("cdef_apply", ts,
                    int32=[*range(n), *range(n + 1, n + 5)]):
        return cdef_apply_ref(planes, coded, mask, dirs, var, y_gi, uv_gi,
                              ydamp, cdamp, cs)
    _check_planes("cdef_apply", planes, coded)
    nv8p, nh8p = mask.shape
    if mask.dtype != torch.uint8 or any(
            t.numel() != nv8p * nh8p for t in (dirs, var, y_gi, uv_gi)):
        raise ValueError("cdef_apply: a uint8 (nv8p, nh8p) mask and one "
                         "direction, variance and strength per unit")
    out = [torch.empty_like(p) for p in planes]
    chroma = n > 1
    u, v = (planes[1], planes[2]) if chroma else (planes[0], planes[0])
    ou, ov = (out[1], out[2]) if chroma else (out[0], out[0])
    hc, wc = u.shape if chroma else (0, 0)
    with torch.cuda.device(mask.device):
        _launched(_lib().svt_cdef_apply_launch(
            planes[0].data_ptr(), planes[0].shape[1], u.data_ptr(),
            v.data_ptr(), u.shape[1], out[0].data_ptr(), ou.data_ptr(),
            ov.data_ptr(), planes[0].shape[0], planes[0].shape[1], hc, wc,
            coded[0], coded[1], mask.data_ptr(), nv8p, nh8p, dirs.data_ptr(),
            var.data_ptr(), y_gi.data_ptr(), uv_gi.data_ptr(), ydamp, cdamp,
            cs, int(chroma), _stream(mask)))
    return out


class CdefFrames:
    """One encoder's CDEF on `device`: `search_frame` runs the search and
    the apply through the kernel on a CUDA device (through the plain
    version with kernels="plain") and through the plain version on the
    CPU.

    On CUDA the work runs on a stream of its own and the host waits on
    that stream's events only, so work queued on other streams (the next
    frame's analysis) neither waits for it nor holds it up. The planes go
    up and come back through pinned staging buffers, kept with their
    device copies while the frame geometry stays the same; a frame makes
    one small readback of the tables and one of the planes."""

    def __init__(self, device, kernels: str = "hand"):
        self.device = torch.device(device)
        self.kernels = check_kernels(kernels)
        self._stream = None
        self._shapes = None
        self._staging = None

    @property
    def uses_kernel(self) -> bool:
        return self.device.type == "cuda" and self.kernels == "hand"

    def search_frame(self, recon_planes, src_planes, skip_g, mi_rows: int,
                     mi_cols: int, base_q_idx: int, rdcost_fn,
                     level: int = 3, bit_depth: int = 8):
        """native/cdefc.py cdef_search_frame_c on this device: returns
        (bits, y_strengths, uv_strengths, fb_gi_map, damping), or None
        when no unit is filterable; filters recon_planes in place."""
        mask = unit_mask(skip_g, mi_rows, mi_cols)
        if mask is None:
            return None
        grid = mask.shape
        nvfb, nhfb = grid[0] // 8, grid[1] // 8
        nplanes = len(recon_planes)
        cs = bit_depth - 8
        damping = 3 + (base_q_idx >> 6)
        ydamp, cdamp = damping + cs, max(0, damping + cs - 1)
        cands = candidate_strengths(level)
        coded = (mi_rows * 4, mi_cols * 4)
        dirs_fn, search_fn, apply_fn = cdef_impl(self.kernels)
        up = self._uploader(recon_planes, src_planes[:nplanes], mask.size)
        with up:
            planes = [up.plane("rec", k, p)
                      for k, p in enumerate(recon_planes)]
            srcs = [up.plane("src", k, p)
                    for k, p in enumerate(src_planes[:nplanes])]
            units = up.small("units", search_units(mask, level))
            cand_t = up.small("cands", np.asarray(cands, np.int32))
            dirs, var = dirs_fn(planes[0], coded, grid, cs)
            mse0, mse1 = search_fn(planes, srcs, coded, units, grid, dirs,
                                   var, cand_t, ydamp, cdamp, cs)
            mse0, mse1 = up.fetch_tables(mse0, mse1)
            bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi = _select_strengths(
                mse0.astype(np.float64), mse1.astype(np.float64), mask, nvfb,
                nhfb, cands, rdcost_fn)
            out = apply_fn(planes, coded, up.small("mask", mask),
                           dirs, var, up.small("y_gi", y_gi),
                           up.small("uv_gi", uv_gi), ydamp, cdamp, cs)
            for rec, o in zip(recon_planes, up.fetch_planes(out)):
                np.copyto(rec, o)
        return bits, y_str, uv_str, fb_gi_map, damping

    def _uploader(self, recon_planes, src_planes, n_units):
        if self.device.type == "cpu":
            return _HostFrame()
        shapes = (n_units, *(p.shape for p in (*recon_planes, *src_planes)))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if shapes != self._shapes:
            self._staging = _Staging(self.device, recon_planes, src_planes,
                                     n_units)
            self._shapes = shapes
        return _CardFrame(self._staging, self._stream)


class _HostFrame(contextlib.nullcontext):
    """search_frame's copies on the CPU: none (tensors over the arrays)."""

    @staticmethod
    def plane(kind, k, arr):
        return torch.from_numpy(np.ascontiguousarray(arr))

    @staticmethod
    def small(name, arr):
        return torch.from_numpy(np.ascontiguousarray(arr))

    @staticmethod
    def fetch_tables(*tables):
        return [t.numpy() for t in tables]

    @staticmethod
    def fetch_planes(planes):
        return [t.numpy() for t in planes]


class _Staging:
    """Pinned host buffers and their device twins for one frame geometry:
    per plane the recon, its source and the filtered output, and per unit
    of the grid the small per-frame arrays."""

    def __init__(self, device, recon_planes, src_planes, n_units):
        def pair(shape, dtype):
            return (torch.empty(shape, dtype=dtype, pin_memory=True),
                    torch.empty(shape, dtype=dtype, device=device))

        self.planes = {
            ("rec", k): pair(p.shape, torch.int32)
            for k, p in enumerate(recon_planes)}
        self.planes.update({
            ("src", k): pair(p.shape, torch.int32)
            for k, p in enumerate(src_planes)})
        self.small = {name: pair(n_units, dt) for name, dt in (
            ("units", torch.int32), ("cands", torch.int32),
            ("mask", torch.uint8), ("y_gi", torch.int32),
            ("uv_gi", torch.int32))}
        self.out = [torch.empty(p.shape, dtype=torch.int32, pin_memory=True)
                    for p in recon_planes]
        # two (nfb, n_cand) tables: at most 64 candidates, 64 units an fb
        self.tables = torch.empty(2 * n_units, dtype=torch.int64,
                                  pin_memory=True)


class _CardFrame:
    """search_frame's copies on a CUDA device, on `stream`: uploads from
    the staging buffers, and fetches that wait on the stream's own event."""

    def __init__(self, staging: _Staging, stream):
        self.st = staging
        self.stream = stream
        self._ctx = torch.cuda.stream(stream)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def plane(self, kind, k, arr):
        pin, dev = self.st.planes[kind, k]
        np.copyto(pin.numpy(), arr, casting="unsafe")
        dev.copy_(pin, non_blocking=True)
        return dev

    def small(self, name, arr):
        pin, dev = self.st.small[name]
        n = arr.size
        pin[:n].numpy()[...] = arr.reshape(-1)
        d = dev[:n]
        d.copy_(pin[:n], non_blocking=True)
        return d.view(arr.shape)

    def fetch_tables(self, *tables):
        """The (nfb, n_cand) tables on the host, through one pinned buffer."""
        n = tables[0].numel()
        return self._fetch(tables, [
            self.st.tables[i * n:(i + 1) * n].view(t.shape)
            for i, t in enumerate(tables)])

    def fetch_planes(self, planes):
        return self._fetch(planes, self.st.out)

    def _fetch(self, tensors, pins):
        """Copies `tensors` into `pins` after this stream's work so far and
        waits for that stream alone."""
        for pin, t in zip(pins, tensors):
            pin.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.stream)
        done.synchronize()
        return [p.numpy() for p in pins]
