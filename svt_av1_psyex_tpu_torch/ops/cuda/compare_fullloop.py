"""Hold the fullloop kernel against an earlier version of its source on
the card: which outputs are bit-identical, and the times of both.

    python3 -m svt_av1_psyex_tpu_torch.ops.cuda.compare_fullloop OLD.cu
    python3 -m svt_av1_psyex_tpu_torch.ops.cuda.compare_fullloop --sass

OLD.cu is an earlier fullloop.cu whose `svt_fullloop_launch` takes the
matrices and scan positions as device pointers (resid, resid_is_float,
nblocks, n, fc, fr, gc, gr, spos, the six quantizer numbers, log_scale,
metrics, inv, stream); for example the source of an earlier commit,
written out with `git show <commit>:<path>`. It is built with the same
nvcc flags as the current one. For each batch of chip_smoke.py's phase 3
the script prints, per metrics column and for the inverse residual, the
share of blocks whose values are bit-identical between the two builds,
the largest difference, and both kernels' times (CUDA events) against the
roofline bound. Needs one NVIDIA GPU.

With --sass it prints instead, for each instantiation of the current
kernel, its SASS instruction mix (cuobjdump of the built library): the
FMAs, shared and global memory instructions and the rest, and for each
loop (the instructions from a backward branch's target to the branch)
its size and its FMAs.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ...device.intra import qp6_for, qp_row_for
from ...params import reference_constants
from ...runtime import resolve_device
from . import build
from .fullloop import fullloop
from .roofline import fullloop_bound

# (label, n, B, float32 input): chip_smoke.py phase 3's batches
CASES = [("off-tile", n, 150, False) for n in (4, 8, 16, 32)] + [
    ("1080p-1-frame", 4, 913920, False),
    ("1080p-16-frames", 8, 3655680, False),
    ("1080p-16-frames", 16, 913920, False),
    ("1080p-16-frames", 32, 228480, False),
    ("720p-inter-candidate", 16, 3840, False),
    ("720p-inter-candidate", 32, 960, False),
    ("720p-TPL-f32", 16, 3840, True),
    ("config-1", 32, 26880, False),
]
COLUMNS = ("dist", "rate", "eob", "sse")


def build_old(src: Path):
    out = build.BUILD_DIR / "libfullloop_old.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svt_fullloop_launch.argtypes = (
        [vp, i, ctypes.c_longlong, i] + [vp] * 5 + [f] * 6 + [i, vp, vp, vp])
    lib.svt_fullloop_launch.restype = i
    return lib


def old_fullloop(lib, resid, qp6, n, log_scale, want_inv):
    b, dev = resid.shape[0], resid.device
    metrics = torch.empty((b, 8), dtype=torch.float32, device=dev)
    inv = (torch.empty((b, n, n), dtype=torch.float32, device=dev)
           if want_inv else None)
    consts = reference_constants(dev)
    fc, fr = consts["fwd_mats"][n]
    gc, gr = consts["inv_mats"][n]
    err = lib.svt_fullloop_launch(
        resid.data_ptr(), int(resid.dtype == torch.float32), b, n,
        fc.data_ptr(), fr.data_ptr(), gc.data_ptr(), gr.data_ptr(),
        consts["scan_pos"][n].data_ptr(), *[float(v) for v in qp6],
        int(log_scale), metrics.data_ptr(),
        inv.data_ptr() if want_inv else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"old fullloop launch failed ({err})")
    return metrics, inv


def residuals(b: int, n: int, seed: int, device, f32: bool):
    """chip_smoke.py's residuals: intra-like amplitudes, block 0 zero."""
    g = torch.Generator(device=device).manual_seed(seed)
    resid = (torch.randint(-64, 65, (b, n, n), generator=g, device=device,
                           dtype=torch.int32)
             + torch.randint(-2, 3, (b, n, n), generator=g, device=device,
                             dtype=torch.int32) * 40)
    if f32:
        resid = resid.to(torch.float32) + torch.rand(
            (b, n, n), generator=g, device=device) - 0.5
    resid[0] = 0
    return resid


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sass_mix() -> None:
    lib = build.build("fullloop")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    line = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)(?:[.\w]*)\s*([^;]*);")
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op, args) for a, op, args in line.findall(fn)]
        # labels (".L_x_3:") stand before the instruction they name
        labels = {m.group(1): int(m.group(2), 16) for m in re.finditer(
            r"(\.L_x_\d+):\s*/\*([0-9a-f]{4,})\*/", fn)}
        kinds = ("FFMA", "LDS", "STS", "LDG", "STG")
        count = {k: sum(op == k for _, op, _ in ins) for k in kinds}
        loops = []
        for addr, op, args in ins:
            lab = re.search(r"(\.L_x_\d+)", args)
            hexa = re.match(r"\s*0x([0-9a-f]+)", args)
            tgt = (labels.get(lab.group(1)) if lab
                   else int(hexa.group(1), 16) if hexa else None)
            if op == "BRA" and tgt is not None and tgt < addr:
                body = [o for a, o, _ in ins if tgt <= a <= addr]
                loops.append(f"{len(body)} instructions, "
                             f"{sum(o == 'FFMA' for o in body)} FFMA")
        print(f"sass: {name}: {len(ins)} instructions; "
              + ", ".join(f"{k} {v}" for k, v in count.items())
              + f", other {len(ins) - sum(count.values())}; loops: "
              + ("; ".join(loops) or "none"), flush=True)


def main(argv: list[str]) -> int:
    if argv == ["--sass"]:
        sass_mix()
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    old = build_old(Path(argv[0]))
    qp_row = qp_row_for(140, 0, 0, 8)
    for label, n, b, f32 in CASES:
        ls = 1 if n == 32 else 0
        qp6 = qp6_for(qp_row, ls)
        resid = residuals(b, n, 7 + n, device, f32)
        mn, inn = fullloop(resid, qp6, n, ls, want_inv=True)
        mo, ino = old_fullloop(old, resid, qp6, n, ls, want_inv=True)
        torch.cuda.synchronize()
        same = []
        for c, name in enumerate(COLUMNS):
            eq = (mn[:, c] == mo[:, c]).double().mean().item()
            d = (mn[:, c] - mo[:, c]).abs().max().item()
            same.append(f"{name} {eq:.6f} (max |diff| {d:.6g})")
        inv_eq = (inn == ino).flatten(1).all(dim=1).double().mean().item()
        inv_d = (inn - ino).abs().max().item()
        same.append(f"inverse {inv_eq:.6f} (max |diff| {inv_d:.6g})")
        del mn, inn, mo, ino
        t = {}
        for want_inv in (False, True):
            t[want_inv] = (
                cuda_ms(lambda: fullloop(resid, qp6, n, ls, want_inv)),
                cuda_ms(lambda: old_fullloop(old, resid, qp6, n, ls,
                                             want_inv)))
        bnd = fullloop_bound(b, n)
        print(f"compare: fullloop n={n} {label} B={b}: bit-identical "
              f"blocks, new vs old: {'; '.join(same)}. new {t[False][0]:.4f}"
              f" ms ({bnd['bound_ms'] / t[False][0]:.1%} of the "
              f"{bnd['bound_ms']:.4f} ms {bnd['bound_by']} bound), old "
              f"{t[False][1]:.4f} ms ({bnd['bound_ms'] / t[False][1]:.1%}); "
              f"with inv: new {t[True][0]:.4f} ms, old {t[True][1]:.4f} ms",
              flush=True)
        del resid
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
