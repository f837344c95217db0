#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (svt_av1_psyex_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the kernel phase one per size and batch), in
order; any failure raises and the script exits non-zero without a result:

1. device: the card's name and its power limit (nvidia-smi).
2. build: the hand-written kernels, built with nvcc from this checkout.
3. kernels: each kernel against its plain PyTorch version on the card,
   with the tolerances of the JAX package's kernel test
   (tests/test_pallas.py:64-75), with and without the inverse output, at
   an off-tile batch, at the batches the main path gives it (config 1;
   the 1080p encode of phase 5, whose 16 frames fold into one batch) and,
   for n = 4, which those paths do not reach, at one 1080p frame's batch;
   times of both.
4. slice: the config-1 clip (tools/mkclip "blobs", 352x288, 32 frames,
   preset 12, qindex 140) through the port's Av1Encoder.encode_keyframes
   on the card, once with the kernels (the main path: the kernels'
   launch counts are set to 0 before this run and read after it) and
   once with kernels="plain". The TUs must agree byte for byte, or each
   differing frame is printed with its per-depth mode agreement
   (>= 0.98). Where libdav1d.so.6 loads, dav1d must decode every frame to
   the encoder's reconstruction bit for bit.
5. 1080p: 1920x1080 8-bit all-intra, 16 frames, preset 12, qindex 140:
   a warm-up encode, then a timed one (fps, device analysis vs host
   stages), then the device analysis alone with the kernels and with
   the plain versions.

Then a JSON line of the kernels ("ms"/"plain_ms": the kernel's device
time summed over its launches in one 1080p 16-frame analysis,
"max_abs_err": the largest |inverse residual| difference against the
plain version over every compared block), the nvidia-smi line, and last
{"ok": true, "device": {...}}. The script imports torch and the port,
and checks that jax never entered sys.modules.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

CONFIG1 = dict(w=352, h=288, frames=32, preset=12, qindex=140)
HD = dict(w=1920, h=1080, frames=16, preset=12, qindex=140)
FULLLOOP_REPLACES = "svt_av1_psyex_tpu/ops/pallas/fullloop.py:151"
FULLLOOP_SOURCE = "svt_av1_psyex_tpu_torch/ops/cuda/fullloop.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over `reps` launches, after a warm-up."""
    import torch

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


def lattice_batch(cfg: dict, n: int, frames: int) -> int:
    """fullloop's batch at size n for `frames` frames of cfg: 7 modes x
    the n-blocks of the frame padded to 64."""
    hp, wp = -(-cfg["h"] // 64) * 64, -(-cfg["w"] // 64) * 64
    return 7 * (hp // n) * (wp // n) * frames


def residuals(b: int, n: int, seed: int, device):
    """Intra-like residual blocks on the card (tests/test_pallas.py's
    amplitudes); block 0 is all zero, whose eob must be 0."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    resid = (torch.randint(-64, 65, (b, n, n), generator=g, device=device,
                           dtype=torch.int32)
             + torch.randint(-2, 3, (b, n, n), generator=g, device=device,
                             dtype=torch.int32) * 40)
    resid[0] = 0
    return resid


def compare_fullloop(mk, mp, ik, ip, resid) -> dict:
    """Kernel (mk, ik) vs plain (mp, ip) on the card, with the tolerances
    of tests/test_pallas.py:64-75. The inverse must agree on every block
    whose eob and rate agree (a coefficient on a quantization boundary
    may round to the other level in another summation order; those
    blocks are counted)."""
    import torch

    sse_ref = resid.to(torch.float64).square().sum(dim=(1, 2))
    check(torch.allclose(mk[:, 3].double(), sse_ref, rtol=1e-5),
          "fullloop sse")
    check(torch.allclose(mk[:, 0], mp[:, 0], rtol=1e-3, atol=2.0),
          "fullloop dist")
    eob_eq = (mk[:, 2] == mp[:, 2]).double().mean().item()
    check(eob_eq > 0.98, f"fullloop eob agreement {eob_eq}")
    rdiff = (mk[:, 1] - mp[:, 1]).abs() / mp[:, 1].clamp_min(512)
    rate_ok = (rdiff < 0.02).double().mean().item()
    check(rate_ok > 0.98, f"fullloop rate agreement {rate_ok}")
    check(mk[0, 2].item() == 0, "fullloop eob of the all-zero block")
    check(bool((mk[:, 4:] == 0).all()), "fullloop metrics columns 4-7")
    same = (mk[:, 1] == mp[:, 1]) & (mk[:, 2] == mp[:, 2])
    check(torch.allclose(ik[same], ip[same], rtol=1e-2, atol=2.0),
          "fullloop inverse residual")
    err = (ik[same] - ip[same]).abs().max().item() if same.any() else 0.0
    return {"eob_eq": eob_eq, "flipped": int((~same).sum().item()),
            "max_abs_err_inv": err}


def phase_kernels(device) -> dict:
    """Phase 3: fullloop kernel vs its plain version on the card."""
    import torch

    from svt_av1_psyex_tpu_torch.device.intra import qp6_for, qp_row_for
    from svt_av1_psyex_tpu_torch.ops.cuda.fullloop import fullloop
    from svt_av1_psyex_tpu_torch.ops.fullloop_ref import fullloop_ref

    qp_row = qp_row_for(CONFIG1["qindex"], 0, 0, 8)
    worst = 0.0
    hd_ms = [0.0, 0.0]
    for n in (4, 8, 16, 32):
        ls = 1 if n == 32 else 0
        qp6 = qp6_for(qp_row, ls)
        cases = [("off-tile", 150)]
        if n == 4:
            cases.append(("1080p-1-frame", lattice_batch(HD, n, 1)))
        else:
            cases.append(("1080p-16-frames", lattice_batch(HD, n,
                                                           HD["frames"])))
        if n == 32:
            cases.append(("config-1", lattice_batch(CONFIG1, n,
                                                    CONFIG1["frames"])))
        for label, b in cases:
            resid = residuals(b, n, 7 + n, device)
            mk, ik = fullloop(resid, qp6, n, ls, want_inv=True)
            mp, ip = fullloop_ref(resid, qp6, n, ls, want_inv=True)
            mk0, none = fullloop(resid, qp6, n, ls, want_inv=False)
            torch.cuda.synchronize()
            check(none is None and torch.equal(mk, mk0),
                  f"fullloop n={n}: metrics depend on want_inv")
            st = compare_fullloop(mk, mp, ik, ip, resid)
            del mk, ik, mp, ip, mk0
            worst = max(worst, st["max_abs_err_inv"])
            ms = {}
            for want_inv in (False, True):
                ms[want_inv] = (
                    cuda_ms(lambda: fullloop(resid, qp6, n, ls, want_inv)),
                    cuda_ms(lambda: fullloop_ref(resid, qp6, n, ls,
                                                 want_inv)))
            print(f"kernels: fullloop n={n} {label} B={b}: kernel "
                  f"{ms[False][0]:.4f} ms vs plain {ms[False][1]:.4f} ms; "
                  f"with inv {ms[True][0]:.4f} ms vs {ms[True][1]:.4f} ms; "
                  f"eob agreement {st['eob_eq']:.6f}, {st['flipped']} "
                  f"blocks at a quantization boundary, max |inv err| "
                  f"{st['max_abs_err_inv']:.6g}", flush=True)
            if label == "1080p-16-frames":
                hd_ms[0] += ms[False][0]
                hd_ms[1] += ms[False][1]
            del resid
            torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": hd_ms[0], "plain_ms": hd_ms[1]}


def make_frames(cfg: dict) -> list:
    sys.path.insert(0, str(ROOT / "tools"))
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    fmt = VideoFormat(cfg["w"], cfg["h"], fps=Fraction(30, 1))
    return [synth_frame(fmt, t, "blobs") for t in range(cfg["frames"])]


def make_encoder(cfg: dict, device, kernels: str):
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    return Av1Encoder(SequenceConfig(width=cfg["w"], height=cfg["h"]),
                      preset=cfg["preset"], device=device, kernels=kernels)


def encode(frames: list, cfg: dict, device, kernels: str):
    enc = make_encoder(cfg, device, kernels)
    t0 = time.perf_counter()
    tus = enc.encode_keyframes(frames, cfg["qindex"])
    return enc, tus, time.perf_counter() - t0


def dav1d_check(tag: str, enc, tus: list, cfg: dict) -> str:
    """Where libdav1d.so.6 loads, dav1d must decode every frame to the
    encoder's reconstruction bit for bit. Returns a word for the phase
    line."""
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    if not dav1d_loads():
        print(f"{tag}: dav1d absent (libdav1d.so.6 does not load): stream "
              "not decoded", flush=True)
        return "not decoded (dav1d absent)"
    bad = dav1d_mismatches(OUT_DIR / f"{tag}.ivf", tus, enc.recons,
                           cfg["w"], cfg["h"])
    check(not bad, f"{tag}: dav1d output differs from the recon in frames "
          f"{bad}")
    return f"dav1d bit-exact on {len(tus)} frames"


def mode_agreement(enc_k, enc_p, frames: list, cfg: dict) -> list:
    """Per frame, per depth: share of blocks whose device mode decision
    agrees between the kernel run (enc_k) and the plain run (enc_p)."""
    import numpy as np

    from svt_av1_psyex_tpu_torch.device.intra import unpack_rd_analysis

    depths = enc_k.keyframe_depths()
    hp, wp = -(-enc_k.aligned_h // 64) * 64, -(-enc_k.aligned_w // 64) * 64
    rows_k = enc_k.analyze_keyframes(frames, cfg["qindex"])
    rows_p = enc_p.analyze_keyframes(frames, cfg["qindex"])
    out = []
    for rk, rp in zip(rows_k, rows_p):
        a = unpack_rd_analysis(rk, hp, wp, depths)
        b = unpack_rd_analysis(rp, hp, wp, depths)
        out.append({blk: float(np.mean(a[blk]["mode"] == b[blk]["mode"]))
                    for blk in depths})
    return out


def stages(enc) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in enc.stage_seconds.items())


def phase_slice(device) -> int:
    """Phase 4: config 1 through the port, kernels vs plain. Returns the
    fullloop launches of the kernel run (the main path)."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop

    frames = make_frames(CONFIG1)
    encode(frames, CONFIG1, device, "hand")  # first-use loads, allocations
    cuda_fullloop.launches = 0
    enc_k, tus_k, dt_k = encode(frames, CONFIG1, device, "hand")
    launches = cuda_fullloop.launches
    check(launches > 0, "slice: the main path launched no fullloop kernel")
    enc_p, tus_p, dt_p = encode(frames, CONFIG1, device, "plain")
    check(len(tus_k) == CONFIG1["frames"] and all(len(t) > 0 for t in tus_k),
          "slice: expected one non-empty TU per frame")
    diff = [i for i, (a, b) in enumerate(zip(tus_k, tus_p)) if a != b]
    if diff:
        agree = mode_agreement(enc_k, enc_p, frames, CONFIG1)
        for i in diff:
            print(f"slice: frame {i} TU differs between kernel and plain "
                  f"runs; mode agreement per depth {agree[i]}", flush=True)
            check(min(agree[i].values()) >= 0.98,
                  f"slice: frame {i} mode agreement below 0.98")
    gate = dav1d_check("config1", enc_k, tus_k, CONFIG1)
    print(f"slice: config 1 ({CONFIG1['w']}x{CONFIG1['h']}, "
          f"{CONFIG1['frames']} frames, p{CONFIG1['preset']}, "
          f"q{CONFIG1['qindex']}): kernels {CONFIG1['frames'] / dt_k:.3f} "
          f"fps (s: {stages(enc_k)}), plain "
          f"{CONFIG1['frames'] / dt_p:.3f} fps (s: {stages(enc_p)}); "
          f"{len(diff)} of "
          f"{len(tus_k)} TUs differ; {gate}; fullloop launches {launches}; "
          f"{sum(map(len, tus_k))} bytes", flush=True)
    return launches


def phase_hd(device) -> None:
    """Phase 5: 1080p all-intra, warm-up then a timed encode; then the
    device analysis alone, kernels vs plain."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop

    frames = make_frames(HD)
    encode(frames, HD, device, "hand")
    cuda_fullloop.launches = 0
    # the host tier's own per-stage clock (accumulated in enc.timing)
    os.environ["SVT_TPU_TIMING"] = "1"
    try:
        enc, tus, dt = encode(frames, HD, device, "hand")
    finally:
        del os.environ["SVT_TPU_TIMING"]
    launches = cuda_fullloop.launches
    check(len(tus) == HD["frames"] and all(len(t) > 0 for t in tus),
          "1080p: expected one non-empty TU per frame")
    gate = dav1d_check("hd", enc, tus, HD)
    analysis = {}
    for kernels in ("hand", "plain", "plain", "hand"):
        a = make_encoder(HD, device, kernels)
        t0 = time.perf_counter()
        a.analyze_keyframes(frames, HD["qindex"])
        analysis.setdefault(kernels, []).append(time.perf_counter() - t0)
    print(f"1080p: {HD['w']}x{HD['h']} 8-bit, {HD['frames']} frames, "
          f"p{HD['preset']}, q{HD['qindex']}: {HD['frames'] / dt:.3f} fps "
          f"({dt:.3f} s: {stages(enc)}; host tier per stage, s: "
          f"{ {k: round(v, 4) for k, v in enc.timing.items()} }); "
          f"analysis alone (s, "
          f"kernels/plain/plain/kernels order): kernels "
          f"{analysis['hand']}, plain {analysis['plain']}; depths "
          f"{enc.keyframe_depths()}; fullloop launches {launches}; "
          f"{sum(map(len, tus))} bytes; {gate}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from svt_av1_psyex_tpu_torch.ops.cuda import build
    from svt_av1_psyex_tpu_torch.runtime import resolve_device

    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    build.load("fullloop")
    log = build.build_logs.get("fullloop", "up to date")
    print(f"build: fullloop in {time.perf_counter() - t0:.3f} s; "
          + " | ".join(ln.strip() for ln in log.splitlines()
                       if "registers" in ln or ln.startswith("built")),
          flush=True)

    kern = phase_kernels(device)
    launches = phase_slice(device)
    phase_hd(device)
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [{
        "name": "fullloop", "route": "cuda", "source": FULLLOOP_SOURCE,
        "replaces": FULLLOOP_REPLACES, "launches": launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
