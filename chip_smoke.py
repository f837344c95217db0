#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (svt_av1_psyex_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the kernel phases one per size and batch), in
order; any failure raises and the script exits non-zero without a result:

1. device: the card's name and its power limit (nvidia-smi).
2. build: the hand-written kernels (fullloop, sad), built with nvcc from
   this checkout, one nvcc process per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card,
   with times of both.
   fullloop with the tolerances of the JAX package's kernel test
   (tests/test_pallas.py:64-75), with and without the inverse output, at
   an off-tile batch, at the batches the main paths give it (config 1;
   the 1080p encode of phase 6, whose 16 frames fold into one batch; the
   inter candidates of phase 5, one 720p frame per launch) and, for
   n = 4, which those paths do not reach, at one 1080p frame's batch.
   sad_lattice bit-exact, with 8-bit and 10-bit samples, at an off-tile
   batch and at one 720p (240 superblocks) and one 1080p (510) frame.
4. slice: the config-1 clip (tools/mkclip "blobs", 352x288, 32 frames,
   preset 12, qindex 140) through the port's Av1Encoder.encode_keyframes
   on the card, once with the kernels (the main path: the kernels'
   launch counts are set to 0 before this run and read after it) and
   once with kernels="plain". The TUs must agree byte for byte, or each
   differing frame is printed with its per-depth mode agreement
   (>= 0.98). Where libdav1d.so.6 loads, dav1d must decode every frame to
   the encoder's reconstruction bit for bit.
5. inter: config 2's shape without TF and TPL: 1280x720 8-bit "blobs", a
   keyframe and one 16-frame random-access mini-GOP (codec.gop.
   plan_minigop), preset 8, qindex 120, driven as the JAX package's API
   drives it (codec.encoder.encode_plans: same-layer runs begun, then
   resumed in order). A short warm-up (keyframe + 2-frame mini-GOP, with
   the kernels and with the plain versions), then a run with the kernels
   (the main path of this phase: both kernels' launch counts are set to 0
   before it and read after it) and one with kernels="plain". The TUs
   must agree byte for byte, or each differing frame is printed with its
   per-depth agreement of the winning candidate (>= 0.98). dav1d as in
   phase 4. fps, the host tier's stage seconds, bytes.
6. 1080p: 1920x1080 8-bit all-intra, 16 frames, preset 12, qindex 140:
   a warm-up encode, then a timed one (fps, device analysis vs host
   stages), then the device analysis alone with the kernels and with
   the plain versions.

Then a JSON line of the kernels ("launches": the count of the inter
phase's kernel run; fullloop "ms"/"plain_ms": its device time summed
over its launches in one 1080p 16-frame analysis, "max_abs_err": the
largest |inverse residual| difference against the plain version over
every compared block; sad "ms"/"plain_ms": one launch at one 720p
frame's 240 superblocks, "max_abs_err": the largest difference over
every compared lattice, 0 when bit-exact), the nvidia-smi line, and last
{"ok": true, "device": {...}}. The script imports torch and the port,
and checks that jax never entered sys.modules.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

CONFIG1 = dict(w=352, h=288, frames=32, preset=12, qindex=140)
HD = dict(w=1920, h=1080, frames=16, preset=12, qindex=140)
# config 2 (720p p8, CRF 30 -> qindex 120) without TF and TPL
INTER = dict(w=1280, h=720, frames=17, gop=16, warmup_gop=2, preset=8,
             qindex=120)
KERNELS = ("fullloop", "sad")
REPLACES = {"fullloop": "svt_av1_psyex_tpu/ops/pallas/fullloop.py:151",
            "sad": "svt_av1_psyex_tpu/ops/pallas/sad.py:69"}
SOURCES = {name: f"svt_av1_psyex_tpu_torch/ops/cuda/{name}.cu"
           for name in KERNELS}


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


def blocks(cfg: dict, n: int) -> int:
    """The n x n blocks of one frame of cfg, padded to 64."""
    hp, wp = -(-cfg["h"] // 64) * 64, -(-cfg["w"] // 64) * 64
    return (hp // n) * (wp // n)


def lattice_batch(cfg: dict, n: int, frames: int) -> int:
    """fullloop's batch at size n for `frames` frames of cfg's intra
    lattice: 7 modes x the n-blocks of each frame."""
    return 7 * blocks(cfg, n) * frames


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
        if n in (16, 32):
            # one inter candidate of one 720p frame (with the inverse)
            cases.append(("720p-inter-candidate", blocks(INTER, n)))
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


def superblocks(cfg: dict) -> int:
    return -(-cfg["h"] // 64) * -(-cfg["w"] // 64)


def phase_sad(device) -> dict:
    """Phase 3, sad_lattice: the kernel against its plain version on the
    card, bit-exact, 8-bit and 10-bit samples."""
    import torch

    from svt_av1_psyex_tpu_torch.ops.cuda.sad import sad_lattice
    from svt_av1_psyex_tpu_torch.ops.sad_ref import sad_lattice_ref

    worst = 0
    out = {}
    for label, nsb in (("off-tile", 7), ("720p", superblocks(INTER)),
                       ("1080p", superblocks(HD))):
        ms = {}
        for bd in (8, 10):
            g = torch.Generator(device=device).manual_seed(nsb * 16 + bd)
            tiles, wins = (
                torch.randint(0, 1 << bd, shape, generator=g, device=device,
                              dtype=torch.int32)
                for shape in ((nsb, 64, 64), (nsb, 80, 80)))
            got = sad_lattice(tiles, wins)
            want = sad_lattice_ref(tiles, wins)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            check(err == 0 and torch.equal(got, want),
                  f"sad_lattice nSB={nsb} {bd}-bit: kernel differs from "
                  f"the plain version (max |err| {err})")
            ms[bd] = (cuda_ms(lambda: sad_lattice(tiles, wins)),
                      cuda_ms(lambda: sad_lattice_ref(tiles, wins)))
            del tiles, wins, got, want
        print(f"kernels: sad_lattice {label} nSB={nsb}: bit-exact at 8 and "
              f"10 bits; kernel {ms[8][0]:.4f} ms vs plain {ms[8][1]:.4f} "
              f"ms (8-bit), {ms[10][0]:.4f} ms vs {ms[10][1]:.4f} ms "
              f"(10-bit)", flush=True)
        if label == "720p":
            out = {"ms": ms[8][0], "plain_ms": ms[8][1]}
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, **out}


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


def dav1d_check(tag: str, enc, tus: list, cfg: dict, recons=None) -> str:
    """Where libdav1d.so.6 loads, dav1d must decode every displayed frame
    to the encoder's reconstruction (`recons`, by default enc.recons) bit
    for bit, on all planes. Returns a word for the phase line."""
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    if not dav1d_loads():
        print(f"{tag}: dav1d absent (libdav1d.so.6 does not load): stream "
              "not decoded", flush=True)
        return "not decoded (dav1d absent)"
    recons = enc.recons if recons is None else recons
    bad = dav1d_mismatches(OUT_DIR / f"{tag}.ivf", tus, recons, cfg["w"],
                           cfg["h"])
    check(not bad, f"{tag}: dav1d output differs from the recon in frames "
          f"{bad}")
    return f"dav1d bit-exact on {len(recons)} frames"


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


def phase_slice(device) -> None:
    """Phase 4: config 1 through the port, kernels vs plain."""
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


def recording_encoder(cfg: dict, device, kernels: str):
    """The port's encoder for cfg, keeping each coded frame's device MD
    (whose stats hold the frame's analysis lattice) in `dmds`."""
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    class Recording(Av1Encoder):
        def _begin_frame_impl(self, *a, **k):
            st = super()._begin_frame_impl(*a, **k)
            if isinstance(st, dict):
                self.dmds.append(st["dmd"])
            return st

    enc = Recording(SequenceConfig(width=cfg["w"], height=cfg["h"]),
                    preset=cfg["preset"], device=device, kernels=kernels)
    enc.dmds = []
    return enc


def encode_gop(frames: list, gop: int, cfg: dict, device, kernels: str):
    """A keyframe, then one `gop`-frame random-access mini-GOP. Returns
    (encoder, TUs, display-order recons, seconds, coded-frame TU
    indices)."""
    from svt_av1_psyex_tpu.codec.gop import plan_minigop

    from svt_av1_psyex_tpu_torch.codec.encoder import encode_plans

    enc = recording_encoder(cfg, device, kernels)
    plans = plan_minigop(0, 1, gop, future_slot=1)
    t0 = time.perf_counter()
    tus = [enc.encode_frame(frames[0], cfg["qindex"], force_key=True)]
    recons = [enc.last_recon]
    more, shown = encode_plans(enc, plans, dict(enumerate(frames[:gop + 1])),
                               cfg["qindex"])
    dt = time.perf_counter() - t0
    coded = [0] + [1 + i for i, pl in enumerate(plans)
                   if pl.show_existing_slot is None]
    return enc, tus + more, recons + shown, dt, coded


def decision_agreement(dk, dp) -> dict:
    """Per depth: share of blocks whose winning candidate (inter frames)
    or mode (keyframes) agrees between two device MDs of one frame."""
    import numpy as np

    key = "cand" if "cand" in dk.stats[dk.DEPTHS[0]] else "mode"
    return {blk: float(np.mean(dk.stats[blk][key] == dp.stats[blk][key]))
            for blk in dk.DEPTHS}


def phase_inter(device) -> dict:
    """Phase 5: config 2's shape without TF and TPL through the port,
    kernels vs plain. Returns the kernel run's launch counts (the main
    path of this slice)."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop
    from svt_av1_psyex_tpu_torch.ops.cuda import sad as cuda_sad

    cfg = INTER
    frames = make_frames(cfg)
    for kernels in ("hand", "plain"):   # first-use loads, allocations
        encode_gop(frames, cfg["warmup_gop"], cfg, device, kernels)
    os.environ["SVT_TPU_TIMING"] = "1"  # the host tier's stage clock
    try:
        cuda_fullloop.launches = cuda_sad.launches = 0
        enc_k, tus_k, rec_k, dt_k, coded = encode_gop(
            frames, cfg["gop"], cfg, device, "hand")
        launches = {"fullloop": cuda_fullloop.launches,
                    "sad": cuda_sad.launches}
        enc_p, tus_p, _, dt_p, _ = encode_gop(frames, cfg["gop"], cfg,
                                              device, "plain")
    finally:
        del os.environ["SVT_TPU_TIMING"]
    for name, n in launches.items():
        check(n > 0, f"inter: the main path launched no {name} kernel")
    check(len(rec_k) == cfg["frames"] and all(len(t) > 0 for t in tus_k),
          "inter: expected a non-empty TU per coded frame and a recon per "
          "displayed frame")
    check(len(enc_k.dmds) == len(coded) and len(tus_k) == len(tus_p),
          "inter: frame counts of the two runs")
    diff = [i for i, (a, b) in enumerate(zip(tus_k, tus_p)) if a != b]
    for i in diff:
        check(i in coded, f"inter: show-existing TU {i} differs")
        agree = decision_agreement(enc_k.dmds[coded.index(i)],
                                   enc_p.dmds[coded.index(i)])
        print(f"inter: TU {i} differs between kernel and plain runs; "
              f"decision agreement per depth {agree}", flush=True)
        check(min(agree.values()) >= 0.98,
              f"inter: TU {i} decision agreement below 0.98")
    gate = dav1d_check("inter", enc_k, tus_k, cfg, recons=rec_k)

    def timing(enc):
        return {k: round(v, 4) for k, v in enc.timing.items()}

    print(f"inter: {cfg['w']}x{cfg['h']} 8-bit, keyframe + {cfg['gop']}-"
          f"frame mini-GOP ({len(tus_k)} TUs, {len(coded)} coded), "
          f"p{cfg['preset']}, q{cfg['qindex']}, depths "
          f"{enc_k.dmds[1].DEPTHS}: kernels {cfg['frames'] / dt_k:.3f} fps "
          f"({dt_k:.3f} s; host tier per stage, s: {timing(enc_k)}), plain "
          f"{cfg['frames'] / dt_p:.3f} fps ({dt_p:.3f} s; {timing(enc_p)}); "
          f"{len(diff)} of {len(tus_k)} TUs differ; {gate}; launches "
          f"{launches}; {sum(map(len, tus_k))} bytes", flush=True)
    return launches


def phase_hd(device) -> None:
    """Phase 6: 1080p all-intra, warm-up then a timed encode; then the
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
    check(launches > 0, "1080p: the main path launched no fullloop kernel")
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
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    # one nvcc per source, all at once (each a subprocess)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load(name)
        log = build.build_logs.get(name, "up to date")
        print(f"build: {name}: "
              + " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln or ln.startswith("built")),
              flush=True)
    print(f"build: {len(KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    measured = {"fullloop": phase_kernels(device), "sad": phase_sad(device)}
    phase_slice(device)
    launches = phase_inter(device)
    phase_hd(device)
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"]}
        for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
