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
   inter candidates of phase 5, one 720p frame per launch; TPL's float32
   closed-loop residual of one 720p frame, n = 16, B = 3600) and, for
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
7. config 2: BASELINE.json config 2 itself, "blobs" 1280x720 8-bit, 48
   frames, through the port's SvtAv1Encoder (api/encoder.py) at preset
   8, CRF 30, everything else at its default (random access, 16-frame
   mini-GOPs, keyframe TF, ARF TF and TPL on). A warm-up on the first 9
   frames (with the kernels and plain), then a timed run with the
   kernels (the main path of this phase: both kernels' launch counts
   are set to 0 before it and read after it) and one with
   kernels="plain", under SVT_TPU_TIMING=1 ("tf" and "tpl" among the
   stage seconds). The TUs must agree byte for byte; a differing TU
   must have the same qindex in both runs (else both runs' TPL r0 are
   printed and the phase fails) and >= 0.98 decision agreement per
   depth. dav1d as in phase 4. Then TPL's dispenser alone on the first
   24 frames, kernels vs plain (motion and the inter choice agree on
   >= 0.99 of the blocks; the largest relative dist/rate difference is
   printed), and the CLI (python -m svt_av1_psyex_tpu_torch.app.main
   --device cuda) in a subprocess on the first 9 frames as y4m
   (build/chip_smoke/config2.y4m): its IVF must equal the warm-up's API
   packets. fps, stage seconds, the per-frame qindex of both runs,
   bytes.

Then a JSON line of the kernels ("launches": the count of phase 7's
kernel run; fullloop "ms"/"plain_ms": its device time summed
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
# config 2 itself (720p 8-bit, p8, CRF 30) through the port's API, all 48
# frames; TPL is held on the card on its first 24, the CLI runs its first 9
CONFIG2 = dict(w=1280, h=720, frames=48, preset=8, crf=30, tpl_frames=24,
               cli_frames=9)
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


def residuals(b: int, n: int, seed: int, device, f32: bool = False):
    """Intra-like residual blocks on the card (tests/test_pallas.py's
    amplitudes); block 0 is all zero, whose eob must be 0. With f32, the
    float32 residuals of a prediction from an unrounded float recon (TPL's
    recrf): the same amplitudes plus a fraction in [-0.5, 0.5)."""
    import torch

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
        if n == 16:
            # TPL's closed-loop (recrf) residual of one 720p frame: f32
            cases.append(("720p-TPL-f32", blocks(CONFIG2, n)))
        if n == 32:
            cases.append(("config-1", lattice_batch(CONFIG1, n,
                                                    CONFIG1["frames"])))
        for label, b in cases:
            resid = residuals(b, n, 7 + n, device, f32=label.endswith("f32"))
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


def recording_api(cfg: dict, device, kernels: str, recon: bool = False):
    """The port's SvtAv1Encoder at config 2's settings (everything else
    at its default, so keyframe TF, ARF TF and TPL are on; the clip's 30
    fps), recording per packet the coded frame's (qindex, device MD), or
    None for a show-existing packet, and the r0 of every TPL group."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    class Recording(SvtAv1Encoder):
        def init(self):
            super().init()
            self.coded, self.r0s, self._last = [], [], None
            enc = self._enc
            begin, resume = enc.begin_frame, enc.resume_frame

            def begin_frame(*a, **k):
                st = begin(*a, **k)
                if not isinstance(st, dict):   # a show-existing TU
                    self._last = None
                return st

            def resume_frame(st):
                tu = resume(st)
                self._last = (st["fr"].base_q_idx, st["dmd"])
                return tu

            enc.begin_frame, enc.resume_frame = begin_frame, resume_frame

        def _run_tpl(self, look, base_qindex):
            model = super()._run_tpl(look, base_qindex)
            self.r0s.append([model.r0(i) for i in range(model.f)])
            return model

        def _emit(self, tu, pts, ftype, shown):
            self.coded.append(self._last)
            super()._emit(tu, pts, ftype, shown)

    api = Recording(device=device, kernels=kernels)
    c = api.config
    c.source_width, c.source_height = cfg["w"], cfg["h"]
    c.enc_mode, c.crf = cfg["preset"], cfg["crf"]
    c.frame_rate_numerator, c.frame_rate_denominator = 30, 1
    c.recon_enabled = recon
    api.init()
    check(c.enable_tf and c.kf_tf_strength > 0 and api._tpl_on(),
          "config 2: TF, keyframe TF and TPL must be on at the defaults")
    return api


def api_encode(frames: list, cfg: dict, device, kernels: str,
               recon: bool = False):
    """All of `frames` through the port's API, then EOS. Returns (api,
    packets, recons in display order, seconds)."""
    api = recording_api(cfg, device, kernels, recon)
    t0 = time.perf_counter()
    for t, f in enumerate(frames):
        api.send_picture(f, t)
    api.send_picture(None)
    pkts = []
    while (p := api.get_packet()) is not None:
        if not p.is_eos:
            pkts.append(p)
    dt = time.perf_counter() - t0
    recons = {}
    while recon and (r := api.get_recon()) is not None:
        recons[r.pts] = r.planes
    return api, pkts, [recons[t] for t in sorted(recons)], dt


def tpl_on_card(frames: list, cfg: dict, device) -> str:
    """TPL's dispenser on one 720p group with the kernels and with their
    plain versions: motion and the inter choice agree on >= 0.99 of the
    blocks. Returns the phase-line words (agreements, the largest
    relative dist/rate difference, times)."""
    import numpy as np
    import torch

    from svt_av1_psyex_tpu_torch.codec.md_device import upload_lumas
    from svt_av1_psyex_tpu_torch.device.intra import qp_row_for
    from svt_av1_psyex_tpu_torch.device.me import _pad64
    from svt_av1_psyex_tpu_torch.device.tpl import STAT_FIELDS, tpl_group_stats

    n = cfg["tpl_frames"]
    srcs = upload_lumas(np.stack([_pad64(f[0]) for f in frames[:n]]), 8,
                        device)
    qp = qp_row_for(cfg["crf"] * 4, 0, 0, 8)
    out, ms = {}, {}
    for kernels in ("hand", "plain", "plain", "hand"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kernels] = tpl_group_stats(srcs, qp, 8, kernels).cpu().numpy()
        ms.setdefault(kernels, []).append(
            round((time.perf_counter() - t0) * 1e3, 3))
    k, p = out["hand"], out["plain"]
    words = []
    for name in ("mv_y", "mv_x", "is_inter"):
        i = STAT_FIELDS.index(name)
        agree = float(np.mean(k[:, i] == p[:, i]))
        check(agree >= 0.99, f"config 2 TPL: {name} agreement {agree}")
        words.append(f"{name} {agree:.6f}")
    for name in ("srcrf_dist", "recrf_dist", "srcrf_rate", "recrf_rate"):
        i = STAT_FIELDS.index(name)
        rel = np.abs(k[:, i] - p[:, i]) / np.maximum(np.abs(p[:, i]), 1.0)
        words.append(f"{name} max rel {rel.max():.3g}")
    return (f"TPL on {n} frames: kernels {ms['hand']} ms, plain "
            f"{ms['plain']} ms (kernels/plain/plain/kernels order); "
            f"agreement {', '.join(words)}; inter share "
            f"{float(k[1:, STAT_FIELDS.index('is_inter')].mean()):.4f}")


def cli_vs_api(frames: list, cfg: dict, device, api_pkts: list) -> str:
    """The port's CLI on the clip's first frames as y4m, in a subprocess
    on the card: its IVF frames must equal the API's packets
    (`api_pkts`, the same frames in-process). The CLI's tune and
    variance-octile defaults differ from the API's, so it is given the
    API's."""
    from svt_av1_psyex_tpu.utils.ivf import read_ivf
    from svt_av1_psyex_tpu.utils.y4m import Y4MWriter

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    y4m, ivf = OUT_DIR / "config2.y4m", OUT_DIR / "config2_cli.ivf"
    with open(y4m, "wb") as fh:
        wr = Y4MWriter(fh, VideoFormat(cfg["w"], cfg["h"],
                                       fps=Fraction(30, 1)))
        for f in frames:
            wr.write_frame(f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "svt_av1_psyex_tpu_torch.app.main",
         "-i", str(y4m), "-b", str(ivf), "--device", str(device),
         "--preset", str(cfg["preset"]), "--crf", str(cfg["crf"]),
         "--tune", "0", "--variance-octile", "5", "--progress", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"config 2 CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(ivf, "rb") as fh:
        got = list(read_ivf(fh))
    check(got == [(p.pts, p.data) for p in api_pkts],
          f"config 2 CLI: its {len(got)} IVF frames differ from the API's "
          f"{len(api_pkts)} packets")
    return (f"CLI on {len(frames)} frames: IVF equals the API's "
            f"{len(got)} packets ({dt:.3f} s for the subprocess)")


def phase_config2(device) -> dict:
    """Phase 7: config 2 through the port's SvtAv1Encoder, kernels vs
    plain; TPL on the card; the CLI. Returns the kernel run's launch
    counts (the main path of this phase)."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop
    from svt_av1_psyex_tpu_torch.ops.cuda import sad as cuda_sad

    cfg = CONFIG2
    frames = make_frames(cfg)
    # warm-up: the CLI's frames, with the kernels (kept for the CLI
    # comparison) and with the plain versions
    head = frames[:cfg["cli_frames"]]
    _, head_pkts, _, _ = api_encode(head, cfg, device, "hand")
    api_encode(head, cfg, device, "plain")
    os.environ["SVT_TPU_TIMING"] = "1"  # stage clock: tf, tpl, host tier
    try:
        cuda_fullloop.launches = cuda_sad.launches = 0
        api_k, pk, rec_k, dt_k = api_encode(frames, cfg, device, "hand",
                                            recon=True)
        launches = {"fullloop": cuda_fullloop.launches,
                    "sad": cuda_sad.launches}
        api_p, pp, _, dt_p = api_encode(frames, cfg, device, "plain")
    finally:
        del os.environ["SVT_TPU_TIMING"]
    for name, n in launches.items():
        check(n > 0, f"config 2: the main path launched no {name} kernel")
    check(len(rec_k) == cfg["frames"] and len(pk) == len(pp)
          and all(len(p.data) > 0 for p in pk),
          "config 2: expected a non-empty packet per TU, the same count in "
          "both runs, and a recon per frame")
    check("tf" in api_k._enc.timing and "tpl" in api_k._enc.timing,
          "config 2: tf and tpl missing from the stage seconds")
    qk = [(p.pts, c[0]) for p, c in zip(pk, api_k.coded) if c is not None]
    qp_ = [(p.pts, c[0]) for p, c in zip(pp, api_p.coded) if c is not None]
    diff = [i for i, (a, b) in enumerate(zip(pk, pp)) if a.data != b.data]
    for i in diff:
        ck, cp = api_k.coded[i], api_p.coded[i]
        check(ck is not None and cp is not None,
              f"config 2: show-existing TU {i} differs")
        if ck[0] != cp[0]:
            print(f"config 2: TU {i} (pts {pk[i].pts}) qindex {ck[0]} with "
                  f"the kernels, {cp[0]} plain; TPL r0 with the kernels "
                  f"{api_k.r0s}, plain {api_p.r0s}", flush=True)
            check(False, f"config 2: TU {i} qindex differs")
        agree = decision_agreement(ck[1], cp[1])
        print(f"config 2: TU {i} (pts {pk[i].pts}, qindex {ck[0]}) differs "
              f"between kernel and plain runs; decision agreement per "
              f"depth {agree}", flush=True)
        check(min(agree.values()) >= 0.98,
              f"config 2: TU {i} decision agreement below 0.98")
    gate = dav1d_check("config2", None, [p.data for p in pk], cfg,
                       recons=rec_k)
    tpl = tpl_on_card(frames, cfg, device)
    cli = cli_vs_api(head, cfg, device, head_pkts)

    def timing(api):
        return {k: round(v, 4) for k, v in api._enc.timing.items()}

    print(f"config 2: {cfg['w']}x{cfg['h']} 8-bit, {cfg['frames']} frames, "
          f"p{cfg['preset']}, CRF {cfg['crf']}, TF + TPL on, through "
          f"SvtAv1Encoder ({len(pk)} TUs): kernels "
          f"{cfg['frames'] / dt_k:.3f} fps ({dt_k:.3f} s; stage seconds "
          f"{timing(api_k)}), plain {cfg['frames'] / dt_p:.3f} fps "
          f"({dt_p:.3f} s; {timing(api_p)}); qindex per coded frame "
          f"(pts, q): kernels {qk}, plain {qp_}; {len(diff)} of {len(pk)} "
          f"TUs differ; {gate}; launches {launches}; "
          f"{sum(len(p.data) for p in pk)} bytes", flush=True)
    print(f"config 2: {tpl}", flush=True)
    print(f"config 2: {cli}", flush=True)
    return launches


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
    phase_inter(device)
    phase_hd(device)
    launches = phase_config2(device)
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
