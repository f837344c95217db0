#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (svt_av1_psyex_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (the kernel phases one per size and batch), in
order, each followed by a "time:" line with its wall seconds; any
failure raises and the script exits non-zero without a result:

1. device: the card's name and its power limit (nvidia-smi).
2. build: the hand-written kernels (fullloop, sad, cdef), built with nvcc from
   this checkout, one nvcc process per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card,
   with times of both and the kernel's bound and share of it; for TPL's
   float32 case also the fullloop wrapper's host time per call and the
   kernel's device time per launch from torch.profiler.
   fullloop with the tolerances of the JAX package's kernel test
   (tests/test_pallas.py:64-75), with and without the inverse output, at
   an off-tile batch, at the batches the main paths give it (config 1;
   the 1080p encode of phase 6, whose 16 frames fold into one batch; the
   inter candidates of phase 5, one 720p frame per launch; TPL's float32
   closed-loop residual of one 720p frame, n = 16, B = 3840: TPL pads 720
   rows to 768), at one 1080p 10-bit frame's lattice batch for n = 16 and
   32 (config 3's qindex, residual amplitudes four times the 8-bit ones)
   and, for n = 4, which those paths do not reach, at one 1080p frame's
   batch.
   sad_lattice bit-exact, with 8-bit and 10-bit samples, at an off-tile
   batch and at one 720p (240 superblocks) and one 1080p (510) frame.
   Both also at the batches of the later phases' paths: fullloop at a
   4-frame chunk of phase 6's group (n = 8, 16, 32), at phase 11's
   larger 1080p shard (2 frames, 9 of 17 superblock rows) and at a
   quarter of a 720p inter candidate (a (1, 4) shard); sad_lattice at a
   720p shard (60 superblocks) and at phase 12's host-MD motion field
   (one 128x96 frame, 4 superblocks).
   cdef: its three launches (dirs, search, apply) on card tensors against
   the plain version (ops/cdef_ref.py) on the same tensors, directions,
   variances, both int64 distortion tables and the filtered planes equal,
   on the two cells' frames (1280x720 8-bit, 1920x1080 10-bit, search
   level 5) and on two ragged frames off the filter blocks (200x136 mono
   at level 1, 104x72 10-bit at level 7); each launch's time, the plain
   version's and the bound (ops/cuda/roofline.py cdef_bound). Then the
   kernel's frame runner (ops/cuda/cdef.py CdefFrames, the main path's
   entry) against the host C (native/cdefc.py): the same result and
   planes; both whole frames timed on the host's clock.
4. slice: the config-1 clip (the "blobs" clip of tools/mkclip.py, made by
   svt_av1_psyex_tpu_torch/utils/clips.py; 352x288, 32 frames,
   preset 12, qindex 140) through the port's Av1Encoder.encode_keyframes
   on the card, once with the kernels (the main path: the kernels'
   launch counts are set to 0 before this run and read after it) and
   once with kernels="plain". The TUs must agree byte for byte, or each
   differing frame is printed with its per-depth mode agreement
   (>= 0.98). Where libdav1d.so.6 loads, dav1d must decode every frame to
   the encoder's reconstruction bit for bit. Where libaom.so.3 loads, the
   port's libaom probe (conformance/libaom.py) must accept every TU;
   where it does not, the phase line says "libaom absent".
5. inter: config 2's shape without TF and TPL: 1280x720 8-bit "blobs", a
   keyframe and one 16-frame random-access mini-GOP (codec.gop.
   plan_minigop), preset 8, qindex 120, driven as the JAX package's API
   drives it (codec.encoder.encode_plans: same-layer runs begun, then
   resumed in order). A short warm-up (keyframe + 2-frame mini-GOP, with
   the kernels and with the plain versions), then a run with the kernels
   (the main path of this phase: the kernels' launch counts are set to 0
   before it and read after it) and one with kernels="plain". The TUs
   must agree byte for byte, or each differing frame is printed with its
   per-depth agreement of the winning candidate (>= 0.98). dav1d as in
   phase 4. fps, the host tier's stage seconds, bytes.
6. 1080p: 1920x1080 8-bit all-intra, 16 frames, preset 12, qindex 140:
   a warm-up encode, then a timed one (fps, device analysis vs host
   stages), then the device analysis alone with the kernels and with
   the plain versions. Then the group again under SVT_TPU_GROUP_CHUNK=4
   (each 4-frame chunk's analysis dispatched before the host commits the
   chunk before it; the main path "1080p chunked": counts set to 0
   before it and read after it): its TUs against the unchunked run's,
   each differing frame printed with the qindex it was coded at in each
   run (which must agree) and the mode agreement per depth of the
   analysis rows each run coded it from (>= 0.98); both
   fps and both runs' device_analysis (with chunks: the dispatches and
   the time blocked on a chunk's rows).
7. config 2: BASELINE.json config 2 itself, "blobs" 1280x720 8-bit, 48
   frames, through the port's SvtAv1Encoder (api/encoder.py) at preset
   8, CRF 30, everything else at its default (random access, 16-frame
   mini-GOPs, keyframe TF, ARF TF and TPL on). A warm-up on the first 9
   frames (with the kernels and plain), then a timed run with the
   kernels (the main path of this phase: the kernels' launch counts
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
8. config 3: BASELINE.json config 3, "blobs" 1920x1080 10-bit, through
   the port's SvtAv1Encoder at preset 6, CRF 30, everything else at its
   default (random access, keyframe and ARF TF, TPL, psy-rd 1.0,
   variance boost, CDEF, loop restoration), cut to a keyframe and one
   mini-GOP (9 frames). A 3-frame warm-up (a keyframe and a 2-frame
   mini-GOP, so that it reaches the ARF's temporal filter as well as the
   keyframe's, which is checked; it keeps the keyframe's three
   loop-restoration stacks), then a timed run with the kernels (the
   main path of this phase, counts set to 0 before it and read after
   it) and, second, one with kernels="plain", under SVT_TPU_TIMING=1;
   the phase line names that order. The TUs must agree as in phase 7. fps, stage seconds (lr.build,
   lr.exact, cdef among them), the per-frame qindex, the
   loop-restoration frame types per frame and plane, launches, bytes.
   Then the LR search's device tier alone on the warm-up keyframe's
   three planes, on the card and on the CPU: taps, best SSE and
   correlations bit-identical; the card's times. Where dav1d loads, the
   keyframe must decode to its recon; the inter frames that do not are
   printed (10-bit p6 inter frames inherit a mismatch from the
   reference, ROADMAP.md section 3). libaom as in phase 4.
9. device CDEF: phase 6's 1080p keyframe group (cdef_group_device) and
   phase 5's 720p keyframe + mini-GOP (the per-frame entry) again with
   SVT_TPU_DEVICE_CDEF=1. On one frame of each, the directions and
   variances (on the card) equal ops/cdef.py find_dir_batch's and the
   filtered coded area equals ops/cdef.py filter_blocks for the chosen
   strengths; the number of TUs that differ from the CDEF kernel's run
   of the same phase, and both runs' "cdef" stage seconds.
10. intdct: the integer analysis tier (the port's device.intra.
   _USE_MATDCT set to False for the phase and restored after, as
   SVT_TPU_INTDCT=1 sets it at import): phase 5's 720p keyframe +
   16-frame mini-GOP with the kernels after a short warm-up, under
   SVT_TPU_TIMING=1 (the main path of this phase: counts set to 0 before
   it and read after it). The fullloop kernel must launch 0 times (the
   switch bypasses it, as in the JAX package) and sad more than 0. fps,
   stage seconds, bytes, the TUs that differ from phase 5's float run;
   dav1d and libaom as in phase 4. The keyframe's and the first inter
   frame's analysis calls are recorded and run again on the CPU: every
   fullloop_int call's residuals, coefficients, eob and inverse equal
   the CPU's bit for bit, and the winning mode (keyframe) or candidate
   (inter frame) agrees on >= 0.98 of the blocks of each depth. Then
   ops.int_kernels.frame_intra_analysis on one 1920x1088 luma frame
   (phase 6's first, edge-padded), timed with CUDA events: sse, sad and
   pred_dc equal the CPU's, var8x8 within rtol 1e-5, atol 1e-4 (float32
   means of 64 rounded squares).
11. mesh: the analysis over a (dp, sp) DeviceMesh (svt_av1_psyex_tpu_torch/
   parallel/), spread over the cards there are (one card: every shard on
   it), each run against the unsharded run of the same frames. Phase
   6's clip cut to 4 frames under (2, 2): the keyframe group's analysis
   rows equal the unsharded rows value for value (17 superblock rows
   split 9 + 8), then an encode of each: TUs identical. Phase 5's cell
   under (1, 4) (3 superblock rows per shard), after a short sharded
   warm-up: TUs and every coded frame's analysis fields identical. In
   both, each kernel launches once per shard where the unsharded run
   launches it once (the main path of this phase: the two sharded runs,
   counts set to 0 before each and read after it). Then
   parallel.dryrun.dryrun_multichip(4) on the card. fps sharded and
   unsharded, the distinct cards and the shards on each, launches; dav1d
   as in phase 4.
12. host MD: the paths the device MD does not take (the host MD of
   codec/md.py, with the device motion field under its inter frames)
   and mono's device MD, at the tier-1 tests' clip sizes: a 128x96 4:4:4
   keyframe + 4-frame mini-GOP at preset 10, a 256x128 two-tile-column
   keyframe + 2-frame mini-GOP at preset 8, a 128x96 mono keyframe +
   4-frame mini-GOP at preset 6, a 128x128 screen-content (palette)
   keyframe at preset 6, and a 64x64 10-bit preset-4 film-grain keyframe
   + 1-frame mini-GOP, each encoded on the card with the kernels (the
   main path "host MD": counts set to 0 before each and read after it;
   sad must launch, and fullloop on the mono GOP) and on the CPU, all
   ten encodes at once in spawn worker processes (the host MD runs for
   minutes on one thread). The TUs must agree byte for byte; a
   differing TU is printed with both qindexes and the decision agreement
   per depth, and fails on another qindex, on agreement below 0.98, or
   when its frame ran the host MD (whose device inputs are exact
   integers). Then the time from a fresh SvtAv1Encoder at config 2's
   shape to its first packet, each in a fresh process (this script with
   --first-packet): init (which starts no warm-up) and then
   SvtAv1Encoder.warm_device, once as it is and once under
   SVT_TPU_NO_WARM=1 (each kernel's warm-up launches above 0 with the
   warm-up, 0 without).

Then a JSON line of the kernels ("launches": the counts of the kernel
runs of phases 7, 8, 10, 11, 6's chunked group and 12 summed,
"launches_by_path" each of them, for each of the three kernels; a warm-up thread's launches count
apart, in the wrappers' warm_launches;
fullloop "ms"/"plain_ms": its device time summed over its launches in
one 1080p 16-frame analysis, "bound_ms" the sum of those launches'
bounds, "max_abs_err": the largest |inverse residual| difference
against the plain version over every compared block; sad
"ms"/"plain_ms"/"bound_ms": one launch at one 720p frame's 240
superblocks, "max_abs_err": the largest difference over every compared
lattice, 0 when bit-exact; cdef "ms"/"plain_ms"/"bound_ms": its three
launches on one 720p 8-bit frame summed, "max_abs_err" 0: every output
is required equal; "library_ms" null: no single PyTorch call computes
any of the three functions), the nvidia-smi line, and last
{"ok": true, "device": {...}}. A bound is the least time an H100 SXM
could take for the same work (ops/cuda/roofline.py): the larger of the
bytes moved over 3.35 TB/s and the operations over the fp32 FMA or int32
issue rate. The script imports torch and the port, and checks that
neither jax nor the JAX package (svt_av1_psyex_tpu) entered
sys.modules.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
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
# config 3 (1080p 10-bit, p6, CRF 30; TF, TPL, psy-rd, variance boost,
# CDEF and loop restoration on at their defaults) through the port's API,
# cut to a keyframe and one mini-GOP; a 2-frame warm-up first
CONFIG3 = dict(w=1920, h=1080, bd=10, frames=9, preset=6, crf=30,
               warmup_frames=3)
# the integer analysis tier's frame analysis on one 1080p luma frame,
# padded to a multiple of its 64x64 blocks
INTDCT_FRAME = dict(h=1088, blk=64)
# phase 11, the (dp, sp) layout: 4 frames of phase 6's clip under (2, 2)
# (17 superblock rows, 9 + 8 over sp), and phase 5's cell under (1, 4)
# (12 rows, 3 per shard)
MESH_HD = dict(HD, frames=4, mesh=(2, 2))
MESH_INTER = dict(INTER, mesh=(1, 4))
# phase 6 again with the keyframe group's analysis in chunks of 4 frames
HD_CHUNK = 4
# the frame of phase 12's host-MD motion fields (the 4:4:4 and mono GOPs)
HOST_MD_ME = dict(w=128, h=96)
# phase 12: the host-MD paths, card vs CPU, on the clips of
# tests/test_torch_host_paths*.py and tests/test_torch_film_grain.py
HOST_MD_PATHS = ("4:4:4 GOP", "2-tile inter GOP", "mono p6 GOP",
                 "screen-content keyframe", "film grain p4 10-bit")
KERNELS = ("fullloop", "sad", "cdef")
REPLACES = {"fullloop": "svt_av1_psyex_tpu/ops/pallas/fullloop.py:151",
            "sad": "svt_av1_psyex_tpu/ops/pallas/sad.py:69",
            # the JAX package's CDEF is no Pallas kernel
            "cdef": "none: native/cdef.c"}
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


def residuals(b: int, n: int, seed: int, device, f32: bool = False,
              scale: int = 1):
    """Intra-like residual blocks on the card (tests/test_pallas.py's
    amplitudes, times `scale`: 4 for 10-bit samples); block 0 is all
    zero, whose eob must be 0. With f32, the float32 residuals of a
    prediction from an unrounded float recon (TPL's recrf): the same
    amplitudes plus a fraction in [-0.5, 0.5)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    resid = (torch.randint(-64, 65, (b, n, n), generator=g, device=device,
                           dtype=torch.int32)
             + torch.randint(-2, 3, (b, n, n), generator=g, device=device,
                             dtype=torch.int32) * 40) * scale
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


def host_and_device_us(fn, name: str, reps: int = 200) -> tuple:
    """fn's host time per call (the enqueue: `reps` calls back to back, no
    synchronisation inside) and the device time per launch of the kernels
    whose name holds `name`, from torch.profiler; None where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if name in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) for e in evts)
    count = sum(e.count for e in evts)
    return host_us, (total / count if count and total else None)


def phase_kernels(device) -> dict:
    """Phase 3: fullloop kernel vs its plain version on the card."""
    import torch

    from svt_av1_psyex_tpu_torch.device.intra import qp6_for, qp_row_for
    from svt_av1_psyex_tpu_torch.ops.cuda.fullloop import fullloop
    from svt_av1_psyex_tpu_torch.ops.cuda.roofline import fullloop_bound
    from svt_av1_psyex_tpu_torch.ops.fullloop_ref import fullloop_ref

    qp_row = qp_row_for(CONFIG1["qindex"], 0, 0, 8)
    # config 3's 10-bit residuals at its CRF's qindex
    qp_row10 = qp_row_for(CONFIG3["crf"] * 4, 0, 0, 10)
    worst = 0.0
    hd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
          "ops_ms": 0.0}
    for n in (4, 8, 16, 32):
        ls = 1 if n == 32 else 0
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
        if n in (16, 32):
            # one 1080p 10-bit frame's intra lattice (config 3)
            cases.append(("1080p-10bit-1-frame", lattice_batch(HD, n, 1)))
            # a quarter of a 720p inter candidate: one (1, 4) mesh shard
            cases.append(("720p-inter-candidate-shard",
                          blocks(INTER, n) // MESH_INTER["mesh"][1]))
        if n != 4:
            # a chunk of phase 6's group under SVT_TPU_GROUP_CHUNK
            cases.append((f"1080p-chunk-{HD_CHUNK}-frames",
                          lattice_batch(HD, n, HD_CHUNK)))
            # the larger (2, 2) mesh shard of phase 11: 2 frames, 9 of
            # 17 superblock rows
            cases.append(("1080p-shard-2f-9rows",
                          7 * (9 * 64 // n) * (-(-HD["w"] // 64) * 64 // n)
                          * 2))
        for label, b in cases:
            ten = "10bit" in label
            qp6 = qp6_for(qp_row10 if ten else qp_row, ls)
            resid = residuals(b, n, 7 + n, device, f32=label.endswith("f32"),
                              scale=4 if ten else 1)
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
            bnd = fullloop_bound(b, n)
            bnd_inv = fullloop_bound(b, n, want_inv=True)
            print(f"kernels: fullloop n={n} {label} B={b}: kernel "
                  f"{ms[False][0]:.4f} ms vs plain {ms[False][1]:.4f} ms, "
                  f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                  f"{bnd['bound_ms'] / ms[False][0]:.1%} of it; with inv "
                  f"{ms[True][0]:.4f} ms vs {ms[True][1]:.4f} ms, bound "
                  f"{bnd_inv['bound_ms']:.4f} ms, "
                  f"{bnd_inv['bound_ms'] / ms[True][0]:.1%}; eob agreement "
                  f"{st['eob_eq']:.6f}, {st['flipped']} blocks at a "
                  f"quantization boundary, max |inv err| "
                  f"{st['max_abs_err_inv']:.6g}", flush=True)
            if label == "720p-TPL-f32":
                host_us, dev_us = host_and_device_us(
                    lambda: fullloop(resid, qp6, n, ls, True),
                    "fullloop_kernel")
                dev = "not measured" if dev_us is None else f"{dev_us:.2f} us"
                print(f"kernels: fullloop n={n} {label} B={b}: the wrapper's "
                      f"host time {host_us:.2f} us per call, the kernel's "
                      f"device time {dev} per launch (torch.profiler)",
                      flush=True)
            if label == "1080p-16-frames":
                hd["ms"] += ms[False][0]
                hd["plain_ms"] += ms[False][1]
                for k in ("bound_ms", "bytes_ms", "ops_ms"):
                    hd[k] += bnd[k]
            del resid
            torch.cuda.empty_cache()
    return {"max_abs_err": worst, **hd,
            "bound_by": ("bytes" if hd["bytes_ms"] >= hd["ops_ms"]
                         else "operations")}


def superblocks(cfg: dict) -> int:
    return -(-cfg["h"] // 64) * -(-cfg["w"] // 64)


def phase_sad(device) -> dict:
    """Phase 3, sad_lattice: the kernel against its plain version on the
    card, bit-exact, 8-bit and 10-bit samples."""
    import torch

    from svt_av1_psyex_tpu_torch.ops.cuda.roofline import sad_bound
    from svt_av1_psyex_tpu_torch.ops.cuda.sad import sad_lattice
    from svt_av1_psyex_tpu_torch.ops.sad_ref import sad_lattice_ref

    worst = 0
    out = {}
    for label, nsb in (("off-tile", 7), ("720p", superblocks(INTER)),
                       ("1080p", superblocks(HD)),
                       ("720p-shard", superblocks(INTER)
                        // MESH_INTER["mesh"][1]),
                       ("host-MD-128x96", superblocks(HOST_MD_ME))):
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
        bnd = sad_bound(nsb)
        print(f"kernels: sad_lattice {label} nSB={nsb}: bit-exact at 8 and "
              f"10 bits; kernel {ms[8][0]:.4f} ms vs plain {ms[8][1]:.4f} "
              f"ms (8-bit), {ms[10][0]:.4f} ms vs {ms[10][1]:.4f} ms "
              f"(10-bit); bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), {bnd['bound_ms'] / ms[8][0]:.1%} of it",
              flush=True)
        if label == "720p":
            out = {"ms": ms[8][0], "plain_ms": ms[8][1],
                   "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, **out}


# phase 3's CDEF frames: (mi rows, mi cols, bit depth, share of the
# mode-info cells skipped, search level, planes): the two cells' frames at
# their preset's level, and two ragged ones off the 64x64 filter blocks at
# the levels of presets <= 1 (64 candidates, no subsampling; mono) and
# >= 9 (4 candidates, every fourth unit)
CDEF_FRAMES = {"720p-8bit": (180, 320, 8, 0.1, 5, 3),
               "1080p-10bit": (270, 480, 10, 0.6, 5, 3),
               "off-tile-mono-level1": (34, 50, 8, 0.3, 1, 1),
               "off-tile-10bit-level7": (18, 26, 10, 0.2, 7, 3)}


def cdef_frame(mi_rows: int, mi_cols: int, bit_depth: int, skip: float,
               nplanes: int, seed: int = 1):
    """A smooth source (a sine pattern), its recon with noise of +-6 at 8
    bits, and a random skip grid: int32 planes as the encoder holds them
    (chroma 4 samples wider and taller than half the luma)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    h, w = mi_rows * 4, mi_cols * 4
    src = []
    for sh in [(h, w)] + [(h // 2 + 4, w // 2 + 4)] * (nplanes - 1):
        yy, xx = np.mgrid[0:sh[0], 0:sh[1]]
        wave = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        src.append((wave * maxv).astype(np.int32))
    amp = 6 << (bit_depth - 8)
    recon = [np.clip(s + rng.integers(-amp, amp + 1, s.shape), 0,
                     maxv).astype(np.int32) for s in src]
    skip_g = (rng.random((mi_rows, mi_cols)) < skip).astype(np.uint8)
    return recon, src, skip_g


def phase_cdef(device) -> dict:
    """Phase 3, CDEF: the kernel's three launches against its plain
    version on the card, then the frame runner against the host C; all
    bit-exact. Times and bounds of each launch, and the whole frame on
    the host's clock."""
    import numpy as np
    import torch

    from svt_av1_psyex_tpu_torch.device.cdef import _select_strengths
    from svt_av1_psyex_tpu_torch.native import cdefc
    from svt_av1_psyex_tpu_torch.ops.cdef import candidate_strengths
    from svt_av1_psyex_tpu_torch.ops.cdef_ref import search_units, unit_mask
    from svt_av1_psyex_tpu_torch.ops.cuda.cdef import CdefFrames
    from svt_av1_psyex_tpu_torch.ops.cuda.roofline import cdef_bound
    from svt_av1_psyex_tpu_torch.runtime import cdef_impl

    def rd_fn(rate, dist):
        return dist + rate

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {}
    for label, (mi_rows, mi_cols, bd, skip, level, nplanes) in (
            CDEF_FRAMES.items()):
        cs, q = bd - 8, 160
        damping = 3 + (q >> 6)
        ydamp, cdamp = damping + cs, max(0, damping + cs - 1)
        recon, src, skip_g = cdef_frame(mi_rows, mi_cols, bd, skip, nplanes)
        mask = unit_mask(skip_g, mi_rows, mi_cols)
        grid, coded = mask.shape, (mi_rows * 4, mi_cols * 4)
        units_np = search_units(mask, level)
        cands_np = np.asarray(candidate_strengths(level), np.int32)
        planes, srcs = [up(p) for p in recon], [up(p) for p in src]
        units, cands, mask_t = up(units_np), up(cands_np), up(mask)
        nvfb, nhfb = grid[0] // 8, grid[1] // 8
        calls, results = {}, {}
        for kernels in ("hand", "plain"):
            dirs_fn, search_fn, apply_fn = cdef_impl(kernels)
            dirs, var = dirs_fn(planes[0], coded, grid, cs)
            mse0, mse1 = search_fn(planes, srcs, coded, units, grid, dirs,
                                   var, cands, ydamp, cdamp, cs)
            if kernels == "hand":   # both apply the kernel's choice
                _, _, _, _, y_gi, uv_gi = _select_strengths(
                    mse0.cpu().numpy().astype(np.float64),
                    mse1.cpu().numpy().astype(np.float64), mask, nvfb, nhfb,
                    [int(c) for c in cands_np], rd_fn)
                y_gi_t, uv_gi_t = up(y_gi.astype(np.int32)), up(
                    uv_gi.astype(np.int32))
            filtered = apply_fn(planes, coded, mask_t, dirs, var, y_gi_t,
                                uv_gi_t, ydamp, cdamp, cs)
            results[kernels] = [dirs, var, mse0, mse1, *filtered]
            calls[kernels] = {
                "dirs": lambda f=dirs_fn: f(planes[0], coded, grid, cs),
                "search": lambda f=search_fn, d=dirs, v=var: f(
                    planes, srcs, coded, units, grid, d, v, cands, ydamp,
                    cdamp, cs),
                "apply": lambda f=apply_fn, d=dirs, v=var: f(
                    planes, coded, mask_t, d, v, y_gi_t, uv_gi_t, ydamp,
                    cdamp, cs)}
        torch.cuda.synchronize()
        names = ["dirs", "var", "mse0", "mse1"] + [
            f"plane {k}" for k in range(nplanes)]
        for name, a, b in zip(names, results["hand"], results["plain"]):
            check(a.shape == b.shape and torch.equal(a, b),
                  f"cdef {label}: the kernel's {name} differs from the "
                  f"plain version's")
        ms = {k: {stage: cuda_ms(fn, reps=20 if k == "hand" else 3)
                  for stage, fn in calls[k].items()} for k in calls}
        msk = mask.reshape(-1).astype(bool)
        bnd = cdef_bound(coded, units_np.size, cands_np, y_gi[msk],
                         uv_gi[msk], nplanes > 1)
        frames = {"kernel": CdefFrames(device, "hand").search_frame,
                  "C": cdefc.cdef_search_frame_c}
        got = {}
        for who, fn in frames.items():
            rec = [p.copy() for p in recon]
            got[who] = (fn(rec, src, skip_g, mi_rows, mi_cols, q, rd_fn,
                           level=level, bit_depth=bd), rec)
        (res_k, rec_k), (res_c, rec_c) = got["kernel"], got["C"]
        check(res_k[:3] == res_c[:3] and res_k[4] == res_c[4]
              and np.array_equal(res_k[3], res_c[3])
              and all(np.array_equal(a, b) for a, b in zip(rec_k, rec_c)),
              f"cdef {label}: the frame runner's result or planes differ "
              f"from the host C's")
        frame_ms = {who: host_ms(lambda fn=fn: fn(
            [p.copy() for p in recon], src, skip_g, mi_rows, mi_cols, q,
            rd_fn, level=level, bit_depth=bd), 10 if who == "kernel" else 2)
            for who, fn in frames.items()}
        print(f"kernels: cdef {label} ({coded[1]}x{coded[0]}, {bd}-bit, "
              f"level {level}, {len(cands_np)} candidates, "
              f"{units_np.size} units searched, {int(msk.sum())} filtered, "
              f"{nplanes} planes): dirs, var, mse0, mse1 and planes "
              f"bit-exact with the plain version, the frame runner's with "
              f"the C; "
              + "; ".join(
                  f"{stage} {ms['hand'][stage]:.4f} ms vs plain "
                  f"{ms['plain'][stage]:.4f} ms, bound "
                  f"{bnd[stage]['bound_ms']:.4f} ms "
                  f"({bnd[stage]['bound_by']}), "
                  f"{bnd[stage]['bound_ms'] / ms['hand'][stage]:.1%} of it"
                  for stage in ("dirs", "search", "apply"))
              + f"; the whole frame on the host's clock: frame runner "
              f"{frame_ms['kernel']:.3f} ms, host C {frame_ms['C']:.3f} ms",
              flush=True)
        if label == "720p-8bit":
            tot = {k: sum(b[k] for b in bnd.values())
                   for k in ("bound_ms", "bytes_ms", "ops_ms")}
            out = {"ms": sum(ms["hand"].values()),
                   "plain_ms": sum(ms["plain"].values()),
                   "bound_ms": tot["bound_ms"],
                   "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                                else "operations")}
        del planes, srcs, results, calls
        torch.cuda.empty_cache()
    # every compared output was required to be equal
    return {"max_abs_err": 0, **out}


def make_frames(cfg: dict) -> list:
    from svt_av1_psyex_tpu_torch.streams import VideoFormat
    from svt_av1_psyex_tpu_torch.utils.clips import synth_frame

    fmt = VideoFormat(cfg["w"], cfg["h"], cfg.get("bd", 8),
                      fps=Fraction(30, 1))
    return [synth_frame(fmt, t) for t in range(cfg["frames"])]


def make_encoder(cfg: dict, device, kernels: str, mesh=None,
                 record: bool = False):
    """The port's encoder for cfg; with `record`, it keeps each coded
    frame's (qindex, analysis row it was coded from) in `coded`."""
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    class Recording(Av1Encoder):
        def _begin_frame_impl(self, planes, base_q_idx=80, force_key=False,
                              plan=None, _analysis_row=None, _group=None):
            st = super()._begin_frame_impl(planes, base_q_idx, force_key,
                                           plan, _analysis_row, _group)
            if isinstance(st, dict):
                self.coded.append((st["fr"].base_q_idx, _analysis_row))
            return st

    enc = (Recording if record else Av1Encoder)(
        SequenceConfig(width=cfg["w"], height=cfg["h"]),
        preset=cfg["preset"], device=device, kernels=kernels, mesh=mesh)
    enc.coded = []
    return enc


def encode(frames: list, cfg: dict, device, kernels: str, mesh=None,
           record: bool = False):
    enc = make_encoder(cfg, device, kernels, mesh, record)
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


def libaom_check(tag: str, tus: list, cfg: dict) -> str:
    """Where libaom.so.3 loads, the port's libaom probe must accept
    every TU (it raises on the first it rejects). Returns a word for the
    phase line."""
    from svt_av1_psyex_tpu_torch.conformance import libaom
    from svt_av1_psyex_tpu_torch.streams import write_ivf

    if not libaom.available():
        return "libaom absent"
    libaom.validate_ivf(write_ivf(OUT_DIR / f"{tag}_libaom.ivf", tus,
                                  cfg["w"], cfg["h"]))
    return f"libaom accepts all {len(tus)} TUs"


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
    aom = libaom_check("config1", tus_k, CONFIG1)
    print(f"slice: config 1 ({CONFIG1['w']}x{CONFIG1['h']}, "
          f"{CONFIG1['frames']} frames, p{CONFIG1['preset']}, "
          f"q{CONFIG1['qindex']}): kernels {CONFIG1['frames'] / dt_k:.3f} "
          f"fps (s: {stages(enc_k)}), plain "
          f"{CONFIG1['frames'] / dt_p:.3f} fps (s: {stages(enc_p)}); "
          f"{len(diff)} of "
          f"{len(tus_k)} TUs differ; {gate}; {aom}; fullloop launches "
          f"{launches}; "
          f"{sum(map(len, tus_k))} bytes", flush=True)


def recording_encoder(cfg: dict, device, kernels: str, mesh=None):
    """The port's encoder for cfg (its analysis sharded over `mesh`, if
    given), keeping each coded frame's device MD (whose stats hold the
    frame's analysis lattice) in `dmds`."""
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    class Recording(Av1Encoder):
        def _begin_frame_impl(self, *a, **k):
            st = super()._begin_frame_impl(*a, **k)
            if isinstance(st, dict):
                self.dmds.append(st["dmd"])
            return st

    enc = Recording(SequenceConfig(width=cfg["w"], height=cfg["h"]),
                    preset=cfg["preset"], device=device, kernels=kernels,
                    mesh=mesh)
    enc.dmds = []
    return enc


def encode_gop(frames: list, gop: int, cfg: dict, device, kernels: str,
               mesh=None):
    """A keyframe, then one `gop`-frame random-access mini-GOP. Returns
    (encoder, TUs, display-order recons, seconds, coded-frame TU
    indices)."""
    from svt_av1_psyex_tpu_torch.codec.encoder import encode_plans
    from svt_av1_psyex_tpu_torch.codec.gop import plan_minigop

    enc = recording_encoder(cfg, device, kernels, mesh)
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
    kernels vs plain. Returns the clip, the kernel run's TUs and its
    "cdef" stage seconds (the CDEF kernel), for phase 9."""
    cfg = INTER
    frames = make_frames(cfg)
    for kernels in ("hand", "plain"):   # first-use loads, allocations
        encode_gop(frames, cfg["warmup_gop"], cfg, device, kernels)
    os.environ["SVT_TPU_TIMING"] = "1"  # the host tier's stage clock
    try:
        (enc_k, tus_k, rec_k, dt_k, coded), launches = counted(
            lambda: encode_gop(frames, cfg["gop"], cfg, device, "hand"))
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
    return {"frames": frames, "tus": tus_k,
            "cdef_s": enc_k.timing.get("cdef", 0.0)}


def phase_hd(device) -> dict:
    """Phase 6: 1080p all-intra, warm-up then a timed encode; then the
    device analysis alone, kernels vs plain. Returns the clip, the TUs
    and the "cdef" stage seconds (the CDEF kernel), for phase 9."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop

    frames = make_frames(HD)
    encode(frames, HD, device, "hand")
    cuda_fullloop.launches = 0
    # the host tier's own per-stage clock (accumulated in enc.timing)
    os.environ["SVT_TPU_TIMING"] = "1"
    try:
        enc, tus, dt = encode(frames, HD, device, "hand", record=True)
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
    chunked = group_chunk(frames, tus, enc, dt, device)
    print(f"1080p: {HD['w']}x{HD['h']} 8-bit, {HD['frames']} frames, "
          f"p{HD['preset']}, q{HD['qindex']}: {HD['frames'] / dt:.3f} fps "
          f"({dt:.3f} s: {stages(enc)}; host tier per stage, s: "
          f"{ {k: round(v, 4) for k, v in enc.timing.items()} }); "
          f"analysis alone (s, "
          f"kernels/plain/plain/kernels order): kernels "
          f"{analysis['hand']}, plain {analysis['plain']}; depths "
          f"{enc.keyframe_depths()}; fullloop launches {launches}; "
          f"{sum(map(len, tus))} bytes; {gate}", flush=True)
    return {"frames": frames, "tus": tus, "cdef_s": enc.stage_seconds["cdef"],
            "chunked_launches": chunked}


def group_chunk(frames: list, tus: list, enc, dt: float, device) -> dict:
    """Phase 6's group again under SVT_TPU_GROUP_CHUNK=HD_CHUNK: each
    chunk's analysis is dispatched before the host commits the one before
    it. A chunk is a smaller batch, so a TU may differ from the unchunked
    run's (`enc`, made with record=True): each differing frame must have
    been coded at the same qindex in both runs, and the analysis rows
    each run coded it from must agree on >= 0.98 of the modes per depth.
    Returns the chunked run's launch counts."""
    import numpy as np

    from svt_av1_psyex_tpu_torch.device.intra import unpack_rd_analysis

    os.environ["SVT_TPU_GROUP_CHUNK"] = str(HD_CHUNK)
    try:
        (enc_c, tus_c, dt_c), launches = counted(
            lambda: encode(frames, HD, device, "hand", record=True))
    finally:
        del os.environ["SVT_TPU_GROUP_CHUNK"]
    check(len(tus_c) == len(tus) and launches["fullloop"] > 0,
          "1080p chunked: a TU per frame and fullloop launches")
    check(len(enc_c.coded) == len(enc.coded) == len(tus),
          "1080p chunked: a recorded analysis row per coded frame")
    diff = [i for i, (a, b) in enumerate(zip(tus_c, tus)) if a != b]
    depths = enc.keyframe_depths()
    hp, wp = -(-enc.aligned_h // 64) * 64, -(-enc.aligned_w // 64) * 64
    for i in diff:
        (qc, row_c), (qu, row_u) = enc_c.coded[i], enc.coded[i]
        a = unpack_rd_analysis(row_c, hp, wp, depths)
        b = unpack_rd_analysis(row_u, hp, wp, depths)
        agree = {blk: float(np.mean(a[blk]["mode"] == b[blk]["mode"]))
                 for blk in depths}
        print(f"1080p chunked: frame {i} TU differs from the unchunked "
              f"run's; qindex {qc} chunked, {qu} unchunked; mode agreement "
              f"per depth of the rows each run coded it from {agree}",
              flush=True)
        check(qc == qu, f"1080p chunked: frame {i} qindex differs")
        check(min(agree.values()) >= 0.98,
              f"1080p chunked: frame {i} mode agreement below 0.98")
    n = len(frames)
    print(f"1080p chunked: SVT_TPU_GROUP_CHUNK={HD_CHUNK}, {n} frames: "
          f"{n / dt_c:.3f} fps ({dt_c:.3f} s: {stages(enc_c)}) against "
          f"{n / dt:.3f} fps unchunked ({stages(enc)}); device_analysis "
          f"counts each chunk's dispatch and the time blocked on its rows; "
          f"{len(diff)} of {n} TUs differ; launches {launches}",
          flush=True)
    return launches


def recording_api(cfg: dict, device, kernels: str, recon: bool = False):
    """The port's SvtAv1Encoder at cfg's size, bit depth, preset and CRF
    (everything else at its default, so keyframe TF, ARF TF and TPL are
    on; the clip's 30 fps), recording per packet the coded frame's
    (qindex, device MD, loop-restoration frame types), or None for a
    show-existing packet, the r0 of every TPL group, and the number of
    temporal-filter calls (keyframe and ARF) in `tf_calls`."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    class Recording(SvtAv1Encoder):
        def init(self):
            super().init()
            self.coded, self.r0s, self._last = [], [], None
            self.tf_calls = 0
            enc = self._enc
            begin, resume = enc.begin_frame, enc.resume_frame

            def begin_frame(*a, **k):
                st = begin(*a, **k)
                if not isinstance(st, dict):   # a show-existing TU
                    self._last = None
                return st

            def resume_frame(st):
                tu = resume(st)
                self._last = (st["fr"].base_q_idx, st["dmd"],
                              st["fr"].lr_frame_types)
                return tu

            enc.begin_frame, enc.resume_frame = begin_frame, resume_frame

        def _temporal_filter(self, planes, nbrs, strength):
            self.tf_calls += 1
            return super()._temporal_filter(planes, nbrs, strength)

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
    c.encoder_bit_depth = cfg.get("bd", 8)
    c.enc_mode, c.crf = cfg["preset"], cfg["crf"]
    c.frame_rate_numerator, c.frame_rate_denominator = 30, 1
    c.recon_enabled = recon
    api.init()
    check(c.enable_tf and c.kf_tf_strength > 0 and api._tpl_on(),
          f"p{cfg['preset']}: TF, keyframe TF and TPL must be on at the "
          "defaults")
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

    from svt_av1_psyex_tpu_torch.runtime import upload_lumas
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
    from svt_av1_psyex_tpu_torch.streams import VideoFormat
    from svt_av1_psyex_tpu_torch.utils.ivf import read_ivf
    from svt_av1_psyex_tpu_torch.utils.y4m import Y4MWriter

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


def kernel_vs_plain(tag: str, api_k, pk: list, api_p, pp: list):
    """The packets of a kernel run (api_k, pk) and a plain run (api_p,
    pp) must agree byte for byte; a differing TU must have the same
    qindex in both runs (else both runs' TPL r0 are printed and the phase
    fails) and >= 0.98 decision agreement per depth. Returns the
    per-frame (pts, qindex) of both runs and the differing TUs."""
    qk = [(p.pts, c[0]) for p, c in zip(pk, api_k.coded) if c is not None]
    qp_ = [(p.pts, c[0]) for p, c in zip(pp, api_p.coded) if c is not None]
    diff = [i for i, (a, b) in enumerate(zip(pk, pp)) if a.data != b.data]
    for i in diff:
        ck, cp = api_k.coded[i], api_p.coded[i]
        check(ck is not None and cp is not None,
              f"{tag}: show-existing TU {i} differs")
        if ck[0] != cp[0]:
            print(f"{tag}: TU {i} (pts {pk[i].pts}) qindex {ck[0]} with "
                  f"the kernels, {cp[0]} plain; TPL r0 with the kernels "
                  f"{api_k.r0s}, plain {api_p.r0s}", flush=True)
            check(False, f"{tag}: TU {i} qindex differs")
        agree = decision_agreement(ck[1], cp[1])
        print(f"{tag}: TU {i} (pts {pk[i].pts}, qindex {ck[0]}) differs "
              f"between kernel and plain runs; decision agreement per "
              f"depth {agree}", flush=True)
        check(min(agree.values()) >= 0.98,
              f"{tag}: TU {i} decision agreement below 0.98")
    return qk, qp_, diff


def phase_config2(device) -> dict:
    """Phase 7: config 2 through the port's SvtAv1Encoder, kernels vs
    plain; TPL on the card; the CLI. Returns the kernel run's launch
    counts (the main path of this phase)."""
    cfg = CONFIG2
    frames = make_frames(cfg)
    # warm-up: the CLI's frames, with the kernels (kept for the CLI
    # comparison) and with the plain versions
    head = frames[:cfg["cli_frames"]]
    _, head_pkts, _, _ = api_encode(head, cfg, device, "hand")
    api_encode(head, cfg, device, "plain")
    os.environ["SVT_TPU_TIMING"] = "1"  # stage clock: tf, tpl, host tier
    try:
        (api_k, pk, rec_k, dt_k), launches = counted(
            lambda: api_encode(frames, cfg, device, "hand", recon=True))
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
    qk, qp_, diff = kernel_vs_plain("config 2", api_k, pk, api_p, pp)
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


@contextmanager
def recording_lr_stacks(out: list, n: int = 3):
    """Keeps the arguments of the next `n` calls of the LR search's
    device tier (codec.restoration._device_search: one coded frame's Y,
    U and V stacks) in `out`."""
    import svt_av1_psyex_tpu_torch.codec.restoration as CR

    orig = CR._device_search

    def record(*args, **kwargs):
        if len(out) < n:
            out.append(args[:8])
        return orig(*args, **kwargs)

    CR._device_search = record
    try:
        yield
    finally:
        CR._device_search = orig


def lr_alone(stacks: list, device) -> str:
    """The LR search's device tier alone on one frame's three planes: on
    the card and on the CPU, taps, best SSE and correlations equal bit
    for bit; the card's time of each program and of the whole call."""
    import numpy as np
    import torch

    from svt_av1_psyex_tpu_torch.codec.restoration import _device_search
    from svt_av1_psyex_tpu_torch.device.restoration import (
        sgr_corr,
        wiener_descent,
    )

    words = []
    for plane, args in zip("YUV", stacks):
        pads, srcs, masks, init, bd, n_rounds, chroma, eps = args
        t0 = time.perf_counter()
        card = _device_search(*args, device)
        t1 = time.perf_counter()
        host = _device_search(*args, torch.device("cpu"))
        t2 = time.perf_counter()
        for name, a, b in zip(("taps", "best SSE", "correlations"), card,
                              host):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"config 3 LR search, plane {plane}: {name} differ "
                  "between the card and the CPU")
        up = [torch.from_numpy(a).to(device) for a in (pads, srcs, masks)]
        it = torch.from_numpy(init).to(device)
        wd = cuda_ms(lambda: wiener_descent(*up, it, bd, n_rounds, chroma),
                     reps=3)
        sg = cuda_ms(lambda: sgr_corr(*up, eps, bd), reps=3)
        words.append(
            f"{plane} ({pads.shape[0]} RUs padded to {pads.shape[1] - 6}x"
            f"{pads.shape[2] - 6}, {init.shape[1]} initial tap sets, "
            f"{n_rounds} rounds, {len(eps)} eps): wiener_descent {wd:.3f} "
            f"ms + sgr_corr {sg:.3f} ms on the card (CUDA events), the "
            f"whole call {(t1 - t0) * 1e3:.3f} ms with upload and fetch; "
            f"CPU {(t2 - t1) * 1e3:.1f} ms")
    return "; ".join(words)


def phase_config3(device) -> dict:
    """Phase 8: config 3 through the port's SvtAv1Encoder, kernels vs
    plain; the LR search alone, card vs CPU; dav1d on the keyframe.
    Returns the kernel run's launch counts (the main path of this
    phase)."""
    from svt_av1_psyex_tpu_torch.streams import dav1d_loads, dav1d_mismatches

    cfg = CONFIG3
    frames = make_frames(cfg)
    stacks: list = []
    with recording_lr_stacks(stacks):   # the warm-up keyframe's planes
        warm, _, _, _ = api_encode(frames[:cfg["warmup_frames"]], cfg,
                                   device, "hand")
    check(len(stacks) == 3, "config 3: the warm-up ran no LR search")
    # the keyframe's filter and the 2-frame mini-GOP's ARF filter
    check(warm.tf_calls >= 2, f"config 3: the warm-up ran "
          f"{warm.tf_calls} temporal filter calls, not the keyframe's and "
          "the ARF's")
    os.environ["SVT_TPU_TIMING"] = "1"  # stage clock, LR's sub-stages
    try:
        (api_k, pk, rec_k, dt_k), launches = counted(
            lambda: api_encode(frames, cfg, device, "hand", recon=True))
        api_p, pp, _, dt_p = api_encode(frames, cfg, device, "plain")
    finally:
        del os.environ["SVT_TPU_TIMING"]
    for name, n in launches.items():
        check(n > 0, f"config 3: the main path launched no {name} kernel")
    enc = api_k._enc
    check(enc.seq.enable_restoration and enc.seq.enable_cdef
          and enc.psy_rd > 0 and enc.enable_variance_boost
          and enc.seq.bit_depth == 10,
          "config 3: 10-bit with LR, CDEF, psy-rd and variance boost on "
          "at the defaults")
    check(len(rec_k) == cfg["frames"] and len(pk) == len(pp)
          and all(len(p.data) > 0 for p in pk),
          "config 3: expected a non-empty packet per TU, the same count in "
          "both runs, and a recon per frame")
    stage = {k: round(v, 4) for k, v in enc.timing.items()}
    for key in ("tf", "tpl", "cdef", "lr.build", "lr.exact"):
        check(key in stage, f"config 3: {key} missing from the stage "
              "seconds")
    qk, qp_, diff = kernel_vs_plain("config 3", api_k, pk, api_p, pp)
    lr_types = [(p.pts, c[2]) for p, c in zip(pk, api_k.coded)
                if c is not None]
    check(any(any(t) for _, t in lr_types),
          "config 3: loop restoration chose no filter on any frame")
    if dav1d_loads():
        bad = dav1d_mismatches(OUT_DIR / "config3.ivf",
                               [p.data for p in pk], rec_k, cfg["w"],
                               cfg["h"])
        # 10-bit p6 inter frames may mismatch: inherited from the
        # reference (ROADMAP.md section 3); the keyframe must not
        check(0 not in bad, "config 3: dav1d output differs from the "
              "keyframe's recon")
        gate = (f"dav1d: keyframe bit-exact, frames differing from the "
                f"recon {bad}")
    else:
        gate = "not decoded (dav1d absent)"
    aom = libaom_check("config3", [p.data for p in pk], cfg)
    alone = lr_alone(stacks, device)
    print(f"config 3: {cfg['w']}x{cfg['h']} 10-bit, {cfg['frames']} frames "
          f"(a keyframe + one mini-GOP), p{cfg['preset']}, CRF "
          f"{cfg['crf']}, TF + TPL + psy-rd + variance boost + CDEF + LR "
          f"on, through SvtAv1Encoder ({len(pk)} TUs; a "
          f"{cfg['warmup_frames']}-frame warm-up with {warm.tf_calls} "
          f"temporal filter calls, then the kernel run first and the plain "
          f"run second): kernels "
          f"{cfg['frames'] / dt_k:.4f} fps ({dt_k:.3f} s; stage seconds "
          f"{stage}), plain {cfg['frames'] / dt_p:.4f} fps ({dt_p:.3f} s; "
          f"{ {k: round(v, 4) for k, v in api_p._enc.timing.items()} }); "
          f"qindex per coded frame (pts, q): kernels {qk}, plain {qp_}; LR "
          f"frame types (Y, U, V) per coded frame (pts, types): {lr_types};"
          f" {len(diff)} of {len(pk)} TUs differ; {gate}; {aom}; "
          f"launches {launches}; {sum(len(p.data) for p in pk)} bytes",
          flush=True)
    print(f"config 3: LR search alone on the warm-up keyframe, bit-exact "
          f"card vs CPU: {alone}", flush=True)
    return launches


@contextmanager
def recording_cdef_frame(out: list):
    """Keeps, for the first frame the device CDEF backend filters, its
    job (recon planes copied before the filter), the recon planes after
    it and its result (device.cdef.cdef_group_device, which the
    per-frame entry calls too)."""
    import svt_av1_psyex_tpu_torch.device.cdef as PC

    orig = PC.cdef_group_device

    def record(jobs, *args, **kwargs):
        before = None
        if not out:
            before = dict(jobs[0], recon_planes=[
                p.copy() for p in jobs[0]["recon_planes"]])
        res = orig(jobs, *args, **kwargs)
        if before is not None and res[0] is not None:
            out.append((before, [p.copy() for p in jobs[0]["recon_planes"]],
                        res[0]))
        return res

    PC.cdef_group_device = record
    try:
        yield
    finally:
        PC.cdef_group_device = orig


def check_cdef_frame(tag: str, frame: tuple, bit_depth: int, device) -> str:
    """One frame of the device CDEF backend: the directions and
    variances (on the card) equal ops.cdef.find_dir_batch's; the
    filtered coded area equals ops.cdef.filter_blocks for the strengths
    the frame chose, with every unfiltered unit unchanged."""
    import numpy as np
    import torch

    from svt_av1_psyex_tpu_torch.device.cdef import (
        _blocked,
        _find_dir,
        _prep_frame,
    )
    from svt_av1_psyex_tpu_torch.ops.cdef import (
        adjust_strength,
        filter_blocks,
        find_dir_batch,
    )

    job, after, (_, y_str, uv_str, fb_map, damping) = frame
    before = job["recon_planes"]
    mi_rows, mi_cols = job["mi_rows"], job["mi_cols"]
    pads, _, maskg, (_, nhfb, nv8p, nh8p) = _prep_frame(
        before, job["src_planes"], job["skip_g"], mi_rows, mi_cols)
    cs = bit_depth - 8
    blocks = _blocked(torch.from_numpy(pads[0]).to(device)[2:-2, 2:-2],
                      nv8p, nh8p, 8)
    dirs, var = (t.cpu().numpy().astype(np.int64)
                 for t in _find_dir(blocks, cs))
    want_d, want_v = find_dir_batch(blocks.cpu().numpy(), cs)
    check(np.array_equal(dirs, want_d) and np.array_equal(var, want_v),
          f"{tag}: device CDEF directions/variances differ from "
          "find_dir_batch")
    n = nv8p * nh8p
    b = np.arange(n)
    fb = fb_map.reshape(-1)[(b // nh8p // 8) * nhfb + (b % nh8p) // 8]
    ydamp, cdamp = damping + cs, max(0, damping + cs - 1)
    filtered = 0
    for k, (strs, bs, damp) in enumerate(((y_str, 8, ydamp),
                                          (uv_str, 4, cdamp),
                                          (uv_str, 4, cdamp))):
        gi = np.where(fb >= 0, np.asarray(strs)[np.maximum(fb, 0)], 0)
        blk = np.nonzero((maskg.reshape(-1) > 0) & (gi != 0))[0]
        pri = (gi[blk] // 4) << cs
        sec = gi[blk] % 4
        sec = (sec + (sec == 3)) << cs
        d = np.where(pri != 0, dirs[blk], 0)
        if k == 0:
            for p in np.unique(pri):
                sel = pri == p
                pri[sel] = adjust_strength(int(p), var[blk[sel]])
        rows, cols = (blk // nh8p) * bs, (blk % nh8p) * bs
        out = filter_blocks(pads[k], rows + 2, cols + 2, bs, bs, pri, sec,
                            d, damp, damp, cs)
        ch, cw = (mi_rows * 4, mi_cols * 4) if k == 0 else (mi_rows * 2,
                                                            mi_cols * 2)
        want = before[k][:ch, :cw].copy()
        for i, (r, c) in enumerate(zip(rows, cols)):
            want[r:r + bs, c:c + bs] = out[i]
        check(np.array_equal(after[k][:ch, :cw], want),
              f"{tag}: device CDEF plane {k} differs from the host filter")
        filtered += blk.size
    return (f"{tag} frame: directions and variances of {n} units equal "
            f"find_dir_batch's; {filtered} filtered units (Y, U, V) and "
            f"every other unit equal the host filter's")


def phase_device_cdef(device, hd: dict, inter: dict) -> None:
    """Phase 9: phase 6's 1080p keyframe group (cdef_group_device) and
    phase 5's 720p KF + mini-GOP (the per-frame entry) with
    SVT_TPU_DEVICE_CDEF=1: one frame of each held against the host's
    exact direction search and filter; the TUs against the CDEF kernel's
    run of the same phase (bit-exact with the native C), and both "cdef"
    stage seconds."""
    words = []
    os.environ["SVT_TPU_DEVICE_CDEF"] = "1"
    os.environ["SVT_TPU_TIMING"] = "1"
    try:
        for tag, cfg, base in (("1080p keyframe group", HD, hd),
                               ("720p KF + mini-GOP", INTER, inter)):
            seen: list = []
            with recording_cdef_frame(seen):
                if cfg is HD:
                    enc, tus, dt = encode(base["frames"], cfg, device, "hand")
                    cdef_s = enc.stage_seconds["cdef"]
                else:
                    enc, tus, _, dt, _ = encode_gop(
                        base["frames"], cfg["gop"], cfg, device, "hand")
                    cdef_s = enc.timing["cdef"]
            check(len(seen) == 1, f"{tag}: the device CDEF backend did not "
                  "run")
            held = check_cdef_frame(tag, seen[0], 8, device)
            diff = sum(a != b for a, b in zip(tus, base["tus"]))
            words.append(
                f"{tag}: {held}; {diff} of {len(tus)} TUs differ from the "
                f"CDEF kernel's run; cdef {cdef_s:.4f} s on the card "
                f"vs {base['cdef_s']:.4f} s the kernel; {len(tus)} TUs in "
                f"{dt:.3f} s")
    finally:
        del os.environ["SVT_TPU_DEVICE_CDEF"], os.environ["SVT_TPU_TIMING"]
    for w in words:
        print(f"device CDEF: {w}", flush=True)


@contextmanager
def recording_int_analysis(out: dict):
    """Keeps, for the first keyframe analysis (device.intra's
    intra_analysis_batch, one call a shard of the encoder's (1, 1) mesh)
    and the first inter-frame analysis (device.inter's inter_analysis),
    their arguments, their packed result and, for every
    ops.int_kernels.fullloop_int call made inside them, its arguments
    and outputs: out["intra"] and out["inter"]."""
    import svt_av1_psyex_tpu_torch.device.inter as DI
    import svt_av1_psyex_tpu_torch.device.intra as DA
    import svt_av1_psyex_tpu_torch.ops.int_kernels as IK

    names = {"intra": (DA, "intra_analysis_batch"),
             "inter": (DI, "inter_analysis")}
    orig = {kind: getattr(mod, name) for kind, (mod, name) in names.items()}
    orig_loop = IK.fullloop_int
    active: list = []

    def wrap(kind):
        def run(*args, **kwargs):
            if kind in out:
                return orig[kind](*args, **kwargs)
            out[kind] = {"run": orig[kind], "args": args, "kwargs": kwargs,
                         "loops": []}
            active.append(kind)
            try:
                out[kind]["packed"] = orig[kind](*args, **kwargs)
            finally:
                active.pop()
            return out[kind]["packed"]
        return run

    def loop(resid, qp6, n, log_scale, bit_depth, want_inv=False):
        res = orig_loop(resid, qp6, n, log_scale, bit_depth, want_inv)
        if active:
            out[active[-1]]["loops"].append(
                ((resid, qp6, n, log_scale, bit_depth), res))
        return res

    for kind, (mod, name) in names.items():
        setattr(mod, name, wrap(kind))
    IK.fullloop_int = loop
    try:
        yield
    finally:
        for kind, (mod, name) in names.items():
            setattr(mod, name, orig[kind])
        IK.fullloop_int = orig_loop


def check_int_analysis(rec: dict) -> str:
    """The recorded keyframe and inter-frame analyses of phase 10 against
    the CPU, in one CPU run of each: every fullloop_int call of the CPU
    run gets the card's input, and its coefficients, eob and inverse
    equal the card's bit for bit (dist and rate are float32 sums and
    log2s: printed); the winning mode / candidate agrees on >= 0.98 of
    each depth's blocks."""
    import numpy as np
    import torch

    import svt_av1_psyex_tpu_torch.ops.int_kernels as IK
    from svt_av1_psyex_tpu_torch.device.inter import unpack_inter_analysis
    from svt_av1_psyex_tpu_torch.device.intra import unpack_rd_analysis

    loop = IK.fullloop_int
    words = []
    for kind, key, unpack in (("intra", "mode", unpack_rd_analysis),
                              ("inter", "cand", unpack_inter_analysis)):
        r = rec[kind]
        cpu_loops = []

        def capture(resid, qp6, n, log_scale, bit_depth, want_inv=False):
            met, inv = loop(resid, qp6, n, log_scale, bit_depth, True)
            cpu_loops.append((resid, IK.forward_txfm2d_int(resid, n, n, 0),
                              met, inv))
            return met, (inv if want_inv else None)

        args = [a.cpu() if torch.is_tensor(a) else a for a in r["args"]]
        IK.fullloop_int = capture
        try:
            packed_c = r["run"](*args, **r["kwargs"]).cpu().numpy()
        finally:
            IK.fullloop_int = loop
        check(len(r["loops"]) > 0 and len(cpu_loops) == len(r["loops"]),
              f"intdct: the {kind} analysis made {len(r['loops'])} "
              f"fullloop_int calls on the card, {len(cpu_loops)} on the CPU")
        blocks, dist_rel, rate_eq = 0, 0.0, []
        for ((resid, qp6, n, ls, bd), (met, _)), (rc, coef_c, mc, ic) in zip(
                r["loops"], cpu_loops):
            check(torch.equal(resid.cpu(), rc),
                  f"intdct {kind} n={n}: the residuals differ card vs CPU")
            mk, ik = loop(resid, qp6, n, ls, bd, True)
            mk = mk.cpu()
            check(torch.equal(mk, met.cpu()),
                  f"intdct {kind} n={n}: metrics depend on want_inv")
            check(torch.equal(IK.forward_txfm2d_int(resid, n, n, 0).cpu(),
                              coef_c),
                  f"intdct {kind} n={n}: coefficients differ card vs CPU")
            check(torch.equal(mk[:, 2], mc[:, 2])
                  and torch.equal(ik.cpu(), ic),
                  f"intdct {kind} n={n}: eob or inverse differ card vs CPU")
            dist_rel = max(dist_rel, ((mk[:, 0] - mc[:, 0]).abs()
                                      / mc[:, 0].clamp_min(1.0)).max().item())
            rate_eq.append((mk[:, 1] == mc[:, 1]).double().mean().item())
            blocks += resid.shape[0]
        packed_k = r["packed"].cpu().numpy()
        depths = r["kwargs"]["depths"]
        if kind == "intra":
            hp, wp = args[0].shape[1:]
            got = unpack(packed_k[0], hp, wp, depths)
            want = unpack(packed_c[0], hp, wp, depths)
        else:
            hp, wp = args[0].shape
            got = unpack(packed_k, hp, wp, depths)
            want = unpack(packed_c, hp, wp, depths)
        agree = {blk: float(np.mean(got[blk][key] == want[blk][key]))
                 for blk in depths}
        check(min(agree.values()) >= 0.98,
              f"intdct {kind}: {key} agreement card vs CPU {agree}")
        words.append(
            f"{kind} ({len(r['loops'])} fullloop_int calls, {blocks} "
            f"blocks): residuals, coefficients, eob and inverse "
            f"bit-identical card vs CPU; largest relative dist difference "
            f"{dist_rel:.3g}; rate equal on >= {min(rate_eq):.6f} of the "
            f"blocks of a call; {key} agreement per depth {agree}")
    return "; ".join(words)


def frame_analysis_on_card(frame: list, device) -> str:
    """ops.int_kernels.frame_intra_analysis on one 1920x1088 luma frame
    on the card, timed with CUDA events, against the CPU."""
    import numpy as np
    import torch

    from svt_av1_psyex_tpu_torch.ops.int_kernels import frame_intra_analysis

    y = frame[0]
    luma = np.pad(y, ((0, INTDCT_FRAME["h"] - y.shape[0]), (0, 0)),
                  mode="edge").astype(np.int32)
    blk = INTDCT_FRAME["blk"]
    card = torch.from_numpy(luma).to(device)
    got = frame_intra_analysis(card, blk)
    want = frame_intra_analysis(torch.from_numpy(luma), blk)
    for k in ("sse", "sad", "pred_dc"):
        check(torch.equal(got[k].cpu(), want[k]),
              f"intdct frame analysis: {k} differs card vs CPU")
    var_err = (got["var8x8"].cpu() - want["var8x8"]).abs().max().item()
    check(torch.allclose(got["var8x8"].cpu(), want["var8x8"], rtol=1e-5,
                         atol=1e-4), "intdct frame analysis: var8x8")
    ms = cuda_ms(lambda: frame_intra_analysis(card, blk))
    return (f"frame_intra_analysis on {luma.shape[1]}x{luma.shape[0]} "
            f"({got['sse'].shape[1]} blocks of {blk}x{blk}): {ms:.4f} ms on "
            f"the card (CUDA events); sse, sad and pred_dc equal the CPU's, "
            f"var8x8 max |diff| {var_err:.3g}")


def phase_intdct(device, inter: dict, hd: dict) -> dict:
    """Phase 10: phase 5's cell on the integer analysis tier; its
    analysis batches card vs CPU; the frame analysis at 1080p. Returns
    the run's launch counts (the main path of this phase)."""
    import svt_av1_psyex_tpu_torch.device.intra as PI

    cfg = INTER
    frames = inter["frames"]
    flag = PI._USE_MATDCT
    PI._USE_MATDCT = False
    rec: dict = {}
    try:
        encode_gop(frames, cfg["warmup_gop"], cfg, device, "hand")
        os.environ["SVT_TPU_TIMING"] = "1"
        try:
            with recording_int_analysis(rec):
                (enc, tus, recons, dt, coded), launches = counted(
                    lambda: encode_gop(frames, cfg["gop"], cfg, device,
                                       "hand"))
        finally:
            del os.environ["SVT_TPU_TIMING"]
        check(launches["fullloop"] == 0, f"intdct: the fullloop kernel "
              f"launched {launches['fullloop']} times under the switch")
        check(launches["sad"] > 0, "intdct: the main path launched no sad "
              "kernel")
        check(len(recons) == cfg["frames"] and all(len(t) > 0 for t in tus),
              "intdct: expected a non-empty TU per coded frame and a recon "
              "per displayed frame")
        check("intra" in rec and "inter" in rec,
              "intdct: the keyframe or inter analysis was not recorded")
        t0 = time.perf_counter()
        held = check_int_analysis(rec)
        held += f" ({time.perf_counter() - t0:.1f} s with the CPU runs)"
        gate = dav1d_check("intdct", enc, tus, cfg, recons=recons)
        aom = libaom_check("intdct", tus, cfg)
        alone = frame_analysis_on_card(hd["frames"][0], device)
    finally:
        PI._USE_MATDCT = flag
    diff = sum(a != b for a, b in zip(tus, inter["tus"]))
    print(f"intdct: {cfg['w']}x{cfg['h']} 8-bit, keyframe + {cfg['gop']}-"
          f"frame mini-GOP ({len(tus)} TUs), p{cfg['preset']}, "
          f"q{cfg['qindex']}, analysis on the integer networks: "
          f"{cfg['frames'] / dt:.3f} fps ({dt:.3f} s; host tier per stage, "
          f"s: { {k: round(v, 4) for k, v in enc.timing.items()} }); "
          f"{diff} of {len(tus)} TUs differ from phase 5's float analysis; "
          f"{gate}; {aom}; launches {launches}; {sum(map(len, tus))} bytes",
          flush=True)
    print(f"intdct: {held}", flush=True)
    print(f"intdct: {alone}", flush=True)
    return launches


def kernel_modules() -> dict:
    """The wrapper module of each kernel, by name."""
    from svt_av1_psyex_tpu_torch.ops.cuda import cdef, fullloop, sad

    return {"fullloop": fullloop, "sad": sad, "cdef": cdef}


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before it;
    returns its result and the counts read just after it."""
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    out = fn()
    return out, {name: mod.launches for name, mod in mods.items()}


def mesh_launches(tag: str, sharded: dict, single: dict,
                  shards: int) -> None:
    """The sharded run launches each analysis kernel once per shard where
    the unsharded run launches it once, and CDEF (a frame's, after its
    rows are gathered) as often as the unsharded run."""
    for name in KERNELS:
        want = single[name] * (1 if name == "cdef" else shards)
        check(sharded[name] == want,
              f"mesh: {tag}: {name} launched {sharded[name]} times "
              f"sharded, {single[name]} unsharded, {shards} shards")
    check(sharded["fullloop"] > 0, f"mesh: {tag}: no fullloop launch")


def phase_mesh(device) -> dict:
    """Phase 11: the analysis over a (dp, sp) mesh against the unsharded
    run: phase 6's clip (4 frames) under (2, 2), phase 5's cell under
    (1, 4), then dryrun_multichip(4). Returns the launch counts of the
    two sharded runs (the main path of this phase)."""
    import numpy as np

    from svt_av1_psyex_tpu_torch.parallel.dryrun import dryrun_multichip
    from svt_av1_psyex_tpu_torch.parallel.mesh import DeviceMesh, shard_grid

    cfg = MESH_HD
    frames = make_frames(cfg)
    mesh = DeviceMesh.spread(cfg["mesh"], device)
    shards = len(shard_grid(cfg["frames"], -(-cfg["h"] // 64), mesh))
    probe = make_encoder(cfg, device, "hand")
    rows_one = probe.analyze_keyframes(frames, cfg["qindex"])
    rows_mesh = probe.analyze_keyframes(frames, cfg["qindex"], mesh)
    ndiff = int(np.sum(rows_one != rows_mesh))
    print(f"mesh: 1080p analysis rows, {cfg['mesh']} vs unsharded: {ndiff} "
          f"of {rows_one.size} values differ (largest |diff| "
          f"{float(np.max(np.abs(rows_one - rows_mesh)))})", flush=True)
    check(ndiff == 0, "mesh: the sharded keyframe analysis rows differ")
    (_, tus_1, dt_1), l_1 = counted(
        lambda: encode(frames, cfg, device, "hand"))
    (enc_m, tus_m, dt_m), l_m = counted(
        lambda: encode(frames, cfg, device, "hand", mesh))
    diff = [i for i, (a, b) in enumerate(zip(tus_m, tus_1)) if a != b]
    check(len(tus_m) == cfg["frames"] and not diff,
          f"mesh: 1080p TUs {diff} differ sharded vs unsharded")
    mesh_launches("1080p", l_m, l_1, shards)
    gate = dav1d_check("mesh_hd", enc_m, tus_m, cfg)
    print(f"mesh: 1080p {cfg['frames']} keyframes, p{cfg['preset']}, "
          f"q{cfg['qindex']}, mesh {cfg['mesh']} (dp, sp) on "
          f"{len(mesh.placement())} distinct card(s) {mesh.placement()}, "
          f"{shards} shards: sharded {cfg['frames'] / dt_m:.3f} fps "
          f"({stages(enc_m)}), unsharded {cfg['frames'] / dt_1:.3f} fps; "
          f"TUs identical; launches sharded {l_m}, unsharded {l_1} "
          f"(x {shards}); {gate}", flush=True)

    cfg = MESH_INTER
    gframes = make_frames(cfg)
    mesh4 = DeviceMesh.spread(cfg["mesh"], device)
    shards4 = len(shard_grid(1, -(-cfg["h"] // 64), mesh4))
    encode_gop(gframes, cfg["warmup_gop"], cfg, device, "hand", mesh4)
    (enc_1, gtus_1, _, gdt_1, coded), gl_1 = counted(
        lambda: encode_gop(gframes, cfg["gop"], cfg, device, "hand"))
    (enc_g, gtus_m, grec_m, gdt_m, _), gl_m = counted(
        lambda: encode_gop(gframes, cfg["gop"], cfg, device, "hand", mesh4))
    diff = [i for i, (a, b) in enumerate(zip(gtus_m, gtus_1)) if a != b]
    check(len(gtus_m) == len(gtus_1) and not diff,
          f"mesh: 720p TUs {diff} differ sharded vs unsharded")
    rows_differ = sum(
        not np.array_equal(dm.stats[blk][k], d1.stats[blk][k])
        for dm, d1 in zip(enc_g.dmds, enc_1.dmds) for blk in d1.DEPTHS
        for k in d1.stats[blk])
    check(rows_differ == 0 and len(enc_g.dmds) == len(coded),
          f"mesh: 720p analysis fields differ sharded vs unsharded "
          f"({rows_differ})")
    mesh_launches("720p", gl_m, gl_1, shards4)
    ggate = dav1d_check("mesh_inter", enc_g, gtus_m, cfg, recons=grec_m)
    print(f"mesh: 720p keyframe + {cfg['gop']}-frame mini-GOP "
          f"({len(gtus_m)} TUs, {len(coded)} coded), p{cfg['preset']}, "
          f"q{cfg['qindex']}, mesh {cfg['mesh']} on "
          f"{len(mesh4.placement())} distinct card(s), {shards4} shards "
          f"per frame: sharded {cfg['frames'] / gdt_m:.3f} fps, unsharded "
          f"{cfg['frames'] / gdt_1:.3f} fps; TUs and every coded frame's "
          f"analysis fields identical; launches sharded {gl_m}, unsharded "
          f"{gl_1} (x {shards4}); {ggate}", flush=True)

    summary, dl = counted(lambda: dryrun_multichip(4, device="cuda"))
    print(f"mesh: dryrun_multichip(4) passed: mesh {summary['mesh']} on "
          f"{len(summary['placement'])} distinct card(s) "
          f"{summary['placement']}; launches (sharded and unsharded "
          f"encodes) {dl}", flush=True)
    return {name: l_m[name] + gl_m[name] for name in KERNELS}


def host_md_case(name: str) -> tuple:
    """Phase 12's encode `name`: (SequenceConfig arguments, Av1Encoder
    arguments, frames, qindex, gop: None for encode_keyframe per frame,
    else a keyframe and a gop-frame mini-GOP). The clips are those of
    tests/test_torch_host_paths*.py (the JAX package's tests/test_444.py,
    test_tiles.py, test_mono.py, test_palette.py) and of
    tests/test_torch_film_grain.py; the tiled GOP and the film-grain
    encode are cut in depth."""
    import numpy as np

    from svt_av1_psyex_tpu_torch.streams import VideoFormat
    from svt_av1_psyex_tpu_torch.utils.clips import synth_frame

    w, h = HOST_MD_ME["w"], HOST_MD_ME["h"]
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w]

    def luma(t):
        return np.clip(110 + 70 * np.sin((xx + 4 * t) / 9.0)
                       * np.cos(yy / 7.0) + rng.integers(-5, 6, (h, w)),
                       0, 255).astype(np.uint8)

    if name == "4:4:4 GOP":
        frames = []
        for t in range(5):
            frames.append([
                luma(t),
                np.clip(100 + 60 * np.cos((xx + 4 * t) / 11.0), 0,
                        255).astype(np.uint8),
                np.clip(150 - 60 * np.sin(yy / 13.0), 0,
                        255).astype(np.uint8)])
        return (dict(width=w, height=h, profile=1, subsampling_x=0,
                     subsampling_y=0), dict(preset=10), frames, 120, 4)
    if name == "mono p6 GOP":
        return (dict(width=w, height=h, mono_chrome=True), dict(preset=6),
                [[luma(t)] for t in range(5)], 120, 4)
    if name == "2-tile inter GOP":
        # cut to a 2-frame mini-GOP: the test's 4-frame one takes about
        # 150 s of host MD on one thread
        fmt = VideoFormat(256, 128)
        return (dict(width=256, height=128),
                dict(preset=8, tile_cols_log2=1),
                [synth_frame(fmt, t) for t in range(3)], 120, 2)
    if name == "screen-content keyframe":
        # tests/test_palette.py's _sc_frame(): text-like strokes
        rng_sc = np.random.default_rng(0)
        y = np.full((128, 128), 32, np.uint8)
        y[:64] = 200
        for _ in range(12):
            r0, c0 = rng_sc.integers(0, 104, 2)
            y[r0:r0 + 3, c0:c0 + 24] = 90
            y[r0:r0 + 20, c0:c0 + 2] = 140
        return (dict(width=128, height=128),
                dict(preset=6, screen_content_mode=1),
                [[y, np.full((64, 64), 110, np.uint8),
                  np.full((64, 64), 140, np.uint8)]], 100, None)
    if name == "film grain p4 10-bit":
        fmt = VideoFormat(64, 64, 10)
        return (dict(width=64, height=64, bit_depth=10),
                dict(preset=4, film_grain=8, adaptive_film_grain=True),
                [synth_frame(fmt, t) for t in range(2)], 120, 1)
    raise ValueError(name)


def host_md_encode(name: str, device, kernels: str = "hand") -> tuple:
    """Phase 12's encode `name` on `device`. Returns (TUs, per TU its
    coded frame's (qindex, {depth: the device MD's winning mode or
    candidate per block}, empty for a host-MD frame) or None for a
    show-existing TU, seconds)."""
    import numpy as np

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig
    from svt_av1_psyex_tpu_torch.codec.gop import plan_key, plan_minigop

    seq_kw, enc_kw, frames, q, gop = host_md_case(name)
    coded = []

    class Recording(Av1Encoder):
        def _begin_frame_impl(self, *a, **k):
            st = super()._begin_frame_impl(*a, **k)
            if isinstance(st, dict):
                dmd = st["dmd"]
                dec = {}
                if dmd is not None and getattr(dmd, "stats", None):
                    key = ("cand" if "cand" in dmd.stats[dmd.DEPTHS[0]]
                           else "mode")
                    dec = {blk: np.asarray(dmd.stats[blk][key])
                           for blk in dmd.DEPTHS}
                coded.append((st["fr"].base_q_idx, dec))
            return st

    enc = Recording(SequenceConfig(**seq_kw), device=device,
                    kernels=kernels, **enc_kw)
    t0 = time.perf_counter()
    tus, per_tu = [], []
    if gop is None:
        for f in frames:
            tus.append(enc.encode_keyframe([p.copy() for p in f], q))
            per_tu.append(coded[-1])
    else:
        for pl in [plan_key(0)] + plan_minigop(0, 1, gop, future_slot=1):
            n = len(coded)
            src = (None if pl.show_existing_slot is not None
                   else [p.copy() for p in frames[pl.disp_idx]])
            tus.append(enc.encode_frame(src, q, plan=pl))
            per_tu.append(coded[-1] if len(coded) > n else None)
    return tus, per_tu, time.perf_counter() - t0


def host_md_run(name: str, device: str) -> tuple:
    """host_md_encode in a worker process (one torch thread), the
    kernels' launch counts set to 0 just before it and read just after
    it: (TUs, per TU the coded frame's decisions, seconds, launches)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from svt_av1_psyex_tpu_torch.runtime import resolve_device

    out, launches = counted(
        lambda: host_md_encode(name, resolve_device(device)))
    return out + (launches,)


def phase_host_md(device) -> dict:
    """Phase 12: the host-MD paths, each encoded on the card and on the
    CPU, all at once in worker processes (the host MD runs for minutes
    on one thread). Returns the card runs' launch counts summed (the
    main path of this phase)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    total = {name: 0 for name in KERNELS}
    words = []
    with ProcessPoolExecutor(
            2 * len(HOST_MD_PATHS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {(name, dev): pool.submit(host_md_run, name, dev)
                for name in HOST_MD_PATHS for dev in (str(device), "cpu")}
        for name in HOST_MD_PATHS:
            tus_k, coded_k, dt_k, launches = runs[name, str(device)].result()
            tus_c, coded_c, dt_c, _ = runs[name, "cpu"].result()
            for k in KERNELS:
                total[k] += launches[k]
            if name == "mono p6 GOP":
                check(launches["fullloop"] > 0, "host MD: the mono GOP "
                      "launched no fullloop kernel")
            check(len(tus_k) == len(tus_c) and all(tus_k),
                  f"host MD: {name}: TU counts")
            diff = [i for i, (a, b) in enumerate(zip(tus_k, tus_c))
                    if a != b]
            for i in diff:
                check(coded_k[i] is not None and coded_c[i] is not None,
                      f"host MD: {name}: show-existing TU {i} differs")
                (qk, dk), (qc, dc) = coded_k[i], coded_c[i]
                agree = {blk: float(np.mean(dk[blk] == dc[blk]))
                         for blk in dk}
                print(f"host MD: {name}: TU {i} differs card vs CPU; "
                      f"qindex {qk} on the card, {qc} on the CPU; decision "
                      f"agreement per depth {agree or 'none: a host-MD '
                      'frame, whose device inputs are exact integers'}",
                      flush=True)
                check(qk == qc, f"host MD: {name}: TU {i} qindex differs")
                check(bool(agree) and min(agree.values()) >= 0.98,
                      f"host MD: {name}: TU {i} decision agreement")
            words.append(f"{name}: {len(diff)} of {len(tus_k)} TUs differ "
                         f"card vs CPU, card {dt_k:.3f} s, CPU {dt_c:.3f} s, "
                         f"launches {launches}, "
                         f"{sum(map(len, tus_k))} bytes")
    check(total["sad"] > 0, "host MD: no sad launch on the host-MD paths")
    for w in words:
        print(f"host MD: {w}", flush=True)
    return total


def first_packet_child() -> int:
    """With --first-packet: the seconds from a fresh SvtAv1Encoder at
    config 2's shape (on the card, its init and its warm_device call
    included) to its first packet, the clip's frames made beforehand;
    printed as a JSON line."""
    sys.path.insert(0, str(ROOT))
    frames = make_frames(dict(CONFIG2, frames=13))
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    t0 = time.perf_counter()
    api = SvtAv1Encoder(device="cuda")
    c = api.config
    c.source_width, c.source_height = CONFIG2["w"], CONFIG2["h"]
    c.enc_mode, c.crf = CONFIG2["preset"], CONFIG2["crf"]
    c.frame_rate_numerator, c.frame_rate_denominator = 30, 1
    api.init()
    check(api._enc._warm_thread is None, "first packet: init started "
          "a warm-up")
    api.warm_device()
    t_init = time.perf_counter() - t0
    pkt = None
    for t, f in enumerate(frames):
        api.send_picture(f, t)
        if (pkt := api.get_packet()) is not None:
            break
    dt = time.perf_counter() - t0
    check(pkt is not None and len(pkt.data) > 0, "first packet: none")
    print(json.dumps({"first_packet_s": dt, "init_s": t_init,
                      "frames_sent": t + 1,
                      "sha256": hashlib.sha256(pkt.data).hexdigest(),
                      "warm_launches": {
                          name: mod.warm_launches
                          for name, mod in kernel_modules().items()}}))
    return 0


def phase_first_packet() -> str:
    """The time to the first packet of a fresh SvtAv1Encoder at config
    2's shape, in a fresh process each: init, then warm_device as it is,
    then under SVT_TPU_NO_WARM=1 (where it does nothing). No claim: the
    numbers."""
    out = {}
    for label, env in (("warm", {}), ("no warm", {"SVT_TPU_NO_WARM": "1"})):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--first-packet"],
            cwd=ROOT, env={**os.environ, **env}, capture_output=True,
            text=True, timeout=300)
        check(proc.returncode == 0, f"first packet ({label}) exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        out[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["warm"]["sha256"] == out["no warm"]["sha256"],
          "first packet: the keyframe's TU differs with and without warm")
    check(min(out["warm"]["warm_launches"].values()) > 0
          and max(out["no warm"]["warm_launches"].values()) == 0,
          f"first packet: warm launches {out['warm']['warm_launches']} "
          f"with warm, {out['no warm']['warm_launches']} without")
    return "the keyframe's TU identical with and without; " + "; ".join(
        f"{label}: {r['first_packet_s']:.3f} s to the first packet "
        f"(init and warm_device {r['init_s']:.3f} s, "
        f"{r['frames_sent']} frames sent, "
        f"warm launches {r['warm_launches']})"
        for label, r in out.items())


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

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"time: {label} took {time.perf_counter() - t:.1f} s",
              flush=True)
        return out

    measured = {"fullloop": timed("phase 3 (fullloop)", phase_kernels, device),
                "sad": timed("phase 3 (sad)", phase_sad, device),
                "cdef": timed("phase 3 (cdef)", phase_cdef, device)}
    timed("phase 4 (slice)", phase_slice, device)
    inter = timed("phase 5 (inter)", phase_inter, device)
    hd = timed("phase 6 (1080p)", phase_hd, device)
    by_path = {"config 2": timed("phase 7 (config 2)", phase_config2, device),
               "config 3": timed("phase 8 (config 3)", phase_config3, device)}
    timed("phase 9 (device CDEF)", phase_device_cdef, device, hd, inter)
    by_path["intdct"] = timed("phase 10 (intdct)", phase_intdct, device,
                              inter, hd)
    by_path["mesh"] = timed("phase 11 (mesh)", phase_mesh, device)
    by_path["1080p chunked"] = hd["chunked_launches"]
    by_path["host MD"] = timed("phase 12 (host MD)", phase_host_md, device)
    print(f"first packet: config 2's shape through a fresh SvtAv1Encoder "
          f"in a fresh process ({smi}): "
          f"{timed('phase 12 (first packet)', phase_first_packet)}",
          flush=True)
    check(not any(m.split(".")[0] in ("jax", "svt_av1_psyex_tpu")
                  for m in sys.modules), "jax or the JAX package was imported")

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": sum(p[name] for p in by_path.values()),
        "launches_by_path": {k: p[name] for k, p in by_path.items()},
        "max_abs_err": measured[name]["max_abs_err"],
        "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"],
        "bound_ms": measured[name]["bound_ms"],
        "bound_by": measured[name]["bound_by"],
        # no single PyTorch call computes any kernel's function
        "library_ms": None}
        for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(first_packet_child() if sys.argv[1:] == ["--first-packet"]
             else main())
