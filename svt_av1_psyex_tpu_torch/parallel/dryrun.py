"""dryrun_multichip: the port's sharded encode held against its unsharded
encode.

Counterpart of the JAX package's `dryrun_multichip`
(__graft_entry__.py:34-190), with the same two phases, clips, presets,
quantizers and mesh rule:

1. a group of keyframes, one frame per dp shard, each 128 wide and two
   superblock rows per sp shard high, at preset 12, qindex 120, through
   Av1Encoder.encode_keyframes(..., mesh=mesh);
2. a 384x192 keyframe and a 2-frame random-access mini-GOP at preset 6
   (TX-select, interpolation-filter trials, CDEF search, loop
   restoration), qindex 110, with enc.mesh set, so that the keyframe's
   and every inter frame's analysis is sharded.

Each phase's TUs must equal the unsharded encode's byte for byte, and,
where libdav1d.so.6 loads, every displayed frame must decode in dav1d to
the sharded encoder's reconstruction (else the summary says the decoder
is absent). On the CPU that holds at any shard size, and the run checks
the layout; on a CUDA device it holds where the analysis rows do
(parallel/mesh.py), and the run checks it at these shards of 4 to 18
superblocks. The summary says which case it checked. Run from the
repository root:

    python -m svt_av1_psyex_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..codec.encoder import Av1Encoder, SequenceConfig
from ..codec.gop import plan_minigop
from ..streams import dav1d_loads, dav1d_mismatches
from .mesh import DeviceMesh

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "dryrun_multichip"


def mesh_shape(n_devices: int) -> tuple:
    """(n/2, 2) for even n > 2, else (n, 1): the JAX dry run's rule."""
    if n_devices % 2 == 0 and n_devices > 2:
        return (n_devices // 2, 2)
    return (n_devices, 1)


def _same(tag: str, sharded: list, single: list) -> None:
    if len(sharded) != len(single):
        raise RuntimeError(f"{tag}: {len(sharded)} sharded TUs against "
                           f"{len(single)} unsharded")
    bad = [i for i, (a, b) in enumerate(zip(sharded, single)) if a != b]
    if bad:
        raise RuntimeError(f"{tag}: sharded TUs {bad} differ from the "
                           "unsharded encode's")


def _dav1d(tag: str, tus: list, recons: list, w: int, h: int) -> str:
    if not dav1d_loads():
        return "dav1d absent (libdav1d.so.6 does not load): not decoded"
    bad = dav1d_mismatches(OUT_DIR / f"{tag}.ivf", tus, recons, w, h)
    if bad:
        raise RuntimeError(f"{tag}: dav1d output differs from the recon "
                           f"in frames {bad}")
    return f"dav1d bit-exact on {len(recons)} frames"


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Encode both phases under a mesh_shape(n_devices) mesh spread over
    the cards there are (DeviceMesh.spread: round-robin when there are
    fewer than n_devices; all on the CPU only with device="cpu") and
    against the unsharded encode. Raises on any difference. Returns a
    summary: the mesh's shape, its placement, which case of exactness the
    run checked (module docstring), the frames of each phase and the
    dav1d verdicts."""
    shape = mesh_shape(n_devices)
    mesh = DeviceMesh.spread(shape, device)
    placement = mesh.placement()
    case = ("cpu: rows exact at any shard size" if mesh.first.type == "cpu"
            else "cuda: TUs equal at these shard sizes, as checked here")
    print(f"dryrun_multichip: mesh {shape} (dp, sp) over "
          f"{len(placement)} distinct device(s), shards per device "
          f"{placement}; {case}", flush=True)

    # phase 1: one keyframe per dp shard, two superblock rows per sp shard
    b = shape[0]
    w, h = 128, 64 * 2 * shape[1]
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(b):
        y = np.clip(110 + 70 * np.sin((xx + 5 * t) / 9.0) * np.cos(yy / 7.0)
                    + rng.randint(-6, 7, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 135, np.uint8)
        frames.append([y, u, v])
    q = 120
    enc = Av1Encoder(SequenceConfig(width=w, height=h), preset=12,
                     device=device)
    tus_mesh = enc.encode_keyframes([list(f) for f in frames], q, mesh=mesh)
    recons = list(enc.recons)
    tus_one = Av1Encoder(SequenceConfig(width=w, height=h), preset=12,
                         device=device).encode_keyframes(
        [list(f) for f in frames], q)
    _same("keyframes", tus_mesh, tus_one)
    kf_dav1d = _dav1d("dryrun_keyframes", tus_mesh, recons, w, h)
    print(f"dryrun_multichip: {b} keyframes {w}x{h} p12 q{q} through the "
          f"sharded analysis: TUs identical to the unsharded encode; "
          f"{kf_dav1d}", flush=True)

    # phase 2: a keyframe and a p6 random-access mini-GOP under the mesh
    gw, gh = 384, 192
    gyy, gxx = np.mgrid[0:gh, 0:gw]
    gframes = []
    for t in range(4):
        y = np.clip(120 + 60 * np.sin((gxx + 4 * t) / 11.0)
                    * np.cos((gyy - 3 * t) / 8.0)
                    + rng.randint(-5, 6, (gh, gw)), 0, 255).astype(np.uint8)
        u = np.full((gh // 2, gw // 2), 118, np.uint8)
        v = np.full((gh // 2, gw // 2), 130, np.uint8)
        gframes.append([y, u, v])

    def encode_gop(mesh_arg):
        enc = Av1Encoder(SequenceConfig(width=gw, height=gh), preset=6,
                         device=device)
        enc.mesh = mesh_arg
        tus = [enc.encode_keyframe([p.copy() for p in gframes[0]], 110)]
        recons = [[p.copy() for p in enc.last_recon]]
        for pl in plan_minigop(0, 1, 2, future_slot=1):
            src = (gframes[pl.disp_idx] if pl.show_existing_slot is None
                   else None)
            tus.append(enc.encode_frame(
                [p.copy() for p in src] if src else None, 110, plan=pl))
            if pl.show_frame or pl.show_existing_slot is not None:
                recons.append([p.copy() for p in enc.last_recon])
        return tus, recons

    gop_mesh, gop_recons = encode_gop(mesh)
    gop_one, _ = encode_gop(None)
    _same("GOP", gop_mesh, gop_one)
    gop_dav1d = _dav1d("dryrun_gop", gop_mesh, gop_recons, gw, gh)
    print(f"dryrun_multichip: keyframe + p6 mini-GOP ({len(gop_mesh)} TUs, "
          f"{gw}x{gh}, q110) under the mesh: TUs identical to the "
          f"unsharded encode; {gop_dav1d}", flush=True)
    return {"mesh": shape, "placement": placement, "case": case,
            "keyframes": len(tus_mesh), "gop_tus": len(gop_mesh),
            "dav1d": {"keyframes": kf_dav1d, "gop": gop_dav1d}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
