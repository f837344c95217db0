"""The (dp, sp) device mesh of the analysis tier.

Counterpart of the JAX package's `jax.sharding.Mesh` with axes
("dp", "sp") (svt_av1_psyex_tpu/codec/encoder.py encode_keyframes,
codec/md_device.py analyze_dispatch): the analysis batch of a keyframe
group puts its frames over dp and its superblock rows over sp; an inter
frame puts its superblock rows over sp.

One process drives every device of the mesh, as one JAX controller
drives its mesh: a shard is a slice of the host planes uploaded to its
device and run through the same torch functions as the whole frame, so
each block's arithmetic is the one of the unsharded call. Every shard is
dispatched before any is fetched (CUDA runs them asynchronously, so
shards on distinct cards overlap); the shards are then fetched in order
and reassembled into the unsharded packed rows (ShardedRows).

Unlike the JAX mesh, a split need not be even: 1080p has 17 superblock
rows, and over sp = 2 the first shard takes 9 and the second 8. A mesh
may name one device several times (DeviceMesh.spread places its shards
round-robin on the cards there are); a shard never moves to another
device than the one the mesh names for it. The unsharded analysis is
the (1, 1) mesh (DeviceMesh.single): one shard, the whole batch.

How exact the reassembled rows are depends on the device. On the CPU
they equal the unsharded rows bit for bit at any shard size: the float
transforms run fixed-order chains, and every reduction sums a block in
one order whatever the batch. On a CUDA device a few float ops answer
by the size of the batch they are given: cuBLAS's sgemm of blk 64's
transforms, the batched 8x8 psy Hadamard and torch's sums of few blocks
may take another summation order, so a J may move in its last bits (and
then perhaps a decision) when a shard holds only a few superblocks. At
the shard sizes of a 720p or 1080p frame over sp <= 4 the rows were
equal on an H100 (PERF.md section 6).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..runtime import resolve_device

AXES = ("dp", "sp")
SB = 64  # superblock rows are the unit of the sp split


class DeviceMesh:
    """A (dp, sp) grid of torch devices, row-major over `devices`. Each
    entry is resolved as the encoder's device is ("cuda", "cuda:1",
    "cpu", a torch.device): naming a CUDA device where there is none
    raises."""

    axis_names = AXES

    def __init__(self, devices, shape: tuple):
        dp, sp = (int(v) for v in shape)
        devs = [resolve_device(d) for d in devices]
        if dp < 1 or sp < 1 or len(devs) != dp * sp:
            raise ValueError(f"a ({dp}, {sp}) mesh needs {dp * sp} "
                             f"devices, got {len(devs)}")
        self.shape = (dp, sp)
        self.devices = devs

    @classmethod
    def spread(cls, shape: tuple, device="cuda") -> "DeviceMesh":
        """A mesh of `shape` whose shards sit round-robin on the cards
        there are (device "cuda"), or all on the CPU (device "cpu")."""
        n = int(shape[0]) * int(shape[1])
        dev = resolve_device(device)
        if dev.type == "cpu":
            return cls([dev] * n, shape)
        count = torch.cuda.device_count()
        return cls([torch.device("cuda", (dev.index + i) % count)
                    for i in range(n)], shape)

    @classmethod
    def single(cls, device) -> "DeviceMesh":
        """The (1, 1) mesh on `device`: the unsharded analysis."""
        return cls([device], (1, 1))

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d * self.shape[1] + s]

    @property
    def first(self) -> torch.device:
        """The device of shard (0, 0); the encoder's own device."""
        return self.devices[0]

    def placement(self) -> dict:
        """{device name: number of mesh positions on it}."""
        return dict(Counter(str(d) for d in self.devices))


def split(n: int, parts: int) -> list:
    """`parts` contiguous [start, stop) ranges over range(n), as
    np.array_split cuts: the first n % parts ranges one longer; empty
    ranges where parts > n."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (i < extra)
        out.append((start, stop))
        start = stop
    return out


def shard_grid(n_frames: int, sb_rows: int, mesh: DeviceMesh) -> list:
    """The non-empty shards of a batch: (device, (f0, f1), (r0, r1)) for
    frames [f0, f1) over dp and superblock rows [r0, r1) over sp."""
    return [(mesh.device(d, s), fr, rr)
            for d, fr in enumerate(split(n_frames, mesh.shape[0]))
            for s, rr in enumerate(split(sb_rows, mesh.shape[1]))
            if fr[0] < fr[1] and rr[0] < rr[1]]


class ShardedRows:
    """Packed analysis rows computed in shards. A packed row is a run of
    fields, each an (sb_rows * k, nbx) raster (k block rows per
    superblock row); a shard holds the rows [r0 * k, r1 * k) of every
    field of frames [f0, f1), packed the same way. numpy() fetches the
    shards in order and returns the (F, P) rows of the unsharded call."""

    def __init__(self, shards: list, fields: list, n_frames: int,
                 sb_rows: int):
        self.shards = shards      # ((f0, f1), (r0, r1), (f1-f0, P_s) tensor)
        self.fields = fields      # (k, nbx) per field
        self.n_frames = n_frames
        self.sb_rows = sb_rows
        self._events: list = []   # start_fetch's copies, one per CUDA shard

    def start_fetch(self) -> "ShardedRows":
        """Queue each CUDA shard's copy into pinned host memory behind its
        analysis, and an event after the copy. numpy() then waits on
        those events only: a plain .cpu() would also wait for whatever
        was queued on the stream after this call (the next chunk of a
        keyframe group). CPU shards are on the host already."""
        shards = []
        for fr, rr, part in self.shards:
            if part.device.type == "cuda":
                host = torch.empty(part.shape, dtype=part.dtype,
                                   pin_memory=True)
                with torch.cuda.device(part.device):
                    host.copy_(part, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                self._events.append(ev)
                part = host
            shards.append((fr, rr, part))
        self.shards = shards
        return self

    def numpy(self) -> np.ndarray:
        for ev in self._events:
            ev.synchronize()
        size = sum(self.sb_rows * k * nbx for k, nbx in self.fields)
        out = np.empty((self.n_frames, size), np.float32)
        for (f0, f1), (r0, r1), part in self.shards:
            part = part.cpu().numpy()
            pos = spos = 0
            for k, nbx in self.fields:
                n = (r1 - r0) * k * nbx
                a = pos + r0 * k * nbx
                out[f0:f1, a:a + n] = part[:, spos:spos + n]
                pos += self.sb_rows * k * nbx
                spos += n
            if spos != part.shape[1]:
                raise ValueError(f"shard rows {r0}:{r1} hold "
                                 f"{part.shape[1]} values, the fields "
                                 f"need {spos}")
        return out

