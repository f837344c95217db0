"""What the harness reads from the program while the window is open.

The probes wrap three entry points of the port for the length of a run,
without changing what they compute:

* `ops.cuda.fullloop.fullloop` and `ops.cuda.sad.sad_lattice`, the two
  hand kernels' launchers: each launch's shape is recorded (the kernels'
  roofline shares), and a sample of the launches, drawn from the seed,
  keeps a few of its rows' inputs and outputs for the check;
* `device.intra.intra_analysis_sharded` as the mode decision calls it
  (`codec.md_device`, `codec.encoder`): each call's inputs and its rows,
  for the check of the keyframe's device analysis;
* `device.inter.inter_analysis_sharded` as the mode decision calls it
  (`codec.md_device`): the inputs and rows of a sample of the inter
  frames' analyses, drawn from the seed (the window's first always);
* `codec.md_device.DeviceIntraMD.plan_frame`, the partition DP of every
  frame (inter frames' included, by inheritance): the J lattices and
  lambdas it read and the split decisions it took;
* the encoder's stage clock (program.watch_stages, switched on by
  SVT_TPU_TIMING=1): each stage's span on the host's clock.

A sampled launch keeps `rows` rows picked by the seed: a gather on the
device into tensors of the harness, so that nothing waits for the
device inside the window. `fault` plants a fault in the kernels'
outputs; only the harness's own tests set it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

FAULTS = ("unchanged", "half_batch", "altered")


@dataclass
class Sampling:
    launch_p: float = 0.25     # share of launches sampled
    rows: int = 1024           # rows (blocks, superblocks) kept a launch
    max_bytes: int = 1 << 30   # per kernel


INTER_P = 0.15     # share of the inter analyses after the first kept
INTER_MAX = 6      # inter analyses kept a run


@dataclass
class Probes:
    seed: int
    fullloop: Sampling = field(default_factory=Sampling)
    sad: Sampling = field(default_factory=lambda: Sampling(0.5, 8))
    fault: str | None = None
    recording: bool = False
    launches: dict = field(default_factory=lambda: {"fullloop": [],
                                                    "sad": []})
    samples: dict = field(default_factory=lambda: {"fullloop": [],
                                                   "sad": []})
    analyses: list = field(default_factory=list)
    inter: list = field(default_factory=list)
    plans: list = field(default_factory=list)
    spans: list = field(default_factory=list)   # (stage, t0, t1)

    def __post_init__(self):
        if self.fault is not None and self.fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}")
        self._rng = np.random.default_rng([int(self.seed), 0x5A17])
        self._bytes = {"fullloop": 0, "sad": 0}
        self._undo: list = []

    # ---- install / remove ------------------------------------------------
    def install(self) -> "Probes":
        from svt_av1_psyex_tpu_torch.codec import encoder as enc_mod
        from svt_av1_psyex_tpu_torch.codec import md_device
        from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as fl_mod
        from svt_av1_psyex_tpu_torch.ops.cuda import sad as sad_mod

        self._patch(fl_mod, "fullloop", self._wrap_fullloop(fl_mod.fullloop))
        self._patch(sad_mod, "sad_lattice", self._wrap_sad(sad_mod.sad_lattice))
        for mod in (md_device, enc_mod):
            self._patch(mod, "intra_analysis_sharded",
                        self._wrap_intra(mod.intra_analysis_sharded))
        self._patch(md_device, "inter_analysis_sharded",
                    self._wrap_inter(md_device.inter_analysis_sharded))
        self._patch(md_device.DeviceIntraMD, "plan_frame",
                    self._wrap_plan(md_device.DeviceIntraMD.plan_frame))
        return self

    def _patch(self, mod, name: str, fn) -> None:
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def remove(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo.clear()

    def on_span(self, key: str, t0: float, t1: float) -> None:
        """The stage clock's span callback (program.watch_stages)."""
        if self.recording:
            self.spans.append((key, t0, t1))

    # ---- sampling ----------------------------------------------------------
    def _take(self, kernel: str, n: int, device) -> torch.Tensor | None:
        """Row indices to keep of a launch of n rows, or None: evenly
        spaced from a phase drawn from the seed, made on the launch's
        device (a host-made index would be a copy that waits for the
        device)."""
        cfg = getattr(self, kernel)
        if (not self.recording or n == 0
                or self._bytes[kernel] >= cfg.max_bytes
                or self._rng.random() >= cfg.launch_p):
            return None
        k = min(cfg.rows, n)
        stride = n // k
        start = int(self._rng.integers(0, stride + n % k))
        return torch.arange(k, device=device) * stride + start

    def _keep(self, kernel: str, rec: dict) -> None:
        self._bytes[kernel] += sum(v.numel() * v.element_size()
                                   for v in rec.values()
                                   if isinstance(v, torch.Tensor))
        self.samples[kernel].append(rec)

    # ---- wrappers ----------------------------------------------------------
    def _wrap_fullloop(self, orig):
        def fullloop(resid, qp6, n, log_scale, want_inv=False):
            metrics, inv = orig(resid, qp6, n, log_scale, want_inv)
            if self.fault is not None:
                metrics, inv = self._plant(metrics, inv)
            b = resid.shape[0]
            if self.recording:
                self.launches["fullloop"].append(
                    (b, n, bool(want_inv), resid.element_size()))
            idx = self._take("fullloop", b, resid.device)
            if idx is not None:
                rec = {"resid": resid.index_select(0, idx),
                       "metrics": metrics.index_select(0, idx),
                       "qp6": [float(v) for v in qp6], "n": n,
                       "log_scale": int(log_scale)}
                if inv is not None:
                    rec["inv"] = inv.index_select(0, idx)
                self._keep("fullloop", rec)
            return metrics, inv

        return fullloop

    def _wrap_sad(self, orig):
        def sad_lattice(tiles, wins):
            out = orig(tiles, wins)
            if self.fault is not None:
                out, _ = self._plant(out, None)
            nsb = tiles.shape[0]
            if self.recording:
                self.launches["sad"].append((nsb,))
            idx = self._take("sad", nsb, tiles.device)
            if idx is not None:
                self._keep("sad", {"tiles": tiles.index_select(0, idx),
                                   "wins": wins.index_select(0, idx),
                                   "out": out.index_select(0, idx)})
            return out

        return sad_lattice

    def _wrap_intra(self, orig):
        def intra_analysis_sharded(lumas, qp_rows, rd_rows, mesh,
                                   depths=(64, 32, 16, 8), bit_depth=8,
                                   psy=False, kernels="hand"):
            rows = orig(lumas, qp_rows, rd_rows, mesh, depths=depths,
                        bit_depth=bit_depth, psy=psy, kernels=kernels)
            if self.recording:
                self.analyses.append({
                    "lumas": np.array(lumas), "qp_rows": np.array(qp_rows),
                    "rd_rows": np.array(rd_rows), "depths": tuple(depths),
                    "bit_depth": int(bit_depth), "psy": bool(psy),
                    "rows": rows})
            return rows

        return intra_analysis_sharded

    def _wrap_inter(self, orig):
        def inter_analysis_sharded(src, refs, qp_row, rd_row, mesh,
                                   depths=(64, 32, 16, 8), bit_depth=8,
                                   psy=False, kernels="hand"):
            rows = orig(src, refs, qp_row, rd_row, mesh, depths=depths,
                        bit_depth=bit_depth, psy=psy, kernels=kernels)
            if self.recording and len(self.inter) < INTER_MAX and (
                    not self.inter or self._rng.random() < INTER_P):
                self.inter.append({
                    "src": np.array(src), "refs": np.array(refs),
                    "qp_row": np.array(qp_row), "rd_row": np.array(rd_row),
                    "depths": tuple(depths), "bit_depth": int(bit_depth),
                    "psy": bool(psy), "rows": rows})
            return rows

        return inter_analysis_sharded

    def _wrap_plan(self, orig):
        from svt_av1_psyex_tpu_torch.codec.constants import BLOCK_W, Partition

        def plan_frame(dmd, rdmult_sb):
            orig(dmd, rdmult_sb)
            if not self.recording:
                return
            if self.fault == "altered":      # one decision flipped
                top = max(dmd._split)
                dmd._split[top][0, 0] = not dmd._split[top][0, 0]
            none, split = int(Partition.NONE), int(Partition.SPLIT)
            self.plans.append({
                "j": {b: np.array(dmd.stats[b]["j"]) for b in dmd.DEPTHS},
                "rdmult_sb": np.array(rdmult_sb, np.int64),
                "costs": {b: (int(c[none]), int(c[split]))
                          for b, c in dmd.part_costs.items()},
                "h": dmd.mi_rows * 4, "w": dmd.mi_cols * 4,
                "hp": dmd._hp, "wp": dmd._wp, "depths": tuple(dmd.DEPTHS),
                "pmin": int(BLOCK_W[getattr(dmd.md, "min_bsize", 3)]),
                "split": {b: np.array(v) for b, v in dmd._split.items()}})

        return plan_frame

    # ---- faults (tests only) ----------------------------------------------
    def _plant(self, out, inv):
        if self.fault == "unchanged":        # the output left unwritten
            return torch.zeros_like(out), (None if inv is None
                                           else torch.zeros_like(inv))
        if self.fault == "half_batch":       # half computed, mean for rest
            out = out.clone()
            h = max(out.shape[0] // 2, 1)
            out[h:] = out[:h].to(torch.float32).mean(dim=0).to(out.dtype)
            return out, inv
        out = out.clone()                     # "altered": one answer
        out.view(-1)[0] += 1
        return out, inv
