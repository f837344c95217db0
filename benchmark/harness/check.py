"""The comparison that decides `correct`.

Each number is read from what the timed path produced in the window
(the probes' samples, the keyframe analyses, the TUs) against the plain
reference under benchmark/reference/, which imports nothing of the
program and recomputes each answer from the same inputs:

* fullloop_off: the share of sampled fullloop rows (blocks) that
  disagree with the reference: another eob or rate, a distortion, sse or
  inverse residual off by more than 1e-4 of the reference's magnitude,
  or a nonzero unused column. Float32 in another summation order moves
  a coefficient across a quantizer boundary now and then; TF32 moves
  many.
* sad_off: the share of sampled sad_lattice sums that differ. The sums
  are integers: the limit is 0.
* intra_off: the share of the keyframe analysis' blocks (every depth)
  whose mode differs or whose J is off by more than 1e-4 of the
  reference's.
* inter_off: the same over a sample of the inter frames' analyses (the
  window's first and more drawn from the seed), with the motion search
  in the reference too: a block is off where its candidate or any of
  its MVs differs, or its J is off by more than 1e-4.
* dp_off: the share of the partition DP's split decisions (every block
  of every depth but the smallest) that differ from the reference's DP
  over the same J lattices and lambdas, on up to DP_FRAMES frames of the
  window drawn from the seed. Integer sums: the limit is 0.
* stream_faults: TUs that do not parse, a sequence header that is not
  the configuration's format (size, bit depth, 4:2:0), a TU that codes
  or shows other than one frame, and shown frames out of display order.
  Counted over every TU the run received: the limit is 0.

A number whose layer did not run in the window reads None and is not
compared: a kernel taken off the path, or the inter analysis in a
window that coded no inter frame; the keyframe's analysis, the DP and
the stream are always there. The check follows the program from its own
state where a stage reads another's output: the kernels' inputs are
the program's residuals, and the DP reads the program's J lattices,
which intra_off and inter_off check against the reference's on their
own. The control puts the reference, computed one precision
below the configuration's, in the program's place: `control_numbers`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import fullloop as ref_fullloop
from ..reference import inter as ref_inter
from ..reference import intra as ref_intra
from ..reference import partition as ref_partition
from ..reference import sad as ref_sad
from . import obu

REL = 1e-4          # what "off" means for a float answer, of its magnitude
DP_FRAMES = 8       # frames whose partition DP is recomputed a run
KERNELS = ("fullloop_off", "sad_off")

# -- fullloop ----------------------------------------------------------------


def fullloop_reference(samples: list, device, precision: str = "fp32"):
    """The reference's (metrics, inv) for each sampled launch."""
    out = []
    for s in samples:
        m, inv = ref_fullloop.fullloop(
            s["resid"].to(device), s["qp6"], s["n"], s["log_scale"],
            want_inv="inv" in s, precision=precision)
        out.append((m, inv))
    return out


def fullloop_off_rows(got, ref) -> dict:
    """Rows of one launch (got/ref = (metrics, inv)) off by each
    criterion, and in all ("off") of "rows"."""
    (m, inv), (mr, invr) = got, ref
    m, mr = m.to(mr.device).double(), mr.double()
    crit = {"eob": m[:, 2] != mr[:, 2], "rate": m[:, 1] != mr[:, 1]}
    for name, col in (("dist", 0), ("sse", 3)):
        crit[name] = (m[:, col] - mr[:, col]).abs() \
            > REL * mr[:, col].abs().clamp_min(1.0)
    crit["unused"] = (m[:, 4:] != 0).any(dim=1)
    if invr is not None:
        inv = inv.to(invr.device).double()
        invr = invr.double()
        gap = (inv - invr).abs().flatten(1).amax(dim=1)
        mag = invr.abs().flatten(1).amax(dim=1).clamp_min(1.0)
        crit["inv"] = gap > REL * mag
    off = torch.zeros_like(crit["eob"])
    for v in crit.values():
        off |= v
    out = {k: int(v.sum()) for k, v in crit.items()}
    out.update(off=int(off.sum()), rows=int(off.numel()))
    return out


def fullloop_counts(got: list, ref: list) -> dict:
    """Rows off by each criterion over every sampled launch."""
    tot: dict = {}
    for g, r in zip(got, ref):
        for k, v in fullloop_off_rows(g, r).items():
            tot[k] = tot.get(k, 0) + v
    return tot


def fullloop_off(got: list, ref: list) -> float | None:
    c = fullloop_counts(got, ref)
    return c["off"] / c["rows"] if c.get("rows") else None


# -- sad ---------------------------------------------------------------------


def sad_reference(samples: list, device, precision: str = "int32"):
    return [ref_sad.sad_lattice(s["tiles"].to(device), s["wins"].to(device),
                                precision) for s in samples]


def sad_off(got: list, ref: list) -> float | None:
    n_off = n = 0
    for g, r in zip(got, ref):
        n_off += int((g.to(r.device) != r).sum())
        n += r.numel()
    return n_off / n if n else None


# -- the keyframe analysis ---------------------------------------------------


def intra_reference(analyses: list, device, precision: str = "fp32"):
    return [ref_intra.intra_analysis(a["lumas"], a["qp_rows"], a["rd_rows"],
                                     a["depths"], a["bit_depth"], a["psy"],
                                     device, precision) for a in analyses]


def intra_off(analyses: list, got: list, ref: list) -> float | None:
    """Share of blocks off, over every depth of every analysis. got/ref:
    (F, P) packed rows (J then mode, per depth)."""
    n_off = n = 0
    for a, g, r in zip(analyses, got, ref):
        f, hp, wp = a["lumas"].shape
        pos = 0
        for blk in a["depths"]:
            k = (hp // blk) * (wp // blk)
            j, jr = g[:, pos: pos + k], r[:, pos: pos + k]
            md, mr = g[:, pos + k: pos + 2 * k], r[:, pos + k: pos + 2 * k]
            pos += 2 * k
            off = (md != mr) | (np.abs(j.astype(np.float64) - jr)
                                > REL * np.maximum(np.abs(jr), 1.0))
            n_off += int(off.sum())
            n += off.size
        if pos != g.shape[1]:
            raise ValueError("analysis rows do not match their depths")
    return n_off / n if n else None


# -- the inter analysis ------------------------------------------------------


def inter_reference(analyses: list, device, precision: str = "fp32"):
    return [ref_inter.inter_analysis(a["src"], a["refs"], a["qp_row"],
                                     a["rd_row"], a["depths"],
                                     a["bit_depth"], a["psy"], device,
                                     precision) for a in analyses]


def inter_off(analyses: list, got: list, ref: list) -> float | None:
    """Share of blocks off over every depth of every sampled analysis.
    got/ref: packed rows, per depth (j, cand, mv_y, mv_x, mv_y1,
    mv_x1)."""
    n_off = n = 0
    for a, g, r in zip(analyses, got, ref):
        hp, wp = a["src"].shape
        pos = 0
        for blk in a["depths"]:
            k = (hp // blk) * (wp // blk)
            f = [(g[pos + i * k: pos + (i + 1) * k],
                  r[pos + i * k: pos + (i + 1) * k]) for i in range(6)]
            pos += 6 * k
            (j, jr) = f[0]
            off = np.abs(j.astype(np.float64) - jr) \
                > REL * np.maximum(np.abs(jr), 1.0)
            for x, xr in f[1:]:
                off |= x != xr
            n_off += int(off.sum())
            n += off.size
        if pos != g.size:
            raise ValueError("inter rows do not match their depths")
    return n_off / n if n else None


# -- the partition DP ----------------------------------------------------------


def dp_sample(plans: list, seed: int) -> list:
    """Up to DP_FRAMES of the recorded frames, drawn from the seed."""
    if len(plans) <= DP_FRAMES:
        return plans
    rng = np.random.default_rng([int(seed), 0xD9])
    pick = sorted(rng.choice(len(plans), DP_FRAMES, replace=False))
    return [plans[i] for i in pick]


def dp_off(plans: list, ref: list) -> float | None:
    """Share of split decisions that differ. plans: the program's records
    (their "split" grids); ref: the reference's grids."""
    n_off = n = 0
    for p, r in zip(plans, ref):
        for blk, got in p["split"].items():
            n_off += int((np.asarray(got, bool) != r[blk]).sum())
            n += got.size
    return n_off / n if n else None


def dp_reference(plans: list, precision: str = "int64") -> list:
    return [ref_partition.decide(p, precision) for p in plans]


# -- the stream --------------------------------------------------------------


def stream_faults(tus: list, width: int, height: int,
                  bit_depth: int) -> tuple[int, list]:
    """(faults, what) over the TUs of each encoder in order: `tus` is a
    list of per-encoder lists of (pts, bytes)."""
    faults, what = 0, []
    for chunk in tus:
        seq, shown = None, []
        for i, (pts, data) in enumerate(chunk):
            try:
                info = obu.parse_tu(data, seq)
            except obu.StreamError as e:
                faults += 1
                what.append(f"TU {i}: {e}")
                continue
            if info.sequence is not None:
                seq = info.sequence
                fmt = (seq.width, seq.height, seq.bit_depth,
                       seq.subsampling_x, seq.subsampling_y, seq.mono_chrome)
                if fmt != (width, height, bit_depth, 1, 1, False):
                    faults += 1
                    what.append(f"TU {i}: sequence header {fmt}")
            if len(info.frames) != 1 or info.shown > 1:
                faults += 1
                what.append(f"TU {i}: {len(info.frames)} frame headers, "
                            f"{info.shown} shown")
            if info.shown:
                shown.append(pts)
        if shown != list(range(len(shown))):
            faults += 1
            what.append(f"shown frames in order {shown[:20]}")
    return faults, what


# -- all numbers ---------------------------------------------------------------


def program_numbers(probes, rows: list, inter_rows: list, plans: list,
                    device) -> tuple[dict, dict]:
    """The numbers of the program against the reference, and the
    fullloop rows off by each criterion. rows / inter_rows: the fetched
    rows of probes.analyses / probes.inter; plans: the DP frames to
    check (dp_sample)."""
    fl = probes.samples["fullloop"]
    sd = probes.samples["sad"]
    counts = fullloop_counts([(s["metrics"], s.get("inv")) for s in fl],
                             fullloop_reference(fl, device))
    return {
        "fullloop_off": (counts["off"] / counts["rows"]
                         if counts.get("rows") else None),
        "sad_off": sad_off([s["out"] for s in sd], sad_reference(sd, device)),
        "intra_off": intra_off(probes.analyses, rows,
                               intra_reference(probes.analyses, device)),
        "inter_off": inter_off(probes.inter, inter_rows,
                               inter_reference(probes.inter, device)),
        "dp_off": dp_off(plans, dp_reference(plans)),
    }, counts


def control_numbers(probes, plans: list, device) -> dict:
    """The same numbers with the reference one precision lower (TF32 for
    the float32 analyses, bfloat16 sums for the integer SAD, float32
    sums for the integer DP) in the program's place."""
    fl = probes.samples["fullloop"]
    sd = probes.samples["sad"]
    ref_dp = dp_reference(plans)
    low = [{"split": s} for s in dp_reference(plans, "fp32")]
    low16 = [{"split": s} for s in dp_reference(plans, "bf16")]
    return {
        "fullloop_off": fullloop_off(
            fullloop_reference(fl, device, "tf32"),
            fullloop_reference(fl, device)),
        "sad_off": sad_off(sad_reference(sd, device, "bf16"),
                           sad_reference(sd, device)),
        "intra_off": intra_off(
            probes.analyses,
            intra_reference(probes.analyses, device, "tf32"),
            intra_reference(probes.analyses, device)),
        "inter_off": inter_off(
            probes.inter, inter_reference(probes.inter, device, "tf32"),
            inter_reference(probes.inter, device)),
        "dp_off": dp_off(low, ref_dp),
        "dp_off_bf16": dp_off(low16, ref_dp),
        "dp_j_max": max((float(np.max(v)) for p in plans
                         for v in p["j"].values()), default=None),
    }


def judge(numbers: dict, limits: dict,
          inter_frames: bool = True) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}). Every number in `limits`
    must read at most its limit; a kernel number may read None (its
    kernel did not run), inter_off where the window coded no inter
    frame, the others never."""
    optional = KERNELS + (() if inter_frames else ("inter_off",))
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        limit = lim["limit"]
        out[name] = {"value": v, "limit": limit}
        if v is None:
            ok &= name in optional
        else:
            ok &= v <= limit
    return ok, out

