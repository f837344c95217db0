"""One run of one cell: set-up, the measured window, the check.

`run_cell` is the whole run that benchmark/run.py makes on the card,
and that the harness's tests make on the CPU at a small size. It
returns the result line's fields (without the device's name, which
run.py adds) and the check's lines.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field

import torch

from . import check, obu, program
from .frames import FrameSource
from .manifest import Cell, metric_reader
from .probes import Probes
from .window import TU, Timeline


class _Stop(Exception):
    """Raised from the packet hook once the window is closed and the
    quality frames are coded: it leaves the encoder mid-GOP."""


@dataclass
class Run:
    timeline: Timeline
    probes: Probes
    tus: list = field(default_factory=list)       # per encoder: (pts, bytes)
    stage_open: dict = field(default_factory=dict)
    stage_close: dict = field(default_factory=dict)
    t_open: float = 0.0
    wall_open_ns: int = 0
    prof: object = None


def run_window(cell: Cell, api, frames: FrameSource, seconds: float,
               probes: Probes, device, trace: bool) -> Run:
    """Feeds chunks of frames until the window is closed and the quality
    frames are coded. Chunk k's encoder after the first is made inside
    the window, as a chunked pipeline makes it."""
    chunk = int(cell.traffic["chunk_frames"])
    run = Run(Timeline(seconds, int(cell.traffic["quality_frames"])), probes)
    state = {"seq": None, "api": api, "base": 0}

    def on_packet(pkt):
        t = time.perf_counter() - run.t_open
        info = obu.parse_tu(pkt.data, state["seq"])
        if info.sequence is not None:
            state["seq"] = info.sequence
        coded = info.coded
        ftype = info.frames[0].frame_type if info.frames else None
        run.tus[-1].append((pkt.pts, pkt.data))
        tl = run.timeline
        if coded and tl.wants_quality():
            tl.add_quality(state["base"] + pkt.pts, len(pkt.data),
                           program.recon_y(state["api"]))
        if tl.add(TU(t, state["base"] + pkt.pts, len(pkt.data), coded,
                     ftype)):
            _close(run, state["api"], device, trace)
        if tl.done:
            raise _Stop

    try:
        for k in range(frames.span // chunk):
            if k:
                state["api"] = program.make_encoder(cell.settings, device)
            enc_api = state["api"]
            state["seq"], state["base"] = None, k * chunk
            program.stamp_packets(enc_api, on_packet)
            program.watch_stages(enc_api, probes.on_span)
            run.tus.append([])
            if k == 0:
                _open(run, api, trace)
            for t in range(chunk):
                enc_api.send_picture(frames.frame(k * chunk + t), t)
            enc_api.send_picture(None)
        raise RuntimeError(f"the window did not close in {frames.span} "
                           "frames")
    except _Stop:
        pass
    return run


def _open(run: Run, api, trace: bool) -> None:
    if trace:
        from torch.profiler import ProfilerActivity, profile

        run.prof = profile(activities=[ProfilerActivity.CUDA])
        run.prof.start()
    run.stage_open = program.stage_clock(api)
    run.probes.recording = True
    run.wall_open_ns = time.time_ns()
    run.t_open = time.perf_counter()


def _close(run: Run, api, device, trace: bool) -> None:
    run.probes.recording = False
    run.stage_close = program.stage_clock(api)
    if trace:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        run.prof.stop()


def stage_seconds(run: Run) -> dict:
    return {k: v - run.stage_open.get(k, 0.0)
            for k, v in run.stage_close.items()
            if v - run.stage_open.get(k, 0.0) > 0}


def traced_record(run: Run, frames: int) -> dict:
    """What the per-layer readers read: the stage clock over the window,
    the kernels' launches, and the device trace."""
    from . import trace as tr

    tl = run.timeline
    rec = {"frames": frames, "window_s": tl.window_s,
           "stages": stage_seconds(run),
           "launches": run.probes.launches, "kernel_s": {}, "busy_s": None,
           "device_ops": [], "idle_gaps": []}
    if run.prof is None:
        return rec
    ev = tr.device_events(run.prof)
    lo = run.wall_open_ns
    hi = lo + int(tl.window_s * 1e9)
    if ev:
        off = run.wall_open_ns - int(run.t_open * 1e9)
        spans = [(n, int(a * 1e9) + off, int(b * 1e9) + off)
                 for n, a, b in run.probes.spans]
        rec["busy_s"] = tr.busy_ns(ev, lo, hi) / 1e9
        rec["kernel_s"] = {k: tr.kernel_ns(ev, f"{k}_kernel", lo, hi) / 1e9
                           for k in ("fullloop", "sad")}
        rec["device_ops"] = tr.top_ops(ev, lo, hi)
        rec["idle_gaps"] = tr.idle_by_stage(ev, spans, lo, hi)
    return rec


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, probes: Probes | None = None,
             control: bool = False) -> dict:
    """One run. Returns {"correct", "attempted", "failed", "metrics",
    "memory_peak_bytes", "setup_s", "checks", "lines", "numbers",
    "timeline"}, with --trace 1 also "busy_s", "window_s", "breakdown"
    and "record"; with `control`, the control's numbers ("control",
    never computed by a benchmark run)."""
    dev = torch.device(device)
    if trace:
        os.environ["SVT_TPU_TIMING"] = "1"
    s = cell.settings
    w, h = int(s["source_width"]), int(s["source_height"])
    bd = int(s.get("encoder_bit_depth", 8))
    chunk = int(cell.traffic["chunk_frames"])
    # a window reaches the second chunk at most (none does today)
    frames = FrameSource(cell.traffic["kind"], w, h, bd, seed, dev,
                         span=2 * chunk,
                         params=cell.traffic.get("params"))
    frames.prepare(chunk)
    api = program.make_encoder(s, dev)
    program.warm(api)
    probes = probes or Probes(seed)
    probes.install()
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        run = run_window(cell, api, frames, seconds, probes, dev, trace)
    finally:
        probes.remove()
    tl = run.timeline
    n_frames = tl.frames
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    rec = traced_record(run, n_frames) if trace else None
    run.prof = None
    # the program's outputs, then its state freed before the reference
    rows = [a["rows"].numpy() for a in probes.analyses]
    inter_rows = [a["rows"].numpy()[0] for a in probes.inter]
    for a in probes.analyses + probes.inter:
        a["rows"] = None
    del api
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tl.measure_quality(lambda t: frames.frame(t)[0], bd)
    faults, what = check.stream_faults(run.tus, w, h, bd)
    plans = check.dp_sample(probes.plans, seed)
    numbers, counts = check.program_numbers(probes, rows, inter_rows, plans,
                                            dev)
    numbers["stream_faults"] = faults
    ctrl = check.control_numbers(probes, plans, dev) if control else None
    inter_frames = any(tu.coded and tu.frame_type not in (None, 0, 2)
                       for tu in tl.tus[: tl.close + 1])
    correct, checks = check.judge(numbers, cell.limits, inter_frames)
    if not cell.limits:
        correct = False
    lines = [f"fullloop rows off, by what: {counts}; sampled launches "
             f"fullloop {len(probes.samples['fullloop'])}, sad "
             f"{len(probes.samples['sad'])}; keyframe analyses "
             f"{len(probes.analyses)}; inter analyses {len(probes.inter)}; "
             f"partition DPs {len(plans)} of {len(probes.plans)}"]
    lines += [f"stream: {x}" for x in what[:10]]
    if not cell.limits:
        lines.append(f"no limits for {cell.name}: "
                     + ", ".join(f"{k} {v}" for k, v in numbers.items()))
    # the numbers compared, each beside its limit, come last
    lines += [f"{k} {v['value']} (limit {v['limit']})"
              for k, v in checks.items()]
    out = {"correct": bool(correct), "attempted": n_frames,
           "failed": faults, "memory_peak_bytes": int(peak),
           "setup_s": setup_s, "checks": checks, "lines": lines,
           "numbers": numbers, "timeline": tl, "control": ctrl}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out.update(metrics=metrics, busy_s=rec["busy_s"],
                   window_s=rec["window_s"],
                   breakdown={"device_ops": rec["device_ops"],
                              "idle_gaps": rec["idle_gaps"]},
                   record=rec)
    else:
        values = {"fps": tl.fps(), "first_packet_s": tl.first_packet_s(),
                  "kbit_per_frame": tl.kbit_per_frame(),
                  "mse_y8": tl.mse_y8(), "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    return out


def frame_types(tl: Timeline) -> list:
    """(pts, frame type) of the coded TUs through the window's close."""
    return [(tu.pts, tu.frame_type) for tu in tl.tus[: tl.close + 1]
            if tu.coded]
