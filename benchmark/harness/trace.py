"""The traced run's reading of the device: what ran on the card and when.

`torch.profiler` records the device's kernels, copies and sets over the
window (CUDA activity only: a host-op trace of a host-bound encoder
would cost more than it tells). Its timestamps are on the wall clock in
nanoseconds; the harness's own clock is `time.perf_counter`, so the
window's start is taken on both and the stage clock's spans are moved
onto the profiler's clock by that offset (accurate to well under a
millisecond, against idle gaps of tens of milliseconds and more).
"""

from __future__ import annotations

from collections import defaultdict


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device activity in the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def merge(intervals: list, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of [start, end) intervals clipped to [lo, hi)."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                   if e > lo and s < hi)
    out: list = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(events: list, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merge(events, lo, hi))


def kernel_ns(events: list, name: str, lo: int, hi: int) -> int:
    """Device time of the kernels whose name holds `name`."""
    return sum(min(e, hi) - max(s, lo) for n, s, e in events
               if name in n and e > lo and s < hi)


def top_ops(events: list, lo: int, hi: int, k: int = 10) -> list:
    """The k device operations that took most time, by name (cut to its
    first 120 characters: a template's arguments follow)."""
    tot: dict = defaultdict(int)
    for n, s, e in events:
        if e > lo and s < hi:
            tot[n[:120]] += min(e, hi) - max(s, lo)
    return [[n, v / 1e9] for n, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_by_stage(events: list, spans: list, lo: int, hi: int,
                  k: int = 10) -> list:
    """The device's idle time in [lo, hi), split by the host stage whose
    span covers it (spans: (stage, start_ns, end_ns) on the profiler's
    clock); idle time under no span is "untimed" (the API's glue, the
    harness). The k largest, in seconds."""
    busy = merge(events, lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    tot: dict = defaultdict(int)
    spans = sorted(spans, key=lambda x: x[1])
    for g0, g1 in gaps:
        covered = 0
        for name, s, e in spans:
            if e <= g0:
                continue
            if s >= g1:
                break
            d = min(e, g1) - max(s, g0)
            if d > 0:
                tot[name] += d
                covered += d
        tot["untimed"] += max(0, (g1 - g0) - covered)
    return [[n, v / 1e9] for n, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k] if v > 0]
