"""The fullloop kernel's share of its roofline over the traced window, %.

The least time an H100 SXM could take for every launch in the window
(harness/roofline.py, from each launch's shape as the probes recorded
it) over the kernel's device time in the window (torch.profiler). None
where the kernel did not run or the trace holds no time for it."""

from benchmark.harness.roofline import fullloop_bound


def read(record):
    launches = record["launches"].get("fullloop") or []
    dev = record["kernel_s"].get("fullloop")
    if not launches or not dev:
        return None
    bound_ms = sum(fullloop_bound(b, n, inv, nbytes)["bound_ms"]
                   for b, n, inv, nbytes in launches)
    return bound_ms / (dev * 1e3) * 100.0
