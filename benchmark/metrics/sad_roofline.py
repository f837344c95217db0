"""The sad_lattice kernel's share of its roofline over the traced window,
%: the bound of every launch in the window (harness/roofline.py) over
the kernel's device time (torch.profiler). None where the kernel did not
run or the trace holds no time for it."""

from benchmark.harness.roofline import sad_bound


def read(record):
    launches = record["launches"].get("sad") or []
    dev = record["kernel_s"].get("sad")
    if not launches or not dev:
        return None
    bound_ms = sum(sad_bound(nsb)["bound_ms"] for (nsb,) in launches)
    return bound_ms / (dev * 1e3) * 100.0
