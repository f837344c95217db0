"""Runs one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It encodes the cell's clip (made from the
seed) through the port's SvtAv1Encoder, measures for `--seconds`, checks
what the timed path produced against the plain reference, and prints
the result as one JSON line, the last line of its standard output. With
--trace 0 the line holds the cell's end-to-end metrics, with --trace 1
its per-layer metrics and the device's busy time. The check's numbers,
each beside its limit, are the last lines on standard error and the
last key of the result. It exits non-zero, and prints no result, where
there is no card or fewer than the cell asks for, where the program is
absent, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from benchmark.harness.isolation import forbidden_modules
    from benchmark.harness.manifest import load_cell, pin_host_threads

    cell = load_cell(args.workload)
    threads = pin_host_threads(cell)
    import torch

    torch.set_num_threads(threads)

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    import svt_av1_psyex_tpu_torch  # noqa: F401  (absent: exits here)
    from benchmark.harness.runner import frame_types, run_cell

    limit = card_limit()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    tl = out["timeline"]
    print(f"card: {limit}; host: {os.cpu_count()} cores, "
          f"{len(os.sched_getaffinity(0))} ours, {torch.get_num_threads()} "
          f"torch threads; {cell.name} seed {args.seed}: {tl.frames} frames "
          f"coded in {tl.window_s:.3f} s (window {args.seconds} s), first "
          f"packet {tl.first_packet_s()} s; coded "
          f"(pts, frame type): {frame_types(tl)}; quality frames "
          f"{[(p, n) for p, n, _ in tl.quality]}, mse_y8 "
          f"{tl.mse}", file=sys.stderr)
    if args.trace:
        rec = out["record"]
        if not rec["busy_s"]:
            print("benchmark: the profiler recorded no device time",
                  file=sys.stderr)
            return 5
        print(f"trace: stages {rec['stages']}; kernel seconds "
              f"{rec['kernel_s']}; launches "
              f"{ {k: len(v) for k, v in rec['launches'].items()} }",
              file=sys.stderr)
    for line in out["lines"]:
        print(line, file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
