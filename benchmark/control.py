"""The check's two readings for a cell: the program's numbers and the
control's, on several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is one full run of the cell (run_cell) at its own load; after
the window the run compares what the program produced with the
reference (the program's reading, whose largest over the seeds is the
lower reading of each limit) and the reference computed one precision
lower with the full-precision one (the control's reading, whose
smallest is the upper reading). One JSON line per seed. The benchmark's
own runs never compute the control. On the card only.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.manifest import load_cell, pin_host_threads

    cell = load_cell(args.workload)
    threads = pin_host_threads(cell)
    import torch

    from benchmark.harness.runner import run_cell

    torch.set_num_threads(threads)
    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, "cuda",
                       time.perf_counter(), control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "frames": out["attempted"],
                          "program": out["numbers"],
                          "control": out["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
