"""Readings for the correctness limits of a cell: the program's and the control's.

    python3 gpubench/tools/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell once per seed in this process, as ``run.py`` does, and on the
same sample of served requests reads the widest gap of the program's
tokens and of the control's (the reference at the precision below the
configuration's: int8 weights under bf16, int4 under int8; see
``reference/check.py``). Prints one JSON line per seed. The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness, manifest, run

    run._cache_dirs()
    cell = manifest.cell(args.workload)
    t = T_PROCESS
    for seed in args.seeds:
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t,
                               run.device_info(cell.chips), control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": res["correct"],
                          "metrics": res["metrics"], "calibration": res["calibration"],
                          "checks": res["checks"], "device": res["device"]}), flush=True)
        t = time.perf_counter()


if __name__ == "__main__":
    main()
