"""Stream counts against the stream cell's criteria, one engine, one process.

    python3 gpubench/tools/sweep.py --workload nano-bf16.streams --seed <n> --seconds <s> \
        --streams 32 48 64

Builds the cell's system once, then runs the cell's traffic at each stream
count in turn and prints one JSON line each: interim and commit p95 (the
harness's clock), the feed's lag, the sessions that found no ring row
(host path), and whether the count held (interim p95 <= 300 ms, no lag over
one chunk, no host-path session). The cell's load is set from this, once.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="nano-bf16.streams")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--streams", type=int, nargs="+", default=[32, 48, 64])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness, manifest, run, system
    from gpubench.stats import percentile

    run._cache_dirs()
    cell = manifest.cell(args.workload)
    engine, vad, conf, info = system.build(cell.config, cell.family(), args.seed, "cuda:0")
    kind = cell.traffic()
    try:
        for n in args.streams:
            c = copy.copy(cell)
            c.mix = dict(cell.mix, streams=n)
            window = harness.Window(c, args.seed, args.seconds, False, engine, vad, conf)
            out = asyncio.run(kind.run(window))
            s = out["samples"]
            row = {"streams": n, "interim_p95_ms": percentile(s["interim_ms"], 95),
                   "interims": len(s["interim_ms"]),
                   "commit_p95_ms": percentile(s["commit_ms"], 95),
                   "commits": len(s["commit_ms"]), "ingest_lag_s": s["ingest_lag_s"],
                   "host_path_sessions": s["host_path_sessions"], "failed": out["failed"],
                   "card": run.device_info(1)["card"], "warmup_s": info["warmup_s"],
                   "t": time.perf_counter()}
            row["held"] = bool(row["interim_p95_ms"] is not None
                               and row["interim_p95_ms"] <= 300 and s["ingest_lag_s"] <= 0.064
                               and s["host_path_sessions"] == 0 and out["failed"] == 0)
            print(json.dumps(row), flush=True)
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
