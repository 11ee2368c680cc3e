"""Interim-latency decomposition at 50 realtime streams.

The port's counterpart of the JAX package's ``tools/bench_interim.py``. It
splits the tentative (interim) latency under load with:

1. the short class's queue / run latency samples (``engine.stats``: queue
   = enqueue -> prefill dispatch, run = dispatch -> reap);
2. the per-tick phase timeline (``BatchedEngine.tick_trace``, as
   SONIC_TICK_TRACE=1 turns it on): ingest, VAD dispatch, admit + prefill
   dispatch, decode dispatch, the previous tick's resolve, and the gaps
   between busy ticks.

nano in bf16 on 32 long slots with ``SileroCostProbeVad`` (the Silero
network's cost, the energy gate's decisions), warmed; a settle run, then
50 streams for 16 s (--quick: tiny f32, 4 streams, 6 s). Prints one JSON
line; writes it to a file only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_interim [--quick] [--device cpu] [--out F]
"""

from __future__ import annotations

import numpy as np

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.tools.loadtest import (
    bench_engine,
    bench_parser,
    busy_ticks,
    class_latency,
    emit,
    pct,
    run_bench,
    run_load,
)

PHASES = ("ingest_ms", "vad_dispatch_ms", "admit_ms", "early_resolve_ms", "decode_dispatch_ms",
          "resolve_ms", "total_ms")


def tick_decomposition(ticks) -> dict:
    """Busy ticks' phase p50 / p95 / mean, the gaps between them (idle
    waits of a second or more dropped) and the short slots active a tick."""
    busy = busy_ticks(ticks)
    gaps = [(b["t"] - a["t"]) * 1e3 - a["total_ms"]
            for a, b in zip(busy, busy[1:]) if (b["t"] - a["t"]) < 1.0]
    phases = {}
    for key in PHASES:
        xs = [t[key] for t in busy]
        phases[key] = {"p50": pct(xs, 50, 2), "p95": pct(xs, 95, 2),
                       "mean": round(float(np.mean(xs)), 2) if xs else None}
    short_active = [dict(t["active"]).get("short", 0) for t in busy]
    return {
        "busy_ticks": len(busy),
        "early_resolve_ticks": sum(1 for t in busy if t["early"]),
        "tick_phases_ms": phases,
        "inter_tick_gap_ms": {"p50": pct(gaps, 50, 2), "p95": pct(gaps, 95, 2)},
        "short_active_per_busy_tick": {"p50": pct(short_active, 50, 2),
                                       "max": max(short_active, default=0)},
    }


async def measure(engine, config: AppConfig, n_streams: int, seconds: float,
                  realtime: bool = True) -> dict:
    """A settle run, then the measured run with the tick trace cleared ->
    the interim and committed percentiles, verify rounds, the short
    class's split and the tick decomposition."""
    await run_load(engine, config, n_streams, max(4.0, seconds / 2), realtime=realtime)
    engine.stats.pop("short_lat_ms", None)
    engine.stats.pop("long_lat_ms", None)
    engine.tick_trace.clear()
    v0 = engine.stats.get("verify_rounds", 0)
    captured0 = engine.router.stats["captured_on_run"]
    m = await run_load(engine, config, n_streams, seconds, realtime=realtime)
    short = class_latency(engine).get("short")
    return {
        "bench": "interim_decomposition",
        "streams": n_streams,
        "seconds": seconds,
        "interim_p50_ms": m["interim_p50_ms"],
        "interim_p95_ms": m["interim_p95_ms"],
        "committed_p50_ms": m["committed_p50_ms"],
        "errors": m["errors"],
        "verify_rounds": engine.stats.get("verify_rounds", 0) - v0,
        "captured_on_run": engine.router.stats["captured_on_run"] - captured0,
        "short_class": None if short is None else {
            k: short[k] for k in ("n", "queue_p50_ms", "queue_p95_ms", "run_p50_ms",
                                  "run_p95_ms")},
        **tick_decomposition(list(engine.tick_trace)),
    }


def make_engine(quick: bool, device):
    return bench_engine(quick, device, vad="probe", no_eos=False, no_pad=False, trace=True)


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    n, seconds = (4, 6.0) if args.quick else (50, 16.0)
    engine = make_engine(args.quick, args.device)
    emit(run_bench(engine, args.device, "tiny" if args.quick else "nano",
                   lambda: measure(engine, AppConfig(), n, seconds)), args.out)


if __name__ == "__main__":
    main()
