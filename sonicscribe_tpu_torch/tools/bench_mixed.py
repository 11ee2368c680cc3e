"""Mixed workload: realtime streams beside a concurrent file job.

The port's counterpart of the JAX package's ``tools/bench_mixed.py``. N
realtime sessions (short-pool interims) run while the server transcribes
an uploaded file (12 long-pool segments of 5.12 s, 256 tokens each,
started 4 s into the streams). The legs sweep the two per-tick caps on
long work:

- ``busy_long_admit_cap``: file prefill groups admitted a tick while the
  short class is busy;
- ``long_live_k_cap``: long decode steps a tick while realtime sessions are
  live.

Interim latency is split into the file job's wall-clock window and outside
it (run_load's `samples`): a whole-window percentile dilutes the
during-file regime. Each leg keeps the tick trace and reports its phase
and admit split (prep / write / dispatch, groups a pool) in and out of the
file window.

The JAX bench has a third leg variable, ``fuse_slot_writes`` (one fused
program for the admitted slots' state, or one write a field). The port has
no such choice: its prefill graphs write the budget and draft rows of the
admitted slots themselves (``engine/batcher.py:_slot_write_program``,
called inside ``_prefill_common``), which is the fused form. The twin has
no ``nofuse`` leg. The legs share one warmed engine (the caps are read a
tick at a time); each starts from fresh eager and speculation gates.
``--int8dec`` adds a leg on a second engine with int8-decoder weights.

nano in bf16 on 32 long slots, the energy gate, EOS and pad suppressed;
each leg one settle run of the whole workload, then the measured one (50
streams for 16 s; --quick: tiny f32, 4 streams, 6 s, 3 segments of
1.28 s at 64 tokens). Prints one JSON line; writes it to a file only with
--out.

    python -m sonicscribe_tpu_torch.tools.bench_mixed [--int8dec] [--quick]
        [--device cpu] [--out F]
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.tools.loadtest import (
    bench_engine,
    bench_parser,
    busy_ticks,
    device_fields,
    emit,
    pct,
    run_load,
)

SR = 16000
# (tag, long_live_k_cap, busy_long_admit_cap)
VARIANTS = (("shipped", 8, 2), ("admit1", 8, 1), ("k4", 4, 2))


def file_segments(quick: bool) -> tuple[list, int, float]:
    """-> (the file job's segments: noise from seed 0, one stream bucket
    each; their bucket in frames; seconds a segment)."""
    bucket = 128 if quick else 512
    seg_seconds = bucket * 160 / SR
    rng = np.random.default_rng(0)
    segs = [(0.1 * rng.standard_normal(int(SR * seg_seconds))).astype(np.float32)
            for _ in range(3 if quick else 12)]
    return segs, bucket, seg_seconds


async def run_both(engine, config: AppConfig, segments, file_budget: int, n_streams: int,
                   window_s: float, realtime: bool, file_delay_s: float, samples=None,
                   span=None):
    """The streams and, file_delay_s after they start, the file job's
    segments all at once -> (run_load's metrics, the file job's wall)."""
    async def file_job():
        await asyncio.sleep(file_delay_s)
        t0 = time.perf_counter()
        rs = await asyncio.gather(*[engine.transcribe(s, SR, max_new_tokens=file_budget)
                                    for s in segments])
        t1 = time.perf_counter()
        if any(len(r.tokens) != file_budget for r in rs):
            raise RuntimeError(f"a file segment stopped short of {file_budget} tokens: "
                               f"{[len(r.tokens) for r in rs]}")
        if span is not None:
            span[:] = [t0, t1]
        return t1 - t0

    load = asyncio.ensure_future(run_load(engine, config, n_streams, window_s,
                                          realtime=realtime, samples=samples))
    file_task = asyncio.ensure_future(file_job())
    m = await load
    return m, await file_task


def window_split(ticks, span) -> dict:
    """Busy ticks in and out of the file window: tick total, admit and
    resolve p50 / p95 ms, the admit split's means and groups a pool."""
    t_f0, t_f1 = span
    busy = busy_ticks(ticks)
    out = {}
    for name, tset in (("in_file", [t for t in busy if t_f0 <= t["t"] <= t_f1]),
                       ("out_file", [t for t in busy if not t_f0 <= t["t"] <= t_f1])):
        if not tset:
            continue
        ad = [t["admit_detail"] for t in tset if t.get("admit_detail")]

        def mean(key):
            return round(float(np.mean([a[key] for a in ad])), 2) if ad else None

        out[name] = {
            "ticks": len(tset),
            "tick_total_ms": {"p50": pct([t["total_ms"] for t in tset], 50),
                              "p95": pct([t["total_ms"] for t in tset], 95)},
            "admit_ms": {"p50": pct([t["admit_ms"] for t in tset], 50),
                         "p95": pct([t["admit_ms"] for t in tset], 95)},
            "resolve_ms": {"p50": pct([t["resolve_ms"] for t in tset], 50),
                           "p95": pct([t["resolve_ms"] for t in tset], 95)},
            "admit_prep_ms_mean": mean("prep_ms"),
            "admit_write_ms_mean": mean("write_ms"),
            "admit_dispatch_ms_mean": mean("dispatch_ms"),
            "long_groups_total": sum(a["groups_long"] for a in ad),
            "short_groups_total": sum(a["groups_short"] for a in ad),
        }
    return out


async def leg(engine, config: AppConfig, tag: str, kcap: int, admit_cap: int, segments,
              file_budget: int, seg_seconds: float, n_streams: int, window_s: float,
              realtime: bool = True, file_delay_s: float = 4.0) -> dict:
    """One leg: its caps set, the gates fresh, a settle run of the whole
    workload, then the measured one -> its `tag`-prefixed fields."""
    engine.long_live_k_cap = kcap
    engine.busy_long_admit_cap = admit_cap
    engine.eager_accept_ema = engine.spec_accept_ema = 1.0
    engine._eager_probe = 0
    engine._eager_pending.clear()
    args = (engine, config, segments, file_budget, n_streams, window_s, realtime, file_delay_s)
    await run_both(*args)
    engine.tick_trace.clear()
    captured0 = engine.router.stats["captured_on_run"]
    samples, span = [], []
    m, file_s = await run_both(*args, samples=samples, span=span)
    t_f0, t_f1 = span

    def in_file(t, lat):
        return t_f0 <= t <= t_f1 + lat

    inside = [lat * 1e3 for t, kind, lat in samples if kind == "interim" and in_file(t, lat)]
    outside = [lat * 1e3 for t, kind, lat in samples
               if kind == "interim" and not in_file(t, lat)]
    return {
        f"{tag}_interim_p50_ms": m["interim_p50_ms"],
        f"{tag}_interim_p95_ms": m["interim_p95_ms"],
        f"{tag}_interim_p50_ms_in_file": pct(inside, 50),
        f"{tag}_interim_p95_ms_in_file": pct(inside, 95),
        f"{tag}_interim_p50_ms_out_file": pct(outside, 50),
        f"{tag}_interim_p95_ms_out_file": pct(outside, 95),
        f"{tag}_interim_n_in_file": len(inside),
        f"{tag}_committed": m["committed_count"],
        f"{tag}_committed_p50_ms": m["committed_p50_ms"],
        f"{tag}_ingest_lag_s": m["max_ingest_lag_s"],
        f"{tag}_errors": m["errors"],
        f"{tag}_captured_on_run": engine.router.stats["captured_on_run"] - captured0,
        f"{tag}_file_wall_s": round(file_s, 3),
        f"{tag}_file_rtf": round(file_s / (len(segments) * seg_seconds), 5),
        f"{tag}_tick_decomposition": window_split(list(engine.tick_trace), span),
    }


def make_engine(quick: bool, device, quant: str = "native"):
    _, bucket, _ = file_segments(quick)
    return bench_engine(quick, device, max_decode_tokens=64 if quick else 256,
                        buckets=(128, bucket), quant=quant, trace=True)


async def measure(engine, quick: bool, n_streams: int, window_s: float, realtime: bool = True,
                  variants=VARIANTS, file_delay_s: float = 4.0) -> dict:
    segments, _, seg_seconds = file_segments(quick)
    config = AppConfig()
    out = {}
    for tag, kcap, admit_cap in variants:
        out.update(await leg(engine, config, tag, kcap, admit_cap, segments,
                             64 if quick else 256, seg_seconds, n_streams, window_s, realtime,
                             file_delay_s))
    return out


def bench(quick: bool, device, n_streams: int, window_s: float, int8dec: bool = False,
          realtime: bool = True, variants=VARIANTS, file_delay_s: float = 4.0) -> dict:
    """The legs on a native engine (and with int8dec the int8dec leg on an
    int8-decoder one), each engine warmed first -> the bench's JSON."""
    segments, _, seg_seconds = file_segments(quick)
    results = {"model": "tiny" if quick else "nano", "streams": n_streams, "window_s": window_s,
               "file_segments": len(segments),
               "file_audio_seconds": round(len(segments) * seg_seconds, 2)}
    legs = [("native", variants)] + ([("int8-decoder", (("int8dec", 8, 2),))] if int8dec else [])
    for quant, leg_variants in legs:
        engine = make_engine(quick, device, quant)
        engine.warmup()
        try:
            results.update(asyncio.run(measure(engine, quick, n_streams, window_s, realtime,
                                               leg_variants, file_delay_s)))
        finally:
            engine.shutdown()
        del engine
    return {**results, **device_fields(device)}


def main(argv=None) -> None:
    ap = bench_parser(__doc__)
    ap.add_argument("--int8dec", action="store_true",
                    help="add a leg on int8-decoder weights (a second engine)")
    args = ap.parse_args(argv)
    n, window_s = (4, 6.0) if args.quick else (50, 16.0)
    emit(bench(args.quick, args.device, n, window_s, args.int8dec), args.out)


if __name__ == "__main__":
    main()
