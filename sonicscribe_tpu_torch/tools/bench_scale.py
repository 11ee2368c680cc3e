"""Scale bench: the long file and 100 realtime streams.

The port's counterpart of the JAX package's ``tools/bench_scale.py``. Two
workloads beyond the headline bench, and the capacity knee between them:

1. the long file's batched RTF: 24 x 20.48 s segments (an ~8 min file)
   decoded at once through the continuous batcher on a 24-slot pool,
   256 tokens each (EOS and pad suppressed), the better of two runs after
   a settle run, on an engine with one ring row (no stream runs here).
   Decode streams the weights once a step, so more segments in flight
   spread that read;
2. the capacity knee (``--skip-knee`` leaves it out): 60 / 75 / 90 / 100
   streams on int8-decoder weights (64 long slots, a ring of 128 streams,
   ``SileroCostProbeVad``), a settle run of 6 s and two back-to-back
   windows of 12 s each, with the long and short classes' queue / run
   split of each window; the largest N whose interim p50 stays under
   300 ms in both windows; then at 100 streams the oversubscribed k cap
   forced down to the live cap (``control_k8_100``: the cap's A/B);
   ``--remedy-slots`` adds 100 streams on a 96-slot pool;
3. 100 concurrent realtime streams (``--skip-streams`` leaves them out):
   bf16, int8 (``--skip-int8``) and int8-decoder (``--skip-int8-decoder``)
   weights, each on its own engine (64 long slots, a ring of 128 streams,
   ``SileroCostProbeVad``), a settle run of 8 s and two measured windows
   of 12 s; ``--stagger-ab`` adds each with interim staggering off. Every
   stream leg records how many sessions ran on the host path (no ring row
   free).

``--quick``: tiny f32 at 4 streams and 6 s windows (the knee at 2 and 4
streams, 4 file segments of 1.28 s at 32 tokens on 4 slots, rings of 8).
Prints one JSON line; writes it to a file only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_scale [--skip-file] [--skip-knee]
        [--skip-streams] [--quick] [--device cpu] [--out F]
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.tools.loadtest import (
    bench_engine,
    bench_parser,
    class_latency,
    device_fields,
    emit,
    host_path_sessions,
    run_load,
)

SR = 16000
FULL = dict(file_segments=24, file_bucket=2048, file_budget=256, knee=(60, 75, 90, 100),
            knee_settle_s=6.0, window_s=12.0, streams=100, stream_settle_s=8.0, slots=64,
            ring=128, remedy_slots=96)
QUICK = dict(file_segments=4, file_bucket=128, file_budget=32, knee=(2, 4), knee_settle_s=3.0,
             window_s=6.0, streams=4, stream_settle_s=3.0, slots=4, ring=8, remedy_slots=8)
KNEE_P50_MS = 300.0


async def file_leg(engine, segments, budget: int) -> float:
    """The segments at once: a settle run, then the better of two -> wall s."""
    async def batch():
        t0 = time.perf_counter()
        rs = await asyncio.gather(*[engine.transcribe(s, SR, max_new_tokens=budget)
                                    for s in segments])
        dt = time.perf_counter() - t0
        if any(len(r.tokens) != budget for r in rs):
            raise RuntimeError(f"a segment stopped short of {budget} tokens: "
                               f"{[len(r.tokens) for r in rs]}")
        return dt

    await batch()
    return min([await batch(), await batch()])


async def window(engine, config: AppConfig, n: int, seconds: float,
                 realtime: bool = True) -> dict:
    """One measured window -> run_load's metrics and the long and short
    classes' queue / run split accumulated during it."""
    engine.stats.pop("short_lat_ms", None)
    engine.stats.pop("long_lat_ms", None)
    m = await run_load(engine, config, n, seconds, realtime=realtime)
    for cls, split in class_latency(engine).items():
        m.update({f"{cls}_{k}": v for k, v in split.items() if k != "tokens_p50"})
    return m


async def knee_leg(engine, config: AppConfig, n: int, settle_s: float, window_s: float,
                   realtime: bool = True) -> dict:
    """A settle run at n streams, then two windows -> the knee row."""
    await run_load(engine, config, n, settle_s, realtime=realtime)
    w1 = await window(engine, config, n, window_s, realtime)
    w2 = await window(engine, config, n, window_s, realtime)
    return {
        "interim_p50_ms_windows": [w1["interim_p50_ms"], w2["interim_p50_ms"]],
        "interim_p95_ms_windows": [w1["interim_p95_ms"], w2["interim_p95_ms"]],
        "committed_p50_ms_windows": [w1["committed_p50_ms"], w2["committed_p50_ms"]],
        "committed_counts": [w1["committed_count"], w2["committed_count"]],
        "errors": w1["errors"] + w2["errors"],
        "ingest_lag_s": max(w1["max_ingest_lag_s"], w2["max_ingest_lag_s"]),
        "host_path_sessions": host_path_sessions(engine, n),
        "w2_long_queue_p50_ms": w2.get("long_queue_p50_ms"),
        "w2_long_queue_p95_ms": w2.get("long_queue_p95_ms"),
        "w2_long_run_p50_ms": w2.get("long_run_p50_ms"),
        "w2_long_run_p95_ms": w2.get("long_run_p95_ms"),
        "w1_long_queue_p50_ms": w1.get("long_queue_p50_ms"),
        "w1_long_run_p50_ms": w1.get("long_run_p50_ms"),
    }


async def stream_leg(engine, config: AppConfig, n: int, settle_s: float, window_s: float,
                     realtime: bool = True) -> dict:
    """A settle run, then two measured windows -> the better window's
    interim and committed numbers, both windows' interim percentiles."""
    host = host_path_sessions(engine, n)
    await run_load(engine, config, n, settle_s, realtime=realtime)
    runs = [await run_load(engine, config, n, window_s, realtime=realtime) for _ in range(2)]
    m = min(runs, key=lambda r: r["interim_p50_ms"] or float("inf"))
    return {
        "interim_p50_ms": m["interim_p50_ms"],
        "interim_p95_ms": m["interim_p95_ms"],
        "interim_p50_ms_runs": [r["interim_p50_ms"] for r in runs],
        "interim_p95_ms_runs": [r["interim_p95_ms"] for r in runs],
        "committed": m["committed_count"],
        "committed_p50_ms": m["committed_p50_ms"],
        "ingest_lag_s": m["max_ingest_lag_s"],
        "errors": sum(r["errors"] for r in runs),
        "host_path_sessions": host,
    }


def _warm(engine) -> float:
    t0 = time.perf_counter()
    engine.warmup()
    return time.perf_counter() - t0


def _run(engine, coro_fn):
    """Run coro_fn() on a new loop and shut the engine down after."""
    try:
        return asyncio.run(coro_fn())
    finally:
        engine.shutdown()


def file_section(quick: bool, device, size: dict) -> dict:
    seg_seconds = size["file_bucket"] * 160 / SR
    # one ring row: the file leg runs no stream, and a ring of 64 would make
    # warmup capture short-pool ring prefills of the 20.48 s bucket it never runs
    engine = bench_engine(quick, device, slots=size["file_segments"],
                          max_decode_tokens=size["file_budget"], n_streams=1,
                          buckets=(size["file_bucket"],), fuse_dual_decode=False)
    _warm(engine)
    rng = np.random.default_rng(0)
    segments = [(0.1 * rng.standard_normal(int(SR * seg_seconds))).astype(np.float32)
                for _ in range(size["file_segments"])]
    dt = _run(engine, lambda: file_leg(engine, segments, size["file_budget"]))
    audio_s = size["file_segments"] * seg_seconds
    return {"file_long_segments": size["file_segments"],
            "file_long_audio_seconds": round(audio_s, 2),
            "file_long_wall_s": round(dt, 4),
            "file_long_rtf": round(dt / audio_s, 6)}


async def control_leg(engine, config: AppConfig, n: int, size: dict,
                      realtime: bool = True) -> dict:
    """A settle run at n streams, then two windows -> their interim and
    committed p50s and the second window's long-class split."""
    await run_load(engine, config, n, size["knee_settle_s"], realtime=realtime)
    w1 = await window(engine, config, n, size["window_s"], realtime)
    w2 = await window(engine, config, n, size["window_s"], realtime)
    return {"streams": n,
            "interim_p50_ms_windows": [w1["interim_p50_ms"], w2["interim_p50_ms"]],
            "committed_p50_ms_windows": [w1["committed_p50_ms"], w2["committed_p50_ms"]],
            "w2_long_queue_p50_ms": w2.get("long_queue_p50_ms"),
            "w2_long_run_p50_ms": w2.get("long_run_p50_ms")}


def knee_section(quick: bool, device, size: dict, realtime: bool = True,
                 remedies: bool = True, remedy_slots: bool = False) -> dict:
    config = AppConfig()
    engine = bench_engine(quick, device, vad="probe", slots=size["slots"],
                          n_streams=size["ring"], quant="int8-decoder")
    out = {"knee_warmup_s": round(_warm(engine), 2),
           "knee_mode": f"int8-decoder, stagger on, slots={size['slots']}"}

    async def legs():
        knee = None
        for n in size["knee"]:
            row = out[f"knee_{n}"] = await knee_leg(engine, config, n, size["knee_settle_s"],
                                                    size["window_s"], realtime)
            if all(p is not None and p < KNEE_P50_MS for p in row["interim_p50_ms_windows"]):
                knee = n
        out["knee_max_n_p50_under_300_both_windows"] = knee
        if remedies:
            shipped = engine.long_oversub_k_cap
            engine.long_oversub_k_cap = engine.long_live_k_cap
            out["control_k8_100"] = await control_leg(engine, config, size["knee"][-1], size,
                                                      realtime)
            engine.long_oversub_k_cap = shipped

    _run(engine, legs)
    if remedy_slots:
        engine = bench_engine(quick, device, vad="probe", slots=size["remedy_slots"],
                              n_streams=size["ring"], quant="int8-decoder")
        _warm(engine)
        out["remedy_slots96_100"] = {"slots": size["remedy_slots"], **_run(
            engine, lambda: control_leg(engine, config, size["knee"][-1], size, realtime))}
    return out


def stream_section(quick: bool, device, size: dict, tags, realtime: bool = True) -> dict:
    """tags: (tag, quant mode, stagger) of each stream leg."""
    out = {}
    for tag, quant, stagger in tags:
        engine = bench_engine(quick, device, vad="probe", slots=size["slots"],
                              n_streams=size["ring"], quant=quant)
        engine.stagger_interims = stagger
        out[f"stream100{tag}_warmup_s"] = round(_warm(engine), 2)
        leg = _run(engine, lambda: stream_leg(engine, AppConfig(), size["streams"],
                                               size["stream_settle_s"], size["window_s"],
                                               realtime))
        out.update({f"stream100{tag}_{k}": v for k, v in leg.items()})
        del engine
    return out


def stream_tags(int8: bool = True, int8_decoder: bool = True, stagger_ab: bool = False):
    tags = [("", "native", True)]
    if stagger_ab:
        tags.append(("_nostagger", "native", False))
    if int8:
        tags.append(("_int8", "int8", True))
    if int8_decoder:
        tags.append(("_int8_decoder", "int8-decoder", True))
        if stagger_ab:
            tags.append(("_int8_decoder_nostagger", "int8-decoder", False))
    return tags


def bench(quick: bool, device, size: dict, file: bool = True, knee: bool = True,
          remedies: bool = True, remedy_slots: bool = False, streams: bool = True,
          tags=None, realtime: bool = True) -> dict:
    """The sections asked for at `size` (FULL or QUICK's keys) -> the
    bench's JSON."""
    results = {"model": "tiny" if quick else "nano", "streams": size["streams"]}
    if file:
        results.update(file_section(quick, device, size))
    if knee:
        results.update(knee_section(quick, device, size, realtime, remedies, remedy_slots))
    if streams:
        results.update(stream_section(quick, device, size, tags or stream_tags(), realtime))
    return {**results, **device_fields(device)}


def main(argv=None) -> None:
    ap = bench_parser(__doc__)
    for flag in ("--skip-file", "--skip-knee", "--skip-remedies", "--remedy-slots",
                 "--skip-streams", "--skip-int8", "--skip-int8-decoder", "--stagger-ab"):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    emit(bench(args.quick, args.device, QUICK if args.quick else FULL, file=not args.skip_file,
               knee=not args.skip_knee, remedies=not args.skip_remedies,
               remedy_slots=args.remedy_slots, streams=not args.skip_streams,
               tags=stream_tags(not args.skip_int8, not args.skip_int8_decoder,
                                args.stagger_ab)), args.out)


if __name__ == "__main__":
    main()
