"""Realtime multi-stream load harness.

The port's counterpart of the JAX package's ``tools/loadtest.py``. It
simulates N concurrent realtime sessions in-process: each session gets its
own StreamSession (ring buffer + dynamic-threshold gate) fed 64 ms chunks
of synthetic speech/silence cycles at realtime pace, all multiplexed onto
the shared engine (the continuous batcher packs their VAD windows and
decodes).

It measures the north-star metrics: p50/p95 interim ("tentative")
latency, committed-result latency, and ingest health (whether sessions
keep up with the 64 ms cadence) at a given stream count.

Usage (on the card; ``--device cpu --model tiny-random`` on the CPU):
    python -m sonicscribe_tpu_torch.tools.loadtest --streams 50 --seconds 20 \
        --model nano-random

The module also holds what the serving benches (``tools/bench_*.py``,
built on run_load) share: the bench engine, the per-class latency split,
the card's identity and the two probes, and the one-line JSON output.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import time
from collections import deque

import numpy as np
import torch

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.serve.session import StreamSession

SR = 16000
CHUNK_SAMPLES = 1024
CHUNK_BYTES = 2048


def device_rtt_ms(device=None, n: int = 20):
    """p50 ms of one tiny op on the card followed by
    ``torch.cuda.synchronize()``: the fixed cost of one host wait on the
    device, which every dispatch-bound latency pays. Stands for the JAX
    package's ``tunnel_rtt_ms`` (a tiny dispatch plus fetch). None on the
    CPU: it is a device metric."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    x = torch.ones((8, 8), dtype=torch.float32, device=device)
    (x + 1.0).sum()
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add(1.0)
        torch.cuda.synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ts, 50))


def capture_probe_s(device=None):
    """Seconds to capture a fresh tiny CUDA graph through the port's
    GraphRouter (its eager warm run, then the recording), replay it once
    and read its output: the port's only compile-like cost on the serving
    path (a program key's first capture). A fresh shape each call, so that
    nothing cached serves it. Stands for the JAX package's
    ``compile_probe_s`` (one fresh compile plus first execution). None on
    the CPU."""
    from sonicscribe_tpu_torch.engine.exec_store import GraphRouter

    device = resolve_device(device)
    if device.type != "cuda":
        return None
    dim = int(3 + (time.perf_counter_ns() // 1000) % 97)
    bufs = {"x": torch.ones((dim, 5), dtype=torch.float32, device=device)}
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    entry = GraphRouter(device).prepare(
        ("probe", dim), lambda b: {"y": (b["x"] * 2.0).sum(dim=1)}, bufs)
    entry.outputs["y"].cpu()
    return time.perf_counter() - t0


def card_identity(device=None):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first line); None on the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else None


def make_stream_audio(
    total_s: float, seed: int, speech_s: float = 2.0, silence_s: float = 1.5
) -> bytes:
    """Speech/silence cycles, default 2.0 s speech / 1.5 s silence; the same
    bytes as the JAX package's make_stream_audio.

    On the default cycle: 1.5 s of silence fits TWO full 640 ms gate
    windows only at favorable phase, and the 3.5 s cycle is not a multiple
    of the window, so the phase drifts: segments often span several cycles
    (~16 s, 130-token finals). That makes the default the worst-case
    committed-latency workload. For utterance-realistic finals pass
    silence_s >= 2.56 (4 full windows: every utterance ends)."""
    rng = np.random.default_rng(seed)
    out = []
    t_done = 0.0
    while t_done < total_s:
        for kind, sec in (("speech", speech_s), ("silence", silence_s)):
            n = int(SR * sec)
            t = np.arange(n) / SR
            if kind == "speech":
                env = 0.5 * (1 + np.sin(2 * np.pi * (3 + seed % 3) * t))
                x = 0.25 * env * sum(
                    np.sin(2 * np.pi * f * t) for f in (210 + 10 * (seed % 7), 700, 1500, 2600)
                ) + 0.002 * rng.standard_normal(n)
            else:
                x = 0.0006 * rng.standard_normal(n)
            out.append(np.clip(x, -1, 1))
            t_done += sec
    pcm = (np.concatenate(out)[: int(SR * total_s)] * 32767).astype("<i2")
    return pcm.tobytes()


async def run_load(
    engine,
    config: AppConfig,
    n_streams: int,
    seconds: float,
    realtime: bool = True,
    speech_s: float = 2.0,
    silence_s: float = 1.5,
    samples: "list | None" = None,
) -> dict:
    """-> metrics dict (the JAX package's keys). `engine` must expose the
    async engine interface.

    `samples`, when given, collects per-result tuples
    ``(time.perf_counter(), kind, latency_s)`` with kind in
    {"interim", "committed"}: callers split latency percentiles by a
    concurrent event's wall-clock window (bench_mixed's file job).
    realtime False feeds the chunks as fast as the sessions take them, on a
    stream clock."""
    interim_lat: list[float] = []
    committed_lat: list[float] = []
    committed_count = 0
    errors = 0

    # in accelerated mode the sessions' >=1 s interim cadence must follow
    # STREAM time, not wall time, or interims never fire
    stream_now = [0.0]
    clock = time.monotonic if realtime else (lambda: stream_now[0])

    sessions = []
    for i in range(n_streams):
        async def send(msg, _i=i):
            nonlocal committed_count
            if msg["type"] == "tentative_output":
                interim_lat.append(msg["processing_delay"])
                if samples is not None:
                    samples.append((time.perf_counter(), "interim", msg["processing_delay"]))
            elif msg["type"] == "committed_output":
                committed_count += 1
                if msg.get("processing_delay") is not None:
                    committed_lat.append(msg["processing_delay"])
                    if samples is not None:
                        samples.append(
                            (time.perf_counter(), "committed", msg["processing_delay"]))

        sessions.append(StreamSession(f"load{i}", config, engine, send, clock=clock))

    audio = [
        make_stream_audio(seconds, seed=i, speech_s=speech_s, silence_s=silence_s)
        for i in range(n_streams)
    ]
    n_chunks = int(seconds * 1000 / config.audio_chunk_duration_ms)
    chunk_period = config.audio_chunk_duration_ms / 1000.0

    t_start = time.perf_counter()
    max_ingest_lag = 0.0
    for c in range(n_chunks):
        stream_now[0] = c * chunk_period
        target_t = t_start + c * chunk_period
        now = time.perf_counter()
        if realtime and target_t > now:
            await asyncio.sleep(target_t - now)
        elif realtime:
            max_ingest_lag = max(max_ingest_lag, now - target_t)
        off = c * CHUNK_BYTES
        for i, s in enumerate(sessions):
            frame = audio[i][off : off + CHUNK_BYTES]
            if len(frame) == CHUNK_BYTES:
                try:
                    await s.on_audio(frame)
                except Exception:
                    errors += 1
        if not realtime and (c + 1) % config.vad_process_window == 0:
            # accelerated mode: keep the stream clock coherent with gate
            # processing by draining all sessions' VAD queues per window
            await asyncio.gather(*[s.flush_vad() for s in sessions], return_exceptions=True)
    # drain: finalize open segments
    await asyncio.gather(*[s.flush() for s in sessions], return_exceptions=True)
    for s in sessions:
        await s.cleanup()
    wall = time.perf_counter() - t_start

    def pct_ms(xs, p):
        return round(float(np.percentile(xs, p)) * 1000, 1) if xs else None

    return {
        "streams": n_streams,
        "seconds": seconds,
        "wall_s": round(wall, 2),
        "realtime_factor": round(wall / seconds, 3),
        "max_ingest_lag_s": round(max_ingest_lag, 3),
        "interim_count": len(interim_lat),
        "interim_p50_ms": pct_ms(interim_lat, 50),
        "interim_p95_ms": pct_ms(interim_lat, 95),
        "committed_count": committed_count,
        "committed_p50_ms": pct_ms(committed_lat, 50),
        "committed_p95_ms": pct_ms(committed_lat, 95),
        "errors": errors,
    }


async def settled_load(engine, config: AppConfig, n_streams: int, seconds: float,
                       realtime: bool = True, settle_s=None, **kw) -> dict:
    """run_load after a settle run (settle_s, default max(4, seconds / 2)
    s, without `samples`) that absorbs the scheduler's warm-in; the
    engine's per-class latency samples are cleared between the two."""
    settle_kw = {k: v for k, v in kw.items() if k != "samples"}
    await run_load(engine, config, n_streams, settle_s or max(4.0, seconds / 2),
                   realtime=realtime, **settle_kw)
    for eng in replicas(engine):
        eng.stats.pop("short_lat_ms", None)
        eng.stats.pop("long_lat_ms", None)
    return await run_load(engine, config, n_streams, seconds, realtime=realtime, **kw)


def replicas(engine) -> list:
    """The engines behind `engine`: a data-parallel router's replicas
    (engine/replicas.py), else the engine itself."""
    return list(getattr(engine, "replicas", None) or [engine])


def host_path_sessions(engine, n_streams: int) -> int:
    """How many of n_streams new sessions find no free ring row and take
    the host-audio path (stream_idx None): sessions claim rows in order."""
    if not getattr(engine, "has_ring", False):
        return n_streams
    free = sum(len(eng._free_streams) for eng in replicas(engine))
    return max(0, n_streams - free)


def captured_on_run(engine) -> int:
    """Graphs captured on a request's path so far, over every replica."""
    return sum((eng.router if getattr(eng, "has_ring", False) else eng.transcriber.router)
               .stats["captured_on_run"] for eng in replicas(engine))


# ---------------- what the serving benches share ----------------


def pct(xs, p, nd: int = 1):
    return round(float(np.percentile(xs, p)), nd) if len(xs) else None


def busy_ticks(ticks) -> list:
    """Traced ticks with work: a pool active or a VAD batch (idle wake-up
    ticks would drown the percentiles)."""
    return [t for t in ticks if t["n_vad"] or any(n for _, n in t["active"])]


def class_latency(engine) -> dict:
    """Pop the engine's per-class latency samples (queue: enqueue ->
    prefill dispatch; run: dispatch -> reap) -> {"short" | "long": {n,
    queue and run p50 / p95 ms, tokens_p50}} for the classes that ran."""
    out = {}
    for cls in ("short", "long"):
        lat: dict = {}
        for eng in replicas(engine):
            for k, v in (eng.stats.pop(cls + "_lat_ms", None) or {}).items():
                lat.setdefault(k, []).extend(v)
        if lat and lat["queue"]:
            out[cls] = {
                "n": len(lat["queue"]),
                "queue_p50_ms": pct(lat["queue"], 50),
                "queue_p95_ms": pct(lat["queue"], 95),
                "run_p50_ms": pct(lat["run"], 50),
                "run_p95_ms": pct(lat["run"], 95),
                "tokens_p50": pct(lat["tokens"], 50),
            }
    return out


def bench_parser(doc: str) -> argparse.ArgumentParser:
    """The serving benches' common flags: --quick (tiny f32, 4 streams, 6 s),
    --device (default the card), --out (the only file a bench writes)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny f32 at 4 streams and 6 s: a smoke of the bench's own code")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    return ap


def bench_engine(quick: bool, device, vad: str = "energy", slots=None,
                 max_decode_tokens: int = 200, n_streams: int = 64, buckets=(128, 512),
                 no_eos: bool = True, no_pad: bool = True, quant: str = "native",
                 trace: bool = False, **engine_kw):
    """The benches' BatchedEngine: nano in bf16 (quick: tiny in f32) with
    random weights from seed 0 on `device`; `slots` long slots (default
    32, quick 4); vad "energy" or "probe" (SileroCostProbeVad: the Silero
    network's device cost, the energy gate's decisions); EOS (and pad)
    suppressed through the base logit bias, so that every decode runs its
    budget; quant "native", "int8" or "int8-decoder" (build_runtime's
    modes of those names); trace: the tick trace on (as SONIC_TICK_TRACE=1
    sets it)."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.config import nano, tiny
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.models.weights import init_random
    from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
    from sonicscribe_tpu_torch.vad.model import EnergyVad, SileroCostProbeVad

    if quant not in ("native", "int8", "int8-decoder"):
        raise ValueError(f"quant {quant!r} is not native, int8 or int8-decoder")
    device = resolve_device(device)
    cfg = tiny() if quick else nano()
    params = init_random(cfg, 0, dtype=torch.float32 if quick else torch.bfloat16,
                         device=device)
    if quant != "native":
        params = quantize_params_int8(params, decoder_only=quant == "int8-decoder")
    bias = np.zeros((cfg.decoder.vocab_size,), np.float32)
    if no_eos:
        bias[cfg.eos_id] = -1e9
    if no_pad:
        bias[cfg.pad_id] = -1e9
    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=buckets)
    gate = SileroCostProbeVad(device=device) if vad == "probe" else EnergyVad(device=device)
    engine = BatchedEngine(tr, gate, slots=slots or (4 if quick else 32),
                           max_decode_tokens=max_decode_tokens, n_streams=n_streams,
                           base_logit_bias=bias, **engine_kw)
    if trace:
        engine.tick_trace = deque(maxlen=4096)
    return engine


def device_fields(device) -> dict:
    """The fields every bench's JSON holds about where it ran: the torch
    device type (``backend``), the card's nvidia-smi line and the two
    probes (None on the CPU)."""
    device = resolve_device(device)
    return {"backend": device.type, "card": card_identity(device),
            "device_rtt_ms": device_rtt_ms(device), "capture_probe_s": capture_probe_s(device)}


def run_bench(engine, device, model: str, legs) -> dict:
    """Warm the engine (timed), run the coroutine `legs()` on a new event
    loop, shut the engine down -> {"model", "warmup_s", device_fields,
    **the legs' result}."""
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    try:
        result = asyncio.run(legs())
    finally:
        engine.shutdown()
    return {"model": model, "warmup_s": warmup_s, **device_fields(device), **result}


def emit(result: dict, out: str = "") -> str:
    """Print the result as one JSON line; write it to `out` only when given."""
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description="realtime multi-stream load on the port")
    ap.add_argument("--streams", type=int, default=50)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--model", default="tiny-random")
    ap.add_argument("--vad", default="energy")
    ap.add_argument("--engine", default="batched")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-realtime", action="store_true",
                    help="feed chunks as fast as possible")
    args = ap.parse_args(argv)

    from sonicscribe_tpu_torch.serve.runtime import build_runtime

    config = AppConfig()
    engine, _vad, info = build_runtime(args.model, args.vad, config, device=args.device,
                                       engine_kind=args.engine)
    engine.warmup(budgets=(config.interim_max_new_tokens, config.final_max_tokens))
    batched = getattr(engine, "has_ring", False)
    captured0 = captured_on_run(engine)
    host_path = host_path_sessions(engine, args.streams)

    async def go():
        return await run_load(engine, config, args.streams, args.seconds,
                              realtime=not args.no_realtime)

    try:
        metrics = asyncio.run(go())
    finally:
        engine.shutdown()
    metrics["host_path_sessions"] = host_path
    metrics["captured_on_run"] = captured_on_run(engine) - captured0
    metrics["latency_by_class"] = class_latency(engine) if batched else {}
    metrics["model_info"] = info
    metrics.update(device_fields(args.device))
    emit(metrics)


if __name__ == "__main__":
    main()
