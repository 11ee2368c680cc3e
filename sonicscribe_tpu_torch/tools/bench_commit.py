"""Committed-output latency split, and an A/B of its two levers.

The port's counterpart of the JAX package's ``tools/bench_commit.py``.
Speech end -> committed_output is the second most visible latency of the
product. This bench:

1. splits the committed path with the engine's per-class latency samples
   (queue = speech-end enqueue -> prefill dispatch; run = prefill -> reap,
   which spans the decode ticks and the one-tick reap delay);
2. A/Bs the two levers on the same warmed engine:
   - ``idle_k``: the long pool's decode k cap while the short pool is idle
     (``long_idle_k_cap``; finals of synchronized speech/silence cycles
     decode in the silence, when no interims compete);
   - ``group_prefill``: final waves admitted through the B = 4 / 8 ring
     prefill programs, or one B = 1 program a final.
   Then the utterance workload (2.0 s speech / 2.56 s silence: every
   utterance ends) at k 32 with grouped prefill.

nano in bf16 on 32 long slots with ``SileroCostProbeVad``, EOS and pad
suppressed (every final decodes its whole 50 + 5 * duration budget),
warmed; each leg a settle run, then 50 streams for 16 s (--quick: tiny
f32, 4 streams, 6 s). Prints one JSON line; writes it to a file only with
--out.

    python -m sonicscribe_tpu_torch.tools.bench_commit [--quick] [--device cpu] [--out F]
"""

from __future__ import annotations

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.tools.loadtest import (
    bench_engine,
    bench_parser,
    class_latency,
    emit,
    run_bench,
    settled_load,
)

# (name, long_idle_k_cap, group_prefill)
VARIANTS = (
    ("baseline_r2", 8, False),  # a flat k cap of 8, B = 1 prefills
    ("combined_k16", 16, True),
    ("combined_k32", 32, True),
    ("combined_k64", 64, True),
)
UTTERANCE = ("utterance_workload_k32_group", 32, True)
UTTERANCE_SILENCE_S = 2.56


def set_variant(engine, idle_k: int, group_prefill: bool, ring_grid: set) -> None:
    """The long pool's idle k cap, and its ring prefill programs: the whole
    warmed grid, or only B = 1 (and the smallest chunk bucket's)."""
    smallest_cb = min(engine.chunk_buckets)
    engine.long_idle_k_cap = idle_k
    engine.long.compiled_ring_prefill = (
        set(ring_grid) if group_prefill
        else {t for t in ring_grid if t[2] == 1 or t[0] == smallest_cb})


async def leg(engine, config: AppConfig, name: str, idle_k: int, group_prefill: bool,
              ring_grid: set, n_streams: int, seconds: float, realtime: bool = True,
              silence_s: float = 1.5) -> dict:
    """One variant: a settle run, then the measured run -> its percentiles
    and the per-class split of the measured run."""
    set_variant(engine, idle_k, group_prefill, ring_grid)
    m = await settled_load(engine, config, n_streams, seconds, realtime=realtime,
                           silence_s=silence_s)
    return {
        "variant": name,
        "cycle": f"2.0 s speech / {silence_s} s silence",
        "long_idle_k_cap": idle_k,
        "group_prefill": group_prefill,
        "interim_p50_ms": m["interim_p50_ms"],
        "interim_p95_ms": m["interim_p95_ms"],
        "committed_count": m["committed_count"],
        "committed_p50_ms": m["committed_p50_ms"],
        "committed_p95_ms": m["committed_p95_ms"],
        "errors": m["errors"],
        "decomposition": class_latency(engine),
    }


async def measure(engine, config: AppConfig, n_streams: int, seconds: float,
                  realtime: bool = True, variants=VARIANTS, utterance: bool = True) -> dict:
    ring_grid = set(engine.long.compiled_ring_prefill)
    captured0 = engine.router.stats["captured_on_run"]
    results = [await leg(engine, config, *v, ring_grid, n_streams, seconds, realtime)
               for v in variants]
    if utterance:
        results.append(await leg(engine, config, *UTTERANCE, ring_grid, n_streams, seconds,
                                 realtime, silence_s=UTTERANCE_SILENCE_S))
    set_variant(engine, UTTERANCE[1], True, ring_grid)
    return {
        "bench": "commit_latency",
        "streams": n_streams,
        "seconds_per_run": seconds,
        "workload": "loadtest speech/silence cycles (2.0 s / 1.5 s), EOS suppressed (worst "
                    "case: finals decode their full 50 + 5 * duration budget)",
        "captured_on_run": engine.router.stats["captured_on_run"] - captured0,
        "variants": results,
    }


def make_engine(quick: bool, device):
    return bench_engine(quick, device, vad="probe")


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    n, seconds = (4, 6.0) if args.quick else (50, 16.0)
    engine = make_engine(args.quick, args.device)
    emit(run_bench(engine, args.device, "tiny" if args.quick else "nano",
                   lambda: measure(engine, AppConfig(), n, seconds)), args.out)


if __name__ == "__main__":
    main()
