"""Speculative-finals A/B: committed-output latency with and without the
draft-verify path, on the same warmed engine.

The port's counterpart of the JAX package's ``tools/bench_spec.py``. The
session banks its interim tokens and hands them to the final's decode as a
draft; the batched engine verifies them w at a time per read of the
weights (``models/glm_asr.py:verify_step``, ``engine/batcher.py``'s verify
program), losslessly. This bench prices the flag
(``AppConfig.speculative_finals``) at 50 realtime streams under both
workloads:

- worst case: drifting-phase speech/silence cycles -> ~16 s segments,
  ~130-token finals with EOS suppressed (every final runs its budget);
- utterance: 2.0 s speech / 2.56 s silence -> every utterance ends,
  ~70-token finals.

Random weights make interims no draft of their finals, so the session
workloads price the path as shipped at whatever the interim/final
agreement is. Two sections measure the mechanism directly through the
engine API: the ceiling (a batch of long-pool finals decoded plain, then
again with their own greedy tokens as drafts: acceptance limited only by
near-tie argmax flips between the decode and verify programs in bf16),
and the middle (drafts that are the greedy tokens with the tail corrupted
from 25 / 50 / 75 %, three batches each from a fresh acceptance EMA: the
EMA's trajectory, and the launch gate closing below spec_accept_min).
Tokens must equal the plain ones in float32 (--quick); in bf16 a count of
mismatching finals is recorded (near-tie flips).

nano in bf16 on 32 long slots with ``SileroCostProbeVad``, EOS and pad
suppressed, warmed; each session leg a settle run, then 50 streams for
16 s; 16 finals of 13 s at 130 tokens (--quick: tiny f32, 4 streams, 6 s;
4 finals of 2 s at 24 tokens). Prints one JSON line; writes it to a file
only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_spec [--quick] [--device cpu] [--out F]
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
    emit,
    run_bench,
    settled_load,
)

WORKLOADS = (("worst_case", 1.5), ("utterance", 2.56))
FRACTIONS = (0.25, 0.5, 0.75)
SR = 16000


async def session_leg(engine, spec: bool, wl_name: str, silence_s: float, n_streams: int,
                      seconds: float, realtime: bool = True) -> dict:
    """One session workload with speculative finals on or off: a settle run,
    then the measured run."""
    config = AppConfig()
    config.speculative_finals = spec
    v0 = engine.stats.get("verify_rounds", 0)
    m = await settled_load(engine, config, n_streams, seconds, realtime=realtime,
                           silence_s=silence_s)
    return {
        "variant": f"{wl_name}_{'spec' if spec else 'plain'}",
        "speculative_finals": spec,
        "silence_s": silence_s,
        "interim_p50_ms": m["interim_p50_ms"],
        "interim_p95_ms": m["interim_p95_ms"],
        "committed_count": m["committed_count"],
        "committed_p50_ms": m["committed_p50_ms"],
        "committed_p95_ms": m["committed_p95_ms"],
        "errors": m["errors"],
        # settle run included, as in the JAX bench
        "verify_rounds": engine.stats.get("verify_rounds", 0) - v0,
        "decomposition": class_latency(engine),
    }


def final_segments(quick: bool) -> list:
    """The finals of the ceiling and agreement sections: tones with noise,
    from seed 0."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(4 if quick else 16):
        t = np.arange(int(SR * (2.0 if quick else 13.0))) / SR
        x = 0.25 * np.sin(2 * np.pi * (220 + 15 * i) * t) + 0.002 * rng.standard_normal(len(t))
        out.append(x.astype(np.float32))
    return out


async def run_batch(engine, segments, budget: int, drafts=None):
    """-> (each final's tokens, the batch's wall seconds)."""
    t0 = time.perf_counter()
    rs = await asyncio.gather(*[
        engine.transcribe(a, SR, max_new_tokens=budget,
                          draft_tokens=(drafts[i] if drafts else None))
        for i, a in enumerate(segments)])
    return [r.tokens for r in rs], time.perf_counter() - t0


def mismatches(want, got) -> int:
    return sum(0 if len(a) == len(b) and all(int(x) == int(y) for x, y in zip(a, b)) else 1
               for a, b in zip(want, got))


def corrupt(toks, frac: float, cfg) -> np.ndarray:
    """The tokens with every one from round(len * frac) (at least 1) on
    replaced by another id (never EOS or pad)."""
    toks = np.asarray(toks, np.int32).copy()
    V = cfg.decoder.vocab_size
    keep = max(1, int(round(len(toks) * frac)))
    for i in range(keep, len(toks)):
        bad = int(toks[i])
        while True:
            bad = (bad + 1) % V
            if bad not in (cfg.eos_id, cfg.pad_id) and bad != int(toks[i]):
                break
        toks[i] = bad
    return toks


async def ceiling_leg(engine, segments, budget: int) -> tuple[dict, list, float]:
    """The batch plain (twice: the second warmed), then with its own greedy
    tokens as drafts -> (entry, the greedy tokens, the plain wall)."""
    engine.spec_accept_ema = 1.0
    await run_batch(engine, segments, budget)
    golden, t_plain = await run_batch(engine, segments, budget)
    vr0 = engine.stats.get("verify_rounds", 0)
    spec, t_spec = await run_batch(engine, segments, budget, golden)
    return {
        "variant": "ceiling_golden_drafts",
        "n_finals": len(segments),
        "tokens_per_final": budget,
        "plain_s": round(t_plain, 3),
        "spec_s": round(t_spec, 3),
        "speedup": round(t_plain / max(t_spec, 1e-9), 3),
        "verify_rounds": engine.stats.get("verify_rounds", 0) - vr0,
        "accept_ema_after": round(engine.spec_accept_ema, 3),
        "token_mismatches": mismatches(golden, spec),
    }, golden, t_plain


async def agreement_leg(engine, segments, budget: int, golden, t_plain: float, frac: float,
                        cfg) -> dict:
    """Tail-corrupted golden drafts at `frac`: three batches from a fresh
    acceptance EMA -> walls, the EMA's trajectory, verify rounds, and the
    finals whose tokens differ from the plain ones."""
    engine.spec_accept_ema = 1.0
    drafts = [corrupt(t, frac, cfg) for t in golden]
    traj, times, mismatch = [], [], 0
    vr0 = engine.stats.get("verify_rounds", 0)
    for _ in range(3):
        toks, t_run = await run_batch(engine, segments, budget, drafts)
        times.append(round(t_run, 3))
        traj.append(round(engine.spec_accept_ema, 3))
        mismatch += mismatches(golden, toks)
    return {
        "variant": f"agreement_{int(frac * 100)}",
        "target_acceptance": frac,
        "n_finals": len(segments),
        "tokens_per_final": budget,
        "plain_s": round(t_plain, 3),
        "runs_s": times,
        "best_speedup_vs_plain": round(t_plain / max(min(times), 1e-9), 3),
        "accept_ema_trajectory": traj,
        "gate_floor": engine.spec_accept_min,
        "gated_off_at_end": engine.spec_accept_ema < engine.spec_accept_min,
        "verify_rounds": engine.stats.get("verify_rounds", 0) - vr0,
        "token_mismatches": mismatch,
    }


async def measure(engine, quick: bool, n_streams: int, seconds: float,
                  realtime: bool = True, specs=(False, True), workloads=WORKLOADS,
                  fractions=FRACTIONS) -> dict:
    captured0 = engine.router.stats["captured_on_run"]
    results = []
    for spec in specs:
        if spec:
            engine.spec_accept_ema = 1.0  # a fresh gate for the ON legs
        for wl_name, silence_s in workloads:
            results.append(await session_leg(engine, spec, wl_name, silence_s, n_streams,
                                             seconds, realtime))
    segments, budget = final_segments(quick), 24 if quick else 130
    entry, golden, t_plain = await ceiling_leg(engine, segments, budget)
    results.append(entry)
    for frac in fractions:
        results.append(await agreement_leg(engine, segments, budget, golden, t_plain, frac,
                                           engine.cfg))
    bad = [r for r in results if r.get("token_mismatches")]
    if quick and bad:
        raise RuntimeError(f"float32 speculative decoding must be exact: {bad}")
    return {
        "bench": "spec_finals",
        "streams": n_streams,
        "seconds_per_run": seconds,
        "note": "A/B of AppConfig.speculative_finals on one warmed engine. worst_case: "
                "drifting-phase cycles, ~130-token finals, EOS suppressed; utterance: every "
                "2 s utterance ends (~70-token finals). Random weights make interims no draft "
                "of their finals; the ceiling and agreement_25/50/75 legs measure the "
                "mechanism with golden and tail-corrupted golden drafts. token_mismatches "
                "counts finals whose tokens differ from the plain decode (0 in float32; in "
                "bf16 near-tie argmax flips between the decode and verify programs).",
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
                   lambda: measure(engine, args.quick, n, seconds)), args.out)


if __name__ == "__main__":
    main()
