"""Eager-finals A/B: speech end -> committed latency with endpoint
speculation.

The port's counterpart of the JAX package's ``tools/bench_eager.py``. The
VAD gate confirms a speech end only at the second consecutive silent
window, so a final's audio is buffered one 640 ms window before the
confirmation. With ``AppConfig.eager_finals`` the session launches the
final's decode at the first silent window and commits the (nearly)
finished result on confirmation: the decode overlaps the gate's own wait.

This bench A/Bs eager_finals on one warmed engine over the utterance cycle
(2.0 s speech / 2.56 s silence: every utterance ends) and the worst-case
drifting-phase cycle (2.0 / 1.5 s), EOS and pad suppressed (every final
decodes its whole 50 + 5 * duration budget). Speculation discarded on a
speech resume is priced by the worst-case cycle, whose phase drift gives
resumes. Committed latency runs from the gate's confirmation (the second
silent window) to committed_output, the anchor the server reports as
processing_delay; eager starts the decode one window earlier.
cancelled_slots counts engine slots freed mid-decode by discarded
speculation.

nano in bf16 on 32 long slots with ``SileroCostProbeVad``, warmed; each
leg a settle run, then 50 streams for 16 s (--quick: tiny f32, 4 streams,
6 s). Prints one JSON line; writes it to a file only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_eager [--quick] [--device cpu] [--out F]
"""

from __future__ import annotations

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.tools.loadtest import (
    bench_engine,
    bench_parser,
    emit,
    run_bench,
    run_load,
)

# (name, eager_finals, silence_s): the utterance cycle first, then the
# drifting-phase worst case, where resumes discard speculation
VARIANTS = (
    ("utterance_eager_off", False, 2.56),
    ("utterance_eager_on", True, 2.56),
    ("worstcase_eager_off", False, 1.5),
    ("worstcase_eager_on", True, 1.5),
)


async def leg(engine, name: str, eager: bool, silence_s: float, n_streams: int,
              seconds: float, realtime: bool = True) -> dict:
    """One variant on a fresh eager gate (the drifting-phase workload drives
    its confirmation EMA down by design: none of that leaks into the next
    leg): a settle run, then the measured run."""
    config = AppConfig()
    config.eager_finals = eager
    engine.eager_accept_ema = 1.0
    engine._eager_probe = 0
    engine._eager_pending.clear()
    await run_load(engine, config, n_streams, max(4.0, seconds / 2), realtime=realtime,
                   silence_s=silence_s)
    cancelled0 = engine.stats.get("cancelled_slots", 0)
    granted0 = engine.stats["eager_granted"]
    m = await run_load(engine, config, n_streams, seconds, realtime=realtime,
                       silence_s=silence_s)
    return {
        "variant": name,
        "eager_finals": eager,
        "silence_s": silence_s,
        "interim_p50_ms": m["interim_p50_ms"],
        "interim_p95_ms": m["interim_p95_ms"],
        "committed_count": m["committed_count"],
        "committed_p50_ms": m["committed_p50_ms"],
        "committed_p95_ms": m["committed_p95_ms"],
        "cancelled_slots": engine.stats.get("cancelled_slots", 0) - cancelled0,
        "eager_granted": engine.stats["eager_granted"] - granted0,
        "eager_accept_ema": round(engine.eager_accept_ema, 3),
        "errors": m["errors"],
    }


async def measure(engine, n_streams: int, seconds: float, realtime: bool = True,
                  variants=VARIANTS) -> dict:
    captured0 = engine.router.stats["captured_on_run"]
    results = [await leg(engine, *v, n_streams, seconds, realtime) for v in variants]
    return {
        "bench": "eager_finals",
        "streams": n_streams,
        "seconds_per_run": seconds,
        "note": "A/B of AppConfig.eager_finals on one warmed engine, EOS suppressed (finals "
                "decode their full 50 + 5 * duration budget). Committed latency runs from gate "
                "confirmation (second silent window) to committed_output; eager starts the "
                "decode one 640 ms window earlier. cancelled_slots: slots freed mid-decode by "
                "discarded speculation (speech resumed).",
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
                   lambda: measure(engine, n, seconds)), args.out)


if __name__ == "__main__":
    main()
