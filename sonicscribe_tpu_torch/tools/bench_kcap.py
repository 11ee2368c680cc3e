"""The live decode-k cap against 50-stream interim latency.

The port's counterpart of the JAX package's ``tools/bench_kcap.py``. The
scheduler dispatches k decode steps a tick; a request arriving mid-tick
waits for the whole program in flight, so the cap bounds queueing latency
at the cost of more status round trips. This sweeps ``live_k_cap`` (and
``pending_k_cap`` = min(16, cap)) on one warmed engine with the stream
engine of the headline bench: nano in bf16, 32 long slots, the energy gate,
EOS suppressed; per cap a settle run of 8 s, then 50 streams for 12 s
(--quick: tiny f32, 4 streams, 6 s). Prints one JSON line (each cap's
run_load metrics under ``caps``); writes it to a file only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_kcap [--caps 32,8,4] [--quick]
        [--device cpu] [--out F]
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


async def cap_leg(engine, config: AppConfig, cap: int, n_streams: int, seconds: float,
                  realtime: bool = True, settle_s: float = 8.0) -> dict:
    """One cap: a settle run, then the measured run -> its metrics."""
    engine.live_k_cap = cap
    engine.pending_k_cap = min(16, cap)
    await run_load(engine, config, n_streams, settle_s, realtime=realtime)
    return {"live_k_cap": cap,
            **await run_load(engine, config, n_streams, seconds, realtime=realtime)}


async def measure(engine, caps, n_streams: int, seconds: float, realtime: bool = True,
                  settle_s: float = 8.0) -> dict:
    config = AppConfig()
    captured0 = engine.router.stats["captured_on_run"]
    legs = [await cap_leg(engine, config, c, n_streams, seconds, realtime, settle_s)
            for c in caps]
    return {"bench": "kcap", "streams": n_streams, "seconds": seconds,
            "captured_on_run": engine.router.stats["captured_on_run"] - captured0,
            "caps": legs}


def make_engine(quick: bool, device, slots=None):
    return bench_engine(quick, device, slots=slots, no_pad=False)


def main(argv=None) -> None:
    ap = bench_parser(__doc__)
    ap.add_argument("--caps", default="32,8,4")
    ap.add_argument("--slots", type=int, default=None, help="long slots (default 32; quick 4)")
    args = ap.parse_args(argv)
    n, seconds = (4, 6.0) if args.quick else (50, 12.0)
    caps = [int(c) for c in args.caps.split(",")]
    engine = make_engine(args.quick, args.device, args.slots)
    emit(run_bench(engine, args.device, "tiny" if args.quick else "nano",
                   lambda: measure(engine, caps, n, seconds)), args.out)


if __name__ == "__main__":
    main()
