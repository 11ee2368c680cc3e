"""NN-VAD serving cost: the 50-stream realtime load with the Silero network
in the batcher's ring VAD path.

The port's counterpart of the JAX package's ``tools/bench_nn_vad.py``. No
Silero checkpoint is in the repo, and a random-init Silero net's
probabilities would destroy the harness's segmentation, so the VAD is
``SileroCostProbeVad``: it runs the whole Silero v5 forward (its device
cost) and returns the energy gate's decisions. The latency measured
therefore includes the network's compute as a converted checkpoint would
incur it.

nano in bf16 on 32 long slots, EOS suppressed, warmed; a settle run of 8 s,
then the measured run (50 streams, 12 s; --quick: tiny f32, 4 streams, 6 s).
Prints one JSON line; writes it to a file only with --out.

    python -m sonicscribe_tpu_torch.tools.bench_nn_vad [--quick] [--device cpu] [--out F]
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


async def measure(engine, config: AppConfig, n_streams: int, seconds: float,
                  realtime: bool = True, settle_s: float = 8.0) -> dict:
    """A settle run, then the measured one -> the JAX artifact's fields and
    the graphs captured on the measured run's path."""
    await run_load(engine, config, n_streams, settle_s, realtime=realtime)
    captured0 = engine.router.stats["captured_on_run"]
    m = await run_load(engine, config, n_streams, seconds, realtime=realtime)
    return {
        "vad": "silero-v5-cost-probe",
        "streams": n_streams,
        "seconds": seconds,
        "stream_interim_p50_ms": m["interim_p50_ms"],
        "stream_interim_p95_ms": m["interim_p95_ms"],
        "stream_committed": m["committed_count"],
        "stream_committed_p50_ms": m["committed_p50_ms"],
        "stream_ingest_lag_s": m["max_ingest_lag_s"],
        "stream_errors": m["errors"],
        "captured_on_run": engine.router.stats["captured_on_run"] - captured0,
    }


def make_engine(quick: bool, device):
    return bench_engine(quick, device, vad="probe", no_pad=False)


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    n, seconds = (4, 6.0) if args.quick else (50, 12.0)
    engine = make_engine(args.quick, args.device)
    emit(run_bench(engine, args.device, "tiny" if args.quick else "nano",
                   lambda: measure(engine, AppConfig(), n, seconds)), args.out)


if __name__ == "__main__":
    main()
