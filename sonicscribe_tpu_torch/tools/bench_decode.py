"""The decode program at the serving bench's two pool shapes, captured and
eager.

The port's counterpart of the JAX package's ``tools/bench_decode.py``. The
JAX bench compares where its layer scan writes K/V (``readonly``,
``inscan``, ``inscan_unroll4``). The port has no layer scan: its step
writes each layer's K/V in place (``models/glm_asr.py:_decode_pools``), so
those legs have no counterpart here. What decides the port's step time
instead is how the host issues it: the batcher serves the k-step program
as one CUDA graph, and the same program run op by op pays a host launch
per kernel (~1,750 a nano step). So the legs are:

- ``graph``: ``engine/batcher.py``'s ``_decode_k_program`` at k = 16 over
  the pool, captured through ``GraphRouter`` and replayed, as served;
- ``eager``: the same program called op by op (deliberately eager: the
  host's launch cost is what it prices).

Their gap is the host's launch cost, which the graphs remove. Pools (the
JAX bench's, from ``bench.py``): ``pool50x896`` (50 slots x 896 positions,
the stream engine's short pool) and ``pool8x2560`` (8 x 2560, the file
engine's long pool), nano in bf16, slot lengths drawn from max_len/4 ..
max_len - k - 2, EOS suppressed so that no slot stops; each replay starts
k positions back (occupancy held steady). Keys:
``<pool>_<leg>_ms_per_step`` (total / (reps x k), CUDA events on the card)
and ``<pool>_<leg>_tok_per_s``, with rooflines (weights + KV at the drawn
lengths; ``tools/bench_hbm.rooflines``).

    python -m sonicscribe_tpu_torch.tools.bench_decode [--quick] [--device cpu] [--out F]

--quick: tiny in float32, 2 programs a leg. Prints one JSON line; writes it
to a file only with --out.
"""

from __future__ import annotations

import numpy as np
import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.batcher import _decode_k_program
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.tools import bench_hbm
from sonicscribe_tpu_torch.tools.bench_decode_parts import (
    bench_params,
    call_times_ms,
    captured,
    decoder_bytes,
    draw_caches,
    kv_bytes,
    ms_per_step,
)
from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

K = 16
REPS = 10
QUICK_REPS = 2
POOLS = (("pool50x896", 50, 896), ("pool8x2560", 8, 2560))
LEGS = ("graph", "eager")


def pool_bufs(cfg, slots: int, max_len: int, k: int, dtype, device, seed: int = 0) -> dict:
    """A pool's static buffers as the batcher lays them out (k, v, len, tok,
    out, n, done, bias, budget, status), every slot live: K/V drawn normal x
    0.02, lengths from max_len/4 .. max_len - k - 2, a budget no run
    reaches, EOS suppressed."""
    dec = cfg.decoder
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cache = draw_caches(cfg, slots, max_len, dtype, device, gen)
    i32 = torch.int32
    bias = torch.zeros((slots, dec.vocab_size), dtype=torch.float32, device=device)
    bias[:, cfg.eos_id] = -1e9
    return {"k": cache["k"], "v": cache["v"],
            "len": torch.from_numpy(rng.integers(max_len // 4, max_len - k - 1, slots)).to(
                device, i32),
            "tok": torch.from_numpy(rng.integers(0, dec.vocab_size, slots)).to(device, i32),
            "out": torch.zeros((slots, 256), dtype=i32, device=device),
            "n": torch.zeros((slots,), dtype=i32, device=device),
            "done": torch.zeros((slots,), dtype=torch.bool, device=device),
            "bias": bias,
            "budget": torch.full((slots,), 1 << 30, dtype=i32, device=device),
            "status": torch.zeros((slots,), dtype=i32, device=device)}


def measure_pool(params, cfg, device, label: str, slots: int, max_len: int, k: int = K,
                 reps: int = REPS, rate_gb_s: float | None = None) -> dict:
    """Each leg's ms per step and tokens/s on one pool, the graph's capture
    seconds, and the step's rooflines."""
    device = resolve_device(device)
    dtype = params["decoder"]["embed"].dtype
    bufs = pool_bufs(cfg, slots, max_len, k, dtype, device)
    # the mean step's KV read: positions <= len over the program's k steps
    positions = float((bufs["len"].long() + 1).sum()) + slots * (k - 1) / 2
    program = lambda b: _decode_k_program(params, cfg, b, k)  # noqa: E731

    def hold():  # each program starts k positions back
        bufs["len"].sub_(k)

    out = {}
    for leg in LEGS:
        if leg == "graph":
            router = GraphRouter(device, warm_in_place=("k", "v"))
            call, out[f"{label}_graph_capture_s"] = captured(router, (label, k), program, bufs)
        else:
            program(bufs)  # warm
            call = lambda: program(bufs)  # noqa: E731
        ms = ms_per_step(call_times_ms(device, call, reps, hold), k)
        out[f"{label}_{leg}_ms_per_step"] = ms
        out[f"{label}_{leg}_tok_per_s"] = slots / (ms / 1e3)
        hold()  # back to the drawn lengths for the next leg
    n_bytes = decoder_bytes(params) + kv_bytes(cfg, positions, bufs["k"].element_size())
    out.update({f"{label}_{key}": v
                for key, v in bench_hbm.rooflines("step", n_bytes, rate_gb_s).items()})
    return out


def measure(params, cfg, device, pools=POOLS, k: int = K, reps: int = REPS,
            rate_gb_s: float | None = None) -> dict:
    device = resolve_device(device)
    out = {"k_steps": k, "reps": reps, "hbm_gb_s": rate_gb_s,
           "timing": ("CUDA events; graph: GraphRouter replays, eager: op by op"
                      if device.type == "cuda" else "the host clock on the CPU")}
    for label, slots, max_len in pools:
        out.update(measure_pool(params, cfg, device, label, slots, max_len, k, reps, rate_gb_s))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    cfg, params = bench_params(args.quick, device)
    rate = bench_hbm.measured_rate(device)
    emit({"model": "tiny" if args.quick else "nano", **device_fields(device),
          **measure(params, cfg, device, reps=QUICK_REPS if args.quick else REPS,
                    rate_gb_s=rate)}, args.out)


if __name__ == "__main__":
    main()
