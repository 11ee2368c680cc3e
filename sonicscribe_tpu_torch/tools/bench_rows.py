"""The long pool's occupied-prefix decode programs against full rows.

The port's counterpart of the JAX package's ``tools/bench_rows.py``. The
long pool decodes its first `rows` slots when only those are active
(``engine/batcher.py``'s ``_decode_k_program(..., rows=)``, the rows
ladder 1 / 4 / 16), so a step reads rows x max_len of cache instead of the
whole pool's. This times the k = 8 program at rows {4, 8, 16, full} on the
long pool's shapes (S 33 rows, 32 slots and the trash row; MAX_LEN 2560;
MAX_NEW 200), each captured through ``GraphRouter`` on one bufs dict and
its replays timed with CUDA events, the slots past `rows` done (the
realistic occupancy for that rung).

Parity: on a state whose active slots are the smallest rung's, every
rung's program must give the same tokens and status on those slots, and
the rows past its prefix must come back untouched (K/V, lengths, tokens,
emitted rows, counts, done flags). Parity is asserted in float32: in bf16
another row count can pick another GEMM tiling, and tokens then part at
near-ties. The bf16 timing legs report their token match against full
rows (``token_match_vs_full``) without asserting it. One generation of
state lives at a time (the K/V pool is ~4.84 GB at nano in bf16).

    python -m sonicscribe_tpu_torch.tools.bench_rows [--quick] [--device cpu] [--out F]

--quick: tiny in float32 on a 5 x 256 pool, rows {2, 4, full}. Prints one
JSON line; writes it to a file only with --out.
"""

from __future__ import annotations

import numpy as np
import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.batcher import _decode_k_program
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.tools.bench_decode_parts import call_times_ms, captured
from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

S, MAX_LEN, MAX_NEW, K = 33, 2560, 200, 8
ROWS = (4, 8, 16, None)
N_ITERS = 6
QUICK = dict(S=5, MAX_LEN=256, MAX_NEW=32, rows=(2, 4, None), n_iters=2)
# what a program may write: the rows past its prefix must keep all of these
STATE = ("k", "v", "len", "tok", "out", "n", "done")


def fresh_state(cfg, S: int, max_len: int, max_new: int, dtype, device, seed: int) -> dict:
    """The long pool's bufs (``_decode_k_program``'s dict): K/V drawn normal
    x 0.02 on the device, lengths from 100 .. max_len - max_new - 2, tokens
    from 5 .. vocab - 2, one emitted token a slot, none done, zero bias,
    budget max_new (no slot finishes inside the bench)."""
    dec = cfg.decoder
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (dec.n_layers, S, max_len, dec.n_kv_heads, dec.head_dim)
    i32 = torch.int32

    def kv():
        return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(0.02)

    return {"k": kv(), "v": kv(),
            "len": torch.from_numpy(rng.integers(100, max_len - max_new - 1, (S,))).to(
                device, i32),
            "tok": torch.from_numpy(rng.integers(5, dec.vocab_size - 1, (S,))).to(device, i32),
            "out": torch.zeros((S, max_new), dtype=i32, device=device),
            "n": torch.ones((S,), dtype=i32, device=device),
            "done": torch.zeros((S,), dtype=torch.bool, device=device),
            "bias": torch.zeros((S, dec.vocab_size), dtype=torch.float32, device=device),
            "budget": torch.full((S,), max_new, dtype=i32, device=device),
            "status": torch.zeros((S,), dtype=i32, device=device)}


def past(name: str, bufs: dict, R: int) -> torch.Tensor:
    """The rows of a state buffer past the prefix of R slots (K/V: slots
    are their second axis)."""
    return bufs[name][:, R:] if name in ("k", "v") else bufs[name][R:]


def rows_program(params, cfg, k: int, rows):
    return lambda b: _decode_k_program(params, cfg, b, k, rows=rows)


def parity(params, cfg, device, S: int, max_len: int, max_new: int, k: int, rows_choices,
           seed: int = 0) -> dict:
    """Each rung's program once on a fresh state (seed `seed`) whose active
    slots are the smallest rung's: tokens and status on those slots equal to
    the first rung's, and the rows past each rung's prefix untouched.
    Raises on a difference. -> {rows label: "ok"}."""
    dtype = params["decoder"]["embed"].dtype
    low = rows_choices[0]
    golden, out = None, {}
    for rows in rows_choices:
        bufs = fresh_state(cfg, S, max_len, max_new, dtype, device, seed)
        bufs["done"][low:] = True
        R = S if rows is None else min(rows, S)
        before = {name: past(name, bufs, R).clone() for name in STATE}
        router = GraphRouter(device, warm_in_place=("k", "v"))
        key, program = ("parity", rows), rows_program(params, cfg, k, rows)
        # captured without its upload replay, which would step the state; the
        # capture's warm run writes K/V only where the replay writes before
        # it reads (a no-op on the CPU, where run calls the program)
        router.prepare(key, program, bufs, replay=False)
        router.run(key, program, bufs)
        got = (bufs["out"][:low].cpu(), bufs["status"][:low].cpu())
        label = "full" if rows is None else str(rows)
        for name in STATE:
            if not torch.equal(past(name, bufs, R), before[name]):
                raise AssertionError(f"rows {label}: {name} past the prefix changed")
        if golden is None:
            golden = got
        elif not (torch.equal(got[0], golden[0]) and torch.equal(got[1], golden[1])):
            raise AssertionError(f"rows {label}: tokens or status differ from rows {low}")
        out[label] = "ok"
        del bufs, before, router
    return out


def timing(params, cfg, device, S: int, max_len: int, max_new: int, k: int, rows_choices,
           n_iters: int, seed: int = 1) -> dict:
    """Each rung's k-step program on a fresh state (seed `seed`) with the
    slots past its prefix done: the capture seconds, then n_iters replays
    (each one's ms; the state chained from one to the next, as served), and
    its active slots' tokens beside the full program's."""
    dtype = params["decoder"]["embed"].dtype
    results, tokens = {}, {}
    for rows in rows_choices:
        bufs = fresh_state(cfg, S, max_len, max_new, dtype, device, seed)
        if rows is not None:
            bufs["done"][rows:] = True
        router = GraphRouter(device, warm_in_place=("k", "v"))
        call, capture_s = captured(router, ("timing", rows), rows_program(params, cfg, k, rows),
                                   bufs)
        times = call_times_ms(device, call, n_iters)
        label = "full" if rows is None else str(rows)
        tokens[label] = bufs["out"].cpu()
        results[label] = {"k8_program_ms_min": min(times),
                          "k8_program_ms_med": float(np.median(times)),
                          "ms_per_step_med": float(np.median(times)) / k,
                          "capture_s": capture_s, "active_slots": S if rows is None else rows}
        del bufs, router, call
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if "full" in tokens:
        for label, r in results.items():
            n = r["active_slots"]
            r["token_match_vs_full"] = float(
                (tokens[label][:n] == tokens["full"][:n]).float().mean())
    return results


def measure(params_f32, params, cfg, device, S: int = S, max_len: int = MAX_LEN,
            max_new: int = MAX_NEW, k: int = K, rows_choices=ROWS,
            n_iters: int = N_ITERS) -> dict:
    """Parity in float32 (params_f32), then the timing legs (params)."""
    device = resolve_device(device)
    checks = parity(params_f32, cfg, device, S, max_len, max_new, k, rows_choices)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    results = timing(params, cfg, device, S, max_len, max_new, k, rows_choices, n_iters)
    for label, ok in checks.items():
        results[label]["parity"] = ok
    return {"bench": "rows_decode", "pool_rows": S, "max_len": max_len, "k": k,
            "max_new": max_new, "parity_dtype": "float32",
            "timing_dtype": str(params["decoder"]["embed"].dtype).replace("torch.", ""),
            "results": results}


def main(argv=None) -> None:
    from sonicscribe_tpu_torch.models.config import nano, tiny
    from sonicscribe_tpu_torch.models.weights import init_random

    args = bench_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny() if args.quick else nano()
    params_f32 = init_random(cfg, 0, dtype=torch.float32, device=device)
    if args.quick:
        q = QUICK
        out = measure(params_f32, params_f32, cfg, device, q["S"], q["MAX_LEN"], q["MAX_NEW"],
                      K, q["rows"], q["n_iters"])
    else:
        params = init_random(cfg, 0, dtype=torch.bfloat16, device=device)
        out = measure(params_f32, params, cfg, device)
    emit({"model": "tiny" if args.quick else "nano", **device_fields(device), **out}, args.out)


if __name__ == "__main__":
    main()
