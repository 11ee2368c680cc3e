"""Decode attention inside the real decode program: the port's kernel
against SDPA over the padded cache, across occupancies.

The port's counterpart of the JAX package's ``tools/bench_flash.py``. The
JAX engine picks between its Pallas flash-decode kernel and XLA's
attention (``flash_decode``; "auto" resolves to XLA). The port always
runs its own kernel (``ops/decode_attention.py``; no route is read on the
serving path). Alone, that kernel is slower than SDPA at one and four
slots; this bench prices the choice where it counts, inside the long
pool's k-step decode program of a ``BatchedEngine`` (nano in bf16, 50
slots, 256 decode tokens, prefill buckets 128 / 3072), at occupancies 64,
256 and max_len - 8, every slot live:

- ``on``: the port's kernel, as served;
- ``off``: ``sdpa_decode_attention``, defined here only: PyTorch's
  scaled_dot_product_attention over the whole padded cache with the lens
  mask, the counterpart of the JAX bench's XLA route and the kernel
  table's SDPA yardstick.

Each route has an engine of its own. A CUDA graph binds what ran while it
was captured, so ``sdpa_route()`` binds ``models/glm_asr.py``'s decode
attention to the SDPA function only while the ``off`` engine's program is
captured (and, on the CPU, run), and restores the kernel in ``finally``.
Nothing on the serving path reads a route. Each occupancy's programs are
replayed `iters` times, the lengths reset to the occupancy before each;
ms per step = total / (iters x k). ``attention_agreement`` holds the two
routes' attention to each other on the pool's state at each occupancy.

    python -m sonicscribe_tpu_torch.tools.bench_flash [--quick] [--device cpu] [--out F]

--quick: tiny in float32, 4 slots, k 4, 2 programs. Prints one JSON line
(JAX's keys ``occ<N>_{off,on}_ms_per_step``, ``_tok_per_s``,
``occ<N>_speedup``); writes it to a file only with --out.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models import glm_asr
from sonicscribe_tpu_torch.tools.bench_decode_parts import (
    bench_params,
    call_times_ms,
    captured,
    ms_per_step,
)
from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

SLOTS = 50
K = 16
ITERS = 8
MAX_DECODE_TOKENS = 256
BUCKETS = (128, 3072)
ROUTES = ("off", "on")
# cache positions every slot holds; an entry below 0 counts back from the
# long pool's max_len (-8: max_len - 8)
OCCUPANCIES = (64, 256, -8)
QUICK = dict(slots=4, k=4, iters=2)
# the routes' attention outputs on the same bf16 inputs: at most this share
# of max|kernel| apart (SDPA rounds its output and its probabilities to
# bf16, a relative 2^-9 each; the kernel keeps float32)
AGREE_TOL = 1e-2


def sdpa_decode_attention(q, k_cache, v_cache, lens) -> torch.Tensor:
    """decode_attention's contract through SDPA over the whole padded
    cache: q [S, nh, hd]; k/v_cache [S, M, nkv, hd]; slot s attends to the
    positions <= lens[s] (a bool mask) -> ctx [S, nh*hd] float32."""
    S, nh, hd = q.shape
    M = k_cache.shape[1]
    mask = (torch.arange(M, device=q.device)[None, :]
            <= lens.to(q.device, torch.long)[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k_cache.transpose(1, 2), v_cache.transpose(1, 2), attn_mask=mask,
        scale=1.0 / math.sqrt(hd), enable_gqa=True)
    return out.reshape(S, nh * hd).float()


@contextlib.contextmanager
def sdpa_route():
    """models/glm_asr's decode attention bound to sdpa_decode_attention for
    the block; the kernel's entry again after it, however it ends."""
    kernel = glm_asr.decode_attention
    glm_asr.decode_attention = sdpa_decode_attention
    try:
        yield
    finally:
        glm_asr.decode_attention = kernel


def make_engine(params, cfg, slots: int = SLOTS, seed: int = 0):
    """A BatchedEngine (energy gate, never started) with its long pool's
    K/V drawn normal x 0.02 from `seed`."""
    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
    from sonicscribe_tpu_torch.engine.transcriber import Transcriber
    from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    tr = Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=BUCKETS)
    engine = BatchedEngine(tr, EnergyVad(device=tr.device), slots=slots,
                           max_decode_tokens=MAX_DECODE_TOKENS)
    gen = torch.Generator(device=tr.device)
    gen.manual_seed(seed)
    for name in ("k", "v"):
        engine.long.state[name].normal_(0.0, 0.02, generator=gen)
    return engine


def occupy(engine, occupancy: int) -> None:
    """Every long-pool row live at `occupancy` cache positions, never
    finishing (the JAX bench's state)."""
    st = engine.long.state
    st["len"].fill_(occupancy)
    st["done"].fill_(False)
    st["budget"].fill_(1 << 30)
    st["tok"].fill_(7)
    st["n"].zero_()


def time_route(engine, name: str, k: int, occupancy: int, iters: int) -> float:
    """ms per step of the long pool's k-step program on `engine`, its graph
    captured (on first use) under route `name`."""
    key = ("decode", "long", k, None)
    program = engine._decode_fn(k, None)
    occupy(engine, occupancy)
    with sdpa_route() if name == "off" else contextlib.nullcontext():
        call, _ = captured(engine.router, key, program, engine.long.state)
        times = call_times_ms(engine.device, call, iters,
                              lambda: engine.long.state["len"].fill_(occupancy))
    return ms_per_step(times, k)


def attention_agreement(engine, occupancy: int, seed: int = 0) -> float:
    """max |kernel - SDPA| / max|kernel| of layer 0's decode attention on the
    long pool's K/V at `occupancy`, for seeded queries."""
    from sonicscribe_tpu_torch.ops.decode_attention import decode_attention

    dec = engine.cfg.decoder
    st = engine.long.state
    S = st["len"].shape[0]
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    q = torch.randn((S, dec.n_heads, dec.head_dim), generator=gen, device=engine.device,
                    dtype=torch.float32).to(st["k"].dtype)
    lens = torch.full((S,), occupancy, dtype=torch.int32, device=engine.device)
    on = decode_attention(q, st["k"][0], st["v"][0], lens)
    off = sdpa_decode_attention(q, st["k"][0], st["v"][0], lens)
    return float((on - off).abs().max() / on.abs().max())


def measure(params, cfg, device, slots: int = SLOTS, k: int = K, iters: int = ITERS,
            occupancies=OCCUPANCIES) -> dict:
    """Each route's ms per step and tokens/s at each occupancy, their
    speedup (off / on), and the routes' attention agreement on each
    occupancy's state."""
    device = resolve_device(device)
    engines = {name: make_engine(params, cfg, slots) for name in ROUTES}
    max_len = engines["on"].long.max_len
    out = {"slots": slots, "k": k, "max_len": max_len, "iters": iters,
           "timing": ("CUDA graphs (the engine's GraphRouter), CUDA events over replays"
                      if device.type == "cuda" else "eager on the CPU, host clock")}
    try:
        for occ in (o if o >= 0 else max_len + o for o in occupancies):
            for name in ROUTES:
                ms = time_route(engines[name], name, k, occ, iters)
                out[f"occ{occ}_{name}_ms_per_step"] = ms
                out[f"occ{occ}_{name}_tok_per_s"] = slots / (ms / 1e3)
            out[f"occ{occ}_speedup"] = (out[f"occ{occ}_off_ms_per_step"]
                                        / out[f"occ{occ}_on_ms_per_step"])
            out[f"occ{occ}_agreement"] = attention_agreement(engines["on"], occ)
    finally:
        for engine in engines.values():
            engine.shutdown()
    out["agree_tol"] = AGREE_TOL
    return out


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    cfg, params = bench_params(args.quick, device)
    kw = QUICK if args.quick else {}
    emit({"model": "tiny" if args.quick else "nano", **device_fields(device),
          **measure(params, cfg, device, **kw)}, args.out)


if __name__ == "__main__":
    main()
