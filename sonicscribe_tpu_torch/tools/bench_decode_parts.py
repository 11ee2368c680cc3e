"""Where the decode step's time goes: its parts, and its kernels by op.

The port's counterpart of the JAX package's ``tools/bench_decode_parts.py``,
at its shapes: nano in bf16, SLOTS 50 slots, caches of MAX_LEN 896
positions, K 16 steps a program. Each part is captured as one CUDA graph
of K steps through ``engine/exec_store.py``'s ``GraphRouter`` (the serving
path's capture), replayed once to warm, then REPS replays are timed with
CUDA events; ms per step = total / (REPS x K):

- ``mlp_chain``: every layer's weight-bound products (qkv, o, gate_up,
  down through ``ops/quant.py``'s ``matmul``), its residual adds with
  their RMSNorms (``ops/decode_glue.py``'s ``add_rms_norm``) and SiLU x up
  (``silu_mul``), as the step runs them; no attention, RoPE or K/V write;
- ``attn_chain``: attention only, every layer against its cache, slot
  lengths drawn from MAX_LEN/2 .. MAX_LEN-2. Unlike the JAX chain (XLA
  einsums) it attends with the port's ``ops/decode_attention.py``
  ``decode_attention``, the kernel its step runs;
- ``lm_head``: the final norm, the vocab product, argmax and the embedding
  add;
- ``full``: ``models/glm_asr.py``'s ``decode_step`` chained K times, the
  occupancy held steady (each replay starts K positions back).

The port adds the step's split by op (``split_by_op``): one profile of the
``full`` program's replays, its kernels grouped by what they compute from
the functor or op in the kernel's name (OP_GROUPS), each group's kernels
and ms per step; what no group names goes to ``other`` with its names. The
profiler drops kernel records now and then, so a profile is taken again
while it holds fewer than layers x steps decode-attention kernels (each
call launches one split and one merge kernel); if no profile itemizes the
replayed graph, the same program is profiled eager (``"source": "eager"``).

Rooflines (``tools/bench_hbm.rooflines``: the data sheet's 3.35 TB/s and
the rate bench_hbm measures for bf16 on this card): the weights a step
streams (the decoder tree, its tied embedding read whole as the LM head),
and the KV read at the drawn lengths, the full padded caches beside it.

The module also holds what the other decode microbenches share:
``call_times_ms`` and ``captured``.

    python -m sonicscribe_tpu_torch.tools.bench_decode_parts [--quick] [--device cpu]
        [--out F]

--quick: tiny in float32, 2 replays. Prints one JSON line; writes it to a
file only with --out.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.models.glm_asr import _layer, _lm_logits, decode_step, init_cache
from sonicscribe_tpu_torch.ops.decode_attention import decode_attention
from sonicscribe_tpu_torch.ops.decode_glue import add_rms_norm, silu_mul
from sonicscribe_tpu_torch.ops.quant import matmul
from sonicscribe_tpu_torch.tools import bench_hbm
from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

SLOTS = 50
MAX_LEN = 896
K = 16
REPS = 8
QUICK_REPS = 2
PROFILE_REPLAYS = 2  # replays of the full program in the split's profile
PROFILE_TRIES = 20  # profiles at most, while kernel records are missing
# the step's kernels by what they compute, from the functor or op in the
# kernel's name; the first group whose pattern a name holds takes it
OP_GROUPS = (
    ("decode_attention", ("decode_attention_split_kernel", "decode_attention_merge_kernel")),
    ("add_rms_norm", ("add_rms_norm_kernel",)),  # ops/decode_glue.py's kernels
    ("qkv_rope_kv_write", ("qkv_rope_kv_write_kernel",)),
    ("silu_mul", ("silu_mul_kernel",)),
    ("gemm", ("nvjet", "gemm", "gemv", "cutlass", "sm90_xmma", "splitKreduce", "cublas")),
    ("argmax", ("ArgMaxOps",)),
    ("reduction (RMSNorm mean)", ("MeanOps", "reduce_kernel")),
    ("rsqrt", ("rsqrt",)),
    ("silu", ("silu",)),
    ("where", ("where_kernel",)),
    ("index_put/scatter (K/V write)", ("index_put", "scatter")),
    ("index (K/V rows read for the write)", ("index_kernel",)),
    ("embedding gather", ("gather_kernel", "indexSelect")),
    ("cat", ("CatArrayBatchedCopy",)),
    ("copy/cast", ("copy_kernel", "direct_copy", "Memcpy", "memcpy", "bfloat16_copy",
                   "float16_copy")),
    ("rope tables (arange, pow, div, reciprocal, cos, sin)",
     ("arange", "pow", "DivFunctor", "div_true", "reciprocal", "cos_kernel", "sin_kernel")),
    ("add/sub", ("CUDAFunctor_add", "CUDAFunctorOnSelf_add", "AddFunctor", "add_kernel")),
    ("mul", ("MulFunctor", "mul_kernel")),
    ("compare/clamp/not/fill", ("Compare", "compare", "clamp", "bitwise_not", "FillFunctor",
                                "fill_kernel", "Memset")),
)


# ---- what the decode microbenches share ------------------------------------------------


def call_times_ms(device: torch.device, call: Callable[[], object], reps: int,
                  between: Callable[[], object] | None = None) -> list[float]:
    """ms of each of `reps` calls of call(), `between()` before each, outside
    the timed window: CUDA events around each call on the card, the host
    clock (after the call returns) on the CPU."""
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            if between is not None:
                between()
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    pairs = []
    for _ in range(reps):
        if between is not None:
            between()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    return [s.elapsed_time(e) for s, e in pairs]


def captured(router: GraphRouter, key, program, bufs: dict) -> tuple[Callable[[], dict], float]:
    """(call, seconds to make it ready): on the card the program's CUDA graph
    captured by `router` and replayed once, `call` a replay; on the CPU one
    warm eager run, `call` the program itself (``router.run`` either way)."""
    t0 = time.perf_counter()
    if router.device.type == "cuda":
        router.prepare(key, program, bufs)
        torch.cuda.synchronize(router.device)
    else:
        program(bufs)
    return (lambda: router.run(key, program, bufs)), time.perf_counter() - t0


def ms_per_step(times: list[float], k: int) -> float:
    return float(sum(times)) / (len(times) * k)


# ---- the parts ---------------------------------------------------------------------------


def mlp_chain(params, cfg, h: torch.Tensor, k: int) -> torch.Tensor:
    """k steps of every layer's norms, products and residuals, no
    attention: the first n_heads x head_dim columns of qkv stand in for the
    attention output that feeds o. h [S, D] -> [S, D]."""
    dec = cfg.decoder
    nq = dec.n_heads * dec.head_dim
    eps = dec.rms_eps
    for _ in range(k):
        delta = None
        for i in range(dec.n_layers):
            lp = _layer(params["decoder"]["layers"], i, whole_qtensors=True)
            h, hn = add_rms_norm(h, delta, lp["ln1_scale"], eps)
            qkv = matmul(hn, lp["qkv_w"])
            h, hn = add_rms_norm(h, matmul(qkv[..., :nq], lp["o_w"]), lp["ln2_scale"], eps)
            delta = matmul(silu_mul(matmul(hn, lp["gate_up_w"])), lp["down_w"])
        h = h + delta
    return h


def attn_chain(cfg, k_cache: torch.Tensor, v_cache: torch.Tensor, lens: torch.Tensor,
               q: torch.Tensor, k: int) -> torch.Tensor:
    """k steps of every layer's decode attention alone, each layer's output
    the next one's query: q [S, n_heads x head_dim]; caches [L, S, M, nkv,
    hd]; slot s attends to positions <= lens[s]."""
    dec = cfg.decoder
    S = q.shape[0]
    for _ in range(k):
        for i in range(dec.n_layers):
            q = decode_attention(q.view(S, dec.n_heads, dec.head_dim), k_cache[i], v_cache[i],
                                 lens).to(q.dtype)
    return q


def lm_head(params, cfg, h: torch.Tensor, k: int) -> torch.Tensor:
    """k steps of the final norm, the vocab product, argmax and the
    embedding add. h [S, D] -> [S, D]."""
    embed = params["decoder"]["embed"]
    for _ in range(k):
        tok = torch.argmax(_lm_logits(params, cfg, h), dim=-1)
        h = h + embed[tok]
    return h


def full(params, cfg, cache: dict, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """decode_step chained k times, each step's argmax the next one's input:
    the cache and `tokens` [S] int32 in place (a graph of it carries them
    from one replay to the next)."""
    for _ in range(k):
        _, logits = decode_step(params, cfg, cache, tokens)
        tokens.copy_(torch.argmax(logits, dim=-1).to(torch.int32))
    return tokens


# ---- state -------------------------------------------------------------------------------


def draw_caches(cfg, slots: int, max_len: int, dtype, device, gen: torch.Generator) -> dict:
    """init_cache's layout with K/V drawn normal x 0.02 from `gen`."""
    cache = init_cache(cfg, slots, max_len, dtype=dtype, device=device)
    for name in ("k", "v"):
        cache[name].normal_(0.0, 0.02, generator=gen)
    return cache


def decoder_bytes(params) -> int:
    """Bytes of the weights a decode step streams: the decoder tree (the
    tied embedding is read whole as the LM head)."""
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.numel() * node.element_size()

    return walk(params["decoder"])


def kv_bytes(cfg, positions: float, itemsize: int) -> float:
    """Bytes of K and V at `positions` cache positions, every layer."""
    dec = cfg.decoder
    return dec.n_layers * positions * dec.n_kv_heads * dec.head_dim * itemsize * 2


# ---- the split by op ---------------------------------------------------------------------


def op_group(name: str) -> str:
    return next((g for g, pats in OP_GROUPS if any(p in name for p in pats)), "other")


def _kernel_events(run: Callable[[], object], device) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _complete_profile(run, device, want: int):
    """(events, tries) of the first profile of run() holding `want`
    decode-attention split kernels, or (None, tries) if PROFILE_TRIES
    profiles never did."""
    for tries in range(1, PROFILE_TRIES + 1):
        events = _kernel_events(run, device)
        seen = sum(e.count for e in events if "decode_attention_split_kernel" in e.key)
        if seen == want:
            return events, tries
    return None, PROFILE_TRIES


def split_by_op(params, cfg, cache: dict, tokens: torch.Tensor, k: int,
                call: Callable[[], object], between: Callable[[], object],
                replays: int = PROFILE_REPLAYS) -> dict:
    """The full program's device time by op group, per step, from one
    profile of `replays` replays (`call`, `between()` before each); the
    same program eager where no profile itemizes the replays. Raises when
    no profile holds every decode-attention kernel (n_layers per step)."""
    device = tokens.device
    steps = replays * k
    want = cfg.decoder.n_layers * steps

    def replayed():
        for _ in range(replays):
            between()
            call()

    def eager():
        for _ in range(replays):
            between()
            full(params, cfg, cache, tokens, k)

    source = "graph"
    events, tries = _complete_profile(replayed, device, want)
    if events is None:
        source = "eager"
        events, more = _complete_profile(eager, device, want)
        tries += more
    if events is None:
        raise RuntimeError(f"no profile of {steps} steps held {want} decode-attention kernels "
                           f"in {tries} tries")
    groups = {g: {"kernels_per_step": 0.0, "ms_per_step": 0.0} for g, _ in OP_GROUPS}
    groups["other"] = {"kernels_per_step": 0.0, "ms_per_step": 0.0}
    other_names = []
    busy_ms = 0.0
    for e in events:
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        g = op_group(e.key)
        groups[g]["kernels_per_step"] += e.count / steps
        groups[g]["ms_per_step"] += ms / steps
        busy_ms += ms
        if g == "other":
            other_names.append(e.key[:160])
    busy_per_step = busy_ms / steps
    return {"source": source, "steps": steps, "profile_tries": tries,
            "busy_ms_per_step": busy_per_step,
            "kernels_per_step": sum(g["kernels_per_step"] for g in groups.values()),
            "decode_attention_split_kernels": sum(
                e.count for e in events if "decode_attention_split_kernel" in e.key),
            "decode_attention_merge_kernels": sum(
                e.count for e in events if "decode_attention_merge_kernel" in e.key),
            "coverage": 1.0 - groups["other"]["ms_per_step"] / busy_per_step if busy_ms else 0.0,
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms_per_step"])),
            "other_names": other_names}


# ---- the bench ---------------------------------------------------------------------------


def measure(params, cfg, device, reps: int = REPS, rate_gb_s: float | None = None) -> dict:
    """The four parts' ms per step (and their graphs' capture seconds), the
    full program's split by op on the card (None on the CPU), rooflines;
    SLOTS x MAX_LEN, K steps a program, state drawn from seed 0."""
    device = resolve_device(device)
    dec = cfg.decoder
    dtype = params["decoder"]["embed"].dtype
    slots, max_len, k = SLOTS, MAX_LEN, K
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    router = GraphRouter(device, warm_in_place=("k", "v"))
    out = {"slots": slots, "max_len": max_len, "k_steps": k, "reps": reps,
           "timing": ("CUDA graphs (GraphRouter), CUDA events over replays"
                      if device.type == "cuda" else "eager on the CPU, host clock")}
    capture_s = {}

    def timed(name, program, bufs, between=None):
        call, capture_s[name] = captured(router, name, program, bufs)
        out[f"{name}_ms_per_step"] = ms_per_step(
            call_times_ms(device, call, reps, between and (lambda: between(bufs))), k)
        return call

    h0 = torch.from_numpy(rng.standard_normal((slots, dec.d_model))).to(device, dtype)
    timed("mlp_chain", lambda b: {"h": mlp_chain(params, cfg, b["h"], k)}, {"h": h0})

    cache = draw_caches(cfg, slots, max_len, dtype, device, gen)
    lens = torch.from_numpy(rng.integers(max_len // 2, max_len - 1, slots)).to(device,
                                                                                torch.int32)
    q0 = torch.from_numpy(rng.standard_normal((slots, dec.n_heads * dec.head_dim))).to(
        device, dtype)
    timed("attn_chain", lambda b: {"q": attn_chain(cfg, b["k"], b["v"], b["len"], b["q"], k)},
          {"k": cache["k"], "v": cache["v"], "len": lens, "q": q0})
    kv_read = kv_bytes(cfg, float((lens.long() + 1).sum()), cache["k"].element_size())

    timed("lm_head", lambda b: {"h": lm_head(params, cfg, b["h"], k)}, {"h": h0})

    cache["len"].copy_(torch.from_numpy(rng.integers(max_len // 2, max_len - k - 1, slots)))
    bufs = {"cache": cache, "tok": torch.from_numpy(
        rng.integers(0, dec.vocab_size, slots)).to(device, torch.int32)}

    def hold(b):  # hold the occupancy steady: each replay starts k positions back
        b["cache"]["len"].sub_(k)

    program = lambda b: {"tok": full(params, cfg, b["cache"], b["tok"], k)}  # noqa: E731
    call = timed("full", program, bufs, hold)
    out["split_by_op"] = (split_by_op(params, cfg, cache, bufs["tok"], k, call,
                                      lambda: hold(bufs))
                          if device.type == "cuda" else None)
    out["capture_s"] = capture_s
    itemsize = cache["k"].element_size()
    out.update(bench_hbm.rooflines("weights", decoder_bytes(params), rate_gb_s))
    out.update(bench_hbm.rooflines("kv_read", kv_read, rate_gb_s))
    out.update(bench_hbm.rooflines("kv_padded", kv_bytes(cfg, slots * max_len, itemsize),
                                   rate_gb_s))
    out["hbm_gb_s"] = rate_gb_s
    out["weights_bytes"] = decoder_bytes(params)
    return out


def bench_params(quick: bool, device):
    """nano in bf16 (quick: tiny in float32), random weights from seed 0."""
    from sonicscribe_tpu_torch.models.config import nano, tiny
    from sonicscribe_tpu_torch.models.weights import init_random

    cfg = tiny() if quick else nano()
    return cfg, init_random(cfg, 0, dtype=torch.float32 if quick else torch.bfloat16,
                            device=device)


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
