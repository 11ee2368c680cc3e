"""Per-decode-step sweep of the int8 decoder projections on the card.

Port of the JAX package's ``tools/bench_int8_matmul.py``: the four
projections (qkv, o, gate_up, down) of nano's 28 decoder layers, chained
as decode_step composes them (each output feeds the next), at decode
batch sizes. Variants:

  bf16       torch.mm on the bf16 stacks (cuBLAS; a yardstick with twice
             the weight bytes, never called by the port)
  int8       the stacked W8A16 kernel (ops/int8_matmul.py)
  int8_w8a8  per-row activation int8 + the W8A8 kernel

Each (batch, variant) prints one JSON line: the step's device ms, timed
with CUDA events around a replay of the step captured as a CUDA graph (the
counterpart of the JAX tool's one jitted program: no host gaps), the
effective rate against the weight stream (1.24 GB int8, 2.48 GB bf16),
and the wall ms of the same step run eagerly, as the decode step runs it
today. Writes no file; raises without a card.

    python -m sonicscribe_tpu_torch.tools.bench_int8_matmul [--batch 1 8] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models.config import nano
from sonicscribe_tpu_torch.ops.int8_matmul import int8_matmul_stacked, int8_matmul_w8a8
from sonicscribe_tpu_torch.ops.quant import quantize_tensor

def layer_shapes(cfg) -> dict:
    """[L, K, N] of the four decoder projections' stacks."""
    dec = cfg.decoder
    L, d = dec.n_layers, dec.d_model
    return {
        "qkv_w": (L, d, (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim),
        "o_w": (L, dec.n_heads * dec.head_dim, d),
        "gate_up_w": (L, d, 2 * dec.ffn_hidden),
        "down_w": (L, dec.ffn_hidden, d),
    }


def layer_weights(cfg, seed: int, device) -> dict:
    """bf16 stacks [L, K, N] of the four decoder projections, N(0, 0.02)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: (torch.randn(s, generator=gen, device=device) * 0.02).to(torch.bfloat16)
            for k, s in layer_shapes(cfg).items()}


def sweep(mm, weights: dict, h: torch.Tensor, n_layers: int) -> torch.Tensor:
    """One decode step's projection chain over all layers; mm(x, w, layer)."""
    d = h.shape[1]
    for layer in range(n_layers):
        qkv = mm(h, weights["qkv_w"], layer)
        h = h + 0.01 * mm(qkv[:, :d].contiguous(), weights["o_w"], layer)
        gate, up = torch.chunk(mm(h, weights["gate_up_w"], layer), 2, dim=-1)
        h = h + 0.01 * mm(F.silu(gate) * up, weights["down_w"], layer)
    return h


VARIANTS = {
    "bf16": lambda x, w, layer: torch.mm(x, w[layer]),
    "int8": lambda x, w, layer: int8_matmul_stacked(x, w["q"], w["scale"], layer),
    "int8_w8a8": lambda x, w, layer: int8_matmul_w8a8(x, w["q"], w["scale"], layer),
}


def time_step(run, reps: int) -> tuple[float, float]:
    """-> (median device ms of the step replayed as a CUDA graph, median
    wall ms of the step run eagerly and synchronized)."""
    run()  # loads the kernels before anything is captured
    torch.cuda.synchronize()
    eager = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # cuBLAS sets up its workspace on the capture stream first
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        run()
    dev = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(dev)), float(np.median(eager))


def run(batches=(1, 8), reps: int = 20, seed: int = 0, device=None) -> list[dict]:
    """Time every variant at every batch size; -> the result records."""
    device = resolve_device(device)
    cfg = nano()
    w_bf16 = layer_weights(cfg, seed, device)
    w_q = {k: quantize_tensor(w) for k, w in w_bf16.items()}
    int8_bytes = sum(t["q"].numel() for t in w_q.values())
    name = torch.cuda.get_device_name(device)
    out = []
    for B in batches:
        gen = torch.Generator(device=device).manual_seed(seed + B)
        h0 = (torch.randn((B, cfg.decoder.d_model), generator=gen, device=device) * 0.1
              ).to(torch.bfloat16)
        for variant, mm in VARIANTS.items():
            weights = w_bf16 if variant == "bf16" else w_q
            with torch.inference_mode():
                ms, eager_ms = time_step(
                    lambda: sweep(mm, weights, h0, cfg.decoder.n_layers), reps)
            stream = int8_bytes * (2 if variant == "bf16" else 1)
            out.append({
                "B": B, "variant": variant, "ms_per_step": ms,
                "eff_gb_s": stream / (ms / 1e3) / 1e9, "weight_gb": stream / 1e9,
                "eager_ms_per_step": eager_ms, "device": name,
            })
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    for rec in run(tuple(args.batch), args.reps):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
