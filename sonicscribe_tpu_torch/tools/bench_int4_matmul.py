"""Per-decode-step sweep of nano's decoder projections with int4 weights, on the card.

Port of the JAX package's ``tools/bench_int4_matmul.py``: the four
projections (qkv, o, gate_up, down) of nano's 28 decoder layers, chained
as decode_step composes them (each output feeds the next), at decode
batch sizes. Variants, each with the JAX tool's variant it takes the
place of:

  int8         the stacked W8A16 kernel (ops/int8_matmul.py) on the same
               codes as int8 weights                      (JAX: int8_xla)
  int4_w4a16   the stacked W4A16 kernel (ops/int4_matmul.py) on the
               halved-K packing                           (JAX: int4_pallas)
  int4_w4a8    per-row activation int8 + the stacked W4A8 kernel
                                                     (JAX: int4_pallas_w4a8)
  int4_packed  the JAX tool's interleaved packing (even k rows in the low
               nibble, odd in the high), unpacked in plain PyTorch on every
               call, then torch.mm; a plain variant, run only when named
                                                          (JAX: int4_packed)
  bf16         torch.mm on the dequantised bf16 stacks (cuBLAS; a yardstick
               with 4x the int4 weight bytes, never called by the port), as
               in bench_int8_matmul

The JAX tool's int4_native and its XLA int4_w4a8 store the weights as
jnp.int4; PyTorch has no int4 arithmetic dtype, so they have no
counterpart here.

Weights follow the JAX tool's recipe: codes uniform in [-7, 7] and a
per-column scale of 0.02/7 rounded through bf16, made from a seed with a
torch.Generator on the card. Each (batch, variant) prints one JSON line:
the step's device ms, timed with CUDA events around a replay of the step
captured as a CUDA graph (the counterpart of the JAX tool's one jitted
program: no host gaps), the effective rate against the variant's own
weight bytes (0.62 GB int4, 1.24 GB int8, 2.48 GB bf16), and the wall ms
of the same step run eagerly. Writes no file (INT4_MATMUL_BENCH.json is
the JAX package's TPU record); raises without a card.

    python -m sonicscribe_tpu_torch.tools.bench_int4_matmul [--batch B..] [--reps N] [variant..]
"""

from __future__ import annotations

import argparse
import json

import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models.config import nano
from sonicscribe_tpu_torch.ops.int4_matmul import (
    int4_matmul_stacked,
    int4_matmul_w4a8_stacked,
    pack_int4,
)
from sonicscribe_tpu_torch.ops.int8_matmul import int8_matmul_stacked
from sonicscribe_tpu_torch.tools.bench_int8_matmul import layer_shapes, sweep, time_step

REPS = 30
BATCHES = (8, 16, 64)


def pack_interleaved(codes: torch.Tensor) -> torch.Tensor:
    """[.., K, N] codes -> [.., K/2, N] uint8: even k rows in the low
    nibble, odd ones in the high (the JAX tool's int4_packed storage)."""
    lo = codes[..., 0::2, :].to(torch.int32) & 0xF
    hi = codes[..., 1::2, :].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_interleaved(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_interleaved -> [.., K, N] int8 codes."""
    v = packed.to(torch.int16)
    nib = torch.stack([v & 0xF, v >> 4], dim=-2)  # [.., K/2, 2, N]
    nib = torch.where(nib >= 8, nib - 16, nib)
    return nib.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1]).to(torch.int8)


def make_weights(cfg, seed: int, device) -> dict:
    """Per projection: the codes [L, K, N] int8 in [-7, 7] ("q", as the
    int8 variant reads them), their halved-K packing ("packed", [L, K/2,
    N]) and interleaved packing ("interleaved"), the scale [L, 1, N]
    float32 (0.02/7 through bf16) and the dequantised bf16 stack ("bf16")."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (L, K, N) in layer_shapes(cfg).items():
        codes = torch.randint(-7, 8, (L, K, N), generator=gen, device=device, dtype=torch.int8)
        scale = torch.full((L, 1, N), 0.02 / 7.0, device=device).to(torch.bfloat16)
        out[name] = {
            "q": codes, "scale": scale.float(), "packed": pack_int4(codes),
            "interleaved": pack_interleaved(codes),
            "bf16": codes.to(torch.bfloat16) * scale,
        }
    return out


def _mm_packed(x, w, layer):
    codes = unpack_interleaved(w["interleaved"][layer]).to(x.dtype)
    return (x @ codes) * w["scale"][layer].reshape(-1).to(x.dtype)


VARIANTS = {  # mm(x, weights of one projection, layer)
    "bf16": lambda x, w, layer: torch.mm(x, w["bf16"][layer].to(x.dtype)),
    "int8": lambda x, w, layer: int8_matmul_stacked(x, w["q"], w["scale"], layer),
    "int4_w4a16": lambda x, w, layer: int4_matmul_stacked(x, w["packed"], w["scale"], layer),
    "int4_w4a8": lambda x, w, layer: int4_matmul_w4a8_stacked(x, w["packed"], w["scale"], layer),
    "int4_packed": _mm_packed,
}
DEFAULT_VARIANTS = ("bf16", "int8", "int4_w4a16", "int4_w4a8")
BYTES_PER_WEIGHT = {"bf16": 2, "int8": 1, "int4_w4a16": 0.5, "int4_w4a8": 0.5, "int4_packed": 0.5}


def run(batches=BATCHES, reps: int = REPS, seed: int = 0, device=None,
        variants=DEFAULT_VARIANTS) -> list[dict]:
    """Time every variant at every batch size; -> the result records."""
    device = resolve_device(device)
    cfg = nano()
    weights = make_weights(cfg, seed, device)
    n_weights = sum(w["q"].numel() for w in weights.values())
    name = torch.cuda.get_device_name(device)
    out = []
    for B in batches:
        gen = torch.Generator(device=device).manual_seed(seed + B)
        h0 = (torch.randn((B, cfg.decoder.d_model), generator=gen, device=device) * 0.1
              ).to(torch.bfloat16)
        for variant in variants:
            mm = VARIANTS[variant]
            with torch.inference_mode():
                ms, eager_ms = time_step(
                    lambda: sweep(mm, weights, h0, cfg.decoder.n_layers), reps)
            stream = n_weights * BYTES_PER_WEIGHT[variant]
            out.append({
                "B": B, "variant": variant, "ms_per_step": ms,
                "eff_gb_s": stream / (ms / 1e3) / 1e9, "weight_gb": stream / 1e9,
                "eager_ms_per_step": eager_ms, "device": name,
            })
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=list(BATCHES))
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help=f"of {', '.join(VARIANTS)}; default: {' '.join(DEFAULT_VARIANTS)}")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        parser.error(f"unknown variants {unknown}")
    for rec in run(tuple(args.batch), args.reps, variants=args.variants or DEFAULT_VARIANTS):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
