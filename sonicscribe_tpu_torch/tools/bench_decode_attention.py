"""Device time of the decode-attention kernel (and of verify attention,
where the package has it) at the shapes the main path and the batcher
give it, on the card.

Shapes (nano's 16 heads, 4 KV heads, hd 128, bf16): S 1 at M 675 and 803
with lens M - 1, S 4 at M 1024, and the batcher's pools, S 33 at M 803
and S 65 at M 83, lens mixed with a third of the slots empty. Each time is
the median of 30 launches, each timed with CUDA events after the L2 cache
is overwritten and behind a spin kernel (host launch cost not counted),
as chip_smoke.py times its kernels. Each shape is timed `--blocks` times
in turn. Prints one JSON line per (kernel, shape, block) with the card's
name and power limit, the package's path and the SHA-256 of the output's
bytes, so that two checkouts run one after the other on one card compare
line by line, bits included:

    PYTHONPATH=. python sonicscribe_tpu_torch/tools/bench_decode_attention.py [--blocks 3]

Writes no file; raises without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

import sonicscribe_tpu_torch
from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models.config import nano
from sonicscribe_tpu_torch.ops import decode_attention as da

SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's boost clock
SEED = 11
W1 = 9  # nano's verify positions per slot (8 drafts + 1)
SHAPES = (  # (S, M, lens: "last" = M - 1 in every slot, or "mixed")
    (1, 675, "last"), (1, 803, "last"), (4, 1024, "last"), (33, 803, "mixed"), (65, 83, "mixed"),
)


def cold_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Median device ms of fn over `iters` launches, L2 overwritten first."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def inputs(S: int, M: int, lens_kind: str, gen: torch.Generator) -> tuple:
    """q [S, W1, nh, hd], k/v strided layer views [S, M, nkv, hd] (bf16),
    lens [S] int32."""
    dec = nano().decoder
    nh, nkv, hd = dec.n_heads, dec.n_kv_heads, dec.head_dim
    if lens_kind == "last":
        lens = torch.full((S,), M - 1, dtype=torch.int32, device="cuda")
    else:
        lens = torch.randint(0, M, (S,), generator=gen, device="cuda")
        lens[::3] = 0  # empty slots
        lens[1] = M - 1
        lens = lens.to(torch.int32)
    k = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)[1]
    v = torch.randn((2, S, M, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)[1]
    q = torch.randn((S, W1, nh, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, lens


def run(blocks: int = 3) -> list[dict]:
    """Time every kernel at every shape, `blocks` times in turn."""
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = []
    for S, M, lens_kind in SHAPES:
        q, k, v, lens = inputs(S, M, lens_kind, gen)
        q1 = q[:, 0].contiguous()
        cases.append((f"S={S} M={M} lens {lens_kind}", "decode_attention",
                      lambda q1=q1, k=k, v=v, lens=lens: da.decode_attention_cuda(q1, k, v, lens)))
        if hasattr(da, "verify_attention_cuda"):
            cases.append((f"S={S} W1={W1} M={M} lens {lens_kind}", "verify_attention",
                          lambda q=q, k=k, v=v, lens=lens: da.verify_attention_cuda(q, k, v, lens)))
    out = []
    digests = [hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
               for _, _, fn in cases]
    for block in range(blocks):
        for (shape, kernel, fn), digest in zip(cases, digests):
            out.append({"kernel": kernel, "shape": shape, "block": block,
                        "ms": cold_ms(fn, flush), "sha256": digest, "card": smi[0],
                        "package": sonicscribe_tpu_torch.__file__})
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blocks", type=int, default=3)
    args = parser.parse_args(argv)
    for rec in run(args.blocks):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
