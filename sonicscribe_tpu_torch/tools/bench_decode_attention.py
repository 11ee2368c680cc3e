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

Then one line on verify attention's accuracy at the model's own inputs:
nano-random (bf16, seed SEED) prefills a prompt of random tokens into an
M 803 cache and runs one verify step of W1 tokens; each of the 28 layers'
verify attention outputs is held to its exact value (float64 on the card)
and to the plain version's (float32): max and mean abs error, and the
share of outputs whose bf16 rounding (the model casts them to bf16)
differs from the exact one's. The script may run against another
checkout's package (PYTHONPATH=<that root>), so two kernels meet the same
inputs.

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


def exact_verify(q, k, v, lens) -> torch.Tensor:
    """verify_attention_plain's masked attention in float64."""
    S, W1, nh, hd = q.shape
    M, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(S, W1, nkv, nh // nkv, hd).double()
    scores = torch.einsum("sqkgd,smkd->skgqm", qg, k.double()) / hd**0.5
    qpos = lens.long()[:, None] + torch.arange(W1, device=q.device)[None, :]
    valid = torch.arange(M, device=q.device)[None, None, :] <= qpos[:, :, None]
    attn = torch.softmax(torch.where(valid[:, None, None], scores, -torch.inf), dim=-1)
    return torch.einsum("skgqm,smkd->sqkgd", attn, v.double()).reshape(S, W1, nh * hd)


def model_accuracy(smi: str, prompt: int = 674, M: int = 803) -> dict:
    """Verify attention against float64 at nano-random's own inputs (see
    the module docstring)."""
    from sonicscribe_tpu_torch.models import glm_asr
    from sonicscribe_tpu_torch.models.weights import init_random

    cfg = nano()
    params = init_random(cfg, SEED, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tokens = torch.randint(0, cfg.decoder.vocab_size, (1, prompt + W1), generator=gen,
                           device="cuda")
    seen, kernel = [], glm_asr.verify_attention

    def recorded(q, k, v, lens):
        out = kernel(q, k, v, lens)
        seen.append((out, q.clone(), k.clone(), v.clone(), lens.clone()))
        return out

    with torch.inference_mode():
        cache = glm_asr.init_cache(cfg, 1, M, device="cuda")
        glm_asr.prefill(params, cfg, glm_asr.embed_tokens(params, tokens[:, :prompt]),
                        torch.tensor([prompt], device="cuda"), cache)
        glm_asr.verify_attention = recorded
        try:
            glm_asr.verify_step(params, cfg, cache, tokens[:, prompt:])
        finally:
            glm_asr.verify_attention = kernel
        errs, plain_errs, flips = [], [], []
        for out, q, k, v, lens in seen:
            want = exact_verify(q, k, v, lens)
            errs.append((out.double() - want).abs())
            plain_errs.append((da.verify_attention_plain(q, k, v, lens).double() - want).abs())
            flips.append((out.to(torch.bfloat16) != want.to(torch.bfloat16)).double().mean())
    return {"kernel": "verify_attention", "shape": f"nano-random verify step, S=1 W1={W1} "
            f"M={M} lens {prompt}, {len(seen)} layers", "max_abs_err": max(e.max().item()
            for e in errs), "mean_abs_err": float(torch.stack([e.mean() for e in errs]).mean()),
            "plain_max_abs_err": max(e.max().item() for e in plain_errs),
            "bf16_flips": float(torch.stack(flips).mean()), "card": smi,
            "package": sonicscribe_tpu_torch.__file__}


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
    out.append(model_accuracy(smi[0]))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blocks", type=int, default=3)
    args = parser.parse_args(argv)
    for rec in run(args.blocks):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
