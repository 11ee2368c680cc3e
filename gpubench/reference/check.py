"""The comparison that decides ``correct`` for a served model.

For each sampled request the reference runs its prompt and served tokens
once (``model.served_logits``) and reads, at every served position, the
gap by which the served token's logit lies below the reference's best
there (nought where the served token is the reference's pick). The number
compared is the gap per near tie: the summed gap over the count of
positions whose reference top two logits lie within 0.1 of each other
(``TIE_MARGIN``). A seed's weights set how many near ties there are, and
that count scales every reading of that seed; divided by it, what is left is the
size of the logit error. (The widest gap and the mean gap do not separate
the bf16 program from its control across seeds: PERF.md.)

The control takes the program's place: the same prompts and tokens
through the reference at the precision below the configuration's, whose
first-ranked token at each position is read against the reference's
logits the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import frontend, model
from gpubench.reference.quant import quantize_tree
from gpubench.reference.weights import QUANT_LEAVES, make_weights


def prompt_ids(cfg: dict) -> tuple[list, list]:
    """(prefix, suffix) token ids around the audio, from the configuration's
    prompt: a byte tokenizer with `byte_offset` specials."""
    p = cfg["prompt"]
    text = [p["byte_offset"] + b for b in p["instruction"].encode("utf-8")]
    return list(p["prefix"]), [p["audio_end"]] + text + [p["assistant"]]


def request_mel(cfg: dict, req: dict, device) -> torch.Tensor:
    """The mel of a sampled request from the harness's own samples."""
    audio = torch.from_numpy(np.asarray(req["pcm"], np.int16).astype(np.float32) / 32768.0)
    audio = audio.to(device)
    fe = cfg["frontend"]
    if req["path"] == "ring":
        return frontend.ring_mel(audio, req["bucket_samples"], fe)
    return frontend.file_mel(audio, fe)


def reference_weights(cfg: dict, seed: int, device, bits=None) -> dict:
    """The configuration's weights from the seed, made in its dtype as the
    program's were, read as float32. Its quantized leaves stand for their
    codes; `bits` below 16 (the control) quantizes to that many bits every
    leaf the int8 mode quantizes (``QUANT_LEAVES``)."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    W = _to_f32(make_weights(cfg["model"], seed, device, dtype))
    if bits is not None:
        return quantize_tree(W, bits, QUANT_LEAVES)
    if cfg["weight_bits"] < 16:
        W = quantize_tree(W, cfg["weight_bits"], tuple(cfg["quantized_leaves"]))
    return W


def _to_f32(node):
    if isinstance(node, dict):
        return {k: _to_f32(v) for k, v in node.items()}
    return node.float()


def control_bits(cfg: dict) -> int:
    """The precision below the configuration's: int8 weights under a
    bfloat16 model, int4 under an int8 one."""
    return {16: 8, 8: 4}[cfg["weight_bits"]]


TIE_MARGIN = 0.1  # logits: a position whose reference top two lie closer is a near tie


def _per_tie(gap: torch.Tensor, margin: torch.Tensor) -> dict:
    """The summed gap over the count of near ties (the gap per near tie)."""
    ties = int((margin < TIE_MARGIN).sum())
    return {"gap_per_tie": float(gap.sum()) / max(ties, 1), "ties": ties}


def _calibration(gap: torch.Tensor, margin: torch.Tensor) -> dict:
    """The gap per near tie with the widest and the mean gap beside it
    (the numbers that did not separate the program from its control)."""
    return dict(_per_tie(gap, margin), gap_max=float(gap.max()) if gap.numel() else 0.0,
                gap_mean=float(gap.mean()) if gap.numel() else 0.0)


@torch.no_grad()
def gaps(cfg: dict, seed: int, requests: list, device, control: bool = False) -> dict:
    """-> the gap per near tie of the served tokens against the reference
    (``_per_tie``), with "tokens" and "requests"; with `control`, the
    widest and mean gap too (``_calibration``), the control's readings
    under "control" and every position's (margin, served gap, control gap)
    under "positions"."""
    model.strict_float32()
    prefix, suffix = prompt_ids(cfg)
    W = reference_weights(cfg, seed, device)
    Wc = reference_weights(cfg, seed, device, control_bits(cfg)) if control else None
    gaps_, margins, gaps_c = [], [], []
    for req in requests:
        toks = [int(t) for t in req["tokens"]]
        if not toks:
            continue
        mel = request_mel(cfg, req, device)
        ref = model.served_logits(W, cfg["model"], mel, prefix, suffix, toks)
        top2 = ref.topk(2, dim=1).values
        best = top2[:, 0]
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        served = ref.gather(1, torch.as_tensor(toks, device=ref.device)[:, None])[:, 0]
        gaps_.append((best - served).cpu())
        if Wc is not None:
            pick = model.served_logits(Wc, cfg["model"], mel, prefix, suffix, toks).argmax(dim=1)
            gaps_c.append((best - ref.gather(1, pick[:, None])[:, 0]).cpu())
        del ref
    cat = lambda xs: torch.cat(xs) if xs else torch.zeros(0)  # noqa: E731
    gap, margin = cat(gaps_), cat(margins)
    readings = _calibration if control else _per_tie
    out = dict(readings(gap, margin), tokens=int(gap.numel()), requests=len(requests))
    if control:
        gc = cat(gaps_c)
        out["control"] = _calibration(gc, margin)
        out["positions"] = [[round(float(a), 5), round(float(b), 5), round(float(c), 5)]
                            for a, b, c in zip(margin, gap, gc)]
    return out
