"""The comparison that decides ``correct`` for a served model.

For each sampled request the reference runs its prompt and served tokens
once (the configuration's model family's ``reference(...).served_logits``:
``families/<family>.py``) and reads, at every served position, the
gap by which the served token's logit lies below the reference's best
there (nought where the served token is the reference's pick). The number
compared is the gap per near tie: the summed gap over the count of
positions whose reference top two logits lie within 0.1 of each other
(``TIE_MARGIN``). A seed's weights set how many near ties there are, and
that count scales every reading of that seed; divided by it, what is left is the
size of the logit error. (The widest gap and the mean gap do not separate
the bf16 program from its control across seeds: PERF.md.)

The control takes the program's place: the same prompts and tokens
through the family's reference at the precision below the configuration's
(``reference(..., bits=control_bits(cfg))``), whose
first-ranked token at each position is read against the reference's
logits the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import frontend


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


def strict_float32() -> None:
    """TF32 off: float32 products run in float32 on the card too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
def gaps(family, cfg: dict, seed: int, requests: list, device, control: bool = False) -> dict:
    """-> the gap per near tie of the served tokens against the reference
    of model family `family` (``_per_tie``), with "tokens" and "requests";
    with `control`, the widest and mean gap too (``_calibration``), the
    control's readings under "control" and every position's (margin,
    served gap, control gap) under "positions"."""
    strict_float32()
    prefix, suffix = prompt_ids(cfg)
    ref_model = family.reference(cfg, seed, device)
    control_model = (family.reference(cfg, seed, device, bits=control_bits(cfg)) if control
                     else None)
    gaps_, margins, gaps_c = [], [], []
    for req in requests:
        toks = [int(t) for t in req["tokens"]]
        if not toks:
            continue
        mel = request_mel(cfg, req, device)
        ref = ref_model.served_logits(mel, prefix, suffix, toks)
        top2 = ref.topk(2, dim=1).values
        best = top2[:, 0]
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        served = ref.gather(1, torch.as_tensor(toks, device=ref.device)[:, None])[:, 0]
        gaps_.append((best - served).cpu())
        if control_model is not None:
            pick = control_model.served_logits(mel, prefix, suffix, toks).argmax(dim=1)
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
