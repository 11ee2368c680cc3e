"""Weight quantization as the configurations state it, recomputed here.

A frozen copy of the per-output-channel recipe the reference's int8 mode
states (symmetric over the input axis, scale = max|w| / 127 as an IEEE
float32 division, round half to even, codes clipped to +-127), and the
same recipe at 4 bits for the control of an int8 configuration. Each
returns the dequantized float32 weight: the reference multiplies in
float32 by what the codes and scales stand for.
"""

from __future__ import annotations

import torch

from gpubench.reference.weights import QUANT_LEAVES


def fake_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w [..., K, N] -> float32 dequantized codes of `bits` bits, one scale
    per output column (and per layer of a stack)."""
    levels = float(2 ** (bits - 1) - 1)
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / torch.full((), levels, device=w.device)
    q = torch.clamp(torch.round(wf / scale), -levels, levels)
    return q * scale


def quantize_tree(tree: dict, bits: int, leaves=QUANT_LEAVES) -> dict:
    """A copy of `tree` whose encoder and decoder layer projections named
    in `leaves` are fake-quantized to `bits`; other leaves are shared."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = quantize_tree(v, bits, leaves)
        elif k in leaves:
            out[k] = fake_quant(v, bits)
        else:
            out[k] = v
    return out
