"""INT8 weight-only quantization of the GLM-ASR projections.

Port of the JAX package's ``ops/quant.py`` (the reference's bitsandbytes
``Linear8bitLt`` path, backend/asr.py:169-210): every linear projection
except ``lm_head`` / ``embed_tokens`` / ``audio_proj`` becomes int8 with
per-output-channel symmetric scales.

A quantized tensor is the dict ``{"q": int8 [..., in, out], "scale":
float32 [..., 1, out]}``, the JAX layout, so a tree carries across
bit-exact. Stacked layer weights quantize per layer per output channel.
A QTensor may also carry ``"layer": i``: then q and scale are the whole
stack and the product uses layer i, read by offset inside the kernel
(the decode step's form; no slice is made).

On the card the products are the hand-written kernels of
``ops/int8_matmul.py``: no PyTorch operator takes an int8 weight against
bf16 activations, and ``x @ q.to(bf16)`` would write a bf16 copy of every
weight on every call.
"""

from __future__ import annotations

from typing import Any

import torch

from sonicscribe_tpu_torch.ops.int8_matmul import (
    div127,
    int8_matmul,
    int8_matmul_stacked,
    int8_matmul_w8a8,
)

QTensor = dict  # {"q": int8, "scale": float32[, "layer": int]}

# dict keys of projection weights that get quantized; embed / lm_head /
# adapter (audio_proj) are skipped, matching reference asr.py:176. "o_w"
# names the encoder's output projection too.
_QUANT_KEYS = {
    # decoder
    "qkv_w", "o_w", "gate_up_w", "down_w",
    # encoder
    "q_w", "k_w", "v_w", "fc1_w", "fc2_w",
}


def is_qtensor(x: Any) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8 over the input axis (axis -2):
    float32 division and round half to even, bit-exact with JAX on the CPU
    and on the card alike (IEEE divisions: div127)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = div127(torch.clamp(absmax, min=1e-8))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_tensor(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (t["q"].float() * t["scale"]).to(dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] -> contiguous [rows, K] for the kernels."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w may be a plain tensor or an int8 QTensor (W8A16: the
    product in float32, the scale after it, one cast to x.dtype). A
    QTensor with a layer goes to the stacked kernel, one without to the
    flat one."""
    if not is_qtensor(w):
        return x @ w
    if "layer" in w:
        out = int8_matmul_stacked(_rows(x), w["q"], w["scale"], w["layer"])
    else:
        out = int8_matmul(_rows(x), w["q"], w["scale"])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def matmul_w8a8(x: torch.Tensor, w, row_amax: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w with dynamic per-row int8 activations on top of the int8
    weight (s8 x s8, int32 sums, then * sx * scale). Plain tensors pass
    through to ``x @ w``, as in JAX. ``row_amax`` (float32, x.shape[:-1])
    gives each row's max|x| for its scale: a tensor-parallel rank's x at a
    row-parallel product holds its K / tp share of each row, and the row's
    scale is the JAX recipe's over the whole K only with the max over every
    rank's share (the max GSPMD takes across the "model" axis); None takes
    x's own, over its K."""
    if not is_qtensor(w):
        return x @ w
    if "layer" in w:
        q, scale, layer = w["q"], w["scale"], w["layer"]
    else:  # a stack of one
        q, scale, layer = w["q"][None], w["scale"][None], 0
    if row_amax is not None:
        if tuple(row_amax.shape) != tuple(x.shape[:-1]):
            raise ValueError(f"matmul_w8a8: row_amax must be {tuple(x.shape[:-1])} for x "
                             f"{tuple(x.shape)}, got {tuple(row_amax.shape)}")
        row_amax = row_amax.reshape(-1)
    out = int8_matmul_w8a8(_rows(x), q, scale, layer, row_amax)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def quantize_params_int8(params: dict, decoder_only: bool = False) -> dict:
    """Quantize a GLM-ASR parameter tree (returns a new tree that shares
    the unquantized leaves). decoder_only=True quantizes only the decoder
    projections ("int8-decoder" modes); full int8 also quantizes the
    encoder's q, k, v, o, fc1 and fc2 (the reference's skip-list)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        return {k: quantize_tensor(v) if k in _QUANT_KEYS and isinstance(v, torch.Tensor)
                else walk(v) for k, v in node.items()}

    if decoder_only:
        out = dict(params)
        out["decoder"] = walk(params["decoder"])
        return out
    return walk(params)
