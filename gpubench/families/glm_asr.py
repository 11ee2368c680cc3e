"""The GLM-ASR family: a Whisper-style encoder, the audio adapter and a GQA
decoder with a QKV bias and partial RoPE (GLM-ASR-Nano and its tiny twin).

A configuration names its family (``"family"``); the harness loads this
file by that name (``manifest.family``) and asks it for:

- ``program_config(cfg)``: the port's config object for ``cfg["spec"]``;
- ``check_widths(cfg, program_cfg)``: raises on any width that differs;
- ``make_weights(m, seed, device, dtype)``: the tree handed to the program
  (``reference/weights.py``, made on the device from the seed);
- ``reference(cfg, seed, device, bits=None)``: the plain float32 model
  (``reference/model.py``) over the same weights made again, quantized as
  the configuration states, or with `bits`, the control's precision. It
  reads nothing of the program's.
"""

from __future__ import annotations

import torch

from gpubench.reference import model
from gpubench.reference.quant import quantize_tree
from gpubench.reference.weights import QUANT_LEAVES, make_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(cfg: dict):
    """The port's preset named by the spec's first word (``nano-random``:
    ``nano()``)."""
    from sonicscribe_tpu_torch.models import config as model_configs

    return getattr(model_configs, cfg["spec"].split("-")[0])()


def check_widths(cfg: dict, program_cfg) -> None:
    """Raise unless the configuration's model widths are those of the
    program's config object for the same spec."""
    m = cfg["model"]
    enc, dec = program_cfg.encoder, program_cfg.decoder
    pairs = [(m["encoder"][k], getattr(enc, k)) for k in m["encoder"]]
    pairs += [(m["decoder"][k], getattr(dec, k)) for k in m["decoder"]]
    pairs += [(m[k], getattr(program_cfg, k)) for k in ("adapter_stack", "adapter_hidden")]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"configuration {cfg['name']} differs from the program's "
                         f"{cfg['spec']}: {bad}")


def quantized(W: dict, cfg: dict, bits=None) -> dict:
    """The float32 tree (or any subtree) `W` with its quantized leaves
    standing for their codes, as the configuration states; `bits` (the
    control) quantizes to that many bits every leaf the int8 mode
    quantizes (``QUANT_LEAVES``) instead."""
    if bits is not None:
        return quantize_tree(W, bits, QUANT_LEAVES)
    if cfg["weight_bits"] < 16:
        return quantize_tree(W, cfg["weight_bits"], tuple(cfg["quantized_leaves"]))
    return W


def reference_weights(cfg: dict, seed: int, device, bits=None) -> dict:
    """The configuration's weights from the seed, made in its dtype as the
    program's were, read as float32 and quantized (``quantized``)."""
    return quantized(_to_f32(make_weights(cfg["model"], seed, device, _DTYPES[cfg["dtype"]])),
                     cfg, bits)


def _to_f32(node):
    if isinstance(node, dict):
        return {k: _to_f32(v) for k, v in node.items()}
    return node.float()


class Reference:
    """The plain model over a whole float32 tree."""

    def __init__(self, W: dict, m: dict):
        self.W, self.m = W, m

    def served_logits(self, mel, prefix: list, suffix: list, tokens: list) -> torch.Tensor:
        return model.served_logits(self.W, self.m, mel, prefix, suffix, tokens)


def reference(cfg: dict, seed: int, device, bits=None) -> Reference:
    return Reference(reference_weights(cfg, seed, device, bits), cfg["model"])
