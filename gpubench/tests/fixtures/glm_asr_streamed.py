"""A model family added by files alone (a test fixture, copied into
``families/`` of a copy of the benchmark): GLM-ASR's shapes and equations,
with every leaf drawn from its own seed, derived from (seed, leaf path),
and a reference that makes the decoder's float32 leaves one layer at a
time and frees each layer before it makes the next, as a family whose
model is larger than the card in float32 would."""

from __future__ import annotations

import zlib
from pathlib import Path

import torch

from gpubench import manifest
from gpubench.reference import model
from gpubench.reference.weights import layout

_BASE = manifest.family("glm_asr", Path(__file__).resolve().parents[2])
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

program_config = _BASE.program_config
check_widths = _BASE.check_widths


def leaf_seed(seed: int, path: tuple) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32("/".join(map(str, path)).encode())) % 2**63


def _draw(path, shape, kind, seed, device, dtype) -> torch.Tensor:
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)


def _per_layer(path) -> bool:
    return path[:2] == ("decoder", "layers")


def _put(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def make_weights(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The stacked tree the port reads; decoder layer i's leaf at path p is
    drawn from leaf_seed(seed, p + (i,))."""
    tree: dict = {}
    for path, shape, kind in layout(m):
        if _per_layer(path):
            value = torch.stack([_draw(path + (i,), shape[1:], kind, seed, device, dtype)
                                 for i in range(shape[0])])
        else:
            value = _draw(path, shape, kind, seed, device, dtype)
        _put(tree, path, value)
    return tree


class Reference:
    def __init__(self, cfg: dict, seed: int, device, bits=None):
        self.cfg, self.seed, self.device, self.bits = cfg, seed, device, bits
        self.dtype = _DTYPES[cfg["dtype"]]
        self.m = cfg["model"]
        rest: dict = {}
        self.layer_leaves = []
        for path, shape, kind in layout(self.m):
            if _per_layer(path):
                self.layer_leaves.append((path, shape[1:], kind))
            else:
                _put(rest, path, _draw(path, shape, kind, seed, device, self.dtype).float())
        self.W = _BASE.quantized(rest, cfg, bits)
        self.layers_made = 0

    def layers(self):
        for i in range(self.m["decoder"]["n_layers"]):
            layer = {p[-1]: _draw(p + (i,), s, k, self.seed, self.device, self.dtype).float()
                     for p, s, k in self.layer_leaves}
            self.layers_made += 1
            yield _BASE.quantized(layer, self.cfg, self.bits)
            del layer

    def served_logits(self, mel, prefix: list, suffix: list, tokens: list) -> torch.Tensor:
        return model.served_logits(self.W, self.m, mel, prefix, suffix, tokens, self.layers())


def reference(cfg: dict, seed: int, device, bits=None) -> Reference:
    return Reference(cfg, seed, device, bits)
