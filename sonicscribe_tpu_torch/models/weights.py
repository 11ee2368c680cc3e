"""Parameter trees: carried over from JAX, loaded from a checkpoint, or
random.

The tree has the JAX package's layout (models/glm_asr.py:init_params):
{"encoder", "adapter", "decoder"} with stacked layer weights, every leaf a
tensor; an int8 projection is a QTensor dict {"q", "scale"}
(ops/quant.py).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.models.config import (
    AudioEncoderConfig,
    DecoderConfig,
    GlmAsrConfig,
)
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer, HFTokenizer

NATIVE_CONFIG = "sonicscribe_config.json"
NATIVE_PARAMS = "params.npz"


def _leaf_from_numpy(v: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor with the same bits; bfloat16 (numpy's ml_dtypes
    type, or a uint16 view of it) via an int16 view."""
    if v.dtype.name == "bfloat16":
        v = v.view(np.uint16)
    v = np.array(v)  # a writable, contiguous copy
    if v.dtype == np.uint16:
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def params_from_jax(tree, device=None) -> dict:
    """A JAX parameter tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``), quantized or not -> the port's tree on `device` (as in
    device.resolve_device: the card unless 'cpu' is asked for), every leaf
    bit-exact."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_from_numpy(np.asarray(node)).to(device)

    return walk(tree)


def _unflatten(flat: dict) -> dict:
    """{"a/b/0/c": leaf} -> nested dicts, integer-keyed levels as lists
    (the inverse of the JAX package's tools/convert_weights.py:_flatten)."""
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [fix(node[k]) for k in sorted(node, key=int)]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _cfg_from_dict(d: dict) -> GlmAsrConfig:
    d = dict(d)
    enc = AudioEncoderConfig(**d.pop("encoder"))
    dec = DecoderConfig(**d.pop("decoder"))
    return GlmAsrConfig(encoder=enc, decoder=dec, **d)


def load_checkpoint(path: str, device=None):
    """A native checkpoint directory (``sonicscribe_config.json`` +
    ``params.npz``, written by tools/convert_weights.py:save_checkpoint or
    the JAX package's) -> (cfg, params on `device`,
    tokenizer). bfloat16 leaves are stored there as uint16 views; an int8
    checkpoint (written after ``--int8``) stores each quantized projection
    as ``…/q`` int8 and ``…/scale`` float32, which become QTensor dicts."""
    device = resolve_device(device)
    cfg_path = os.path.join(path, NATIVE_CONFIG)
    if not os.path.exists(cfg_path):
        if os.path.isdir(path) and any(
            f == "config.json" or f.endswith((".safetensors", ".bin")) for f in os.listdir(path)
        ):
            raise FileNotFoundError(
                f"no {NATIVE_CONFIG} in '{path}': it looks like an HF checkpoint; convert "
                f"it first: python -m sonicscribe_tpu_torch.tools.convert_weights {path} <out_dir>"
            )
        raise FileNotFoundError(f"no {NATIVE_CONFIG} in '{path}'")
    with open(cfg_path) as f:
        meta = json.load(f)
    if meta.get("format") == "orbax":
        raise ValueError(f"'{path}' is an orbax checkpoint; only npz is read here")
    cfg = _cfg_from_dict(meta["model_config"])
    dtypes = meta.get("dtypes", {})
    flat = {}
    with np.load(os.path.join(path, NATIVE_PARAMS)) as z:
        for k in z.files:
            v = z[k]
            if dtypes.get(k) == "bfloat16":
                v = v.view(np.uint16)
            flat[k] = _leaf_from_numpy(v).to(device)
    params = _unflatten(flat)

    tok_dir = os.path.join(path, "tokenizer")
    tokenizer = HFTokenizer(tok_dir) if os.path.isdir(tok_dir) else ByteTokenizer(cfg)
    return cfg, params, tokenizer


def init_random(
    cfg: GlmAsrConfig, seed: int = 0, dtype=torch.bfloat16, device=None
) -> dict:
    """Random parameters with the JAX package's init_params shapes and
    scales (normal * 0.02 for projections and embeddings, zero biases, unit
    norm scales), drawn on `device` from a torch.Generator seeded with
    `seed`. JAX's PRNGKey bits cannot be reproduced in torch, so these are
    not the JAX package's numbers for the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    enc, dec = cfg.encoder, cfg.decoder
    d, L = enc.d_model, enc.n_layers
    encoder = {
        "conv1": {"w": dense(3, enc.n_mels, d), "b": zeros(d)},
        "conv2": {"w": dense(3, d, d), "b": zeros(d)},
        "layers": {
            "ln1_scale": ones(L, d),
            "ln1_bias": zeros(L, d),
            "q_w": dense(L, d, d),
            "q_b": zeros(L, d),
            "k_w": dense(L, d, d),
            "v_w": dense(L, d, d),
            "v_b": zeros(L, d),
            "o_w": dense(L, d, d),
            "o_b": zeros(L, d),
            "ln2_scale": ones(L, d),
            "ln2_bias": zeros(L, d),
            "fc1_w": dense(L, d, enc.ffn_mult * d),
            "fc1_b": zeros(L, enc.ffn_mult * d),
            "fc2_w": dense(L, enc.ffn_mult * d, d),
            "fc2_b": zeros(L, d),
        },
        "ln_post_scale": ones(d),
        "ln_post_bias": zeros(d),
    }
    adapter = {
        "fc1": {"w": dense(cfg.adapter_stack * d, cfg.adapter_hidden),
                "b": zeros(cfg.adapter_hidden)},
        "fc2": {"w": dense(cfg.adapter_hidden, dec.d_model), "b": zeros(dec.d_model)},
    }
    dd, Ld = dec.d_model, dec.n_layers
    qkv_out = (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim
    decoder = {
        "embed": dense(dec.vocab_size, dd),
        "layers": {
            "ln1_scale": ones(Ld, dd),
            "qkv_w": dense(Ld, dd, qkv_out),
            "qkv_b": zeros(Ld, qkv_out),
            "o_w": dense(Ld, dec.n_heads * dec.head_dim, dd),
            "ln2_scale": ones(Ld, dd),
            "gate_up_w": dense(Ld, dd, 2 * dec.ffn_hidden),
            "down_w": dense(Ld, dec.ffn_hidden, dd),
        },
        "ln_f_scale": ones(dd),
    }
    if not dec.tie_embeddings:
        decoder["lm_head"] = dense(dd, dec.vocab_size)
    return {"encoder": encoder, "adapter": adapter, "decoder": decoder}
