"""The benchmark's weights, made from the seed on the device.

Both sides take these: the harness hands the tree to the system under
test, and the reference makes it again from the same seed after the
window. The tree has the layout the port's model reads (stacked layers on
a leading axis, conv weights [K, C_in, C_out]); every dense leaf is normal
x 0.02, biases zero, norm scales one.

Dense leaves are drawn in two large calls, one per group: the projections
that an int8 configuration quantizes (``QUANT_LEAVES``) and the rest, so
that quantizing can free the first group whole. Each leaf is a view of its
group's buffer.
"""

from __future__ import annotations

import torch

# the projections the reference's int8 mode quantizes: every linear but
# lm_head, embed_tokens and audio_proj (the adapter)
QUANT_LEAVES = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
                "qkv_w", "gate_up_w", "down_w")


def layout(m: dict) -> list:
    """-> [(path, shape, kind)] of the tree for the model dict `m` of a
    configuration file; kind "dense" | "zeros" | "ones"."""
    enc, dec = m["encoder"], m["decoder"]
    d, L, f = enc["d_model"], enc["n_layers"], enc["ffn_mult"] * enc["d_model"]
    dd, Ld = dec["d_model"], dec["n_layers"]
    qkv = (dec["n_heads"] + 2 * dec["n_kv_heads"]) * dec["head_dim"]
    out = [
        (("encoder", "conv1", "w"), (3, enc["n_mels"], d), "dense"),
        (("encoder", "conv1", "b"), (d,), "zeros"),
        (("encoder", "conv2", "w"), (3, d, d), "dense"),
        (("encoder", "conv2", "b"), (d,), "zeros"),
    ]
    for name, shape, kind in (
        ("ln1_scale", (L, d), "ones"), ("ln1_bias", (L, d), "zeros"),
        ("q_w", (L, d, d), "dense"), ("q_b", (L, d), "zeros"),
        ("k_w", (L, d, d), "dense"),
        ("v_w", (L, d, d), "dense"), ("v_b", (L, d), "zeros"),
        ("o_w", (L, d, d), "dense"), ("o_b", (L, d), "zeros"),
        ("ln2_scale", (L, d), "ones"), ("ln2_bias", (L, d), "zeros"),
        ("fc1_w", (L, d, f), "dense"), ("fc1_b", (L, f), "zeros"),
        ("fc2_w", (L, f, d), "dense"), ("fc2_b", (L, d), "zeros"),
    ):
        out.append((("encoder", "layers", name), shape, kind))
    out += [
        (("encoder", "ln_post_scale"), (d,), "ones"),
        (("encoder", "ln_post_bias"), (d,), "zeros"),
        (("adapter", "fc1", "w"), (m["adapter_stack"] * d, m["adapter_hidden"]), "dense"),
        (("adapter", "fc1", "b"), (m["adapter_hidden"],), "zeros"),
        (("adapter", "fc2", "w"), (m["adapter_hidden"], dd), "dense"),
        (("adapter", "fc2", "b"), (dd,), "zeros"),
        (("decoder", "embed"), (dec["vocab_size"], dd), "dense"),
    ]
    for name, shape, kind in (
        ("ln1_scale", (Ld, dd), "ones"),
        ("qkv_w", (Ld, dd, qkv), "dense"), ("qkv_b", (Ld, qkv), "zeros"),
        ("o_w", (Ld, dec["n_heads"] * dec["head_dim"], dd), "dense"),
        ("ln2_scale", (Ld, dd), "ones"),
        ("gate_up_w", (Ld, dd, 2 * dec["ffn_hidden"]), "dense"),
        ("down_w", (Ld, dec["ffn_hidden"], dd), "dense"),
    ):
        out.append((("decoder", "layers", name), shape, kind))
    out.append((("decoder", "ln_f_scale"), (dd,), "ones"))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The tree for model dict `m`, drawn from `seed` by a torch.Generator
    on `device`, in `dtype`: the same numbers for the same seed, device
    and dtype."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = layout(m)
    tree: dict = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for quant in (False, True):
        group = [(p, s) for p, s, k in leaves
                 if k == "dense" and (p[-1] in QUANT_LEAVES) == quant]
        buf = torch.randn(sum(_numel(s) for _, s in group), generator=gen, device=device,
                          dtype=dtype)
        buf.mul_(0.02)
        at = 0
        for path, shape in group:
            n = _numel(shape)
            put(path, buf[at : at + n].view(shape))
            at += n
    for path, shape, kind in leaves:
        if kind == "zeros":
            put(path, torch.zeros(shape, dtype=dtype, device=device))
        elif kind == "ones":
            put(path, torch.ones(shape, dtype=dtype, device=device))
    return tree
