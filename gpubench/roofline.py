"""The yardstick's peaks and the operations and bytes of the work it counts.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3. A share is
stated against them with the card's power limit beside it.

Bytes follow one rule: each input byte read once, each output byte
written once, whatever the kernel reads again. Operations count 2 per
weight a token passes through; attention's terms that grow with length
are left out, so a count never exceeds the work done.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def encoder_flops(m: dict, frames: int) -> float:
    """Weight FLOPs of the encoder and adapter over `frames` true mel frames."""
    enc = m["encoder"]
    d, f = enc["d_model"], enc["ffn_mult"] * enc["d_model"]
    positions = (frames + 1) // 2
    tokens = max(1, frames // (2 * m["adapter_stack"]))
    conv = frames * 3 * enc["n_mels"] * d + positions * 3 * d * d
    layers = positions * enc["n_layers"] * (4 * d * d + 2 * d * f)
    adapter = tokens * (m["adapter_stack"] * d * m["adapter_hidden"]
                        + m["adapter_hidden"] * m["decoder"]["d_model"])
    return 2.0 * (conv + layers + adapter)


def decoder_weights_per_token(m: dict) -> int:
    """Weights one token passes through in the decoder's layers."""
    dec = m["decoder"]
    dd, hd = dec["d_model"], dec["head_dim"]
    qkv = dd * (dec["n_heads"] + 2 * dec["n_kv_heads"]) * hd
    o = dec["n_heads"] * hd * dd
    mlp = dd * 2 * dec["ffn_hidden"] + dec["ffn_hidden"] * dd
    return dec["n_layers"] * (qkv + o + mlp)


def decoder_flops(m: dict, prompt_tokens: int, decoded_tokens: int) -> float:
    """Weight FLOPs of a prompt's prefill and `decoded_tokens` decode steps:
    every position through the layers, the vocabulary product for the
    prompt's last position and for each decoded one but the last."""
    head = m["decoder"]["d_model"] * m["decoder"]["vocab_size"]
    per = decoder_weights_per_token(m)
    positions = prompt_tokens + max(decoded_tokens - 1, 0)
    return 2.0 * (positions * per + max(decoded_tokens, 1) * head)


def decode_attention_bytes(rows: int, lens, n_heads: int, n_kv: int, head_dim: int,
                           elem: int = 2, out_elem: int = 2) -> int:
    """One decode-attention call: q, each row's K and V up to and including
    its position (len + 1 rows of the cache), the output."""
    kv = sum(2 * (int(n) + 1) * n_kv * head_dim * elem for n in lens)
    return rows * n_heads * head_dim * (elem + out_elem) + kv

