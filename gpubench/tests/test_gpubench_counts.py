"""FLOP and byte counts against counts by hand at the port's tiny() size."""

from __future__ import annotations

import pytest

from gpubench import roofline
from gpubench.tests.tiny import TINY_MODEL


def test_encoder_flops_by_hand():
    # tiny: n_mels 128, d 64, ffn 256, 2 layers, adapter 4 x 64 -> 128 -> 128
    frames = 100
    positions, tokens = 50, 12
    conv = frames * 3 * 128 * 64 + positions * 3 * 64 * 64
    layers = positions * 2 * (4 * 64 * 64 + 2 * 64 * 256)
    adapter = tokens * (256 * 128 + 128 * 128)
    assert roofline.encoder_flops(TINY_MODEL, frames) == 2.0 * (conv + layers + adapter)


def test_decoder_flops_by_hand():
    # tiny: d 128, 4 q / 2 kv heads of 32, ffn 256, 2 layers, vocab 384
    per_layer = 128 * (4 + 4) * 32 + 4 * 32 * 128 + 128 * 512 + 256 * 128
    assert roofline.decoder_weights_per_token(TINY_MODEL) == 2 * per_layer
    prompt, decoded = 40, 10
    expect = 2.0 * ((prompt + decoded - 1) * 2 * per_layer + decoded * 128 * 384)
    assert roofline.decoder_flops(TINY_MODEL, prompt, decoded) == expect


def test_decode_attention_bytes_by_hand():
    # 2 rows at lengths 5 and 9 (6 and 10 cache rows read), 4 q / 2 kv heads of 32
    kv = (6 + 10) * 2 * 2 * 32 * 2
    q_out = 2 * 4 * 32 * (2 + 4)
    assert roofline.decode_attention_bytes(2, [5, 9], 4, 2, 32, 2, 4) == kv + q_out


def test_the_nano_step_flops_match_the_published_arithmetic():
    nano = {"decoder": {"d_model": 2048, "n_layers": 28, "n_heads": 16, "n_kv_heads": 4,
                        "head_dim": 128, "ffn_hidden": 5504, "vocab_size": 59520}}
    per_token = roofline.decoder_flops(nano, 1, 1)
    assert per_token == pytest.approx(2.725e9, rel=0.01)
