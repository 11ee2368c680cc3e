"""On the card: the harness's tiny run and the kernel probes (skip without one)."""

from __future__ import annotations

import time

import pytest

from gpubench import harness, probes
from gpubench.tests.tiny import tiny_cell, tiny_config


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["nano-bf16.files-novad", "nano-bf16.streams"])
def test_tiny_run_on_the_card_is_correct(card, cell_name):
    res = harness.run_cell(tiny_cell(cell_name), 2**31 + 1, 3.0, False, card,
                           time.perf_counter(), {"platform": "gpu", "kind": "", "count": 1})
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_probes_read_a_share_under_the_peak(card):
    att = probes.decode_attention(tiny_config(), {"rows": 4, "cache_len": 64, "len_lo": 8,
                                                  "len_hi": 60, "layers": 2, "reps": 5}, 3, card)
    assert 0 < att["roofline_pct"] <= 100 and att["bytes"] > 0
