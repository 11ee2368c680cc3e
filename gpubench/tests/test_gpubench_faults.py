"""A whole run with the timed path broken underneath comes out not correct.

Each test drives run_cell at tiny() on the CPU (the look for a card is
run.py's, which is skipped here) with a fault planted in the port: a
served token altered where the decode program picks it (the fault a
served model's cell can have). The sound run beside it comes out correct.
"""

from __future__ import annotations

import time

import pytest

from gpubench import harness
from gpubench.tests.tiny import tiny_cell

SEED = 2**31 + 77


def _run(cell_name):
    return harness.run_cell(tiny_cell(cell_name), SEED, 3.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell_name", ["nano-bf16.files-novad", "nano-bf16.streams"])
def test_a_sound_run_is_correct(cell_name):
    res = _run(cell_name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["tokens_compared"]["value"] >= 10


@pytest.mark.parametrize("cell_name", ["nano-bf16.files-novad", "nano-bf16.streams"])
def test_a_token_altered_where_it_is_picked_is_caught(cell_name, monkeypatch):
    import torch

    from sonicscribe_tpu_torch.engine import batcher

    pick = batcher._book_step

    def altered(cfg, logits, bias, dn, tok, out, n, bud, max_new):
        # every served token of a slot's third step moves to its neighbour id
        nxt, n_new, dn_new = pick(cfg, logits, bias, dn, tok, out, n, bud, max_new)
        hit = (n_new == 3) & ~dn
        nxt2 = torch.where(hit, 7 + (nxt - 6) % (logits.shape[-1] - 7), nxt)
        pos = torch.clamp(n, max=max_new - 1).long()[:, None]
        out.scatter_(1, pos, torch.where(hit[:, None], nxt2[:, None], out.gather(1, pos)))
        return nxt2.to(nxt.dtype), n_new, dn_new

    monkeypatch.setattr(batcher, "_book_step", altered)
    res = _run(cell_name)
    assert not res["correct"]
    gap = res["checks"]["served_gap_per_tie"]
    assert gap["value"] > gap["limit"]
