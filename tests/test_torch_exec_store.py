"""Port parity: the transcriber's two programs (prompt, then k-step decode
chunks) vs the JAX package's one `_transcribe_program`, on tiny() f32 with
the JAX tree scaled by 4 and carried over bit-exact; and the graph router's
keying and launch-count accounting, with a fake graph."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine import transcriber as jt
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.models.tokenizer import build_prompt as build_prompt_jax
from sonicscribe_tpu_torch.engine import transcriber as tt
from sonicscribe_tpu_torch.engine.exec_store import GraphRouter
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops import _build

TOL = dict(rtol=2e-4, atol=2e-4)
BUCKET = 128
N_FRAMES = 101


@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_jax()
    params_j = jax.tree.map(
        lambda x: x * 4.0, jm.init_params(cfg_j, jax.random.PRNGKey(11), dtype=jnp.float32)
    )
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((1, BUCKET, cfg_j.encoder.n_mels)) * 0.5).astype(np.float32)
    prompt = build_prompt_jax(ByteTokenizerJax(cfg_j), cfg_j, hotwords=["tpu"])
    suffix = np.full((tt.MAX_SUFFIX_TOKENS,), cfg_j.pad_id, np.int32)
    suffix[: len(prompt.suffix_ids)] = prompt.suffix_ids
    inputs = dict(mel=mel, prefix=prompt.prefix_ids, suffix=suffix,
                  suffix_len=len(prompt.suffix_ids))
    return cfg_j, tiny(), params_j, params_t, inputs


def _jax_tokens(setup, cfg_j, bias, budget):
    _, _, params_j, _, x = setup
    toks = jt._transcribe_program(
        params_j, cfg_j, jnp.asarray(x["mel"]), jnp.asarray(N_FRAMES, jnp.int32),
        jnp.asarray(x["prefix"]), jnp.asarray(x["suffix"]),
        jnp.asarray(x["suffix_len"], jnp.int32), jnp.asarray(bias), budget,
    )
    return np.asarray(toks)[0]


def _port_tokens(setup, cfg, bias, budget, k):
    """The two programs as the transcriber runs them on the CPU (its
    _generate: static buffers, chunks of k steps, the host's read of the
    done flag after each): -> (tokens [budget], decode steps run)."""
    _, _, _, params_t, x = setup
    tr = tt.Transcriber(cfg, params_t, ByteTokenizer(cfg), prefill_buckets=(BUCKET,))
    tr._bias.copy_(torch.from_numpy(bias))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "DECODE_STEPS", k)
        return tr._generate(BUCKET, torch.from_numpy(x["mel"]), N_FRAMES, x["prefix"],
                            x["suffix"], x["suffix_len"], budget)


@pytest.fixture(scope="module")
def free_run(setup):
    """JAX tokens with no bias at the larger budget, and a position p >= 4
    whose token appears nowhere before it: made the EOS id, it stops the
    run at step p, inside a chunk."""
    cfg_j = setup[0]
    toks = _jax_tokens(setup, cfg_j, np.zeros(cfg_j.decoder.vocab_size, np.float32), 15)
    assert len(set(toks.tolist())) > 3
    p = next(i for i in range(4, 11) if toks[i] not in toks[:i])
    return toks, p


@pytest.mark.parametrize("budget", [12, 15])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("eos", ["none", "first", "mid"])
def test_programs_match_jax_transcribe_program(setup, free_run, eos, k, budget):
    cfg_j, cfg, _, _, _ = setup
    bias = np.zeros(cfg.decoder.vocab_size, np.float32)
    bias[100] = 2.0
    eos_at = {"none": None, "first": 0, "mid": free_run[1]}[eos]
    if eos == "first":
        bias[cfg.eos_id] = 1e4
    if eos == "mid":
        cfg_j = replace(cfg_j, eos_id=int(free_run[0][eos_at]))
        cfg = replace(cfg, eos_id=cfg_j.eos_id)
    want = _jax_tokens(setup, cfg_j, bias, budget)
    got, steps = _port_tokens(setup, cfg, bias, budget, k)
    np.testing.assert_array_equal(got, want)
    if eos_at is None:
        assert steps == budget and cfg.eos_id not in want
    else:  # the host stops after the chunk in which EOS was emitted
        assert want[eos_at] == cfg.eos_id and (want[eos_at + 1:] == cfg.pad_id).all()
        assert steps == min(budget, (eos_at // k + 1) * k)


def test_steps_past_the_budget_write_nothing(setup):
    """One 8-step chunk on a 5-token budget leaves the tokens of the
    5-step graph: the 3 steps past the budget write nothing."""
    _, cfg, _, params_t, _ = setup
    bias = np.zeros(cfg.decoder.vocab_size, np.float32)
    want, _ = _port_tokens(setup, cfg, bias, 5, 5)
    tr = tt.Transcriber(cfg, params_t, ByteTokenizer(cfg), prefill_buckets=(BUCKET,))
    x = setup[4]
    tr._generate(BUCKET, torch.from_numpy(x["mel"]), N_FRAMES, x["prefix"], x["suffix"],
                 x["suffix_len"], 5)
    d = tr._bufs[("decode", BUCKET, 5, len(x["prefix"]))]
    p = tr._bufs[("prompt", BUCKET, len(x["prefix"]))]
    tt.start_decode(cfg, d, tt._prompt_program(params_t, cfg, p))
    tt._decode_k_program(params_t, cfg, d, 8)
    np.testing.assert_array_equal(d["out"][0].numpy(), want)
    assert int(d["n"][0]) == 8 and len(set(want.tolist())) > 1


@pytest.mark.parametrize("n_frames", [1, 77, BUCKET])
def test_assemble_prompt_device_offset_matches_jax(setup, n_frames):
    cfg_j, cfg, params_j, params_t, x = setup
    want, want_len = jt.assemble_prompt(
        params_j, cfg_j, jnp.asarray(x["mel"]), jnp.asarray(n_frames, jnp.int32),
        jnp.asarray(x["prefix"]), jnp.asarray(x["suffix"]),
        jnp.asarray(x["suffix_len"], jnp.int32),
    )
    got, got_len = tt.assemble_prompt(
        params_t, cfg, torch.from_numpy(x["mel"]),
        torch.tensor([n_frames], dtype=torch.int32), torch.from_numpy(x["prefix"]),
        torch.from_numpy(x["suffix"]), torch.tensor([x["suffix_len"]], dtype=torch.int32),
    )
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [3, 8])
def test_transcriber_tokens_do_not_depend_on_k(setup, k, monkeypatch):
    _, cfg, _, params_t, _ = setup
    tr = tt.Transcriber(cfg, params_t, ByteTokenizer(cfg), prefill_buckets=(128, 256))
    rng = np.random.default_rng(5)
    audio = (0.3 * np.sin(np.arange(17000) / 9.0) + 0.01 * rng.standard_normal(17000))
    want = tr.transcribe(audio.astype(np.float32), 16000, max_new_tokens=13)
    monkeypatch.setattr(tt, "DECODE_STEPS", k)
    got = tr.transcribe(audio.astype(np.float32), 16000, max_new_tokens=13)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert tr.stats["decode_steps"] == 2 * 13
    assert 2 * len(want.tokens) <= tr.stats["tokens"] <= 2 * 13
    assert tr.router.stats["graphs"] == 0  # the CPU runs the programs eagerly


@pytest.mark.parametrize("budget,k,want", [(15, 8, [8, 7]), (16, 8, [8, 8]), (5, 8, [5]),
                                           (12, 1, [1] * 12), (12, 5, [5, 5, 2])])
def test_chunk_sizes(budget, k, want):
    assert tt.chunk_sizes(budget, k) == want


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class FakeRouter(GraphRouter):
    """A router for the card whose warm-up and recording run the program
    on the CPU and whose graph only counts its replays."""

    def _warm(self, program, bufs):
        program({k: v.clone() for k, v in bufs.items()})

    def _record(self, program, bufs):
        return FakeGraph(), program(bufs)


def _fake_program(scale):
    def program(bufs):  # the launches a captured step would count
        _build.launch_counts["decode_attention"] += 2 * scale
        _build.launch_counts["int8_matmul_stacked"] += scale
        return {"y": bufs["x"] * scale}
    return program


@pytest.fixture
def counts():
    _build.reset_launch_counts()
    yield _build.launch_counts
    _build.reset_launch_counts()


def test_router_adds_a_captures_launches_once_per_replay(counts):
    router = FakeRouter(torch.device("cuda"))
    bufs = {"x": torch.ones(3)}
    a = router.prepare(("decode", 128, 15, 8, 3), _fake_program(1), bufs)
    assert counts["decode_attention"] == 0 and counts["int8_matmul_stacked"] == 0
    assert a.launches == {"decode_attention": 2, "int8_matmul_stacked": 1}
    assert a.graph.replays == 1  # prepare's replay: uncounted
    for _ in range(3):
        out = router.run(("decode", 128, 15, 8, 3), _fake_program(1), bufs)
    assert out is a.outputs and a.graph.replays == 4
    assert counts["decode_attention"] == 6 and counts["int8_matmul_stacked"] == 3
    # another key, captured by run: its own capture, its own launches, one replay
    router.run(("decode", 128, 15, 7, 3), _fake_program(5), bufs)
    b = router.entries[("decode", 128, 15, 7, 3)]
    assert b is not a and b.graph.replays == 1 and a.graph.replays == 4
    assert counts["decode_attention"] == 16 and counts["int8_matmul_stacked"] == 8
    assert router.stats["graphs"] == 2 and router.stats["replays"] == 4
    assert set(router.stats["capture_s"]) == {("decode", 128, 15, 8, 3), ("decode", 128, 15, 7, 3)}
    assert router.prepare(("decode", 128, 15, 8, 3), _fake_program(9), bufs) is a
    assert a.graph.replays == 4 and router.stats["graphs"] == 2


def test_router_on_the_cpu_runs_the_program_each_time(counts):
    router = GraphRouter(torch.device("cpu"))
    bufs = {"x": torch.ones(3)}
    for _ in range(2):
        out = router.run(("prompt", 128, 3), _fake_program(2), bufs)
    np.testing.assert_array_equal(out["y"].numpy(), [2.0, 2.0, 2.0])
    assert counts["decode_attention"] == 8 and counts["int8_matmul_stacked"] == 4
    assert router.prepare(("prompt", 128, 3), _fake_program(2), bufs) is None
    assert router.stats["graphs"] == 0 and router.entries == {}
