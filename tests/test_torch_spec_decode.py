"""Port parity for speculative finals on the CPU: the port's verify_step
(models/glm_asr.py) against the JAX package's, logits and cache; the plain
verify attention (ops/decode_attention.py) against JAX's masked form and,
at one query, the plain decode attention; and the port's BatchedEngine
with speculative finals on against the JAX package's, on the same scaled
tiny() f32 tree, for golden, half-golden and garbage drafts and for
drafted and undrafted requests at once: the same tokens (the sequential
greedy ones) and the same verify rounds. Then a drafted request in every
quant mode. Where a round accepts all w draft tokens the two verify
programs part: the port's draft cursor also consumes the draft's next
token, JAX's lags by one (test_verify_program_consumes_a_golden_draft)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.engine.batcher import _verify_rounds_program as _verify_rounds_program_jax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.ops.quant import quantize_params_int8 as quantize_jax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.audio.mel import frame_count
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine, _verify_rounds_program
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops.decode_attention import (
    decode_attention_plain,
    verify_attention,
    verify_attention_plain,
)
from sonicscribe_tpu_torch.vad.model import EnergyVad

SR = 16000
TOL = dict(rtol=2e-4, atol=2e-4)  # float32, different summation orders
W1 = 9  # the engine's spec_w + 1


@pytest.fixture(scope="module")
def model():
    cfg = tiny_jax()
    params_j = jax.tree.map(
        lambda x: x * 4.0, jm.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32))
    return cfg, params_j, params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")


def _cache(lens, max_len, seed):
    """A post-prefill cache [L, B, max_len, nkv, hd] of random history."""
    dec = tiny().decoder
    rng = np.random.default_rng(seed)
    shape = (dec.n_layers, len(lens), max_len, dec.n_kv_heads, dec.head_dim)
    k = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens", [
    [3, 17, 30],
    # len + W1 past max_len (writes past the end are dropped), and a full cache
    [50, 60, 63, 64],
])
def test_verify_step_matches_jax(model, lens):
    cfg, params_j, params = model
    max_len = 64
    k, v, ln = _cache(lens, max_len, seed=len(lens))
    rng = np.random.default_rng(11)
    tokens = rng.integers(5, cfg.decoder.vocab_size - 1, (len(lens), W1)).astype(np.int32)

    cache_j, logits_j = jm.verify_step(
        params_j, cfg, {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(ln)},
        jnp.asarray(tokens))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "len": torch.from_numpy(ln.copy())}
    cache, logits = tm.verify_step(params, tiny(), cache, torch.from_numpy(tokens))

    assert logits.shape == (len(lens), W1, cfg.decoder.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_array_equal(cache["len"].numpy(), ln)  # left as it was
    # K/V written at the same positions, the rest of the cache unchanged
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cache_j["k"]), **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(cache_j["v"]), **TOL)
    written = np.zeros(k.shape[1:3], bool)
    for b, L in enumerate(ln):
        written[b, L : min(L + W1, max_len)] = True
    assert (cache["k"].numpy() != k).any(axis=(0, 3, 4)).tolist() == written.tolist()


def test_verify_step_equals_sequential_greedy(model):
    """The golden draft's picks at every position are the sequential
    decode_step chain's (the port's own model)."""
    _, _, params = model
    cfg = tiny()
    k, v, ln = _cache([4, 9], 40, seed=3)
    tok0 = torch.tensor([7, 100], dtype=torch.int32)
    seq = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
           "len": torch.from_numpy(ln.copy())}
    tok, golden = tok0, []
    for _ in range(5):
        seq, logits = tm.decode_step(params, cfg, seq, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        golden.append(tok)
    golden = torch.stack(golden, dim=1)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "len": torch.from_numpy(ln.copy())}
    _, logits = tm.verify_step(params, cfg, cache, torch.cat([tok0[:, None], golden[:, :4]], 1))
    np.testing.assert_array_equal(torch.argmax(logits, dim=-1).numpy(), golden.numpy())


def _attn_inputs(lens, M, W, seed=0, nh=8, nkv=2, hd=16):
    rng = np.random.default_rng(seed)
    S = len(lens)
    q = (rng.standard_normal((S, W, nh, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((S, M, nkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((S, M, nkv, hd)) * 0.5).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("W", [1, 9])
def test_verify_attention_plain_matches_jax_masked_form(W):
    """JAX verify_step's layer body: _gqa_scores, the causal mask over
    len + j, float32 softmax, _gqa_context."""
    M = 40
    q, k, v, lens = _attn_inputs([0, 5, 30, 35, 40], M, W)
    qpos = lens[:, None] + np.arange(W)[None, :]
    valid = np.arange(M)[None, None, :] <= qpos[:, :, None]
    scores = jm._gqa_scores(jnp.asarray(q), jnp.asarray(k)) / np.sqrt(q.shape[-1])
    scores = jnp.where(jnp.asarray(valid)[:, None, None], scores, jm.NEG_INF)
    want = jm._gqa_context(jax.nn.softmax(scores, axis=-1), jnp.asarray(v))
    got = verify_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert got.shape == (len(lens), W, q.shape[2] * q.shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_verify_attention_plain_one_query_is_decode_attention():
    q, k, v, lens = (torch.from_numpy(a) for a in _attn_inputs([0, 7, 39, 40, 55], 40, 1))
    got = verify_attention_plain(q, k, v, lens)[:, 0]
    want = decode_attention_plain(q[:, 0], k, v, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------
# the batched engine, speculative on, against the JAX package's
# ---------------------------------------------------------------------


def _audio(seconds, f=300.0, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * f * t)
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def _stack(mode="native"):
    """(JAX Transcriber, port Transcriber) on the scaled tiny() f32 tree of
    test_torch_batcher, quantized in `mode` by each package."""
    params_j = jax.tree.map(lambda x: x * 4.0,
                            jm.init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32))
    cfg_j, cfg = tiny_jax(), tiny()
    if mode != "native":
        params_j = quantize_jax(params_j, decoder_only=mode != "int8")
        if mode == "int8-decoder-a8":
            from dataclasses import replace

            cfg_j = replace(cfg_j, decoder=replace(cfg_j.decoder, act_int8_decode=True))
            cfg = replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    return (TranscriberJax(cfg_j, params_j, ByteTokenizerJax(cfg_j), prefill_buckets=(64, 128)),
            Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=(64, 128)))


@pytest.fixture(scope="module")
def stack():
    return _stack()


def _both(stack, run, **kw):
    """run(engine) on a JAX BatchedEngine, then on the port's, speculative
    finals on in both (their default); each in its own event loop."""
    tr_j, tr = stack
    out = []
    for eng in (BatchedEngineJax(tr_j, EnergyVadJax(), **kw),
                BatchedEngine(tr, EnergyVad(device="cpu"), **kw)):
        assert eng.speculative and eng.spec_w == W1 - 1

        async def go(eng=eng):
            try:
                return await run(eng)
            finally:
                eng.shutdown()

        out.append(asyncio.run(go()))
    return out


def _drafts(tokens, vocab):
    tokens = np.asarray(tokens, np.int32)
    half = len(tokens) // 2
    return {
        "golden": tokens,
        "half then garbage": np.concatenate([tokens[:half], (tokens[half:] + 7) % vocab]),
        "garbage": (tokens + 11) % vocab,
    }


def test_drafted_requests_match_jax(stack):
    """One request undrafted, then with each draft: the tokens of JAX's
    engine and of the sequential Transcriber every time, and the verify
    rounds each draft took, equal to JAX's."""
    _, tr = stack
    audio = _audio(0.6, seed=3)
    golden = tr.transcribe(audio, SR, max_new_tokens=20).tokens
    vocab = tiny().decoder.vocab_size

    async def run(eng):
        base = await eng.transcribe(audio, SR, max_new_tokens=20)
        got = {"undrafted": (base.tokens, eng.stats.get("verify_rounds", 0))}
        for name, d in _drafts(base.tokens, vocab).items():
            r0 = eng.stats.get("verify_rounds", 0)
            r = await eng.transcribe(audio, SR, max_new_tokens=20, draft_tokens=d)
            got[name] = (r.tokens, eng.stats.get("verify_rounds", 0) - r0)
        return got, eng.spec_accept_ema

    (want, ema_j), (got, ema) = _both(stack, run, slots=4, max_decode_tokens=32, n_streams=2)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name][0], want[name][0], err_msg=name)
        np.testing.assert_array_equal(got[name][0], golden, err_msg=name)
        assert got[name][1] == want[name][1], (name, got[name][1], want[name][1])
    assert got["undrafted"][1] == 0 and got["golden"][1] > 0
    assert ema == pytest.approx(ema_j)


def test_drafted_and_undrafted_at_once_match_jax(stack):
    """Six requests at once on four slots, drafted and undrafted side by
    side on the same verify programs: JAX's tokens and verify rounds."""
    _, tr = stack
    vocab = tiny().decoder.vocab_size
    audios = [_audio(0.4 + 0.1 * i, f=220 + 40 * i, seed=i) for i in range(6)]
    golden = [tr.transcribe(a, SR, max_new_tokens=24).tokens for a in audios]
    kinds = ["golden", None, "half then garbage", "garbage", None, "golden"]
    drafts = [None if kind is None else _drafts(g, vocab)[kind]
              for kind, g in zip(kinds, golden)]

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=24, draft_tokens=d)
                                    for a, d in zip(audios, drafts)])
        return [r.tokens for r in rs], eng.stats.get("verify_rounds", 0)

    (want, rounds_j), (got, rounds) = _both(stack, run, slots=4, max_decode_tokens=32,
                                            n_streams=2)
    for i, (g, w, s) in enumerate(zip(got, want, golden)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, s, err_msg=f"request {i} vs sequential")
    assert rounds == rounds_j > 0


def test_spent_draft_returns_to_the_plain_ladder(stack):
    """A three-token draft is spent in one round: the slot goes back to
    the plain decode programs, as in JAX (the same rounds)."""
    _, tr = stack
    audio = _audio(0.6, seed=3)
    golden = tr.transcribe(audio, SR, max_new_tokens=20).tokens

    async def run(eng):
        r = await eng.transcribe(audio, SR, max_new_tokens=20,
                                 draft_tokens=np.asarray(golden[:3], np.int32))
        return r.tokens, eng.stats.get("verify_rounds", 0)

    (want, rounds_j), (got, rounds) = _both(stack, run, slots=4, max_decode_tokens=32,
                                            n_streams=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, golden)
    assert 0 < rounds == rounds_j <= 8


def test_acceptance_gate_closes_and_recovers(stack):
    """Garbage drafts drive spec_accept_ema under spec_accept_min: drafts
    are then received and not spent; golden ones bring it back. The EMA
    and the rounds follow JAX's."""
    _, tr = stack
    audio = _audio(0.6, seed=3)
    golden = np.asarray(tr.transcribe(audio, SR, max_new_tokens=20).tokens, np.int32)
    garbage = (golden + 11) % tiny().decoder.vocab_size

    async def run(eng):
        trace = []
        for d in [garbage] * 7 + [golden] * 5:
            r = await eng.transcribe(audio, SR, max_new_tokens=20, draft_tokens=d)
            np.testing.assert_array_equal(r.tokens, golden)
            trace.append((round(eng.spec_accept_ema, 6), eng.stats.get("verify_rounds", 0)))
        return trace

    want, got = _both(stack, run, slots=2, max_decode_tokens=32, n_streams=2)
    assert got == want
    emas = [e for e, _ in got]
    assert min(emas) < 0.35 and emas[-1] >= 0.35
    # a request admitted while the EMA is under the floor spends no round
    closed = [(r0, r) for (e0, r0), (_, r) in zip(got, got[1:]) if e0 < 0.35]
    assert closed and all(r == r0 for r0, r in closed)
    assert got[-1][1] > got[-2][1]  # reopened: the last golden draft is spent


def test_verify_program_consumes_a_golden_draft(model):
    """The verify program on a pool state whose draft is the sequential
    greedy continuation: the port's consumes it w + 1 tokens a round (18
    tokens in 2 rounds), each emitted token the greedy one. The JAX
    program emits the same tokens, but its draft cursor lags one token
    behind after a fully accepted round, so its second round rejects the
    rest of the draft and emits one token (10 in 2 rounds)."""
    cfg_j, params_j, params = model
    cfg = tiny()
    V, S, width, budget, w = cfg.decoder.vocab_size, 2, 64, 40, W1 - 1
    k, v, ln = _cache([9, 30], 96, seed=8)
    bias = np.zeros((S, V), np.float32)
    bias[:, [cfg.eos_id, cfg.pad_id]] = -1e9  # the rows run to the budget
    tok0 = np.asarray([33, 201], np.int32)
    seq = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
           "len": torch.from_numpy(ln.copy())}
    tok, golden = torch.from_numpy(tok0), []
    for _ in range(30):
        seq, logits = tm.decode_step(params, cfg, seq, tok)
        tok = torch.argmax(logits + torch.from_numpy(bias), dim=-1).to(torch.int32)
        golden.append(tok.numpy())
    golden = np.stack(golden, axis=1)  # [S, 30]: the tokens after tok0
    # no token repeats the one before it (a lagging cursor would match one)
    assert (np.diff(golden[:, : 2 * W1], axis=1) != 0).all()

    out = np.zeros((S, width), np.int32)
    out[:, 0] = tok0
    draft = np.full((S, width), cfg.pad_id, np.int32)
    draft[:, :30] = golden
    state = dict(k=k, v=v, len=ln, tok=tok0, out=out, n=np.ones(S, np.int32),
                 done=np.zeros(S, bool), bias=bias, budget=np.full(S, budget, np.int32),
                 status=np.zeros(S, np.int32), draft=draft,
                 draft_pos=np.zeros(S, np.int32), draft_len=np.full(S, 30, np.int32))
    bufs = {name: torch.from_numpy(np.array(a)) for name, a in state.items()}
    _verify_rounds_program(params, cfg, bufs, w=w, n_rounds=2)
    j = {name: jnp.asarray(a) for name, a in state.items()}
    res = _verify_rounds_program_jax(
        params_j, cfg_j, j["k"], j["v"], j["len"], j["tok"], j["out"], j["n"], j["done"],
        j["bias"], j["budget"], j["draft"], j["draft_pos"], j["draft_len"], w=w, n_rounds=2)
    out_j, n_j = np.asarray(res[4]), np.asarray(res[5])

    np.testing.assert_array_equal(bufs["n"].numpy(), [1 + 2 * W1] * S)
    np.testing.assert_array_equal(bufs["out"].numpy()[:, 1 : 1 + 2 * W1], golden[:, : 2 * W1])
    np.testing.assert_array_equal(bufs["draft_pos"].numpy(), [2 * W1] * S)
    np.testing.assert_array_equal(n_j, [1 + W1 + 1] * S)
    np.testing.assert_array_equal(out_j[:, 1 : 1 + W1 + 1], golden[:, : W1 + 1])
    # both report the draft live (status flag) only where it is: the port's
    assert (bufs["status"].numpy() > 1 << 16).all() and (np.asarray(res[8]) < 1 << 16).all()


def _drafted_at_budget_16(tr, seconds: float):
    """A request of `seconds` with a golden draft and a budget of 16, the
    width of both pools' out buffers, on an engine whose short pool fits
    a 16-token budget after the smallest prompt only. -> (the sequential
    Transcriber's tokens, the engine's, its verify rounds, the pool the
    request was routed to)."""
    audio = _audio(seconds, seed=5)
    golden = tr.transcribe(audio, SR, max_new_tokens=16).tokens
    assert len(golden) == 16  # no EOS before the budget

    async def run():
        eng = BatchedEngine(tr, EnergyVad(device="cpu"), slots=2, max_decode_tokens=16,
                            n_streams=2)
        try:
            x = tr.prepare_audio(audio, SR)
            pool = eng._pool_for(tr._pick_bucket(frame_count(int(x.shape[0]), tr.mel_cfg)), 16)
            r = await eng.transcribe(audio, SR, max_new_tokens=16,
                                     draft_tokens=np.concatenate([[0], golden]))
            return r.tokens, eng.stats["verify_rounds"], pool.name
        finally:
            eng.shutdown()

    return (golden, *asyncio.run(run()))


def test_budget_at_the_buffer_width(stack):
    """A drafted long-pool request whose budget is the whole out buffer
    (the last round's writes past the buffer land on its last column): the
    port's tokens are the sequential greedy ones, the last included. (JAX's
    verify program scatters those writes with duplicate indices, and on
    the CPU the later, unkept ones win: its last token is lost there, so
    this case is held to the sequential Transcriber only.)"""
    golden, got, rounds, pool = _drafted_at_budget_16(stack[1], 1.0)
    assert pool == "long"
    np.testing.assert_array_equal(got, golden)
    assert rounds > 0


def test_drafted_short_request_takes_the_plain_ladder(stack):
    """The short pool has no verify program: a drafted request routed there
    decodes on the plain ladder, as on a warmed JAX engine, with the
    sequential greedy tokens and no verify round."""
    golden, got, rounds, pool = _drafted_at_budget_16(stack[1], 0.6)
    assert pool == "short"
    np.testing.assert_array_equal(got, golden)
    assert rounds == 0


@pytest.mark.parametrize("mode", ["int8", "int8-decoder", "int8-decoder-a8"])
def test_drafted_request_in_each_quant_mode(mode):
    """A golden and a half-garbage draft beside an undrafted request, in a
    quant mode: JAX's tokens and verify rounds."""
    stack = _stack(mode)
    _, tr = stack
    vocab = tiny().decoder.vocab_size
    audios = [_audio(0.5, seed=21), _audio(0.7, f=450.0, seed=22), _audio(0.4, seed=23)]
    golden = [tr.transcribe(a, SR, max_new_tokens=20).tokens for a in audios]
    drafts = [_drafts(golden[0], vocab)["golden"], _drafts(golden[1], vocab)["half then garbage"],
              None]

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=20, draft_tokens=d)
                                    for a, d in zip(audios, drafts)])
        return [r.tokens for r in rs], eng.stats.get("verify_rounds", 0)

    (want, rounds_j), (got, rounds) = _both(stack, run, slots=4, max_decode_tokens=32,
                                            n_streams=2)
    for i, (g, w, s) in enumerate(zip(got, want, golden)):
        np.testing.assert_array_equal(g, w, err_msg=f"{mode} request {i}")
        np.testing.assert_array_equal(g, s, err_msg=f"{mode} request {i} vs sequential")
    assert rounds == rounds_j > 0
