"""Port parity: the PyTorch GLM-ASR model vs the JAX package on tiny() f32,
with the JAX parameter tree carried over bit-exact. Hidden states and
logits within 2e-4 (float32, different summation orders); greedy tokens
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.weights import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = tiny_jax(), tiny()
    # scaled so greedy tokens vary (at init scale it repeats one token)
    params_j = jax.tree.map(
        lambda x: x * 4.0, jm.init_params(cfg_j, jax.random.PRNGKey(7), dtype=jnp.float32)
    )
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def params_to_numpy(tree):
    """Tensor tree -> numpy, bfloat16 leaves as their uint16 bit patterns."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(np.uint16)
    return tree.numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bit_exact(dtype):
    params_j = jax.tree.map(
        np.asarray, jm.init_params(tiny_jax(), jax.random.PRNGKey(3), dtype=dtype)
    )
    params_t = params_from_jax(params_j, device="cpu")
    back = dict(_leaves(params_to_numpy(params_t)))
    want = dict(_leaves(params_j))
    assert back.keys() == want.keys()
    for name, w in want.items():
        t = dict(_leaves(params_t))[name]
        assert tuple(t.shape) == w.shape, name
        assert t.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        bits = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(back[name], bits, err_msg=name)


def test_load_native_checkpoint_bit_exact(tmp_path):
    """A bf16 checkpoint written by the JAX package's save_checkpoint."""
    from sonicscribe_tpu.tools.convert_weights import save_checkpoint
    from sonicscribe_tpu_torch.models.weights import load_checkpoint

    cfg_j = tiny_jax()
    params_j = jm.init_params(cfg_j, jax.random.PRNGKey(5), dtype=jnp.bfloat16)
    save_checkpoint(params_j, cfg_j, str(tmp_path))
    cfg, params, tok = load_checkpoint(str(tmp_path), device="cpu")
    assert cfg == tiny() and tok.vocab_size == 263
    got = dict(_leaves(params_to_numpy(params)))
    for name, w in _leaves(jax.tree.map(np.asarray, params_j)):
        np.testing.assert_array_equal(got[name], w.view(np.uint16), err_msg=name)

    from sonicscribe_tpu.ops.quant import quantize_params_int8

    qparams_j = quantize_params_int8(params_j)
    save_checkpoint(qparams_j, cfg_j, str(tmp_path / "int8"))
    _, qparams, _ = load_checkpoint(str(tmp_path / "int8"), device="cpu")
    got = dict(_leaves(params_to_numpy(qparams)))
    want = dict(_leaves(jax.tree.map(np.asarray, qparams_j)))
    assert got.keys() == want.keys()
    assert got["/decoder/layers/qkv_w/q"].dtype == np.int8
    for name, w in want.items():
        bits = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(got[name], bits, err_msg=name)


def test_encode_audio(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 128, 128)).astype(np.float32) * 0.5
    n_frames = np.asarray([128, 77], np.int32)
    want, n_want = jm.encode_audio(params_j, cfg_j, jnp.asarray(mel), jnp.asarray(n_frames))
    got, n_got = tm.encode_audio(params_t, cfg_t, torch.from_numpy(mel), torch.from_numpy(n_frames))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prompt(cfg, B=2, S=10, seed=1):
    rng = np.random.default_rng(seed)
    embeds = (rng.standard_normal((B, S, cfg.decoder.d_model)) * 0.5).astype(np.float32)
    return embeds, np.asarray([S, 7][:B], np.int32)


def test_prefill_logits(setup):
    cfg_j, cfg_t, params_j, params_t = setup
    embeds, length = _prompt(cfg_t)
    cache_j = jm.init_cache(cfg_j, 2, 16, dtype=jnp.float32)
    cache_j, want = jm.prefill(params_j, cfg_j, jnp.asarray(embeds), jnp.asarray(length), cache_j)
    cache_t = tm.init_cache(cfg_t, 2, 16, dtype=torch.float32)
    cache_t, got = tm.prefill(
        params_t, cfg_t, torch.from_numpy(embeds), torch.from_numpy(length), cache_t
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]), **TOL)
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_j["len"]))


def test_decode_step_logits_six_steps(setup):
    """Row 0 fills its cache after 3 steps (len == max_len: writes dropped
    from then on); row 1 is inactive on steps 1 and 3."""
    cfg_j, cfg_t, params_j, params_t = setup
    embeds, length = _prompt(cfg_t)
    max_len = embeds.shape[1] + 3
    cache_j = jm.init_cache(cfg_j, 2, max_len, dtype=jnp.float32)
    cache_j, _ = jm.prefill(params_j, cfg_j, jnp.asarray(embeds), jnp.asarray(length), cache_j)
    cache_t = tm.init_cache(cfg_t, 2, max_len, dtype=torch.float32)
    cache_t, _ = tm.prefill(
        params_t, cfg_t, torch.from_numpy(embeds), torch.from_numpy(length), cache_t
    )
    rng = np.random.default_rng(2)
    for step in range(6):
        tokens = rng.integers(0, cfg_t.decoder.vocab_size, size=2).astype(np.int32)
        active = np.asarray([True, step not in (1, 3)])
        cache_j, want = jm.decode_step(
            params_j, cfg_j, cache_j, jnp.asarray(tokens), active=jnp.asarray(active)
        )
        cache_t, got = tm.decode_step(
            params_t, cfg_t, cache_t, torch.from_numpy(tokens), active=torch.from_numpy(active)
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step}", **TOL)
        np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_j["len"]))
    assert int(cache_t["len"][0]) == max_len
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]), **TOL)
    np.testing.assert_allclose(cache_t["v"].numpy(), np.asarray(cache_j["v"]), **TOL)


@pytest.mark.parametrize("eos_bias", [0.0, 1e4])
def test_greedy_generate_token_exact(setup, eos_bias):
    """eos_bias 1e4 makes EOS the first token: the port stops at once, JAX
    runs on emitting pads, and the tokens still agree."""
    cfg_j, cfg_t, params_j, params_t = setup
    embeds, length = _prompt(cfg_t, seed=4)
    bias = np.zeros(cfg_t.decoder.vocab_size, np.float32)
    bias[cfg_t.eos_id] = eos_bias
    bias[100] = 2.0
    want = jm.greedy_generate(
        params_j, cfg_j, jnp.asarray(embeds), jnp.asarray(length), 12,
        logit_bias=jnp.asarray(bias),
    )
    got, steps = tm.greedy_generate(
        params_t, cfg_t, torch.from_numpy(embeds), torch.from_numpy(length), 12,
        logit_bias=torch.from_numpy(bias),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not eos_bias:
        assert len(set(np.asarray(want).ravel().tolist())) > 3
    assert steps == (0 if eos_bias else 11)


def test_decode_step_dual_matches_jax_and_single(setup):
    """decode_step_dual on two caches of different lengths and rows (the
    batcher's short and long pools): logits and caches within 2e-4 of the
    JAX package's decode_step_dual and len equal, five steps, cache a's row
    0 full after three (writes dropped), a row of each inactive on some
    steps; and equal to the port's decode_step run once per cache."""
    cfg_j, cfg_t, params_j, params_t = setup
    rng = np.random.default_rng(11)
    ea, la = _prompt(cfg_t, B=2, S=8, seed=5)
    eb = (rng.standard_normal((3, 14, cfg_t.decoder.d_model)) * 0.5).astype(np.float32)
    lb = np.asarray([14, 9, 3], np.int32)
    caches_j, caches_t = [], []
    for embeds, length, max_len in ((ea, la, ea.shape[1] + 3), (eb, lb, 24)):
        c_j = jm.init_cache(cfg_j, len(length), max_len, dtype=jnp.float32)
        c_j, _ = jm.prefill(params_j, cfg_j, jnp.asarray(embeds), jnp.asarray(length), c_j)
        c_t = tm.init_cache(cfg_t, len(length), max_len, dtype=torch.float32)
        tm.prefill(params_t, cfg_t, torch.from_numpy(embeds), torch.from_numpy(length), c_t)
        caches_j.append(c_j)
        caches_t.append(c_t)
    singles = [{k: v.clone() for k, v in c.items()} for c in caches_t]
    ca_j, cb_j = caches_j
    ca_t, cb_t = caches_t
    for step in range(5):
        ta = rng.integers(0, cfg_t.decoder.vocab_size, size=2).astype(np.int32)
        tb = rng.integers(0, cfg_t.decoder.vocab_size, size=3).astype(np.int32)
        act_a = np.asarray([True, step != 1])
        act_b = np.asarray([step not in (0, 3), True, True])
        ca_j, want_a, cb_j, want_b = jm.decode_step_dual(
            params_j, cfg_j, ca_j, jnp.asarray(ta), cb_j, jnp.asarray(tb),
            active_a=jnp.asarray(act_a), active_b=jnp.asarray(act_b))
        _, got_a, _, got_b = tm.decode_step_dual(
            params_t, cfg_t, ca_t, torch.from_numpy(ta), cb_t, torch.from_numpy(tb),
            active_a=torch.from_numpy(act_a), active_b=torch.from_numpy(act_b))
        _, one_a = tm.decode_step(params_t, cfg_t, singles[0], torch.from_numpy(ta),
                                  active=torch.from_numpy(act_a))
        _, one_b = tm.decode_step(params_t, cfg_t, singles[1], torch.from_numpy(tb),
                                  active=torch.from_numpy(act_b))
        for got, want, one, name in ((got_a, want_a, one_a, "a"), (got_b, want_b, one_b, "b")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"step {step} {name}", **TOL)
            np.testing.assert_allclose(got.numpy(), one.numpy(),
                                       err_msg=f"step {step} {name} single", **TOL)
    assert int(ca_t["len"][0]) == ea.shape[1] + 3
    for c_t, c_j, single in ((ca_t, ca_j, singles[0]), (cb_t, cb_j, singles[1])):
        np.testing.assert_array_equal(c_t["len"].numpy(), np.asarray(c_j["len"]))
        np.testing.assert_array_equal(c_t["len"].numpy(), single["len"].numpy())
        for key in ("k", "v"):
            np.testing.assert_allclose(c_t[key].numpy(), np.asarray(c_j[key]), **TOL)
            np.testing.assert_allclose(c_t[key].numpy(), single[key].numpy(), **TOL)
