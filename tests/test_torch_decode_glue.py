"""The decode family's fused glue (ops/decode_glue.py) on the CPU, where its
plain versions run: each against the PyTorch glue it replaces and against
the JAX package's `_rms_norm`, `_apply_rope`, `jax.nn.silu` and in-scan
K/V write (`.at[...].set(mode="drop")`), tiny float32. The steps that call
it (decode, dual decode, verify) are held to JAX in test_torch_model.py
and test_torch_spec_decode.py; here their calls are counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models.config import tiny
from sonicscribe_tpu_torch.models.weights import init_random
from sonicscribe_tpu_torch.ops import _build
from sonicscribe_tpu_torch.ops import decode_glue as dg

NKV, HD, NH, ROT = 2, 32, 4, 16  # tiny's decoder heads; rot as partial_rotary_factor 0.5
N = (NH + 2 * NKV) * HD
EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rope_tables(pos):
    """cos, sin float32 [..., ROT // 2] of positions pos (numpy int)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, ROT, 2, dtype=np.float32) / ROT))
    ang = np.asarray(pos, np.float32)[..., None] * inv
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _old_decode_write(k_new, v_new, k_cache, v_cache, pos):
    """The glue decode_step ran before the fusion: rows past the end rewrite
    their own last entry with its old value."""
    M = k_cache.shape[1]
    rows = torch.arange(pos.shape[0])
    at = torch.clamp(pos.long(), max=M - 1)
    keep = (pos < M)[:, None, None]
    k_cache[rows, at] = torch.where(keep, k_new.to(k_cache.dtype), k_cache[rows, at])
    v_cache[rows, at] = torch.where(keep, v_new.to(v_cache.dtype), v_cache[rows, at])


def _old_verify_write(k_new, v_new, k_cache, v_cache, pos0):
    """The glue verify_step ran before the fusion: writes past the end aimed
    at M - 1, each carrying the value the row's in-range write puts there."""
    B, W1 = k_new.shape[:2]
    M = k_cache.shape[1]
    j_idx = torch.arange(W1)
    qpos = pos0.long()[:, None] + j_idx[None, :]
    rows = torch.arange(B)[:, None]
    at = torch.clamp(qpos, max=M - 1)
    j_last = torch.clamp(M - 1 - pos0.long(), 0, W1 - 1)
    src = torch.where(qpos < M, j_idx[None, :], j_last[:, None])
    src = src[:, :, None, None].expand(B, W1, NKV, HD)
    full = (pos0 >= M)[:, None, None, None]
    k_cache[rows, at] = torch.where(full, k_cache[rows, at], k_new.to(k_cache.dtype).gather(1, src))
    v_cache[rows, at] = torch.where(full, v_cache[rows, at], v_new.to(v_cache.dtype).gather(1, src))


@pytest.mark.parametrize("lead", [(5,), (3, 4)])
@pytest.mark.parametrize("with_delta", [True, False], ids=["add", "layer0"])
def test_add_rms_norm_plain(lead, with_delta):
    """h + delta, then RMSNorm: the glue's `h + delta` and `_rms_norm` bit
    for bit, JAX's `_rms_norm` of the same sum within float32 rounding;
    with no delta (layer 0's ln1) h_new is h itself."""
    rng = np.random.default_rng(1)
    D = 128
    h = _t(rng.standard_normal((*lead, D)))
    delta = _t(rng.standard_normal((*lead, D))) if with_delta else None
    scale = _t(1 + 0.1 * rng.standard_normal(D))
    h_new, hn = dg.add_rms_norm(h, delta, scale, EPS)
    want_h = h + delta if with_delta else h
    if not with_delta:
        assert h_new is h
    assert torch.equal(h_new, want_h)
    assert torch.equal(hn, tm._rms_norm(want_h, scale, EPS))
    jax_hn = np.asarray(jm._rms_norm(jnp.asarray(want_h.numpy()), jnp.asarray(scale.numpy()), EPS))
    np.testing.assert_allclose(hn.numpy(), jax_hn, rtol=1e-6, atol=1e-6)


def _qkv_case(rng, B, W1, M, pos, bias: bool, pool_rows: int):
    qkv = _t(rng.standard_normal((B, W1, N)))
    b = _t(rng.standard_normal(N)) if bias else None
    cos, sin = _rope_tables(np.asarray(pos)[:, None] + np.arange(W1)[None])
    # one layer of a [L, pool_rows, M, nkv, hd] pool buffer, its first B rows
    pool = {k: _t(rng.standard_normal((2, pool_rows, M, NKV, HD))) for k in "kv"}
    return qkv, b, _t(cos), _t(sin), pool, torch.tensor(pos, dtype=torch.int32)


# (B, W1, M, pos): decode rows (one at the end, dropped), verify rows with
# W1 > 1 (one crossing the end, one past it)
QKV_CASES = {
    "decode": (4, 1, 12, [0, 5, 11, 12]),
    "verify": (4, 3, 12, [0, 6, 10, 12]),
    "full": (2, 1, 8, [8, 8]),
}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("pool_rows", [None, 7], ids=["whole", "strided"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_qkv_rope_kv_write_plain(case, pool_rows, bias):
    """The fused QKV bias, RoPE and K/V write against the glue it replaces
    (bias add, `_apply_rope`, the clamp-and-rewrite write) and against
    JAX's `_apply_rope` and in-scan write with mode="drop": q equal, the
    caches equal, a position past the end written nowhere, the pool's rows
    outside the view untouched."""
    B, W1, M, pos = QKV_CASES[case]
    rng = np.random.default_rng(2)
    qkv, bias_t, cos, sin, pool, pos_t = _qkv_case(rng, B, W1, M, pos, bias, pool_rows or B)
    layer = 1
    before = {k: v.clone() for k, v in pool.items()}
    k_cache, v_cache = pool["k"][:, :B][layer], pool["v"][:, :B][layer]
    flat = W1 == 1
    args = (qkv[:, 0], cos[:, 0], sin[:, 0]) if flat else (qkv, cos, sin)
    q = dg.qkv_rope_kv_write(args[0], bias_t, args[1], args[2], ROT, k_cache, v_cache, pos_t)
    assert q.shape == ((B, NH, HD) if flat else (B, W1, NH, HD))

    # the glue it replaces, on copies
    old = {k: v.clone() for k, v in before.items()}
    x = qkv + bias_t if bias else qkv
    q_old, k_old, v_old = dg._split_heads(x, NKV, HD)
    q_old = tm._apply_rope(q_old, cos, sin, ROT)
    k_old = tm._apply_rope(k_old, cos, sin, ROT)
    ok, ov = old["k"][:, :B][layer], old["v"][:, :B][layer]
    if flat:
        _old_decode_write(k_old[:, 0], v_old[:, 0], ok, ov, pos_t)
    else:
        _old_verify_write(k_old, v_old, ok, ov, pos_t)
    assert torch.equal(q, q_old[:, 0] if flat else q_old)
    for k in "kv":
        assert torch.equal(pool[k], old[k]), k

    # JAX: _apply_rope and the in-scan write, mode="drop"
    qj, kj, vj = (jnp.asarray(a.numpy()) for a in dg._split_heads(x, NKV, HD))
    cj, sj = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jm._apply_rope(qj, cj, sj, ROT))[:, 0] if flat
        else np.asarray(jm._apply_rope(qj, cj, sj, ROT)))
    kj = jm._apply_rope(kj, cj, sj, ROT)
    qpos = jnp.asarray(pos)[:, None] + jnp.arange(W1)[None]
    b_idx = jnp.arange(B)[:, None]
    kc = jnp.asarray(before["k"][:, :B][layer].numpy()).at[b_idx, qpos].set(kj, mode="drop")
    vc = jnp.asarray(before["v"][:, :B][layer].numpy()).at[b_idx, qpos].set(vj, mode="drop")
    np.testing.assert_array_equal(k_cache.numpy(), np.asarray(kc))
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(vc))

    for k in "kv":  # nothing outside the view, nothing at a dropped position
        assert torch.equal(pool[k][:, B:], before[k][:, B:])
        assert torch.equal(pool[k][1 - layer], before[k][1 - layer])
    for b, p in enumerate(pos):
        if p >= M:
            assert torch.equal(k_cache[b], before["k"][layer, b])


def test_qkv_rope_kv_write_plain_dual_caches():
    """The dual step's two pools: one concatenated qkv and table, each
    cache written from its own row slice at its own positions (one beyond
    its end), as JAX's decode_step_dual writes them."""
    rng = np.random.default_rng(3)
    Ba, Bb, Ma, Mb = 3, 2, 6, 10
    pos_a, pos_b = [0, 5, 6], [9, 3]
    qkv = _t(rng.standard_normal((Ba + Bb, N)))
    bias = _t(rng.standard_normal(N))
    cos, sin = (_t(a) for a in _rope_tables(np.asarray(pos_a + pos_b)))
    caches = {"a": (_t(rng.standard_normal((Ba, Ma, NKV, HD))),
                    _t(rng.standard_normal((Ba, Ma, NKV, HD)))),
              "b": (_t(rng.standard_normal((Bb, Mb, NKV, HD))),
                    _t(rng.standard_normal((Bb, Mb, NKV, HD))))}
    before = {n: tuple(c.numpy().copy() for c in kv) for n, kv in caches.items()}
    qs = []
    for name, rows, pos in (("a", slice(0, Ba), pos_a), ("b", slice(Ba, Ba + Bb), pos_b)):
        qs.append(dg.qkv_rope_kv_write(qkv[rows], bias, cos[rows], sin[rows], ROT,
                                       *caches[name], torch.tensor(pos, dtype=torch.int32)))
    x = jnp.asarray((qkv + bias).numpy())[:, None]
    qj, kj, vj = (a[:, 0] for a in dg._split_heads(x, NKV, HD))
    cj, sj = jnp.asarray(cos.numpy())[:, None], jnp.asarray(sin.numpy())[:, None]
    qj = jm._apply_rope(qj[:, None], cj, sj, ROT)[:, 0]
    kj = jm._apply_rope(kj[:, None], cj, sj, ROT)[:, 0]
    np.testing.assert_array_equal(torch.cat(qs).numpy(), np.asarray(qj))
    for name, rows, pos in (("a", slice(0, Ba), pos_a), ("b", slice(Ba, Ba + Bb), pos_b)):
        idx = jnp.arange(len(pos))
        for c, new, old in zip(caches[name], (kj[rows], vj[rows]), before[name]):
            want = jnp.asarray(old).at[idx, jnp.asarray(pos)].set(new, mode="drop")
            np.testing.assert_array_equal(c.numpy(), np.asarray(want))


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_silu_mul_plain(lead):
    """SiLU of the gate times up: the glue's `F.silu(gate) * up` bit for
    bit, JAX's `jax.nn.silu(gate) * up` within float32 rounding."""
    rng = np.random.default_rng(4)
    gate_up = _t(3 * rng.standard_normal((*lead, 2 * 48)))
    act = dg.silu_mul(gate_up)
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    assert torch.equal(act, F.silu(gate) * up)
    gj, uj = jnp.split(jnp.asarray(gate_up.numpy()), 2, axis=-1)
    np.testing.assert_allclose(act.numpy(), np.asarray(jax.nn.silu(gj) * uj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("step", ["decode", "dual", "verify"])
def test_decode_family_calls_the_glue_per_layer(step, monkeypatch):
    """A step's calls of the three functions, the launches its card graph
    counts: 2 x layers + 1 add_rms_norm (the last one is ln_f), layers
    silu_mul, and layers qkv_rope_kv_write a pool; on the CPU no launch is
    counted."""
    cfg = tiny()
    L = cfg.decoder.n_layers
    params = init_random(cfg, 0, dtype=torch.float32, device="cpu")
    calls = {name: 0 for name in ("add_rms_norm", "qkv_rope_kv_write", "silu_mul")}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(dg, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tm, name, counted)
    caches = [tm.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu") for B in (3, 2)]
    counts0 = dict(_build.launch_counts)
    if step == "decode":
        tm.decode_step(params, cfg, caches[0], torch.tensor([1, 2, 3], dtype=torch.int32))
    elif step == "dual":
        tm.decode_step_dual(params, cfg, caches[0], torch.tensor([1, 2, 3], dtype=torch.int32),
                            caches[1], torch.tensor([4, 5], dtype=torch.int32))
    else:
        tm.verify_step(params, cfg, caches[0], torch.ones((3, 4), dtype=torch.int32))
    pools = 2 if step == "dual" else 1
    assert calls == {"add_rms_norm": 2 * L + 1, "qkv_rope_kv_write": pools * L, "silu_mul": L}
    assert dict(_build.launch_counts) == counts0
