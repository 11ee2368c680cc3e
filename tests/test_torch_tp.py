"""Tensor parallelism of the port on the CPU, gloo ranks on threads.

The shards (parallel/mesh.py:shard_params_tp) against the JAX package's
placement (parallel/mesh.py:shard_params_tp on the 8-device virtual CPU
mesh): the same leaves cut on the same axes with the same roles, the
int8 q / scale cases included, and each rank's shards put back through
the section permutation equal to the whole tree bit for bit; a block
whose heads do not divide stays whole. The model at tp = 2 (encode_audio,
prefill logits, a decode step, a verify step) against JAX's unsharded
functions within 2e-4. The dp x tp engine (engine/replicas.py) on a 4 x 2
mesh against JAX's Transcriber token for token, each follower's slots
equal to rank 0's; ring streams and a drafted final on a 1 x 2 mesh, and
the int8 modes, against the port's single engine. W8A8 decode
(int8-decoder-a8) under tp: each rank's int8 activations at the
row-parallel products equal the slice of JAX's whole-row recipe, the -a8
decode and verify steps JAX's unsharded -a8 functions within 2e-4, the
4 x 2 -a8 engine JAX's -a8 Transcriber token for token, the fused dual
decode and a drafted final the single engine's. The group failing, not
hanging, on a collective nobody meets; the dry run's tp leg.

Tiny f32 weights from PRNGKey(0), x4 as the parity tests scale them,
carried across bit-exact; audio from numpy seeds. Every test that starts
ranks is bounded by the group's timeout (TPGroup.timeout_s), after which
the group raises."""

import asyncio
import threading
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import glm_asr as jm
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.ops.quant import quantize_params_int8 as quantize_jax
from sonicscribe_tpu.parallel import mesh as mesh_jax
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import glm_asr as tm
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.config import tp_blocks, tp_local
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops import int8_matmul as im
from sonicscribe_tpu_torch.ops import quant as quant_module
from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
from sonicscribe_tpu_torch.parallel import make_mesh, shard_params_tp
from sonicscribe_tpu_torch.parallel.dryrun import dryrun_multichip
from sonicscribe_tpu_torch.parallel.mesh import COLUMN, ROW, tp_rule
from sonicscribe_tpu_torch.parallel.tp import TPGroup
from sonicscribe_tpu_torch.vad.model import EnergyVad

SR = 16000
TOL = dict(rtol=2e-4, atol=2e-4)  # float32 sums split over two ranks
TP_TIMEOUT_S = 30.0  # a collective nobody meets fails after this


def _audio(seconds, f=300.0, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * f * t)
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def _pcm(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


@pytest.fixture(scope="module")
def trees():
    """(JAX tree, port tree) of the x4 tiny model."""
    params_j = jax.tree.map(lambda x: x * 4.0,
                            jm.init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32))
    return params_j, params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")


def _a8(cfg):
    """cfg with W8A8 decode on (quant mode int8-decoder-a8), either package's."""
    return replace(cfg, decoder=replace(cfg.decoder, act_int8_decode=True))


def _transcriber(params, mode="native"):
    cfg = _a8(tiny()) if mode == "int8-decoder-a8" else tiny()
    if mode != "native":
        params = quantize_params_int8(params, decoder_only=mode != "int8")
    return Transcriber(cfg, params, ByteTokenizer(cfg), prefill_buckets=(64, 128))


def _serve(engine, run):
    async def go():
        try:
            return await run(engine)
        finally:
            engine.shutdown()
    return asyncio.run(go())


def _tp_engine(tr, dp: int, tp: int, **kw) -> DataParallelEngine:
    return DataParallelEngine(tr, EnergyVad(device="cpu"),
                              make_mesh(devices=["cpu"] * (dp * tp), model_parallel=tp), **kw)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------
# the shards
# ---------------------------------------------------------------------


def _unshard(path, shards, cfg):
    """The whole leaf from each rank's shard: a row cut concatenated on
    its input axis, a column cut per section (q, k, v; gate, up)."""
    rule = tp_rule(path)
    if rule is None or rule[0] == ROW and path[-1] == "scale":
        assert all(torch.equal(s, shards[0]) for s in shards), path
        return shards[0]
    if rule[0] == ROW:
        return torch.cat(shards, dim=-2)
    dec, name = cfg.decoder, path[-2] if path[-1] in ("q", "scale") else path[-1]
    if name in ("qkv_w", "qkv_b"):
        sections = [dec.n_heads * dec.head_dim // 2] + [dec.n_kv_heads * dec.head_dim // 2] * 2
    elif name == "gate_up_w":
        sections = [shards[0].shape[-1] // 2] * 2
    else:
        sections = [shards[0].shape[-1]]
    out, start = [], 0
    for n in sections:
        out += [s[..., start:start + n] for s in shards]
        start += n
    return torch.cat(out, dim=-1)


@pytest.mark.parametrize("mode", ["native", "int8"])
def test_shards_cut_jaxs_leaves_with_jaxs_roles(trees, mode):
    """Every leaf JAX's shard_params_tp places over "model" (on a 4 x 2
    mesh) is cut by the port on the same axis with the same role, and
    every leaf JAX replicates stays whole; put back, the two ranks'
    shards are the unsharded tree, bit for bit."""
    params_j, params = trees
    if mode == "int8":
        params_j, params = quantize_jax(params_j), quantize_params_int8(params)
    placed = mesh_jax.shard_params_tp(params_j, mesh_jax.make_mesh(8, model_parallel=2))
    mesh = make_mesh(devices=["cpu"] * 8, model_parallel=2)
    shards = shard_params_tp(params, mesh, tiny(), row=1)
    assert len(shards) == 2
    checked = set()
    for path, leaf in _leaves(placed):
        spec = tuple(leaf.sharding.spec)
        whole = _get(params, path)
        rule = tp_rule(path)
        if "model" not in spec:
            assert rule is None or (rule[0] == ROW and path[-1] == "scale"), (path, rule)
        else:
            axis = spec.index("model") - len(spec)
            assert rule is not None and rule[0] == {-1: COLUMN, -2: ROW}[axis], (path, spec)
            checked.add(path[-2] if path[-1] in ("q", "scale") else path[-1])
        parts = [_get(s, path) for s in shards]
        for p in parts:
            assert p.is_contiguous() and p.data_ptr() % 16 == 0, path
            if rule is not None and not (rule[0] == ROW and path[-1] == "scale"):
                assert p.data_ptr() != whole.data_ptr(), path  # a copy, not a view
        assert torch.equal(_unshard(path, parts, tiny()), whole), path
    assert checked >= {"q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w", "qkv_w", "gate_up_w",
                       "down_w", "w"}
    dl = shards[0]["decoder"]["layers"]
    dec = tiny().decoder
    assert tuple(dl["qkv_w"]["q"].shape if mode == "int8" else dl["qkv_w"].shape) == (
        dec.n_layers, dec.d_model, (dec.n_heads + 2 * dec.n_kv_heads) * dec.head_dim // 2)


def test_qkv_and_gate_up_shards_are_head_aligned(trees):
    """Rank r holds [its q heads | its k heads | its v heads] and [its gate
    shard | its up shard], where JAX's contiguous cut would hand rank 0 every
    q head and rank 1 every k and v head."""
    _, params = trees
    dec = tiny().decoder
    shards = shard_params_tp(params, make_mesh(devices=["cpu"] * 2, model_parallel=2), tiny())
    full = params["decoder"]["layers"]
    hd, nh, nkv, F = dec.head_dim, dec.n_heads, dec.n_kv_heads, dec.ffn_hidden
    for r, tree in enumerate(shards):
        qkv = tree["decoder"]["layers"]["qkv_w"]
        q, k, v = torch.split(qkv, [nh * hd // 2, nkv * hd // 2, nkv * hd // 2], dim=-1)
        assert torch.equal(q, full["qkv_w"][..., r * nh * hd // 2:(r + 1) * nh * hd // 2])
        k0, v0 = nh * hd + r * nkv * hd // 2, nh * hd + nkv * hd + r * nkv * hd // 2
        assert torch.equal(k, full["qkv_w"][..., k0:k0 + nkv * hd // 2])
        assert torch.equal(v, full["qkv_w"][..., v0:v0 + nkv * hd // 2])
        gate, up = torch.chunk(tree["decoder"]["layers"]["gate_up_w"], 2, dim=-1)
        assert torch.equal(gate, full["gate_up_w"][..., r * F // 2:(r + 1) * F // 2])
        assert torch.equal(up, full["gate_up_w"][..., F + r * F // 2:F + (r + 1) * F // 2])


def test_an_indivisible_block_stays_whole(trees):
    """tiny's 2 KV heads at tp = 4: the decoder's attention pair (qkv_w,
    qkv_b, o_w) whole on every rank and not reduced, its MLP cut."""
    _, params = trees
    cfg = tiny()
    assert tp_blocks(cfg, 4) == {"encoder_attn", "encoder_mlp", "adapter", "decoder_mlp"}
    local = tp_local(cfg, 4)
    assert (local.decoder.n_heads, local.decoder.n_kv_heads) == (4, 2)
    assert local.decoder.ffn_hidden == cfg.decoder.ffn_hidden // 4
    assert (local.encoder.n_heads, local.encoder.head_dim) == (1, cfg.encoder.head_dim)
    shards = shard_params_tp(params, make_mesh(devices=["cpu"] * 4, model_parallel=4), cfg)
    full = params["decoder"]["layers"]
    for tree in shards:
        layers = tree["decoder"]["layers"]
        for name in ("qkv_w", "qkv_b", "o_w"):
            assert torch.equal(layers[name], full[name]), name
        assert layers["gate_up_w"].shape[-1] == full["gate_up_w"].shape[-1] // 4
        assert layers["down_w"].shape[-2] == full["down_w"].shape[-2] // 4


# ---------------------------------------------------------------------
# the model at tp = 2 against JAX's unsharded functions
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(trees):
    """A gloo pair on threads, each rank's tree with its hook, the local
    config."""
    _, params = trees
    group = TPGroup(["cpu"] * 2, timeout_s=TP_TIMEOUT_S)
    shards = shard_params_tp(params, make_mesh(devices=["cpu"] * 2, model_parallel=2), tiny())
    yield group, group.attach(shards, tiny()), tp_local(tiny(), 2)
    group.close()


def test_encoder_and_prefill_match_jax(trees, ranks):
    params_j, _ = trees
    group, rank_trees, local = ranks
    cfg_j = tiny_jax()
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 128, 128)).astype(np.float32)
    n_frames = np.array([128, 77], np.int32)
    want, want_n = jm.encode_audio(params_j, cfg_j, jnp.asarray(mel), jnp.asarray(n_frames))
    with torch.inference_mode():
        got = group.run(lambda r: tm.encode_audio(
            rank_trees[r], local, torch.from_numpy(mel), torch.from_numpy(n_frames)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_n))

    emb = (rng.standard_normal((2, 24, cfg_j.decoder.d_model)) * 0.5).astype(np.float32)
    length = np.array([24, 15], np.int32)
    ks_j, vs_j, logits_j = jm.prefill_kv(params_j, cfg_j, jnp.asarray(emb), jnp.asarray(length))
    with torch.inference_mode():
        out = [None, None]

        def run(r):
            out[r] = tm.prefill_kv(rank_trees[r], local, torch.from_numpy(emb),
                                   torch.from_numpy(length))
        group.run(run)
    np.testing.assert_allclose(out[0][2].numpy(), np.asarray(logits_j), **TOL)
    assert torch.equal(out[0][2], out[1][2])  # every rank the same bits
    # each rank's K/V: its own KV heads of the whole model's
    half = cfg_j.decoder.n_kv_heads // 2
    for r in range(2):
        np.testing.assert_allclose(out[r][0].numpy(),
                                   np.asarray(ks_j)[..., r * half:(r + 1) * half, :], **TOL)
        np.testing.assert_allclose(out[r][1].numpy(),
                                   np.asarray(vs_j)[..., r * half:(r + 1) * half, :], **TOL)


def _history(lens, max_len, seed):
    dec = tiny().decoder
    rng = np.random.default_rng(seed)
    shape = (dec.n_layers, len(lens), max_len, dec.n_kv_heads, dec.head_dim)
    return ((rng.standard_normal(shape) * 0.3).astype(np.float32),
            (rng.standard_normal(shape) * 0.3).astype(np.float32), np.asarray(lens, np.int32))


def _rank_cache(k, v, ln, r):
    half = k.shape[3] // 2
    return {"k": torch.from_numpy(k[:, :, :, r * half:(r + 1) * half].copy()),
            "v": torch.from_numpy(v[:, :, :, r * half:(r + 1) * half].copy()),
            "len": torch.from_numpy(ln.copy())}


def _step_inputs(step, seed=0):
    """A random cache history for 3 slots and the step's tokens ([3] or
    [3, 9])."""
    k, v, ln = _history([3, 17, 30], 48, seed=9 + seed)
    rng = np.random.default_rng(13 + seed)
    shape = (3,) if step == "decode" else (3, 9)
    return k, v, ln, rng.integers(5, tiny().decoder.vocab_size - 1, shape).astype(np.int32)


def _steps_against_jax(params_j, cfg_j, group, rank_trees, local, step, seed=0):
    """One decode_step or verify_step of JAX's on the whole tree and of the
    port's on each rank's share of the cache: JAX's logits within 2e-4,
    equal bits on both ranks, each rank's KV heads written as JAX writes
    them."""
    k, v, ln, tokens = _step_inputs(step, seed)
    fn_j, fn = (jm.decode_step, tm.decode_step) if step == "decode" else (jm.verify_step,
                                                                          tm.verify_step)
    cache_j, want = fn_j(params_j, cfg_j, {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                           "len": jnp.asarray(ln)}, jnp.asarray(tokens))
    caches = [_rank_cache(k, v, ln, r) for r in range(2)]
    out = [None, None]

    def run(r):
        out[r] = fn(rank_trees[r], local, caches[r], torch.from_numpy(tokens))[1]

    with torch.inference_mode():
        group.run(run)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want), **TOL)
    assert torch.equal(out[0], out[1])
    half = cfg_j.decoder.n_kv_heads // 2
    for r in range(2):
        np.testing.assert_allclose(caches[r]["k"].numpy(),
                                   np.asarray(cache_j["k"])[:, :, :, r * half:(r + 1) * half],
                                   **TOL)
        np.testing.assert_array_equal(caches[r]["len"].numpy(), np.asarray(cache_j["len"]))


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_decode_and_verify_steps_match_jax(trees, ranks, step):
    """One decode_step ([B] tokens) and one verify_step ([B, 9] tokens) on
    each rank's share of a random cache: JAX's logits within 2e-4, equal
    bits on both ranks, each rank's KV heads written as JAX writes them."""
    params_j, _ = trees
    group, rank_trees, local = ranks
    _steps_against_jax(params_j, tiny_jax(), group, rank_trees, local, step)


# ---------------------------------------------------------------------
# W8A8 decode (int8-decoder-a8) under tp
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def a8_ranks(trees):
    """The -a8 trees (decoder int8, quantised whole, then cut): JAX's whole
    tree and config, and a gloo pair with each rank's -a8 tree, its hook
    and the local config."""
    params_j, params = trees
    cfg = _a8(tiny())
    group = TPGroup(["cpu"] * 2, timeout_s=TP_TIMEOUT_S)
    shards = shard_params_tp(quantize_params_int8(params, decoder_only=True),
                             make_mesh(devices=["cpu"] * 2, model_parallel=2), cfg)
    yield (quantize_jax(params_j, decoder_only=True), _a8(tiny_jax()), group,
           group.attach(shards, cfg), tp_local(cfg, 2))
    group.close()


def test_tp_local_keeps_w8a8_decode(trees):
    """-a8 under tp is served: the rank's config keeps act_int8_decode."""
    local = tp_local(_a8(tiny()), 2)
    assert local.decoder.act_int8_decode
    assert local.decoder.n_heads == tiny().decoder.n_heads // 2


class _W8A8Calls:
    """Every W8A8 product's x and row_amax (ops/quant.py's call of the
    entry), by calling thread: the ranks' calls apart."""

    def __init__(self, monkeypatch):
        self.calls: dict = {}
        entry = quant_module.int8_matmul_w8a8

        def record(x, q, scale, layer, row_amax=None):
            self.calls.setdefault(threading.get_ident(), []).append(
                (x.clone(), None if row_amax is None else row_amax.clone()))
            return entry(x, q, scale, layer, row_amax)

        monkeypatch.setattr(quant_module, "int8_matmul_w8a8", record)

    def take(self, ident=None):
        return self.calls.pop(threading.get_ident() if ident is None else ident)


def _jax_xq(x):
    """The JAX package's activation recipe (ops/quant.py:matmul_w8a8) on
    the whole row: xq int8."""
    xf = jnp.asarray(x, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8))


def _rank_calls(group, rank_trees, local, step, calls, seed=0):
    """One -a8 step on both ranks; -> each rank's W8A8 calls in order."""
    k, v, ln, tokens = _step_inputs(step, seed)
    fn = tm.decode_step if step == "decode" else tm.verify_step
    caches = [_rank_cache(k, v, ln, r) for r in range(2)]
    idents = [None, None]

    def run(r):
        idents[r] = threading.get_ident()
        fn(rank_trees[r], local, caches[r], torch.from_numpy(tokens))

    with torch.inference_mode():
        group.run(run)
    return [calls.take(i) for i in idents]


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_a8_rank_xq_is_the_slice_of_jaxs_whole_xq(a8_ranks, monkeypatch, step):
    """At every row-parallel W8A8 product (decoder o_w and down_w, 2 a
    layer) each rank's row_amax is the max of |x| over both ranks' shares
    of the row, the same bits on both ranks, and the rank's int8 x is the
    matching slice of JAX's recipe on the whole row (both shares side by
    side, as the shards are head- and column-aligned) bit for bit. The
    column-parallel products (qkv_w, gate_up_w) take x whole on each rank,
    with no row_amax."""
    *_, group, rank_trees, local = a8_ranks
    calls = _W8A8Calls(monkeypatch)
    per_rank = _rank_calls(group, rank_trees, local, step, calls)
    assert len(per_rank[0]) == len(per_rank[1]) == 4 * tiny().decoder.n_layers
    row_parallel = 0
    for (x0, a0), (x1, a1) in zip(*per_rank):
        if a0 is None:  # column-parallel: the same whole x on both ranks
            assert a1 is None and torch.equal(x0, x1)
            continue
        row_parallel += 1
        whole = torch.cat([x0, x1], dim=-1)
        assert torch.equal(a0, a1) and torch.equal(a0, whole.abs().amax(-1))
        want = _jax_xq(whole.numpy())
        K = x0.shape[-1]
        for r, x in enumerate((x0, x1)):
            got = im.quantize_activations(x, a0)[0].numpy()
            np.testing.assert_array_equal(got, want[:, r * K:(r + 1) * K])
    assert row_parallel == 2 * tiny().decoder.n_layers


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_a8_decode_and_verify_steps_match_jax(a8_ranks, step):
    """The -a8 decode and verify steps at tp = 2 against JAX's unsharded -a8
    functions, as test_decode_and_verify_steps_match_jax holds the native
    ones: within 2e-4 (TOL, the same float32 sums split over two ranks)."""
    params_j, cfg_j, group, rank_trees, local = a8_ranks
    for seed in range(3):
        _steps_against_jax(params_j, cfg_j, group, rank_trees, local, step, seed)


def test_a8_int8_activations_at_tp_equal_the_single_cards(trees, a8_ranks, monkeypatch):
    """How often an int8 step flips: each W8A8 product's int8 x at tp = 2
    (the ranks' row-parallel shares side by side) against the port's
    single-card -a8 step on the whole tree, call by call. A residual that
    an earlier sum-reduce rounded differently could move x / sx across a
    rounding boundary; on these inputs (3 seeds, decode and verify: 48
    products, 115,200 int8 values) it happened 0 times."""
    _, params = trees
    *_, group, rank_trees, local = a8_ranks
    whole = quantize_params_int8(params, decoder_only=True)
    calls = _W8A8Calls(monkeypatch)
    values = flips = products = 0
    for seed in range(3):
        for step in ("decode", "verify"):
            k, v, ln, tokens = _step_inputs(step, seed)
            fn = tm.decode_step if step == "decode" else tm.verify_step
            with torch.inference_mode():
                fn(whole, _a8(tiny()), {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                                        "len": torch.from_numpy(ln)}, torch.from_numpy(tokens))
            single = calls.take()
            per_rank = _rank_calls(group, rank_trees, local, step, calls, seed)
            for (xs, _), (x0, a0), (x1, a1) in zip(single, *per_rank):
                want = im.quantize_activations(xs)[0]
                got = (im.quantize_activations(x0)[0] if a0 is None else torch.cat(
                    [im.quantize_activations(x0, a0)[0], im.quantize_activations(x1, a1)[0]],
                    dim=-1))
                values += want.numel()
                flips += int((got != want).sum())
                products += 1
    assert (products, values) == (48, 115200)
    assert flips == 0


def test_row_amax_none_leaves_the_plain_w8a8_as_it_was():
    """int8_matmul_w8a8_plain without row_amax: bit for bit the recipe it
    computed before row_amax existed (each row's own max|x|, IEEE
    divisions, the integer sums in float64), float32 and bf16 x; with the
    row's own max given, the same bits."""
    from sonicscribe_tpu_torch.ops.quant import quantize_tensor

    g = torch.Generator().manual_seed(3)
    qt = quantize_tensor(torch.randn((2, 96, 64), generator=g) * 0.05)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((5, 96), generator=g) * 2.0).to(dtype)
        xf = x.float()
        sx = im.div127(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8))
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        want = ((xq.double() @ qt["q"][1].double()).float() * sx
                * qt["scale"][1].reshape(-1)).to(dtype)
        assert torch.equal(im.int8_matmul_w8a8_plain(x, qt["q"], qt["scale"], 1), want)
        assert torch.equal(im.int8_matmul_w8a8_plain(x, qt["q"], qt["scale"], 1,
                                                     xf.abs().amax(-1)), want)


# ---------------------------------------------------------------------
# the dp x tp engine
# ---------------------------------------------------------------------


def _four_by_two_against_jax(params_j, params, mode):
    """8 requests at budget 8 on a 4 x 2 mesh of "cpu" in quant mode `mode`
    against JAX's Transcriber in the same mode, token for token; each
    follower's slots hold rank 0's tokens, lengths, counts and done flags;
    every rank's KV heads are its own; the all-reduces are counted."""
    cfg_j = tiny_jax()
    if mode == "int8-decoder-a8":
        params_j, cfg_j = quantize_jax(params_j, decoder_only=True), _a8(cfg_j)
    tr_j = TranscriberJax(cfg_j, params_j, ByteTokenizerJax(cfg_j), prefill_buckets=(64, 128))
    audios = [_audio(0.3 + 0.05 * i, f=200 + 70 * i, seed=i) for i in range(8)]
    golden = [tr_j.transcribe(a, SR, max_new_tokens=8).tokens for a in audios]
    engine = _tp_engine(_transcriber(params, mode), 4, 2, slots=8, max_decode_tokens=32)
    assert engine.data_parallel == 4 and engine.model_parallel == 2
    dec = tiny().decoder
    for rep in engine.replicas:
        assert rep.tp_degree == 2 and len(rep._ranks) == 2
        for eng in rep._ranks:
            assert eng.long.state["k"].shape[3] == dec.n_kv_heads // 2
            assert eng.transcriber.cfg.decoder.n_heads == dec.n_heads // 2
            assert eng.transcriber.cfg.decoder.act_int8_decode == (mode == "int8-decoder-a8")

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in audios])
        return [r.tokens for r in rs]

    got = _serve(engine, run)
    for i, (g, w) in enumerate(zip(got, golden)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert any(len(w) for w in golden)
    for rep in engine.replicas:
        lead, follower = rep._ranks
        for pool in ("short", "long"):
            for name in ("out", "tok", "n", "len", "done", "status", "budget", "bias"):
                assert torch.equal(lead._pool(pool).state[name],
                                   follower._pool(pool).state[name]), (pool, name)
    stats = engine.stats["replicas"]
    assert [s["tp"] for s in stats] == [2] * 4
    assert all(s["all_reduces"] > 0 for s in stats if s["decode_steps"]), stats


def test_four_by_two_engine_matches_jax(trees):
    """The twin of test_parallel.py's tensor-parallel parity test: 8
    requests at budget 8 on a 4 x 2 mesh of "cpu" give JAX's Transcriber
    tokens exactly (_four_by_two_against_jax)."""
    _four_by_two_against_jax(*trees, "native")


def test_four_by_two_a8_engine_matches_jax(trees):
    """int8-decoder-a8 on the 4 x 2 mesh: JAX's int8-decoder-a8
    Transcriber's tokens exactly (W8A16 prefill, W8A8 decode with each
    row's max|x| max-reduced over the ranks)."""
    _four_by_two_against_jax(*trees, "int8-decoder-a8")


def _single_and_tp(tr_single, tr_tp, run, **kw):
    """run(engine) on the port's single engine over the whole tree, then on
    a 1 x 2 mesh over the same tree."""
    single = BatchedEngine(tr_single, EnergyVad(device="cpu"), **kw)
    return _serve(single, run), _serve(_tp_engine(tr_tp, 1, 2, **kw), run)


def test_ring_streams_and_drafted_final_match_the_single_engine(trees):
    """On a 1 x 2 mesh: two ring streams (packed ingest, the ring VAD on
    rank 0, ring prefill on both ranks) and a host request with a golden
    draft (speculative final: verify rounds on both ranks) give the single
    engine's tokens and VAD probabilities."""
    _, params = trees
    audios = [_audio(0.64, f=440 + 50 * i, seed=3 + i) for i in range(2)]
    final = _audio(0.5, f=330, seed=21)

    async def run(eng):
        streams = [eng.alloc_stream() for _ in audios]
        for s, a in zip(streams, audios):
            pcm = _pcm(a)
            for c in range(10):
                eng.ingest(s, c, pcm[c * 2048:(c + 1) * 2048])
        probs = await asyncio.gather(*[eng.vad_window_ring(s, 0) for s in streams])
        rs = await asyncio.gather(*[eng.transcribe_ring(s, 0, 10, max_new_tokens=8)
                                    for s in streams])
        plain = await eng.transcribe(final, SR, max_new_tokens=20)
        drafted = await eng.transcribe(final, SR, max_new_tokens=20,
                                       draft_tokens=np.asarray(plain.tokens))
        for s in streams:
            eng.free_stream(s)
        return ([r.tokens.tolist() for r in rs], probs, plain.tokens.tolist(),
                drafted.tokens.tolist(), eng.stats["verify_rounds"])

    want, got = _single_and_tp(_transcriber(params), _transcriber(params), run, slots=4,
                               max_decode_tokens=32, n_streams=4)
    assert got[:4] == want[:4]
    assert got[3] == got[2] and len(got[2]) > 1
    assert want[4] > 0 and got[4] == want[4]


def test_fused_dual_decode_matches_the_single_engine(trees):
    """FUSE_DUAL_DECODE on a 1 x 2 mesh: a short and a long request at once
    run the dual program on both ranks, with the single engine's tokens."""
    _, params = trees
    short, long = _audio(0.3, f=210, seed=50), _audio(0.5, f=420, seed=60)

    async def run(eng):
        rs = await asyncio.gather(eng.transcribe(short, SR, max_new_tokens=8),
                                  eng.transcribe(long, SR, max_new_tokens=24))
        return [r.tokens.tolist() for r in rs], eng.stats["dual_decodes"]

    want, got = _single_and_tp(_transcriber(params), _transcriber(params), run, slots=4,
                               max_decode_tokens=32, fuse_dual_decode=True)
    assert got == want and want[1] > 0


def test_every_grid_key_has_each_ranks_own_program_and_buffers(trees):
    """The warmup grid (every key a fast boot may defer, the dual programs
    included) gives each rank its own program and buffers under rank 0's
    key: the captures and replays the card runs in lockstep."""
    _, params = trees
    engine = _tp_engine(_transcriber(params), 1, 2, slots=4, max_decode_tokens=32,
                        fuse_dual_decode=True)
    rep = engine.replicas[0]
    P = len(rep._prompt_defaults()[0].prefix_ids)
    items = rep._grid_keys(rep._grid(full=True), P)
    assert any(item.key[0] == "decode_dual" for item in items)
    for item in items:
        for eng in rep._ranks:
            key, fn, bufs = item.entry(eng)
            assert key == item.key and callable(fn)
            state = eng._dual_bufs["long"] if key[0] == "decode_dual" else eng._pool(key[1]).state
            assert state["k"] is (bufs["long"] if key[0] == "decode_dual" else bufs)["k"]
    engine.shutdown()


@pytest.mark.parametrize("mode", ["int8", "int8-decoder"])
def test_int8_modes_match_the_single_engine(trees, mode):
    """W8A16 is exact per shard: at tp = 2 the single engine's tokens in the
    same mode (the tree quantised whole, then cut)."""
    _, params = trees
    audios = [_audio(0.35 + 0.05 * i, f=250 + 90 * i, seed=30 + i) for i in range(4)]

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=10) for a in audios])
        return [r.tokens.tolist() for r in rs]

    want, got = _single_and_tp(_transcriber(params, mode), _transcriber(params, mode), run,
                               slots=4, max_decode_tokens=32)
    assert got == want and any(want)


def test_a8_fused_dual_decode_and_drafted_final_match_the_single_engine(trees):
    """int8-decoder-a8 on a 1 x 2 mesh with FUSE_DUAL_DECODE: a short and a
    long request at once (the dual program on both ranks), then a final
    and the same final with its own tokens as the draft (verify rounds on
    both ranks), give the single -a8 engine's tokens."""
    _, params = trees
    short, long = _audio(0.3, f=210, seed=50), _audio(0.5, f=420, seed=60)
    final = _audio(0.5, f=330, seed=21)

    async def run(eng):
        rs = await asyncio.gather(eng.transcribe(short, SR, max_new_tokens=8),
                                  eng.transcribe(long, SR, max_new_tokens=24))
        plain = await eng.transcribe(final, SR, max_new_tokens=20)
        drafted = await eng.transcribe(final, SR, max_new_tokens=20,
                                       draft_tokens=np.asarray(plain.tokens))
        return ([r.tokens.tolist() for r in rs], plain.tokens.tolist(), drafted.tokens.tolist(),
                eng.stats["dual_decodes"], eng.stats["verify_rounds"])

    mode = "int8-decoder-a8"
    want, got = _single_and_tp(_transcriber(params, mode), _transcriber(params, mode), run,
                               slots=4, max_decode_tokens=32, fuse_dual_decode=True)
    assert got[:3] == want[:3] and got[2] == got[1] and len(got[1]) > 1
    assert want[3] > 0 and got[3] == want[3]
    assert want[4] > 0 and got[4] == want[4]


def test_a_rank_transcriber_refuses_to_serve_alone(trees):
    _, params = trees
    engine = _tp_engine(_transcriber(params), 1, 2, slots=2, max_decode_tokens=16)
    try:
        with pytest.raises(NotImplementedError, match="batcher"):
            engine.transcriber.transcribe(_audio(0.3), SR, max_new_tokens=4)
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------


def test_a_collective_nobody_meets_fails_and_the_group_refuses_more():
    group = TPGroup(["cpu"] * 2, timeout_s=2.0)
    try:
        xs = [torch.full((3,), float(r + 1)) for r in range(2)]
        group.run(lambda r: group.all_reduce(r, xs[r]))
        assert xs[0].tolist() == xs[1].tolist() == [3.0] * 3
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError):  # rank 1 never calls: rank 0's gloo times out
            group.run(lambda r: group.all_reduce(r, xs[r]) if r == 0 else None)
        assert time.perf_counter() - t0 < 30
        with pytest.raises(RuntimeError, match="failed earlier"):
            group.run(lambda r: None)
    finally:
        group.close()


def test_launch_counts_are_exact_across_threads_and_recorded_per_thread():
    """The ranks' threads count launches at once (a capture on each, through
    count_launch): no increment is lost, and each thread's recording holds
    its own alone."""
    import sys
    import threading

    from sonicscribe_tpu_torch.ops import _build

    n_threads, n = 16, 2000
    recorded = [None] * n_threads
    before = _build.launch_counts["all_reduce"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count(t):
            with _build.recording() as rec:
                for _ in range(n):
                    _build.count_launch("all_reduce")
            recorded[t] = rec

        threads = [threading.Thread(target=count, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert _build.launch_counts["all_reduce"] - before == n_threads * n
    assert recorded == [{"all_reduce": n}] * n_threads
    with _build.recording() as rec:  # a count made with += (one thread) is recorded too
        _build.launch_counts["all_reduce"] += 3
    assert rec == {"all_reduce": 3}
    _build.take_back({"all_reduce": n_threads * n + 3})
    assert _build.launch_counts["all_reduce"] == before


def test_group_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="one card"):
        TPGroup([torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="at least two"):
        TPGroup(["cpu"])


def test_dryrun_tp_leg_on_the_cpu():
    out = dryrun_multichip(2, ["cpu"] * 2)
    assert out["tp_tokens"] is not None and len(out["tp_tokens"]) >= 1
    assert out["tp_a8_tokens"] is not None and len(out["tp_a8_tokens"]) >= 1
