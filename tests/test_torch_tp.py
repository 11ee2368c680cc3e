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
the int8 modes, against the port's single engine; -a8 refused; the group
failing, not hanging, on a collective nobody meets; the dry run's tp leg.

Tiny f32 weights from PRNGKey(0), x4 as the parity tests scale them,
carried across bit-exact; audio from numpy seeds. Every test that starts
ranks is bounded by the group's timeout (TPGroup.timeout_s), after which
the group raises."""

import asyncio
import time

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


def _transcriber(params, mode="native"):
    if mode != "native":
        params = quantize_params_int8(params, decoder_only=mode != "int8")
    return Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=(64, 128))


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


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_decode_and_verify_steps_match_jax(trees, ranks, step):
    """One decode_step ([B] tokens) and one verify_step ([B, 9] tokens) on
    each rank's share of a random cache: JAX's logits within 2e-4, equal
    bits on both ranks, each rank's KV heads written as JAX writes them."""
    params_j, _ = trees
    group, rank_trees, local = ranks
    cfg_j = tiny_jax()
    k, v, ln = _history([3, 17, 30], 48, seed=9)
    rng = np.random.default_rng(13)
    shape = (3,) if step == "decode" else (3, 9)
    tokens = rng.integers(5, cfg_j.decoder.vocab_size - 1, shape).astype(np.int32)
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


# ---------------------------------------------------------------------
# the dp x tp engine
# ---------------------------------------------------------------------


def test_four_by_two_engine_matches_jax(trees):
    """The twin of test_parallel.py's tensor-parallel parity test: 8
    requests at budget 8 on a 4 x 2 mesh of "cpu" give JAX's Transcriber
    tokens exactly; each follower's slots hold rank 0's tokens, lengths,
    counts and done flags; every rank's KV heads are its own; the
    all-reduces are counted."""
    params_j, params = trees
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=(64, 128))
    audios = [_audio(0.3 + 0.05 * i, f=200 + 70 * i, seed=i) for i in range(8)]
    golden = [tr_j.transcribe(a, SR, max_new_tokens=8).tokens for a in audios]
    engine = _tp_engine(_transcriber(params), 4, 2, slots=8, max_decode_tokens=32)
    assert engine.data_parallel == 4 and engine.model_parallel == 2
    dec = tiny().decoder
    for rep in engine.replicas:
        assert rep.tp_degree == 2 and len(rep._ranks) == 2
        for eng in rep._ranks:
            assert eng.long.state["k"].shape[3] == dec.n_kv_heads // 2
            assert eng.transcriber.cfg.decoder.n_heads == dec.n_heads // 2

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in audios])
        return [r.tokens for r in rs]

    got = _serve(engine, run)
    for i, (g, w) in enumerate(zip(got, golden)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    for rep in engine.replicas:
        lead, follower = rep._ranks
        for pool in ("short", "long"):
            for name in ("out", "tok", "n", "len", "done", "status", "budget", "bias"):
                assert torch.equal(lead._pool(pool).state[name],
                                   follower._pool(pool).state[name]), (pool, name)
    stats = engine.stats["replicas"]
    assert [s["tp"] for s in stats] == [2] * 4
    assert all(s["all_reduces"] > 0 for s in stats if s["decode_steps"]), stats


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


def test_w8a8_under_tp_raises(trees):
    from dataclasses import replace

    _, params = trees
    tr = _transcriber(params, "int8-decoder")
    tr.cfg = replace(tr.cfg, decoder=replace(tr.cfg.decoder, act_int8_decode=True))
    with pytest.raises(NotImplementedError, match="int8-decoder-a8"):
        _tp_engine(tr, 1, 2, slots=2, max_decode_tokens=16)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tp_local(tr.cfg, 2)


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
