"""Data-parallel serving of the port on the CPU: the mesh and its
placements against the JAX package's parallel/mesh.py, the data-parallel
engine (engine/replicas.py) at 2, 4 and 8 "cpu" replicas against JAX's
Transcriber token for token (plain requests, the fused dual decode,
speculative finals with drafts, the ring path), the router's session
affinity, its crash and /health, build_runtime's DATA_PARALLEL, and the
multi-card dry run's twin.

Tiny f32 weights from PRNGKey(0), x4 as the parity tests scale them,
carried across bit-exact; audio from numpy seeds. Tolerance: tokens exact."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.parallel import mesh as mesh_jax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.ops.int4_matmul import pack_int4
from sonicscribe_tpu_torch.ops.quant import quantize_params_int8
from sonicscribe_tpu_torch.parallel import make_mesh, replicate_params, shard_batch
from sonicscribe_tpu_torch.parallel.dryrun import dryrun_multichip
from sonicscribe_tpu_torch.serve.runtime import build_runtime
from sonicscribe_tpu_torch.vad.model import EnergyVad

SR = 16000
REPLICAS = [2, 4, 8]


def _audio(seconds, f=300.0, seed=None):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * f * t)
    if seed is not None:
        x = x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


def _pcm(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


@pytest.fixture(scope="module")
def stack():
    """(JAX Transcriber, port Transcriber) on the same x4 tiny tree."""
    params_j = jax.tree.map(lambda x: x * 4.0,
                            init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32))
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=(64, 128))
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    return tr_j, Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=(64, 128))


def _engine(stack, n: int, **kw) -> DataParallelEngine:
    return DataParallelEngine(stack[1], EnergyVad(device="cpu"), make_mesh(devices=["cpu"] * n),
                              **kw)


def _serve(engine, run):
    async def go():
        try:
            return await run(engine)
        finally:
            engine.shutdown()
    return asyncio.run(go())


def _assert_tokens(got, want, label):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{label} {i}")


def _busy(engine, key: str) -> list[int]:
    return [r.stats[key] for r in engine.replicas]


# ---------------------------------------------------------------------
# the mesh and its placements
# ---------------------------------------------------------------------


def test_mesh_shape_and_error_are_jaxs():
    for n, mp in ((8, 1), (8, 2), (4, 4), (6, 3)):
        assert make_mesh(n, mp, devices=["cpu"] * 8).shape == dict(
            mesh_jax.make_mesh(n, model_parallel=mp).shape)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_jax.make_mesh(8, model_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(8, model_parallel=3, devices=["cpu"] * 8)
    mesh = make_mesh(devices=["cpu"] * 4, model_parallel=2)
    assert mesh.data_devices == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)  # no card here: the mesh takes the cards unless devices are named


def test_replicate_params_copies_are_bit_equal(stack):
    """A plain tree, the int8 tree of ops/quant.py and an int4 leaf: every
    replica's leaf on its row's device, bit for bit the source's."""
    params = stack[1].params
    codes = torch.from_numpy(np.random.default_rng(0).integers(-8, 8, (64, 16), dtype=np.int8))
    trees = {"plain": params, "int8": quantize_params_int8(params),
             "int4": {"w": {"packed": pack_int4(codes), "scale": torch.rand(1, 16),
                            "layer": 0}}}
    mesh = make_mesh(devices=["cpu"] * 3)
    for kind, tree in trees.items():
        copies = replicate_params(tree, mesh)
        assert len(copies) == 3

        def walk(a, b, path):
            if isinstance(a, dict):
                assert list(a) == list(b), path
                for k in a:
                    walk(a[k], b[k], f"{path}/{k}")
            elif isinstance(a, (list, tuple)):
                for i, (x, y) in enumerate(zip(a, b)):
                    walk(x, y, f"{path}/{i}")
            elif isinstance(a, torch.Tensor):
                assert b.device == torch.device("cpu") and b.dtype == a.dtype, path
                assert torch.equal(a, b), path
            else:
                assert a == b, path

        for copy in copies:
            walk(tree, copy, kind)


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_batch_chunks_are_jaxs_addressable_shards(axis):
    """On JAX's 8-device virtual CPU mesh, each data row's chunk equals the
    addressable shard of that device, the indivisible leaf whole on each."""
    assert len(jax.devices()) >= 8
    tree = {"a": np.arange(16 * 8 * 3, dtype=np.float32).reshape(16, 8, 3),
            "b": np.arange(7, dtype=np.int32),  # indivisible: replicated
            "c": np.arange(24, dtype=np.float32).reshape(8, 3)}
    mj = mesh_jax.make_mesh(8)
    sharded = mesh_jax.shard_batch({k: jnp.asarray(v) for k, v in tree.items()}, mj, axis=axis)
    row_of = {d: r for r, d in enumerate(mj.devices[:, 0].tolist())}
    chunks = shard_batch(tree, make_mesh(devices=["cpu"] * 8), axis=axis)
    for name, arr in sharded.items():
        shards = sorted(arr.addressable_shards, key=lambda s: row_of[s.device])
        assert len(shards) == 8
        for r, shard in enumerate(shards):
            np.testing.assert_array_equal(chunks[r][name].numpy(), np.asarray(shard.data),
                                          err_msg=f"{name} row {r}")


# ---------------------------------------------------------------------
# the data-parallel engine against JAX's Transcriber
# ---------------------------------------------------------------------


@pytest.mark.parametrize("n", REPLICAS)
def test_concurrent_requests_match_jax(stack, n):
    """n + 2 host requests at once, hotwords on two, over n replicas of
    ceil(8 / n) long slots: JAX's Transcriber tokens, every replica busy."""
    tr_j, _ = stack
    reqs = [(_audio(0.3 + 0.05 * (i % 5), f=200 + 70 * i, seed=i),
             ["mesh"] if i in (1, 4) else None) for i in range(n + 2)]
    golden = [tr_j.transcribe(a, SR, max_new_tokens=8, hotwords=h).tokens for a, h in reqs]
    engine = _engine(stack, n, slots=8, max_decode_tokens=32)
    assert engine.data_parallel == n and len(engine.replicas) == n
    assert all(len(r.long.slots) == -(-8 // n) for r in engine.replicas)

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8, hotwords=h)
                                    for a, h in reqs])
        return [r.tokens for r in rs]

    _assert_tokens(_serve(engine, run), golden, f"dp{n} request")
    assert all(s > 0 for s in _busy(engine, "requests")), _busy(engine, "requests")


@pytest.mark.parametrize("n", REPLICAS)
def test_fused_dual_decode_matches_jax(stack, n):
    """FUSE_DUAL_DECODE over the replicas: a short and a long request on
    each, the dual programs counted on every replica, JAX's tokens."""
    tr_j, _ = stack
    shorts = [_audio(0.3, f=210 + 60 * i, seed=50 + i) for i in range(n)]
    longs = [_audio(0.5, f=420 + 80 * i, seed=60 + i) for i in range(n)]
    golden = ([tr_j.transcribe(a, SR, max_new_tokens=8).tokens for a in shorts]
              + [tr_j.transcribe(a, SR, max_new_tokens=24).tokens for a in longs])
    engine = _engine(stack, n, slots=8, max_decode_tokens=32, fuse_dual_decode=True)
    assert engine.fuse_dual

    async def run(eng):
        rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=8) for a in shorts],
                                  *[eng.transcribe(a, SR, max_new_tokens=24) for a in longs])
        return [r.tokens for r in rs]

    _assert_tokens(_serve(engine, run), golden, f"dp{n} request")
    assert engine.stats["dual_decodes"] > 0, _busy(engine, "dual_decodes")


@pytest.mark.parametrize("n", REPLICAS)
def test_speculative_finals_match_jax(stack, n):
    """Drafted requests (JAX's own tokens as drafts on even requests) on
    the replicas: JAX's tokens, verify rounds counted."""
    tr_j, _ = stack
    audios = [_audio(0.4 + 0.05 * (i % 4), f=230 + 60 * i, seed=80 + i) for i in range(n + 2)]
    golden = [tr_j.transcribe(a, SR, max_new_tokens=20).tokens for a in audios]
    engine = _engine(stack, n, slots=8, max_decode_tokens=32)
    assert all(r.speculative for r in engine.replicas)

    async def run(eng):
        rs = await asyncio.gather(*[
            eng.transcribe(a, SR, max_new_tokens=20,
                           draft_tokens=np.asarray(golden[i]) if i % 2 == 0 else None)
            for i, a in enumerate(audios)])
        return [r.tokens for r in rs]

    _assert_tokens(_serve(engine, run), golden, f"dp{n} request")
    assert engine.stats["verify_rounds"] > 0


@pytest.mark.parametrize("n", REPLICAS)
def test_ring_path_matches_jax(stack, n):
    """A ring stream on each replica (packed ingest, the ring VAD, ring
    prefill): JAX's Transcriber on the int16 round trip of its audio."""
    tr_j, _ = stack
    audios = [_audio(0.64, f=440 + 50 * i, seed=3 + i) for i in range(n)]
    rts = [(np.clip(a, -1, 1) * 32767).astype(np.int16).astype(np.float32) / 32768.0
           for a in audios]
    golden = [tr_j.transcribe(rt, SR, max_new_tokens=8).tokens for rt in rts]
    engine = _engine(stack, n, slots=4, max_decode_tokens=32, n_streams=2 * n)

    async def run(eng):
        streams = [eng.alloc_stream() for _ in audios]
        assert sorted(s // eng.rows_per_replica for s in streams) == list(range(n)), streams
        for s, a in zip(streams, audios):
            pcm = _pcm(a)
            for c in range(10):
                eng.ingest(s, c, pcm[c * 2048:(c + 1) * 2048])
        probs = await asyncio.gather(*[eng.vad_window_ring(s, 0) for s in streams])
        assert all(0.0 <= p <= 1.0 for p in probs)
        rs = await asyncio.gather(*[eng.transcribe_ring(s, 0, 10, max_new_tokens=8)
                                    for s in streams])
        for s in streams:
            eng.free_stream(s)
        return [r.tokens for r in rs]

    _assert_tokens(_serve(engine, run), golden, f"dp{n} stream")
    assert all(s == 1 for s in _busy(engine, "ring_prefill_programs"))


# ---------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------


class _Recorder:
    """Wraps a replica's stream calls, recording (name, args) and passing
    them on."""

    def __init__(self, engine: BatchedEngine, log: list, r: int):
        for name in ("ingest", "free_stream", "interim_stagger", "confirm_speculative",
                     "eager_ok", "eager_outcome", "vad_window_ring", "transcribe_ring"):
            real = getattr(engine, name)

            def call(*args, _name=name, _real=real, **kw):
                log.append((r, _name, args[:2] if _name != "eager_outcome" else args))
                return _real(*args, **kw)

            setattr(engine, name, call)


def test_session_affinity(stack):
    """Rows spread over the replicas; every call on a stream reaches the
    replica that owns it, with its local row; full replicas give None."""
    engine = _engine(stack, 2, slots=2, max_decode_tokens=32, n_streams=4)
    log: list = []
    for r, rep in enumerate(engine.replicas):
        _Recorder(rep, log, r)
    streams = [engine.alloc_stream() for _ in range(4)]
    assert engine.alloc_stream() is None
    owners = [s // engine.rows_per_replica for s in streams]
    assert sorted(owners) == [0, 0, 1, 1], streams
    audio = _audio(0.64, seed=9)
    pcm = _pcm(audio)

    async def run(eng):
        s = streams[1]
        for c in range(10):
            eng.ingest(s, c, pcm[c * 2048:(c + 1) * 2048])
        await eng.vad_window_ring(s, 0)
        eng.interim_stagger(s)
        assert eng.eager_ok(s) in (True, False)
        eng.eager_outcome(True, s)
        r = await eng.transcribe_ring(s, 0, 10, max_new_tokens=4)
        eng.confirm_speculative(s)
        eng.free_stream(s)
        return r

    _serve(engine, run)
    owner, local = divmod(streams[1], engine.rows_per_replica)
    calls = {name for r, name, _ in log}
    assert calls == {"ingest", "vad_window_ring", "interim_stagger", "eager_ok", "eager_outcome",
                     "transcribe_ring", "confirm_speculative", "free_stream"}
    for r, name, args in log:
        assert r == owner, (r, name)
        if name == "eager_outcome":
            assert args == (True, local)
        elif name != "interim_stagger" or args:
            assert args[0] == local, (name, args)
    assert engine.alloc_stream() == streams[1]  # the freed row comes back


def test_host_requests_go_to_the_least_loaded_replica(stack):
    engine = _engine(stack, 3, slots=3, max_decode_tokens=32)
    engine._inflight = [2, 0, 1]
    assert engine._pick() == 1
    engine._inflight = [1, 1, 1]
    assert engine._pick() == 0


def test_eager_gate_is_the_streams_replica(stack):
    """eager_ok(stream) is the owner's decision (one replica's gate closed,
    the other's open); a host-path session (no row) asks the replica its
    next host request would go to, and its outcome reaches every gate."""
    engine = _engine(stack, 2, slots=4, max_decode_tokens=32, n_streams=4)
    a, b = engine.alloc_stream(), engine.alloc_stream()
    assert {a // 2, b // 2} == {0, 1}
    for rep in engine.replicas:
        rep.short_queue_ema = 0.0  # slack proven
    closed = engine.replicas[a // 2]
    closed.short_queue_ema = 1e9  # interims queueing on this replica only
    assert engine.eager_ok(a) is False and engine.eager_ok(b) is True
    assert closed.stats["eager_denied"] == 1 and closed.stats["eager_granted"] == 0
    engine._inflight = [0, 0]
    engine._inflight[a // 2] = 5  # the next host request goes to the open replica
    assert engine.eager_ok() is True
    for rep in engine.replicas:
        rep.eager_window_s = 0.0
    engine.eager_outcome(False)
    assert all(rep.eager_accept_ema < 1.0 for rep in engine.replicas)
    engine.shutdown()


def test_crashed_replica_makes_the_router_dead(stack):
    engine = _engine(stack, 2, slots=2, max_decode_tokens=32)
    assert engine.alive
    engine.replicas[1]._crashed = True
    assert not engine.alive
    engine.replicas[1]._crashed = False
    assert engine.alive
    engine.shutdown()


async def test_health_degraded_when_a_replica_crashed(aiohttp_client, stack):
    from sonicscribe_tpu_torch.serve.app import build_app

    engine = _engine(stack, 2, slots=2, max_decode_tokens=32)
    client = await aiohttp_client(build_app(AppConfig(), engine, engine.vad, {"model": "t"}))
    body = await (await client.get("/health")).json()
    assert body["status"] == "ok"
    assert body["engine_stats"]["ticks"] == 0 and "replicas" not in body["engine_stats"]
    engine.replicas[0]._crashed = True
    body = await (await client.get("/health")).json()
    assert body["status"] == "degraded"
    engine.replicas[0]._crashed = False
    engine.shutdown()


def test_build_runtime_data_parallel_on_the_cpu():
    """DATA_PARALLEL as a config knob: 4 replicas on the CPU, each with
    ceil(decode_slots / 4) long slots, reported in info; 1 builds the
    plain engine."""
    cfg = AppConfig()
    cfg.data_parallel, cfg.decode_slots = 4, 6
    engine, vad, info = build_runtime("tiny-random", "energy", cfg, device="cpu")
    try:
        assert info["data_parallel"] == 4 and isinstance(engine, DataParallelEngine)
        assert engine.mesh.shape == {"data": 4, "model": 1}
        assert [len(r.long.slots) for r in engine.replicas] == [2, 2, 2, 2]
        assert engine.N_STREAMS == 64 and engine.rows_per_replica == 16
        assert all(r.vad is not vad for r in engine.replicas[1:])
    finally:
        engine.shutdown()
    cfg.data_parallel = 1
    engine, _vad, info = build_runtime("tiny-random", "energy", cfg, device="cpu")
    assert info["data_parallel"] == 1 and isinstance(engine, BatchedEngine)
    engine.shutdown()


def test_config_reads_data_parallel(monkeypatch):
    monkeypatch.setenv("DATA_PARALLEL", "3")
    assert AppConfig().data_parallel == 3
    monkeypatch.delenv("DATA_PARALLEL")
    assert AppConfig().data_parallel == 1


def test_dryrun_twin_at_four_replicas(capsys):
    out = dryrun_multichip(4, ["cpu"] * 4)
    assert len(out["tokens"]) == 8 and 1 <= len(out["host_tokens"]) <= 8
    assert "dryrun_multichip OK: 4 devices, 8 streams" in capsys.readouterr().out
