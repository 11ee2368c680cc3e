"""The port's realtime load harness against the JAX package's (CPU).

make_stream_audio gives JAX's bytes; run_load, in accelerated mode (a stream
clock, each gate window drained), gives the JAX harness's committed count on
the same tiny f32 tree (the JAX tree x4, as the other parity tests use it)
on the batched and the threaded engine, and its keys.

What is pinned and why: committed_count follows from the gate's segments,
which the stream clock makes deterministic (one commit a segment, eager or
not, and the final flush commits each open one). Interim counts are not
compared: an interim is dropped while a decode of its stream holds the
lock, and how long that lasts is the engine's wall time, so both engines
are held only to having sent at least one."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.serve.engine_async import ThreadedEngine as ThreadedEngineJax
from sonicscribe_tpu.tools.loadtest import make_stream_audio as make_stream_audio_jax
from sonicscribe_tpu.tools.loadtest import run_load as run_load_jax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.tools import loadtest
from sonicscribe_tpu_torch.tools.loadtest import make_stream_audio, run_load
from sonicscribe_tpu_torch.vad.model import EnergyVad

BUCKETS = (64, 128)


@pytest.fixture(scope="module")
def stack():
    params_j = jax.tree.map(lambda x: x * 4.0,
                            init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32))
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=BUCKETS)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    tr = Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=BUCKETS)
    return tr_j, tr


def _load_both(make_engines, n_streams, seconds):
    """run_load on the JAX engine with the JAX harness and on the port's with
    the port's, accelerated, each in its own loop. -> (JAX, port) metrics."""
    eng_j, eng = make_engines()
    out = []
    for e, run, cfg in ((eng_j, run_load_jax, AppConfigJax()), (eng, run_load, AppConfig())):
        async def go(e=e, run=run, cfg=cfg):
            try:
                return await run(e, cfg, n_streams=n_streams, seconds=seconds, realtime=False)
            finally:
                e.shutdown()
        out.append(asyncio.run(go()))
    return out


@pytest.mark.parametrize("silence_s", [1.5, 2.56])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_stream_audio_bytes_equal_jax(seed, silence_s):
    got = make_stream_audio(9.0, seed=seed, silence_s=silence_s)
    assert got == make_stream_audio_jax(9.0, seed=seed, silence_s=silence_s)
    assert len(got) == 9 * 16000 * 2


def test_run_load_matches_jax_on_the_batched_engine(stack):
    tr_j, tr = stack
    want, got = _load_both(lambda: (
        BatchedEngineJax(tr_j, EnergyVadJax(), slots=4, max_decode_tokens=64),
        BatchedEngine(tr, EnergyVad(device="cpu"), slots=4, max_decode_tokens=64)), 4, 6.0)
    assert set(got) == set(want)
    assert got["errors"] == want["errors"] == 0, (got, want)
    # each stream speaks twice in 6 s; the first utterance of each commits
    assert got["committed_count"] == want["committed_count"] >= 4, (got, want)
    assert got["interim_count"] >= 1 and want["interim_count"] >= 1, (got, want)
    assert got["max_ingest_lag_s"] == 0.0  # accelerated: no realtime target


def test_ring_capacity_fallback_to_host_path(stack):
    """More sessions than ring rows: the overflow sessions take the
    host-audio path (stream_idx None) and still commit, as in JAX."""
    tr_j, tr = stack
    port = BatchedEngine(tr, EnergyVad(device="cpu"), slots=4, max_decode_tokens=64, n_streams=2)
    assert loadtest.host_path_sessions(port, 4) == 2
    want, got = _load_both(lambda: (
        BatchedEngineJax(tr_j, EnergyVadJax(), slots=4, max_decode_tokens=64, n_streams=2),
        port), 4, 6.0)
    assert got["errors"] == want["errors"] == 0, (got, want)
    assert got["committed_count"] == want["committed_count"] >= 4, (got, want)
    assert port.stats["vad_batches"] > 0  # the host sessions' gate windows
    assert len(port._free_streams) == 2  # the ring rows given back


def test_run_load_on_the_threaded_engine(stack):
    tr_j, tr = stack
    want, got = _load_both(lambda: (ThreadedEngineJax(tr_j, EnergyVadJax()),
                                    ThreadedEngine(tr, EnergyVad(device="cpu"))), 2, 4.0)
    assert loadtest.host_path_sessions(ThreadedEngine(tr, EnergyVad(device="cpu")), 2) == 2
    assert got["errors"] == want["errors"] == 0, (got, want)
    assert got["committed_count"] == want["committed_count"] >= 2, (got, want)


def test_main_on_the_cpu(capsys):
    """The CLI on tiny-random: one JSON line with run_load's keys, the
    engine's class split, and no device numbers (None on the CPU)."""
    loadtest.main(["--device", "cpu", "--streams", "2", "--seconds", "3", "--no-realtime"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == 0 and out["committed_count"] >= 2
    assert out["host_path_sessions"] == 0 and out["captured_on_run"] == 0
    assert out["backend"] == "cpu" and out["card"] is None
    assert out["device_rtt_ms"] is None and out["capture_probe_s"] is None
    assert out["model_info"]["engine"] == "batched"
    assert set(out["latency_by_class"]) <= {"short", "long"}
