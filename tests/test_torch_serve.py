"""Port parity for the serving slice: energy VAD, segmentation and the
/transcribe/file NDJSON stream vs the JAX package on the CPU, plus the
port's device and import rules."""

import json
import subprocess
import sys
from pathlib import Path

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.audio.wav import write_wav
from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.ops.quant import quantize_params_int8
from sonicscribe_tpu.serve.app import build_app as build_app_jax
from sonicscribe_tpu.serve.engine_async import ThreadedEngine as ThreadedEngineJax
from sonicscribe_tpu.serve.files import FileTranscriptionConfig as FileCfgJax
from sonicscribe_tpu.serve.files import plan_segments as plan_segments_jax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu.vad.model import window_probs as window_probs_jax
from sonicscribe_tpu_torch.audio.mel import log_mel_spectrogram
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import init_random, params_from_jax
from sonicscribe_tpu_torch.serve.app import build_app
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, plan_segments
from sonicscribe_tpu_torch.serve.runtime import build_runtime
from sonicscribe_tpu_torch.vad.model import EnergyVad, window_probs

SR = 16000


def _speech(sec, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _silence(sec, seed=1):
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32
    )


def _payload():
    """Two speech spans split by 1.5 s of silence; the first is longer than
    a 2 s max_segment_duration, so it is cut in two."""
    return np.concatenate(
        [_silence(0.5), _speech(2.6, 2), _silence(1.5, 3), _speech(1.2, 4), _silence(0.4, 5)]
    )


def test_energy_vad_probs_and_segments():
    audio = _payload()
    want = window_probs_jax(EnergyVadJax(), audio)
    got = window_probs(EnergyVad(device="cpu"), audio)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    cfg = dict(max_segment_duration=2.0)
    segs_j = plan_segments_jax(audio, EnergyVadJax(), FileCfgJax.from_dict(cfg))
    segs = plan_segments(audio, EnergyVad(device="cpu"), FileTranscriptionConfig.from_dict(cfg))
    assert [vars(s) for s in segs] == [vars(s) for s in segs_j]
    assert len(segs) == 3 and segs[0].is_long_segment


def _engine_pair(quantize=None):
    """(JAX engine, port engine) on the same tiny() f32 tree, quantized by
    the JAX package with `quantize` when given, carried over bit-exact."""
    # scaled so the random model's greedy tokens vary (see test_torch_transcriber)
    params_j = jax.tree.map(
        lambda x: x * 4.0, init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32)
    )
    if quantize is not None:
        params_j = quantize(params_j)
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=(128, 256))
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    tr = Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=(128, 256))
    return ThreadedEngineJax(tr_j, EnergyVadJax()), ThreadedEngine(tr, EnergyVad(device="cpu"))


@pytest.fixture(scope="module")
def engines():
    eng_j, eng = _engine_pair()
    yield eng_j, eng
    eng_j.shutdown()
    eng.shutdown()


@pytest.fixture(scope="module")
def int8_decoder_engines():
    """The int8-decoder mode: the decoder's projections quantized."""
    eng_j, eng = _engine_pair(lambda p: quantize_params_int8(p, decoder_only=True))
    yield eng_j, eng
    eng_j.shutdown()
    eng.shutdown()


async def _post_file(client, wav: bytes, stream: bool):
    form = aiohttp.FormData()
    form.add_field("file", wav, filename="a.wav", content_type="audio/wav")
    form.add_field("config_str", json.dumps({"max_segment_duration": 2.0}))
    r = await client.post(f"/transcribe/file?stream={'true' if stream else 'false'}", data=form)
    assert r.status == 200
    if stream:
        return [json.loads(line) for line in (await r.text()).splitlines() if line]
    return await r.json()


def _configs():
    cfg_j, cfg = AppConfigJax(), AppConfig()
    cfg_j.file_max_new_tokens = cfg.file_max_new_tokens = 24
    return cfg_j, cfg


async def _assert_same_ndjson(eng_j, eng, aiohttp_client):
    cfg_j, cfg = _configs()
    wav = write_wav(_payload(), SR)
    client_j = await aiohttp_client(build_app_jax(cfg_j, eng_j, eng_j.vad))
    client = await aiohttp_client(build_app(cfg, eng, eng.vad))
    want = await _post_file(client_j, wav, stream=True)
    got = await _post_file(client, wav, stream=True)

    assert [m["type"] for m in got] == [m["type"] for m in want]
    assert got[0]["type"] == "initialization" and got[-1]["type"] == "final_summary"
    assert got[1] == want[1]  # segments_summary: same segment times

    def results(msgs):
        segs = sorted((m for m in msgs if m["type"] == "segment_result"),
                      key=lambda m: m["segment_index"])
        keys = ("segment_index", "start_time", "end_time", "text", "is_long_segment")
        return [{k: m[k] for k in keys} for m in segs]

    assert results(got) == results(want)
    assert len(results(got)) == 3 and any(r["text"] for r in results(got))
    assert got[-1]["full_text"] == want[-1]["full_text"]
    assert got[-1]["failed_segments"] == 0


async def test_transcribe_file_matches_jax_app(engines, aiohttp_client):
    await _assert_same_ndjson(*engines, aiohttp_client)


async def test_transcribe_file_matches_jax_app_int8_decoder(int8_decoder_engines, aiohttp_client):
    await _assert_same_ndjson(*int8_decoder_engines, aiohttp_client)
    _, eng = int8_decoder_engines
    _, cfg = _configs()
    cfg.quant_mode = "int8-decoder"
    client = await aiohttp_client(build_app(cfg, eng, eng.vad, {"quant_mode": cfg.quant_mode}))
    assert (await (await client.get("/debug/config")).json())["quant_mode"] == "int8-decoder"
    assert (await (await client.get("/health")).json())["model_info"]["quant_mode"] == "int8-decoder"


async def test_aggregate_mode_and_health(engines, aiohttp_client):
    _, eng = engines
    _, cfg = _configs()
    client = await aiohttp_client(build_app(cfg, eng, eng.vad, {"model": "tiny"}))
    body = await _post_file(client, write_wav(_payload(), SR), stream=False)
    assert len(body["segments"]) == 3 and body["errors"] == []
    assert body["summary"]["type"] == "final_summary"
    health = await (await client.get("/health")).json()
    assert health["status"] == "ok" and health["engine_stats"]["requests"] >= 3
    d = await (await client.get("/debug/config")).json()
    assert d["decode_budgets"]["file"] == 24 and d["samples_per_chunk"] == 1024


async def test_health_degraded_when_engine_dead(engines, aiohttp_client):
    """/health: ok with a live engine, degraded once its scheduler has
    crashed (a supervisor's liveness probe restarts the process), and
    initializing without an engine, as the JAX server reports it."""
    _, eng = engines
    _, cfg = _configs()
    app = build_app(cfg, eng, eng.vad)
    client = await aiohttp_client(app)
    assert (await (await client.get("/health")).json())["status"] == "ok"

    class Dead:
        alive = False
        stats = {"ticks": 1}

    app["engine"] = Dead()
    body = await (await client.get("/health")).json()
    assert body["status"] == "degraded" and body["model_loaded"]
    app["engine"] = None
    body = await (await client.get("/health")).json()
    assert body["status"] == "initializing" and not body["model_loaded"]


async def test_crash_self_heals_through_serving(engines, aiohttp_client):
    """On the batched engine: a wedged tick crashes the engine (the file
    request fails, /health degraded, and a request while the tick is still
    stuck fails too); once the tick drains, the next request restarts the
    scheduler in-process, succeeds, and /health is ok again (the JAX
    server's test_crash_self_heals_through_serving)."""
    import asyncio
    import time

    from sonicscribe_tpu_torch.engine.batcher import BatchedEngine

    _, threaded = engines
    eng = BatchedEngine(threaded.transcriber, EnergyVad(device="cpu"), slots=4,
                        max_decode_tokens=32, n_streams=4)
    _, cfg = _configs()
    client = await aiohttp_client(build_app(cfg, eng, eng.vad))
    wav = write_wav(_speech(1.0), SR)

    async def drained(timeout=20.0):
        t0 = time.perf_counter()
        while eng._tick_busy and time.perf_counter() - t0 < timeout:
            await asyncio.sleep(0.01)
        return not eng._tick_busy

    real_tick = eng._tick
    try:
        eng.tick_stall_dump_s, eng.tick_stall_abort_s = 0.1, 0.3
        eng._tick = lambda *_a, **_k: time.sleep(3.0)  # wedge
        summary = (await _post_file(client, wav, stream=False))["summary"]
        assert summary["failed_segments"] >= 1
        assert (await (await client.get("/health")).json())["status"] == "degraded"
        if eng._tick_busy:  # still stuck: requests keep failing
            summary = (await _post_file(client, wav, stream=False))["summary"]
            assert summary["failed_segments"] >= 1
        assert await drained()
        eng._tick = real_tick  # the card recovered
        eng.tick_stall_dump_s, eng.tick_stall_abort_s = 60.0, 600.0
        summary = (await _post_file(client, wav, stream=False))["summary"]
        assert summary["failed_segments"] == 0 and summary["successful_segments"] >= 1
        assert (await (await client.get("/health")).json())["status"] == "ok"
    finally:
        eng._tick = real_tick
        await drained()
        eng.shutdown()


def test_build_runtime_on_cpu():
    engine, vad, info = build_runtime("tiny-random", "energy", AppConfig(), device="cpu",
                                      engine_kind="threaded")
    try:
        r = engine.transcriber.transcribe(_speech(0.5), SR, max_new_tokens=4)
        assert isinstance(r.text, str) and info["device"] == "cpu"
        cfg = AppConfig()
        cfg.quant_mode = "int8"
        int8_engine, _, int8_info = build_runtime("tiny-random", "energy", cfg, device="cpu",
                                                  engine_kind="threaded")
        int8_engine.shutdown()
        assert int8_info["quant_mode"] == "int8"
        cfg.quant_mode = "int4"
        with pytest.raises(ValueError, match="int8-decoder-a8"):
            build_runtime("tiny-random", "energy", cfg, device="cpu")
    finally:
        engine.shutdown()


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_runtime("tiny-random", "energy", AppConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_random(tiny(), seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnergyVad()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        log_mel_spectrogram(np.zeros(1600, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros((2, 2), np.float32)})
    cfg = AppConfig()
    cfg.quant_mode = "int8"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_runtime("tiny-random", "energy", cfg)


# the load harness, the serving benches on it, the decode microbenches, the
# deploy tools, the Silero twin and the probe-retry layer (bench_resilience),
# and data- and tensor-parallel serving (the
# mesh, the tp group, the dry run, the replicas' router): each imported with
# jax and the JAX package blocked (and, below, aiohttp too)
NEW_TOOLS = tuple(f"sonicscribe_tpu_torch.tools.{m}" for m in (
    "golden", "loadtest", "bench_nn_vad", "bench_interim", "bench_commit", "bench_eager",
    "bench_spec", "bench_kcap", "bench_mixed", "bench_scale", "bench_hbm",
    "bench_decode_parts", "bench_decode", "bench_rows", "bench_flash", "prewarm",
    "bench_warmup", "torch_silero", "bench_resilience")) + (
    "sonicscribe_tpu_torch.parallel", "sonicscribe_tpu_torch.parallel.mesh",
    "sonicscribe_tpu_torch.parallel.tp", "sonicscribe_tpu_torch.parallel.dryrun",
    "sonicscribe_tpu_torch.engine.replicas")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
NEW_TOOLS = """ + repr(NEW_TOOLS) + r"""

BLOCKED = ["jax", "jaxlib", "sonicscribe_tpu"]

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import sonicscribe_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "sonicscribe_tpu_torch.")]
for name in names:
    if not name.startswith("sonicscribe_tpu_torch.serve.__main__"):
        if name != "sonicscribe_tpu_torch.serve.app":
            importlib.import_module(name)
assert "aiohttp" not in sys.modules, "aiohttp imported outside serve/app.py"
assert all(name in sys.modules for name in NEW_TOOLS), NEW_TOOLS
importlib.import_module("sonicscribe_tpu_torch.serve.app")
importlib.import_module("sonicscribe_tpu_torch.serve.__main__")
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        timeout=240, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) >= 41


# every module but serve/app.py (and serve/__main__.py, which runs it)
# imports with aiohttp, jax and the JAX package blocked: the card machine
# has no aiohttp, and chip_smoke.py drives the stream without it. Nor has it
# safetensors, tokenizers or transformers, which no module imports at import
# time (the checkpoint tools read safetensors themselves)
_IMPORT_WITHOUT_AIOHTTP = _IMPORT_ALL.replace(
    'BLOCKED = ["jax", "jaxlib", "sonicscribe_tpu"]',
    'BLOCKED = ["jax", "jaxlib", "sonicscribe_tpu", "aiohttp", "safetensors", "tokenizers", '
    '"transformers"]',
).split('importlib.import_module("sonicscribe_tpu_torch.serve.app")')[0] + r"""
for name in ("sonicscribe_tpu_torch.serve.session", "sonicscribe_tpu_torch.stream.buffer",
             "sonicscribe_tpu_torch.vad.gate", "sonicscribe_tpu_torch.native",
             "sonicscribe_tpu_torch.serve.debug_tap", "sonicscribe_tpu_torch.tools.safetensors_io",
             "sonicscribe_tpu_torch.tools.convert_weights", "sonicscribe_tpu_torch.tools.export_hf",
             "sonicscribe_tpu_torch.tools.convert_silero",
             "sonicscribe_tpu_torch.tools.verify_checkpoint",
             "sonicscribe_tpu_torch.tools.torch_reference", *NEW_TOOLS):
    assert name in sys.modules, name
try:
    importlib.import_module("sonicscribe_tpu_torch.serve.app")
except ImportError as e:
    assert "aiohttp" in str(e), e
else:
    raise AssertionError("serve/app.py imported with aiohttp blocked")
print(len(names))
"""


def test_port_imports_no_aiohttp_outside_the_app():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_WITHOUT_AIOHTTP], capture_output=True, text=True,
        timeout=240, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip()) >= 41
