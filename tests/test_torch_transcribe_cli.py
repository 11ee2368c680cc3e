"""The port's file CLI (`python -m sonicscribe_tpu_torch.transcribe`), run in a
subprocess that blocks every import of JAX and of the JAX package: its
NDJSON lines equal those of the port's `transcribe_file_stream` on a runtime
built the same way (same model spec, same seed, the batched engine) in the
test process. The model is tiny-random, or a checkpoint of tiny() written
by the JAX package with its weights scaled by 4, whose texts are not empty.
On that checkpoint the lines also equal those of the JAX CLI's pipeline
(its `build_runtime` with the batched engine, `decode_audio` and
`transcribe_file_stream`, as its own CLI runs them) on the same WAV: the
segment plan, each segment's text and the full text. The CLI builds the
batched engine, as the JAX CLI does."""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.serve.app import build_runtime as build_runtime_jax
from sonicscribe_tpu.serve.decode import decode_audio as decode_audio_jax
from sonicscribe_tpu.serve.files import FileTranscriptionConfig as FileCfgJax
from sonicscribe_tpu.serve.files import transcribe_file_stream as transcribe_file_stream_jax
from sonicscribe_tpu.tools.convert_weights import save_checkpoint

from sonicscribe_tpu_torch.audio.wav import write_wav
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.serve.decode import decode_audio
from sonicscribe_tpu_torch.serve.files import FileTranscriptionConfig, transcribe_file_stream
from sonicscribe_tpu_torch import transcribe as cli_module
from sonicscribe_tpu_torch.serve import runtime as runtime_module
from sonicscribe_tpu_torch.serve.runtime import build_runtime

SR = 16000
MAX_NEW = 8
ROOT = Path(__file__).resolve().parents[1]

_RUN_CLI = r"""
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonicscribe_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["transcribe"] + sys.argv[1:]
runpy.run_module("sonicscribe_tpu_torch.transcribe", run_name="__main__")
"""


def _audio() -> np.ndarray:
    """Two speech-like spans split by 1.5 s of near silence."""
    rng = np.random.default_rng(0)

    def speech(sec):
        t = np.arange(int(SR * sec)) / SR
        return 0.3 * np.sin(2 * np.pi * 300 * t) * (1 + np.sin(2 * np.pi * 2 * t))

    x = np.concatenate([np.zeros(SR // 2), speech(1.4), np.zeros(3 * SR // 2), speech(0.9)])
    return (x + 0.001 * rng.standard_normal(len(x))).astype(np.float32)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "a.wav"
    path.write_bytes(write_wav(_audio(), SR))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """'tiny-random', and a tiny() f32 checkpoint scaled by 4 (so that the
    random model's greedy tokens vary)."""
    path = tmp_path_factory.mktemp("ckpt")
    params = jax.tree.map(
        lambda x: x * 4.0, init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32)
    )
    save_checkpoint(params, tiny_jax(), str(path))
    return {"tiny-random": "tiny-random", "scaled": str(path)}


def _cli(model, *args) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", _RUN_CLI, *map(str, args), "--model", model,
         "--device", "cpu", "--max-new-tokens", str(MAX_NEW)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return [line for line in out.stdout.splitlines() if line]


def _in_process(model, path, vad: bool, hotwords: list[str], quant: str) -> list[dict]:
    config = AppConfig()
    config.quant_mode = quant
    engine, vad_model, _ = build_runtime(model, "energy", config, device="cpu",
                                         engine_kind="batched")
    try:
        audio = decode_audio(path.read_bytes(), str(path), engine.transcriber.device)
        file_cfg = FileTranscriptionConfig(vad_enabled=vad, hotwords=hotwords,
                                           max_new_tokens=MAX_NEW)

        async def collect():
            return [m async for m in transcribe_file_stream(
                audio, engine, vad_model if vad else None, file_cfg, str(path))]

        return asyncio.run(collect())
    finally:
        engine.shutdown()


def _jax_pipeline(path, wav_path, vad: bool, hotwords: list[str], quant: str) -> list[dict]:
    """The JAX CLI's file pipeline on the checkpoint at `path`: its
    build_runtime with the batched engine."""
    config = AppConfigJax()
    config.quant_mode = quant
    engine, vad_model, _ = build_runtime_jax(path, "energy", config, "batched")
    try:
        audio = decode_audio_jax(wav_path.read_bytes(), str(wav_path))
        file_cfg = FileCfgJax(vad_enabled=vad, hotwords=hotwords, max_new_tokens=MAX_NEW)

        async def collect():
            return [m async for m in transcribe_file_stream_jax(
                audio, engine, vad_model if vad else None, file_cfg, str(wav_path))]

        return asyncio.run(collect())
    finally:
        engine.shutdown()


def _comparable(msgs: list[dict]) -> list[dict]:
    """Messages without their wall-clock fields, segment results in
    segment order."""
    clean = [{k: v for k, v in m.items() if k not in ("rtf", "processing_time", "progress")}
             for m in msgs]
    results = sorted((m for m in clean if m["type"] == "segment_result"),
                     key=lambda m: m["segment_index"])
    rest = [m for m in clean if m["type"] != "segment_result"]
    return rest[:-1] + results + rest[-1:]


@pytest.mark.parametrize("model,flags,vad,hotwords,quant", [
    ("tiny-random", (), False, [], "native"),
    ("scaled", (), False, [], "native"),
    ("scaled", ("--vad",), True, [], "native"),
    ("scaled", ("--hotwords", "hello, world", "--vad", "--quant", "int8-decoder"), True,
     ["hello", "world"], "int8-decoder"),
])
def test_cli_ndjson_equals_the_file_pipeline(models, wav_path, model, flags, vad, hotwords,
                                             quant):
    got = [json.loads(line) for line in _cli(models[model], wav_path, *flags)]
    want = _in_process(models[model], wav_path, vad, hotwords, quant)
    assert [m["type"] for m in got][0] == "initialization"
    assert got[-1]["type"] == "final_summary" and got[-1]["failed_segments"] == 0
    assert _comparable(got) == _comparable(want)
    assert got[0]["vad_enabled"] is vad and got[0]["hotwords"] == hotwords
    if vad:
        assert got[0]["total_segments"] == 2
    if model == "scaled":
        assert got[-1]["full_text"]
        jax_msgs = _jax_pipeline(models[model], wav_path, vad, hotwords, quant)
        assert _comparable(got) == _comparable(jax_msgs)


def test_cli_info(wav_path):
    lines = _cli("tiny-random", wav_path, "--info", "--quant", "int8")
    assert len(lines) == 1
    config = AppConfig()
    config.quant_mode = "int8"
    engine, _, info = build_runtime("tiny-random", "energy", config, device="cpu",
                                    engine_kind="batched")
    engine.shutdown()
    assert json.loads(lines[0]) == info and info["quant_mode"] == "int8"
    assert info["engine"] == "batched"


def test_cli_builds_the_batched_engine(monkeypatch, wav_path):
    """main asks build_runtime for the batched engine, as the JAX CLI does."""
    asked = []

    class Built(Exception):
        pass

    def fake_build_runtime(model, vad, config, device=None, engine_kind="batched", **kw):
        asked.append((model, engine_kind, device))
        raise Built

    monkeypatch.setattr(runtime_module, "build_runtime", fake_build_runtime)
    with pytest.raises(Built):
        cli_module.main([str(wav_path), "--device", "cpu"])
    assert asked == [("tiny-random", "batched", "cpu")]
