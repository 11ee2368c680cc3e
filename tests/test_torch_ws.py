"""The port's stream surface through aiohttp on the CPU: the /ws/audio
protocol, resume and the detached-session sweeper, /vad/config,
/debug/profile, the web UI routes, the debug tap, and committed texts and
segment ids over WS against the JAX app (threaded engine) on the scaled
tiny f32 checkpoint."""

import asyncio
import json
import time
import wave

import jax
import numpy as np
import pytest

from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.serve.app import build_app as build_app_jax
from sonicscribe_tpu.serve.app import build_runtime as build_runtime_jax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.serve import app as app_module
from sonicscribe_tpu_torch.serve.app import build_app
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.vad.model import EnergyVad

SR = 16000

# the wire schema of each message type (the JAX package's tests/test_server.py)
WS_SCHEMA = {
    "connection_established": {"type", "client_id", "resumed", "config", "capabilities"},
    "tentative_output": {
        "type", "current_text", "text", "start_chunk_id", "end_chunk_id",
        "duration", "confidence", "processing_delay",
    },
    "committed_output": {
        "type", "text", "segment_id", "start_chunk_id", "end_chunk_id",
        "start_time", "end_time", "confidence", "processing_delay",
    },
    "pong": {"type", "t"},
    "connection_state": {
        "type", "client_id", "is_speaking", "vad_enabled", "vad_threshold",
        "buffered_chunks", "newest_chunk_id", "segments", "hotwords",
    },
    "config_updated": {"type", "vad_enabled", "threshold"},
    "hotwords_updated": {"type", "hotwords"},
    "error": {"type", "code", "message"},
    "debug_audio_info": {"type", "enabled", "path"},
}


def _assert_schema(messages):
    for m in messages:
        assert set(m) == WS_SCHEMA[m["type"]], m


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


def _pcm(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()


@pytest.fixture(scope="module")
def engines():
    """(JAX threaded engine from build_runtime, port engine) on tiny() f32,
    the JAX tree x4 so that the random model's tokens vary, carried over."""
    eng_j, _, _ = build_runtime_jax("tiny-random", "energy", AppConfigJax(),
                                    engine_kind="threaded")
    tr_j = eng_j.transcriber
    tr_j.params = jax.tree.map(lambda x: x * 4.0, tr_j.params)
    params = params_from_jax(jax.tree.map(np.asarray, tr_j.params), device="cpu")
    tr = Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=tuple(tr_j.buckets))
    eng = ThreadedEngine(tr, EnergyVad(device="cpu"))
    yield eng_j, eng
    eng_j.shutdown()
    eng.shutdown()


@pytest.fixture
def app(engines):
    eng = engines[1]
    return build_app(AppConfig(), eng, eng.vad, {"model": "tiny"})


async def _until(cond, timeout: float = 20.0) -> bool:
    """Poll cond every 10 ms until it holds (True) or the deadline (False)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            return False
        await asyncio.sleep(0.01)
    return True


async def _json(ws):
    return json.loads(await ws.receive_str())


async def test_ws_protocol(app, aiohttp_client):
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio")
    hello = await _json(ws)
    assert hello["type"] == "connection_established" and hello["resumed"] is False
    assert hello["config"]["audio_chunk_size"] == 2048
    health = await (await client.get("/health")).json()
    assert health["active_sessions"] == 1
    seen = [hello]

    async def ask(msg):
        await ws.send_str(json.dumps(msg))
        seen.append(await _json(ws))
        return seen[-1]

    assert (await ask({"type": "ping"}))["type"] == "pong"
    assert (await ask({"type": "hotwords_config", "hotwords": ["tpu", " ", "jax"]}))[
        "hotwords"] == ["tpu", "jax"]
    assert (await ask({"type": "hotwords_config", "hotwords": "tpu"}))["code"] == "bad_hotwords"
    r = await ask({"type": "vad_config", "vad_enabled": False, "threshold": 0.5})
    assert r == {"type": "config_updated", "vad_enabled": False, "threshold": 0.5}
    r = await ask({"type": "vad_config", "threshold": 2.0})  # out of range: kept
    assert r["threshold"] == 0.5 and r["vad_enabled"] is False
    await ws.send_str("this is not json")
    seen.append(await _json(ws))
    assert seen[-1]["code"] == "bad_json"
    assert (await ask({"type": "warp_drive"}))["code"] == "unknown_message"
    # frame repair: 20 bytes zero-padded to one frame, 5000 bytes split into three
    await ws.send_bytes(b"\x01\x02" * 10)
    await ws.send_bytes(b"\x00" * 5000)
    state = await ask({"type": "get_state"})
    assert state["hotwords"] == ["tpu", "jax"] and state["vad_enabled"] is False
    assert state["newest_chunk_id"] == 3 and state["buffered_chunks"] == 4
    assert abs(state["vad_threshold"] - 0.5) < 1e-9
    _assert_schema(seen)
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()
    assert await _until(lambda: not app["sessions"])
    assert (await (await client.get("/health")).json())["active_sessions"] == 0


async def test_ws_inactivity_timeout(app, aiohttp_client, monkeypatch):
    monkeypatch.setattr(app_module, "RECEIVE_TIMEOUT_S", 0.05)
    monkeypatch.setattr(app_module, "INACTIVITY_DISCONNECT_S", 0.1)
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio")
    await _json(ws)
    err = await _json(ws)
    assert err["type"] == "error" and err["code"] == "inactivity_timeout"
    assert (await ws.receive()).type.name in ("CLOSE", "CLOSED")
    assert app["detached"] == {}  # a timeout closes for good


async def test_resume_preserves_session_state(app, aiohttp_client):
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio")
    cid = (await _json(ws))["client_id"]
    await ws.send_str(json.dumps({"type": "hotwords_config", "hotwords": ["keep", "me"]}))
    await ws.receive_str()
    await ws.send_bytes(b"\x00" * 2048)
    await ws.close()  # abnormal: no {"type": "close"}

    ws2 = await client.ws_connect(f"/ws/audio?resume={cid}")
    hello = await _json(ws2)
    assert hello["resumed"] is True and hello["client_id"] == cid
    await ws2.send_str(json.dumps({"type": "get_state"}))
    state = await _json(ws2)
    assert state["hotwords"] == ["keep", "me"] and state["newest_chunk_id"] == 0
    await ws2.send_str(json.dumps({"type": "close"}))
    await ws2.close()


async def test_resume_unknown_id_starts_fresh(app, aiohttp_client):
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio?resume=nonexistent")
    hello = await _json(ws)
    assert hello["resumed"] is False and hello["client_id"] != "nonexistent"
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()


async def test_detached_sessions_swept_without_new_connects(app, aiohttp_client):
    """Abnormal disconnects with no later connection are cleaned up by the
    app's periodic sweeper once the resume window has passed."""
    app["resume_window_s"] = 0.2  # read by the sweeper started on startup
    client = await aiohttp_client(app)
    for _ in range(5):
        ws = await client.ws_connect("/ws/audio")
        await ws.receive_str()
        await ws.send_bytes(b"\x00" * 2048)
        await ws.close()
    assert await _until(lambda: len(app["detached"]) == 5)
    parked = [s for _, s in app["detached"].values()]
    assert len(parked) == 5 and not any(s.active for s in parked)
    assert await _until(lambda: not app["detached"]
                        and all(s._vad_worker_task is None for s in parked))
    assert app["detached"] == {}
    assert all(s._vad_worker_task is None and not s._tasks for s in parked)


async def test_explicit_close_is_not_resumable(app, aiohttp_client):
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio")
    cid = (await _json(ws))["client_id"]
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()
    ws2 = await client.ws_connect(f"/ws/audio?resume={cid}")
    assert (await _json(ws2))["resumed"] is False
    await ws2.send_str(json.dumps({"type": "close"}))
    await ws2.close()


async def test_vad_config_bounds_and_live_sessions(app, aiohttp_client):
    client = await aiohttp_client(app)
    ws = await client.ws_connect("/ws/audio")
    await _json(ws)
    for body in ({"threshold": 7.0}, {"threshold": 0.01}, {"smoothing_window": 0},
                 {"smoothing_window": 11}):
        assert (await client.post("/vad/config", json=body)).status == 400
    for data in (b"not json", b'["threshold"]', b'{"threshold": "high"}',
                 b'{"smoothing_window": null}'):
        assert (await client.post("/vad/config", data=data)).status == 400
    assert app["config"].vad_speech_threshold == 0.6  # nothing applied
    r = await client.post("/vad/config", json={"threshold": 0.85, "smoothing_window": 3})
    assert r.status == 200
    assert (await r.json())["config"] == {"threshold": 0.85, "smoothing_window": 3}
    assert app["config"].vad_speech_threshold == 0.85
    await ws.send_str(json.dumps({"type": "get_state"}))
    state = await _json(ws)
    assert abs(state["vad_threshold"] - 0.85) < 1e-9
    session = next(iter(app["sessions"].values()))
    assert session.gate.cfg.smoothing_window == 3
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()


async def test_debug_profile_writes_a_trace(app, aiohttp_client, tmp_path):
    client = await aiohttp_client(app)
    r = await client.get("/debug/profile", params={"seconds": "0.1", "dir": str(tmp_path)})
    assert r.status == 200
    body = await r.json()
    assert body["seconds"] == 0.1 and body["trace_dir"] == str(tmp_path)
    trace = json.loads((tmp_path / body["trace"].rsplit("/", 1)[-1]).read_text())
    assert "traceEvents" in trace


async def test_web_ui_routes(app, aiohttp_client):
    client = await aiohttp_client(app)
    r = await client.get("/")
    assert r.status == 200 and "<html" in (await r.text()).lower()
    index = app_module.FRONTEND_DIR / "index.html"
    script = next(p for p in app_module.FRONTEND_DIR.rglob("*.js"))
    rel = script.relative_to(app_module.FRONTEND_DIR).as_posix()
    r = await client.get(f"/static/{rel}")
    assert r.status == 200 and (await r.read()) == script.read_bytes()
    assert (await client.get("/static/index.html")).status == 200 and index.exists()


async def test_debug_tap_through_ws(engines, aiohttp_client, tmp_path):
    eng = engines[1]
    cfg = AppConfig()
    cfg.debug_audio_enabled, cfg.debug_audio_base_dir = True, str(tmp_path)
    client = await aiohttp_client(build_app(cfg, eng, eng.vad))
    ws = await client.ws_connect("/ws/audio")
    info = await _json(ws)
    assert info["type"] == "debug_audio_info" and info["enabled"] is True
    assert (await _json(ws))["type"] == "connection_established"
    pcm = _pcm(_silence(0.3))
    await ws.send_bytes(pcm)
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()
    assert await _until(lambda: not client.app["sessions"])
    with wave.open(info["path"], "rb") as w:
        assert w.readframes(w.getnframes()) == pcm


async def _stream(client, pcm: bytes, n_committed: int) -> list[dict]:
    """Send the PCM in 2048-byte frames, wait for n_committed committed
    outputs, close. -> every message after the hello."""
    ws = await client.ws_connect("/ws/audio")
    await ws.receive_str()
    msgs = []

    async def reader():
        async for m in ws:
            msgs.append(json.loads(m.data))

    task = asyncio.ensure_future(reader())
    for off in range(0, len(pcm), 2048):
        await ws.send_bytes(pcm[off : off + 2048])
        await asyncio.sleep(0.001)
    for _ in range(1200):
        if sum(m["type"] == "committed_output" for m in msgs) >= n_committed:
            break
        await asyncio.sleep(0.05)
    await ws.send_str(json.dumps({"type": "close"}))
    await ws.close()
    await task
    return msgs


async def test_committed_texts_match_the_jax_app(engines, aiohttp_client):
    """The same frames through the port's app and the JAX app: the same
    committed segments, ids and texts (interims depend on timing: each is
    dropped while a decode holds the session's lock)."""
    eng_j, eng = engines
    pcm = _pcm(np.concatenate([_silence(0.7, 31), _speech(2.0, 32), _silence(2.0, 33),
                               _speech(1.2, 34), _silence(2.0, 35)]))
    client_j = await aiohttp_client(build_app_jax(AppConfigJax(), eng_j, eng_j.vad))
    client = await aiohttp_client(build_app(AppConfig(), eng, eng.vad))
    want = await _stream(client_j, pcm, 2)
    got = await _stream(client, pcm, 2)
    _assert_schema(got)

    def committed(msgs):
        keys = ("segment_id", "text", "start_chunk_id", "end_chunk_id", "start_time",
                "end_time")
        return [{k: m[k] for k in keys} for m in msgs if m["type"] == "committed_output"]

    assert committed(got) == committed(want)
    assert [m["segment_id"] for m in committed(got)] == ["0", "1"]
    assert any(m["text"] for m in committed(got))
