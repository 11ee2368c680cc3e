"""Port parity for the streaming slice on the CPU: the chunk ring and
ChunkBuffer, the VAD gate, the energy VAD's per-window step and the
engine's VAD window, the debug audio tap, and StreamSession's messages
against the JAX package's StreamSession on the threaded engine, on the
scaled tiny f32 checkpoint."""

import asyncio
import os
import time
import wave
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from chip_smoke import Tracked, settle

from sonicscribe_tpu import native as native_jax
from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.serve.app import build_runtime as build_runtime_jax
from sonicscribe_tpu.serve.engine_async import ThreadedEngine as ThreadedEngineJax
from sonicscribe_tpu.serve.session import StreamSession as StreamSessionJax
from sonicscribe_tpu.stream.buffer import ChunkBuffer as ChunkBufferJax
from sonicscribe_tpu.vad.gate import VadGate as VadGateJax
from sonicscribe_tpu.vad.gate import VadGateConfig as VadGateConfigJax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch import native
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.transcriber import Transcriber, TranscribeResult
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.serve.debug_tap import DebugAudioTap
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.serve.session import StreamSession
from sonicscribe_tpu_torch.stream.buffer import ChunkBuffer
from sonicscribe_tpu_torch.vad.gate import VadGate, VadGateConfig
from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES, EnergyVad

SR = 16000
CHUNK = 1024  # samples per 2048-byte frame
VAD_TOL = 1e-6  # probability: float32 band energies summed in another order


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


def _frames(audio: np.ndarray) -> list[bytes]:
    """2048-byte PCM16 frames, the last zero-padded."""
    n = -(-len(audio) // CHUNK) * CHUNK
    x = np.zeros(n, np.float32)
    x[: len(audio)] = audio
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    return [pcm[i : i + CHUNK].tobytes() for i in range(0, n, CHUNK)]


def _chunk(value: int) -> bytes:
    return np.full(CHUNK, value, dtype="<i2").tobytes()


# ---------------------------------------------------------------------
# the native ring and ChunkBuffer
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("g++ unavailable; the NumPy fallback is covered by the python backend")
    return lib


def test_native_library_builds_outside_the_package(lib):
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


def test_pcm_conversion_matches_numpy_and_jax(lib):
    pcm = np.random.default_rng(0).integers(-32768, 32768, 4096, dtype=np.int16).tobytes()
    want = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm), want)
    np.testing.assert_array_equal(native.pcm16_to_f32(pcm), native_jax.pcm16_to_f32(pcm))


def test_rms_peak(lib):
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(1024) / 16000)).astype(np.float32)
    pcm = (x * 32767).astype("<i2").tobytes()
    rms, peak = native.rms_peak(pcm)
    assert abs(rms - 0.5 / np.sqrt(2)) < 0.01 and abs(peak - 0.5) < 0.01
    assert (rms, peak) == native_jax.rms_peak(pcm)


def test_ring_push_read_roundtrip(lib):
    ring = native.NativeChunkRing(capacity_chunks=8, chunk_bytes=2048)
    chunks = [np.full(1024, i * 100, dtype="<i2").tobytes() for i in range(5)]
    assert [ring.push(c) for c in chunks] == list(range(5))
    want = np.concatenate([np.frombuffer(chunks[i], "<i2").astype(np.float32) / 32768.0
                           for i in (1, 2, 3)])
    np.testing.assert_array_equal(ring.read_f32(1, 3), want)


def test_ring_eviction(lib):
    ring = native.NativeChunkRing(capacity_chunks=4, chunk_bytes=4)
    for i in range(10):
        ring.push(np.int16([i, i]).tobytes())
    assert (ring.oldest_id, ring.next_id) == (6, 10)
    out = ring.read_f32(0, 9)  # the evicted ids are skipped from the front
    assert len(out) == 4 * 2
    np.testing.assert_allclose(out[::2] * 32768.0, [6, 7, 8, 9])


def test_ring_rejects_a_wrong_chunk_size(lib):
    with pytest.raises(ValueError):
        native.NativeChunkRing(4, 2048).push(b"\x00" * 100)


def _buffers(backend, clock):
    """(JAX ChunkBuffer, port ChunkBuffer) on one backend and clock."""
    use_native = backend == "native"
    pair = (ChunkBufferJax(use_native=use_native, clock=clock),
            ChunkBuffer(use_native=use_native, clock=clock))
    if any(b.backend != backend for b in pair):
        pytest.skip("native lib unavailable")
    return pair


def _buffer_scenario(buf, now, name):
    """One scenario's observable results on one buffer."""
    out = []
    if name == "ranges":
        for i in range(50):
            now[0] = i * 0.064
            out.append(buf.add_chunk(_chunk(i * 100)).chunk_id)
        out.append(buf.audio_in_range(2, 4))
        seg = buf.start_segment(10)
        out.append(buf.interim_audio())
        buf.finalize_segment(25)
        out.append(buf.committed_audio(seg))
        out.append(buf.interim_audio())
    elif name == "odd frames":  # short frames take the dict path on both backends
        for i, n in enumerate((1024, 100, 1024, 2048, 7)):
            out.append(buf.add_chunk(np.full(n, i, "<i2").tobytes()).chunk_id)
        out.append(buf.audio_in_range(0, 4))
    elif name == "segments":
        for i in range(10):
            buf.add_chunk(_chunk(i))
        for s in range(5):
            buf.start_segment(s)
            out.append(asdict(buf.finalize_segment(s)))
        out.append([asdict(s) for s in buf.segments])
    elif name == "eviction":  # 38 s of chunks, 30 s kept; the open segment protected
        for i in range(600):
            now[0] = i * 0.064
            buf.add_chunk(_chunk(i))
            if i == 100:
                seg = buf.start_segment(90)
        out.append(buf.chunk_count())
        out.append(buf.audio_in_range(0, 599))
        buf.finalize_segment(599)
        out.append(buf.committed_audio(seg))
    return out


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("scenario", ["ranges", "odd frames", "segments", "eviction"])
def test_chunk_buffer_matches_jax(backend, scenario):
    now = [0.0]
    buf_j, buf = _buffers(backend, lambda: now[0])
    want = _buffer_scenario(buf_j, now, scenario)
    now[0] = 0.0
    got = _buffer_scenario(buf, now, scenario)
    _assert_same(got, want)
    if scenario == "eviction":  # the ring keeps its capacity, the dict 30 s and the segment
        assert got[0] == (532 if backend == "native" else 600 - 90)


# ---------------------------------------------------------------------
# the gate and the energy VAD
# ---------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_vad_gate_events_match_jax(smoothing, seed):
    rng = np.random.default_rng(seed)
    # runs of speech and silence with noise near the dynamic threshold
    probs = np.concatenate([rng.uniform(lo, hi, n) for lo, hi, n in
                            [(0, 0.2, 4), (0.5, 1, 6), (0, 0.35, 1), (0.6, 1, 3), (0, 0.2, 5),
                             (0.2, 0.5, 12), (0.9, 1, 4), (0, 0.1, 3)]])
    gate_j = VadGateJax(VadGateConfigJax(smoothing_window=smoothing))
    gate = VadGate(VadGateConfig(smoothing_window=smoothing))
    events = 0
    for i, p in enumerate(probs):
        want = gate_j.update(float(p), 10 * i, 10 * i + 9)
        got = gate.update(float(p), 10 * i, 10 * i + 9)
        assert asdict(got) == asdict(want), i
        assert (gate.threshold, gate.is_speaking, gate.speech_count, gate.silence_count) == (
            gate_j.threshold, gate_j.is_speaking, gate_j.speech_count, gate_j.silence_count)
        events += got.state_changed
    assert events >= 2
    gate.reset()
    gate_j.reset()
    assert asdict(gate) == asdict(gate_j)


def _windows():
    """A signal of silence, speech and silence as 512-sample windows."""
    x = np.concatenate([_silence(0.4, 3), _speech(0.8, 4), _silence(0.5, 5)])
    n = len(x) // WINDOW_SAMPLES
    return x[: n * WINDOW_SAMPLES].reshape(n, WINDOW_SAMPLES)


def test_energy_vad_forward_matches_jax_per_window():
    vad_j, vad = EnergyVadJax(), EnergyVad(device="cpu")
    state_j, state = vad_j.init_state(1), vad.init_state(1)
    got, want = [], []
    for w in _windows():
        p_j, state_j = vad_j.forward(vad_j.params, jax.numpy.asarray(w[None]), state_j)
        p, state = vad.forward(vad.params, torch.from_numpy(w[None]), state)
        want.append(float(p_j[0]))
        got.append(float(p[0]))
        np.testing.assert_allclose(state["noise"].numpy(), np.asarray(state_j["noise"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=VAD_TOL)
    assert min(want) < 0.1 and max(want) > 0.9


async def test_vad_window_prob_matches_jax_chained():
    """Gate windows of 20 sub-windows (the session's 10 chunks), and a
    ragged one, with the state threaded from window to window."""
    eng_j = ThreadedEngineJax(None, EnergyVadJax())
    eng = ThreadedEngine(None, EnergyVad(device="cpu"))
    x = np.concatenate([_silence(1.0, 6), _speech(2.0, 7), _silence(1.3, 8)])
    try:
        state_j = state = None
        got, want = [], []
        for lo in range(0, len(x) - 10 * CHUNK + 1, 10 * CHUNK):
            p_j, state_j = await eng_j.vad_window_prob(x[lo : lo + 10 * CHUNK], state_j)
            p, state = await eng.vad_window_prob(x[lo : lo + 10 * CHUNK], state)
            want.append(p_j)
            got.append(p)
        p_j, _ = await eng_j.vad_window_prob(x[:3000], state_j)
        p, _ = await eng.vad_window_prob(x[:3000], state)
        want.append(p_j)
        got.append(p)
    finally:
        eng_j.shutdown()
        eng.shutdown()
    np.testing.assert_allclose(got, want, rtol=0, atol=VAD_TOL)
    assert min(want) < 0.1 and max(want) > 0.9


# ---------------------------------------------------------------------
# StreamSession against the JAX package's
# ---------------------------------------------------------------------


async def drive(session_cls, cfg, engine, frames, vad_enabled=True) -> list[dict]:
    """Stream the frames through one session on a stepped clock (64 ms a
    frame), each window's work done before the next frame (chip_smoke's
    settle), then close as the app does (flush, cleanup). -> the messages, processing_delay
    dropped (a wall-clock field)."""
    msgs, now = [], [0.0]

    async def send(m):
        msgs.append(m)

    tracked = Tracked(engine)
    session = session_cls("c1", cfg, tracked, send, clock=lambda: now[0])
    session.vad_enabled = vad_enabled
    for i, frame in enumerate(frames):
        now[0] = i * cfg.audio_chunk_duration_ms / 1000.0
        await session.on_audio(frame)
        await settle(session, tracked)
    await session.flush()
    await session.cleanup()
    return [{k: v for k, v in m.items() if k != "processing_delay"} for m in msgs]


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


CASES = {
    # two utterances: interims, then an eager final confirmed at speech end
    "eager finals": (dict(), [_silence(0.7, 11), _speech(2.3, 12), _silence(2.0, 13),
                              _speech(1.4, 14), _silence(2.0, 15)], True),
    # no gate: one rolling segment, interims, the final at close
    "vad off": (dict(), [_silence(0.3, 16), _speech(2.0, 17), _silence(0.5, 18)], False),
    # a segment longer than max_segment_duration: committed as _part_i
    "part split": (dict(max_segment_duration=1.0),
                   [_silence(0.7, 19), _speech(2.3, 20), _silence(2.0, 21)], True),
}


@pytest.mark.parametrize("case", CASES)
async def test_session_messages_match_jax(engines, case):
    eng_j, eng = engines
    overrides, parts, vad_enabled = CASES[case]
    cfg_j, cfg = AppConfigJax(), AppConfig()
    for k, v in overrides.items():
        setattr(cfg_j, k, v)
        setattr(cfg, k, v)
    frames = _frames(np.concatenate(parts))
    want = await drive(StreamSessionJax, cfg_j, eng_j, frames, vad_enabled)
    got = await drive(StreamSession, cfg, eng, frames, vad_enabled)
    assert got == want
    committed = [m for m in got if m["type"] == "committed_output"]
    tentative = [m for m in got if m["type"] == "tentative_output"]
    assert committed and tentative and any(m["text"] for m in committed)
    ids = [m["segment_id"] for m in committed]
    if case == "part split":
        assert len(ids) >= 2 and ids == [f"0_part_{i}" for i in range(len(ids))]
    elif case == "eager finals":
        assert ids == ["0", "1"]
    else:
        assert ids == ["0"]


class SlowFakeEngine:
    """Energy-threshold VAD, and a transcribe that sleeps so that a decode
    is in flight when the client closes."""

    def __init__(self, decode_delay_s: float = 0.4):
        self.decode_delay_s = decode_delay_s
        self.decodes = 0

    async def vad_window_prob(self, audio, state):
        rms = float(np.sqrt(np.mean(audio**2))) if len(audio) else 0.0
        return (1.0 if rms > 0.01 else 0.0), None

    async def transcribe(self, audio, sample_rate, max_new_tokens, hotwords=None, **kw):
        self.decodes += 1
        await asyncio.sleep(self.decode_delay_s)
        return TranscribeResult(text="final text", tokens=np.zeros(3, np.int32),
                                audio_duration_s=len(audio) / sample_rate, timings={})


def _tone_chunks(loud: bool, n: int) -> list[bytes]:
    t = np.arange(CHUNK) / SR
    amp = 0.3 if loud else 0.0002
    return [(amp * np.sin(2 * np.pi * 440 * t) * 32767).astype("<i2").tobytes()] * n


async def test_close_right_after_speech_end_delivers_final():
    """A close moments after the last utterance ends still delivers the
    final decoding in the background (the JAX package's
    tests/test_session_close.py)."""
    msgs = []

    async def send(m):
        msgs.append(m)

    eng = SlowFakeEngine()
    s = StreamSession("c1", AppConfig(), eng, send)
    for chunk in _tone_chunks(True, 20) + _tone_chunks(False, 30):
        await s.on_audio(chunk)
    await s.flush_vad()
    t0 = time.perf_counter()  # the gate's commit task has started (it sleeps)
    while eng.decodes < 1 and time.perf_counter() - t0 < 10.0:
        await asyncio.sleep(0.005)
    assert eng.decodes >= 1
    assert not any(m["type"] == "committed_output" for m in msgs)
    await s.flush()
    await s.cleanup()
    committed = [m for m in msgs if m["type"] == "committed_output"]
    assert committed and committed[0]["text"] == "final text"


# ---------------------------------------------------------------------
# the debug audio tap
# ---------------------------------------------------------------------


def test_debug_tap_writes_valid_wav(tmp_path):
    tap = DebugAudioTap(str(tmp_path), "client1", sample_rate=16000)
    pcm = (np.sin(np.arange(4096) * 0.1) * 20000).astype("<i2").tobytes()
    tap.write(pcm)
    tap.write(pcm)
    tap.close()
    with wave.open(tap.path, "rb") as w:
        assert (w.getnchannels(), w.getframerate(), w.getsampwidth()) == (1, 16000, 2)
        assert w.getnframes() == 8192
        assert w.readframes(w.getnframes()) == pcm + pcm


def test_debug_tap_empty_cleans_up_file_and_dir(tmp_path):
    tap = DebugAudioTap(str(tmp_path), "client2", sample_rate=16000)
    session_dir = os.path.dirname(tap.path)
    tap.close()
    assert not os.path.exists(tap.path) and not os.path.exists(session_dir)


def test_debug_tap_spools_below_the_flush_threshold(tmp_path):
    tap = DebugAudioTap(str(tmp_path), "client3", sample_rate=16000)
    tap.write(b"\x01\x02" * 100)
    assert not os.path.exists(tap.path)  # spooled: ingest never waits on the disk
    tap.close()
    with wave.open(tap.path, "rb") as w:
        assert w.getnframes() == 100
