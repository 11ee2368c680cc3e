"""Port parity for the Silero VAD on the CPU: SileroVad's forward, its
features + cell split, window_probs and the cost probe against the JAX
package's classes on the same trees; the Silero converter and its npz
against the JAX package's; build_runtime's --vad specs on both engines;
the engines' VAD windows (threaded, the batcher's host and ring programs)
with Silero against the JAX engines; a stream session's messages with the
cost probe on both sides."""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Tracked, settle
from sonicscribe_tpu.config import AppConfig as AppConfigJax
from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.serve.engine_async import ThreadedEngine as ThreadedEngineJax
from sonicscribe_tpu.serve.session import StreamSession as StreamSessionJax
from sonicscribe_tpu.tools import convert_silero as convert_silero_jax
from sonicscribe_tpu.tools.torch_silero import TorchSileroVad, synthetic_state_dict
from sonicscribe_tpu.vad.model import SileroCostProbeVad as SileroCostProbeVadJax
from sonicscribe_tpu.vad.model import SileroVad as SileroVadJax
from sonicscribe_tpu.vad.model import window_probs as window_probs_jax
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.serve.engine_async import ThreadedEngine
from sonicscribe_tpu_torch.serve.runtime import build_runtime
from sonicscribe_tpu_torch.serve.session import StreamSession
from sonicscribe_tpu_torch.tools import convert_silero, torch_silero
from sonicscribe_tpu_torch.vad.model import (
    WINDOW_SAMPLES,
    EnergyVad,
    SileroConfig,
    SileroCostProbeVad,
    SileroVad,
    window_probs,
)

SR = 16000
CHUNK = 1024
TOL = 1e-5  # probabilities and states: float32 sums in another order, 20+ LSTM steps


def _synthetic_sd(cfg: SileroConfig):
    """The JAX package's tests/test_convert_silero.py fixture: an upstream
    state dict of random weights, the v5 names (bias_hh summed into b, the
    head a conv, the basis a conv buffer)."""
    rng = np.random.default_rng(0)
    sd = {}
    c_in = cfg.n_bins
    for i, c_out in enumerate(cfg.conv_channels):
        sd[f"encoder.{i}.reparam_conv.weight"] = rng.standard_normal(
            (c_out, c_in, cfg.kernel)).astype(np.float32) * 0.05
        sd[f"encoder.{i}.reparam_conv.bias"] = np.zeros(c_out, np.float32)
        c_in = c_out
    h = cfg.lstm_hidden
    sd["decoder.rnn.weight_ih"] = rng.standard_normal((4 * h, c_in)).astype(np.float32) * 0.05
    sd["decoder.rnn.weight_hh"] = rng.standard_normal((4 * h, h)).astype(np.float32) * 0.05
    sd["decoder.rnn.bias_ih"] = np.zeros(4 * h, np.float32)
    sd["decoder.rnn.bias_hh"] = np.ones(4 * h, np.float32) * 0.1
    sd["decoder.decoder.2.weight"] = rng.standard_normal((1, h, 1)).astype(np.float32) * 0.1
    sd["decoder.decoder.2.bias"] = np.zeros(1, np.float32)
    sd["_model.stft.forward_basis_buffer"] = rng.standard_normal(
        (2 * cfg.n_bins, 1, cfg.n_fft)).astype(np.float32) * 0.05
    return sd


def _tree(kind: str):
    """A JAX params tree with numpy leaves: JAX's random init, the
    converted synthetic fixture, or the converted state dict of the JAX
    package's independent torch twin (upstream's names)."""
    if kind == "random":
        return jax.tree.map(np.asarray, SileroVadJax().params)
    if kind == "synthetic":
        return convert_silero_jax.convert_state_dict(_synthetic_sd(SileroConfig()))
    return convert_silero_jax.convert_state_dict(synthetic_state_dict(seed=0))


def _pair(kind: str):
    tree = _tree(kind)
    return (SileroVadJax(params=jax.tree.map(jnp.asarray, tree)),
            SileroVad(params=params_from_jax(tree, device="cpu"), device="cpu"))


def _speech(sec, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _silence(sec, seed=1):
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32)


def _signal():
    """~5 s: silence, speech, silence, speech, silence."""
    return np.concatenate([_silence(0.8, 2), _speech(1.6, 3), _silence(1.0, 4),
                           _speech(1.2, 5), _silence(0.4, 6)])


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL,
                               err_msg=what)


# ---------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "synthetic"])
def test_forward_matches_jax_with_the_state_threaded(kind):
    """20 sub-windows (one gate window) at B = 3, state threaded: every
    probability and every state field within TOL of JAX's."""
    vad_j, vad = _pair(kind)
    x = np.stack([_speech(20 * WINDOW_SAMPLES / SR, 10), _silence(20 * WINDOW_SAMPLES / SR, 11),
                  np.concatenate([_silence(0.3, 12), _speech(0.5, 13)])[: 20 * WINDOW_SAMPLES]])
    x = x.reshape(3, 20, WINDOW_SAMPLES)
    state_j, state = vad_j.init_state(3), vad.init_state(3)
    probs = []
    for i in range(20):
        p_j, state_j = vad_j.forward(vad_j.params, jnp.asarray(x[:, i]), state_j)
        p, state = vad.forward(vad.params, torch.from_numpy(x[:, i]), state)
        _close(p, p_j, f"window {i}")
        for k in ("h", "c", "ctx"):
            _close(state[k], state_j[k], f"window {i} {k}")
        probs.append(np.asarray(p_j))
    assert np.ptp(probs) > 1e-3  # the probabilities move


def test_features_and_cell_compose_to_forward():
    """forward_windows (the front end of all windows in one pass, then the
    cells) gives forward's probabilities and state, window by window."""
    _, vad = _pair("synthetic")
    x = torch.from_numpy(np.stack([_speech(0.64, 20), _silence(0.64, 21)])
                         .reshape(2, 20, WINDOW_SAMPLES))
    state = vad.init_state(2)
    state["h"] += 0.1  # a stream mid-way
    state["ctx"] += torch.linspace(-0.1, 0.1, 64)
    want = []
    s = dict(state)
    for i in range(20):
        p, s = vad.forward(vad.params, x[:, i], s)
        want.append(p)
    got, s2 = vad.forward_windows(vad.params, x, dict(state))
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(), rtol=0, atol=1e-6)
    for k in s:
        np.testing.assert_allclose(s2[k].numpy(), s[k].numpy(), rtol=0, atol=1e-6)
    # features is row-wise: one window's features alone equal its row in a batch
    x576 = torch.cat([state["ctx"], x[:, 0]], 1)
    np.testing.assert_allclose(vad.features(vad.params, x576[1:]).numpy(),
                               vad.features(vad.params, x576)[1:].numpy(), rtol=0, atol=1e-6)


def test_missing_basis_falls_back_to_the_analytic_one():
    tree = _tree("random")  # JAX's init stores the analytic basis
    no_basis = {k: v for k, v in tree.items() if k != "stft"}
    a = SileroVad(params=params_from_jax(tree, device="cpu"), device="cpu")
    b = SileroVad(params=params_from_jax(no_basis, device="cpu"), device="cpu")
    audio = _speech(0.5, 30)
    np.testing.assert_array_equal(window_probs(a, audio), window_probs(b, audio))


@pytest.mark.parametrize("kind", ["synthetic", "twin"])
def test_window_probs_matches_jax(kind):
    """A ~5 s signal, one stream, state carried across 157 windows."""
    vad_j, vad = _pair(kind)
    audio = _signal()
    want = window_probs_jax(vad_j, audio)
    got = window_probs(vad, audio)
    assert got.shape == want.shape == (-(-len(audio) // WINDOW_SAMPLES),)
    _close(got, want, "window_probs")
    assert np.ptp(want) > 1e-3


def test_window_probs_matches_the_independent_torch_twin():
    """The JAX package's torch twin of the upstream graph (its own
    Conv1d(padding=1) and LSTMCell modules) on its own state dict."""
    vad = SileroVad(params=convert_silero.convert_state_dict(synthetic_state_dict(seed=0)),
                    device="cpu")
    twin = TorchSileroVad(seed=0)
    twin.reset_states()
    audio = _signal()[: 100 * WINDOW_SAMPLES]
    want = [float(twin(torch.from_numpy(audio[i * WINDOW_SAMPLES:(i + 1) * WINDOW_SAMPLES])[None],
                       SR)) for i in range(100)]
    _close(window_probs(vad, audio), want, "twin")


@pytest.mark.parametrize("seed", [0, 3])
def test_port_twin_state_dict_equals_the_jax_packages(seed):
    """The port's own twin (tools/torch_silero.py) draws the same
    upstream-named state dict as the JAX package's, tensor for tensor."""
    want = synthetic_state_dict(seed=seed)
    got = torch_silero.synthetic_state_dict(seed=seed)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_port_twin_probabilities_equal_the_jax_twins_bit_for_bit():
    """Both twins on the same windows, three streams at once and their
    state threaded through 40 windows: equal probabilities, bit for bit."""
    twin_j, twin = TorchSileroVad(seed=0), torch_silero.TorchSileroVad(seed=0)
    audio = _signal()[: 40 * WINDOW_SAMPLES]
    streams = np.stack([audio, audio[::-1].copy(), 0.5 * audio])
    for i in range(40):
        x = torch.from_numpy(streams[:, i * WINDOW_SAMPLES:(i + 1) * WINDOW_SAMPLES])
        assert torch.equal(twin(x, SR), twin_j(x, SR)), f"window {i}"


def test_port_converter_of_the_port_twin_matches_silero_vad():
    """The port's converter on the port twin's state dict gives a SileroVad
    whose probabilities match the twin's, as for the JAX package's twin."""
    sd = torch_silero.synthetic_state_dict(seed=0)
    vad = SileroVad(params=convert_silero.convert_state_dict(sd), device="cpu")
    twin = torch_silero.TorchSileroVad(seed=0)
    audio = _signal()[: 100 * WINDOW_SAMPLES]
    want = [float(twin(torch.from_numpy(audio[i * WINDOW_SAMPLES:(i + 1) * WINDOW_SAMPLES])[None],
                       SR)) for i in range(100)]
    _close(window_probs(vad, audio), want, "port twin")


def test_tf32_is_off_for_the_network():
    SileroVad(device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_seeded_random_init_has_jax_shapes():
    tree_j = _tree("random")
    a, b = SileroVad(device="cpu", seed=3), SileroVad(device="cpu", seed=3)
    flat_j = convert_silero.to_flat(tree_j)
    flat_a, flat_b = convert_silero.to_flat(a.params), convert_silero.to_flat(b.params)
    assert {k: v.shape for k, v in flat_a.items()} == {k: v.shape for k, v in flat_j.items()}
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    assert not np.array_equal(flat_a["lstm.wi"], convert_silero.to_flat(
        SileroVad(device="cpu", seed=4).params)["lstm.wi"])


# ---------------------------------------------------------------------
# the cost probe
# ---------------------------------------------------------------------


def test_probe_probabilities_are_the_energy_gates_bit_for_bit():
    audio = _signal()
    probe = SileroCostProbeVad(device="cpu")
    np.testing.assert_array_equal(window_probs(probe, audio),
                                  window_probs(EnergyVad(device="cpu"), audio))
    x = torch.from_numpy(audio[: 3 * 20 * WINDOW_SAMPLES].reshape(3, 20, WINDOW_SAMPLES))
    p, state = probe.forward_windows(probe.params, x, probe.init_state(3))
    p_e, state_e = EnergyVad(device="cpu").forward_windows(None, x,
                                                           EnergyVad(device="cpu").init_state(3))
    assert torch.equal(p, p_e) and torch.equal(state["energy_noise"], state_e["noise"])
    assert sorted(state) == ["energy_init", "energy_noise", "nn_c", "nn_ctx", "nn_h"]


def test_probe_flat_state_matches_jax_nested_state():
    """The port's flat fields against JAX's nested {"nn": ..., "energy":
    ...} after 20 windows at B = 2, the network carried over."""
    probe_j = SileroCostProbeVadJax()
    probe = SileroCostProbeVad(device="cpu")
    probe.nn = SileroVad(params=params_from_jax(jax.tree.map(np.asarray, probe_j.nn.params),
                                                device="cpu"), device="cpu")
    probe.params = {"nn": probe.nn.params}
    x = np.stack([_speech(0.64, 40), _silence(0.64, 41)]).reshape(2, 20, WINDOW_SAMPLES)
    state_j, state = probe_j.init_state(2), probe.init_state(2)
    for i in range(20):
        p_j, state_j = probe_j.forward(probe_j.params, jnp.asarray(x[:, i]), state_j)
        p, state = probe.forward(probe.params, torch.from_numpy(x[:, i]), state)
        np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-6)
    for sub in ("nn", "energy"):
        for k, v in state_j[sub].items():
            got = state[f"{sub}_{k}"].numpy()
            if v.dtype == jnp.bool_:
                np.testing.assert_array_equal(got, np.asarray(v))
            else:
                np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5, atol=TOL)


# ---------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------


def test_convert_state_dict_matches_jax_array_for_array():
    for sd in (_synthetic_sd(SileroConfig()), synthetic_state_dict(seed=1)):
        sd = dict(sd)
        sd["_model_8k.encoder.0.reparam_conv.weight"] = np.zeros((1, 1, 1), np.float32)
        want = _flat_jax(convert_silero_jax.convert_state_dict(sd))
        got = convert_silero.to_flat(convert_silero.convert_state_dict(sd))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
            assert got[k].dtype == np.float32


def _flat_jax(params):
    """The JAX package's main() layout of its converted tree."""
    flat = {}
    for i, c in enumerate(params["convs"]):
        flat[f"convs.{i}.w"], flat[f"convs.{i}.b"] = c["w"], c["b"]
    flat["lstm.wi"], flat["lstm.wh"], flat["lstm.b"] = (
        params["lstm"]["wi"], params["lstm"]["wh"], params["lstm"]["b"])
    flat["out.w"], flat["out.b"] = params["out"]["w"], params["out"]["b"]
    if "stft" in params:
        flat["stft.basis"] = params["stft"]["basis"]
    return flat


def _same_tree(a, b):
    fa, fb = convert_silero.to_flat(a), convert_silero.to_flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_npz_written_by_each_package_loads_in_the_other(tmp_path, monkeypatch):
    """Both CLIs on one torch state-dict file; each npz read by the other
    package's load_npz: the same arrays, key by key (never the files'
    bytes: zip entry order and timestamps may differ)."""
    sd = synthetic_state_dict(seed=2)
    src = str(tmp_path / "silero.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, src)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert_silero.main([src, ours])
    convert_silero_jax.main([src, theirs])
    want = convert_silero.convert_state_dict(sd)
    _same_tree(convert_silero_jax.load_npz(ours), want)
    _same_tree(convert_silero.load_npz(theirs), want)
    _same_tree(convert_silero.load_npz(ours), convert_silero_jax.load_npz(theirs))
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


def test_mapping_error_lists_what_was_tried():
    with pytest.raises(convert_silero.SileroMappingError) as e:
        convert_silero.convert_state_dict({"unrelated.weight": np.zeros(3)})
    msg = str(e.value)
    assert "tried" in msg and "encoder.0.reparam_conv.weight" in msg
    assert "unrelated.weight" in msg


# ---------------------------------------------------------------------
# build_runtime's --vad specs
# ---------------------------------------------------------------------


def _npz(tmp_path) -> str:
    path = str(tmp_path / "silero.npz")
    np.savez(path, **convert_silero.to_flat(_tree("synthetic")))
    return path


@pytest.mark.parametrize("engine_kind", ["batched", "threaded"])
def test_vad_silero_without_weights_falls_back_to_energy(engine_kind, caplog, monkeypatch):
    monkeypatch.delenv("SONIC_SILERO_WEIGHTS", raising=False)
    cfg = AppConfig()
    assert cfg.silero_weights == ""
    with caplog.at_level(logging.ERROR, logger="sonicscribe_tpu_torch.serve.runtime"):
        engine, vad, info = build_runtime("tiny-random", "silero", cfg, device="cpu",
                                          engine_kind=engine_kind)
    try:
        assert type(vad) is EnergyVad and engine.vad is vad
        assert info["vad"] == "energy (silero weights missing)"
        assert any("RANDOM-INIT" in r.getMessage() for r in caplog.records)
    finally:
        engine.shutdown()


@pytest.mark.parametrize("engine_kind", ["batched", "threaded"])
@pytest.mark.parametrize("how", ["env", "path"])
def test_vad_silero_weights_serve_silero(engine_kind, how, tmp_path, monkeypatch):
    path = _npz(tmp_path)
    if how == "env":
        monkeypatch.setenv("SONIC_SILERO_WEIGHTS", path)
        spec = "silero"
    else:
        monkeypatch.delenv("SONIC_SILERO_WEIGHTS", raising=False)
        spec = path
    engine, vad, info = build_runtime("tiny-random", spec, AppConfig(), device="cpu",
                                      engine_kind=engine_kind)
    try:
        assert isinstance(vad, SileroVad) and engine.vad is vad
        assert info["vad"] == spec
        _same_tree(vad.params, convert_silero.load_npz(path))
        assert vad.params["lstm"]["wi"].device.type == "cpu"
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------
# the engines' VAD windows
# ---------------------------------------------------------------------


def _gate_windows():
    """Three 10-chunk gate windows of one stream: quiet, speech, mixed."""
    x = np.concatenate([_silence(0.64, 50), _speech(0.64, 51), _silence(0.3, 52),
                        _speech(0.34, 53)])
    return x[: 30 * CHUNK]


async def test_threaded_engine_silero_window_matches_jax():
    vad_j, vad = _pair("synthetic")
    eng_j, eng = ThreadedEngineJax(None, vad_j), ThreadedEngine(None, vad)
    x = _gate_windows()
    try:
        state_j = state = None
        for w in range(3):
            p_j, state_j = await eng_j.vad_window_prob(x[w * 10 * CHUNK:(w + 1) * 10 * CHUNK],
                                                       state_j)
            p, state = await eng.vad_window_prob(x[w * 10 * CHUNK:(w + 1) * 10 * CHUNK], state)
            assert abs(p - p_j) <= TOL, (w, p, p_j)
            for k in ("h", "c", "ctx"):
                _close(state[k], state_j[k], f"window {w} {k}")
    finally:
        eng_j.shutdown()
        eng.shutdown()


@pytest.fixture(scope="module")
def transcribers():
    params_j = init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32)
    tr_j = TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                          prefill_buckets=(64, 128))
    tr = Transcriber(tiny(), params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu"),
                     ByteTokenizer(tiny()), prefill_buckets=(64, 128))
    return tr_j, tr


def test_batched_engine_silero_windows_match_jax(transcribers):
    """Two streams' three gate windows through the host-audio program
    (vad_window_prob) and through the ring (ingest, vad_window_ring) on
    each batched engine: probabilities within TOL of JAX's, and the ring's
    within TOL of window_probs_state on the same int16 samples. (Ring
    streams 1 and 2: JAX's padding rows read and write stream 0, and its
    write-back of a stream 0 active beside them keeps the old state; see
    tests/test_torch_ring.py.)"""
    tr_j, tr = transcribers
    vad_j, vad = _pair("synthetic")
    x = [_gate_windows(), _gate_windows()[::-1].copy()]
    pcm = [(np.clip(a, -1, 1) * 32767).astype("<i2").tobytes() for a in x]

    async def run(eng):
        try:
            host, states = [], [None, None]
            for w in range(3):
                rs = await asyncio.gather(*[
                    eng.vad_window_prob(a[w * 10 * CHUNK:(w + 1) * 10 * CHUNK], s)
                    for a, s in zip(x, states)])
                host.append([p for p, _ in rs])
                states = [s for _, s in rs]
            streams = [eng.alloc_stream() for _ in x]
            assert 0 not in streams
            for s, p in zip(streams, pcm):
                for c in range(30):
                    eng.ingest(s, c, p[c * 2 * CHUNK:(c + 1) * 2 * CHUNK])
            ring = []
            for w in range(3):
                ring.append(await asyncio.gather(*[eng.vad_window_ring(s, 10 * w)
                                                   for s in streams]))
            return np.asarray(host), np.asarray(ring)
        finally:
            eng.shutdown()

    host_j, ring_j = asyncio.run(run(BatchedEngineJax(tr_j, vad_j, slots=2, n_streams=3)))
    host, ring = asyncio.run(run(BatchedEngine(tr, vad, slots=2, n_streams=3)))
    _close(host, host_j, "host-audio windows")
    _close(ring, ring_j, "ring windows")
    assert np.ptp(host_j) > 1e-3
    # the ring holds the int16 samples
    for j, p in enumerate(pcm):
        q = np.frombuffer(p, "<i2").astype(np.float32) / 32768.0
        state = None
        for w in range(3):
            probs, state = vad.window_probs_state(
                q[w * 10 * CHUNK:(w + 1) * 10 * CHUNK].reshape(20, WINDOW_SAMPLES), state)
            _close(ring[w, j], probs.max(), f"stream {j} window {w}")


# ---------------------------------------------------------------------
# a stream with the cost probe on both sides
# ---------------------------------------------------------------------


def _frames(audio: np.ndarray) -> list[bytes]:
    n = -(-len(audio) // CHUNK) * CHUNK
    x = np.zeros(n, np.float32)
    x[: len(audio)] = audio
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    return [pcm[i : i + CHUNK].tobytes() for i in range(0, n, CHUNK)]


async def _drive(session_cls, cfg, engine, frames) -> list[dict]:
    msgs, now = [], [0.0]

    async def send(m):
        msgs.append(m)

    tracked = Tracked(engine)
    session = session_cls("c1", cfg, tracked, send, clock=lambda: now[0])
    for i, frame in enumerate(frames):
        now[0] = i * cfg.audio_chunk_duration_ms / 1000.0
        await session.on_audio(frame)
        await settle(session, tracked)
    await session.flush()
    await session.cleanup()
    return [{k: v for k, v in m.items() if k != "processing_delay"} for m in msgs]


STREAM_CASES = {
    # two utterances: interims, then eager finals confirmed at speech end
    "eager finals": (dict(), [_silence(0.7, 11), _speech(2.3, 12), _silence(2.0, 13),
                              _speech(1.4, 14), _silence(2.0, 15)], ["0", "1"]),
    # a segment longer than max_segment_duration: committed as _part_i
    "part split": (dict(max_segment_duration=1.0),
                   [_silence(0.7, 19), _speech(2.3, 20), _silence(2.0, 21)], None),
}


@pytest.mark.parametrize("case", STREAM_CASES)
async def test_stream_messages_match_jax_with_the_cost_probe(transcribers, case):
    """tests/test_torch_stream.py's session cases on each threaded engine,
    each gating with its package's SileroCostProbeVad: every message
    equal."""
    tr_j, tr = transcribers
    overrides, parts, ids = STREAM_CASES[case]
    cfg_j, cfg = AppConfigJax(), AppConfig()
    for k, v in overrides.items():
        setattr(cfg_j, k, v)
        setattr(cfg, k, v)
    eng_j = ThreadedEngineJax(tr_j, SileroCostProbeVadJax())
    eng = ThreadedEngine(tr, SileroCostProbeVad(device="cpu"))
    frames = _frames(np.concatenate(parts))
    try:
        want = await _drive(StreamSessionJax, cfg_j, eng_j, frames)
        got = await _drive(StreamSession, cfg, eng, frames)
    finally:
        eng_j.shutdown()
        eng.shutdown()
    assert got == want
    committed = [m["segment_id"] for m in got if m["type"] == "committed_output"]
    if ids is None:
        assert len(committed) >= 2 and committed == [f"0_part_{i}" for i in range(len(committed))]
    else:
        assert committed == ids


async def test_ring_stream_messages_match_jax_with_the_cost_probe(transcribers):
    """The eager-finals case through a StreamSession on each batched engine
    (the ring path: the ring VAD program over the probe's flat state in the
    port, its nested state in JAX): every message equal. The eager gate's
    wall-clock inputs are pinned equal, as in tests/test_torch_batcher.py."""
    tr_j, tr = transcribers
    eng_j = BatchedEngineJax(tr_j, SileroCostProbeVadJax(), slots=4, max_decode_tokens=256,
                             n_streams=4)
    eng = BatchedEngine(tr, SileroCostProbeVad(device="cpu"), slots=4, max_decode_tokens=256,
                        n_streams=4)
    for e in (eng_j, eng):
        e.eager_window_s = 0.0
        e.short_queue_ema = 0.0
        e._note_short_queue = lambda q_ms: None
    _, parts, ids = STREAM_CASES["eager finals"]
    frames = _frames(np.concatenate(parts))
    try:
        want = await _drive(StreamSessionJax, AppConfigJax(), eng_j, frames)
        got = await _drive(StreamSession, AppConfig(), eng, frames)
    finally:
        eng_j.shutdown()
        eng.shutdown()
    assert got == want
    assert [m["segment_id"] for m in got if m["type"] == "committed_output"] == ids
