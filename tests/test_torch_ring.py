"""Port parity for the device audio ring and the batched log-mel on the CPU:
engine/ring.py's scatter, slice, ring VAD program and ring_prompt_inputs,
and audio/mel.py's log_mel_batch, against the JAX package's engine/ring.py
and audio/mel.py; the batched plain log-mel row for row against the 1-D
one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.audio.mel import MelConfig as MelConfigJax
from sonicscribe_tpu.audio.mel import log_mel_batch as log_mel_batch_jax
from sonicscribe_tpu.engine import ring as ring_jax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.audio.mel import MelConfig, device_tables, log_mel_batch
from sonicscribe_tpu_torch.engine import ring
from sonicscribe_tpu_torch.ops.mel import log_mel_frames_plain
from sonicscribe_tpu_torch.vad.model import EnergyVad

N_STREAMS = 3
VAD_TOL = 1e-6  # probability: float32 band energies from another matmul shape
MEL_TOL = 1e-3  # normalized log-mel: float32 DFT sums in another order


def _speech(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return x + 0.002 * rng.standard_normal(n)


def _chunks(seed, n_chunks, loud=True):
    """n_chunks int16 chunks of speech (or near-silence)."""
    x = _speech(n_chunks * ring.CHUNK_SAMPLES, seed) if loud else \
        0.0006 * np.random.default_rng(seed).standard_normal(n_chunks * ring.CHUNK_SAMPLES)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16).reshape(n_chunks, ring.CHUNK_SAMPLES)


def _scatter_both(ring_j, ring_t, packed, stream_idx, chunk_ids):
    ring_j = ring_jax.scatter_chunks_program(ring_j, jnp.asarray(packed),
                                             jnp.asarray(stream_idx), jnp.asarray(chunk_ids))
    ring.scatter_chunks_program({"ring": ring_t, "packed": torch.from_numpy(packed),
                                 "stream_idx": torch.from_numpy(stream_idx),
                                 "chunk_ids": torch.from_numpy(chunk_ids)})
    return ring_j


@pytest.fixture(scope="module")
def rings():
    """(JAX ring, port ring) after the same scatters: stream 0 silence then
    speech, stream 1 speech past the ring's wrap (chunk ids 500-539),
    stream 2 speech; padding rows aimed at the trash stream."""
    shape = (N_STREAMS + 1, 2 * ring.RING_CHUNKS, ring.CHUNK_SAMPLES)
    ring_j, ring_t = jnp.zeros(shape, jnp.int16), torch.zeros(shape, dtype=torch.int16)
    batches = [
        (0, np.arange(0, 30), _chunks(1, 30, loud=False)),
        (0, np.arange(30, 60), _chunks(2, 30)),
        (1, np.arange(500, 540), _chunks(3, 40)),
        (2, np.arange(0, 40), _chunks(4, 40)),
    ]
    for s, ids, packed in batches:
        M = 128  # a scatter bucket, padding rows on the trash stream
        p = np.zeros((M, ring.CHUNK_SAMPLES), np.int16)
        p[: len(ids)] = packed
        sidx = np.full((M,), N_STREAMS, np.int32)
        sidx[: len(ids)] = s
        cid = np.zeros((M,), np.int32)
        cid[: len(ids)] = ids
        ring_j = _scatter_both(ring_j, ring_t, p, sidx, cid)
    return ring_j, ring_t


def test_scatter_then_slice_is_bit_equal_to_jax(rings):
    ring_j, ring_t = rings
    np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
    for s, c, n in ((0, 5, 40), (1, 505, 30), (1, 530, 10), (2, 0, 20)):
        want = np.asarray(ring_jax._slice_stream(ring_j, s, c, n))
        got = ring._slice_stream(ring_t, torch.tensor([s, s]), torch.tensor([c, c]), n)
        np.testing.assert_array_equal(got[0].numpy(), want)
        np.testing.assert_array_equal(got[1].numpy(), want)


def test_ring_vad_probabilities_and_states_match_jax(rings):
    """Chained gate windows of the three streams. The port runs B = 4
    batches with inactive rows reading stream 0's state, JAX the active
    rows alone: probabilities within VAD_TOL, states close to JAX's, so
    the inactive rows disturb nothing. (With a padding row on stream 0
    beside an active stream 0, JAX's own write-back keeps stream 0's old
    state: both rows scatter to one index. The port's padding rows write a
    trash row instead.)"""
    ring_j, ring_t = rings
    vad_j, vad = EnergyVadJax(), EnergyVad(device="cpu")
    run_j = ring_jax.make_vad_ring_program(vad_j, window_chunks=10)
    program = ring.make_vad_ring_program(vad, window_chunks=10)
    states_j = vad_j.init_state(N_STREAMS)
    states = vad.init_state(N_STREAMS + 1)
    probs_seen = []
    for w in range(4):
        # streams 0 and 2 from chunk 0 (stream 0: silence, then speech), 1 from 500;
        # stream 0 is active every other window
        idx = np.array([0, 1, 2, 0], np.int32) if w % 2 == 0 else np.array([1, 2, 0, 0], np.int32)
        active = np.array([True, True, w % 2 == 0, False])
        start = np.array([{0: 10 * w, 1: 500 + 10 * w, 2: 10 * w}[int(s)] for s in idx],
                         np.int32)
        n_active = int(active.sum())
        probs_j, states_j = run_j(ring_j, None, states_j, jnp.asarray(idx[:n_active]),
                                  jnp.asarray(start[:n_active]),
                                  jnp.ones((n_active,), bool))
        bufs = {"ring": ring_t, "states": states, "stream_idx": torch.from_numpy(idx),
                "start_chunk": torch.from_numpy(start), "active": torch.from_numpy(active),
                "probs": torch.zeros(4)}
        program(bufs)
        np.testing.assert_allclose(bufs["probs"].numpy()[:n_active], np.asarray(probs_j),
                                   rtol=0, atol=VAD_TOL)
        np.testing.assert_allclose(states["noise"][:N_STREAMS].numpy(),
                                   np.asarray(states_j["noise"]), rtol=1e-5)
        np.testing.assert_array_equal(states["init"][:N_STREAMS].numpy(),
                                      np.asarray(states_j["init"]))
        probs_seen += list(np.asarray(probs_j))
    assert min(probs_seen) < 0.1 and max(probs_seen) > 0.9


@pytest.mark.parametrize("n_chunks", [20, 40])
def test_ring_prompt_inputs_match_jax(rings, n_chunks):
    ring_j, ring_t = rings
    idx = np.array([0, 1, 2, 3], np.int32)  # row 3: the trash stream
    start = np.array([25, 510, 3, 0], np.int32)
    count = np.array([n_chunks, 7, n_chunks - 3, 1], np.int32)
    mel_j, nf_j = ring_jax.ring_prompt_inputs(
        ring_j, tiny_jax(), MelConfigJax(), jnp.asarray(idx), jnp.asarray(start),
        jnp.asarray(count), n_chunks)
    mel, nf = ring.ring_prompt_inputs(ring_t, MelConfig(), torch.from_numpy(idx),
                                      torch.from_numpy(start), torch.from_numpy(count), n_chunks)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), rtol=0, atol=MEL_TOL)
    assert mel.shape == (4, n_chunks * ring.CHUNK_SAMPLES // 160, 128)


def test_log_mel_batch_matches_jax():
    """Rows of different true lengths (one shorter than a hop): per-row
    masking, per-row dynamic range, n_frames at least 1."""
    N = 8000
    lens = np.array([8000, 5000, 1234, 100], np.int32)
    audio = np.zeros((4, N), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = _speech(n, 10 + i) * (0.1 + 0.3 * i)
    mel_j, nf_j = log_mel_batch_jax(jnp.asarray(audio), jnp.asarray(lens), MelConfigJax())
    mel, nf = log_mel_batch(torch.from_numpy(audio), torch.from_numpy(lens), MelConfig())
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    assert list(nf.numpy()) == [50, 31, 7, 1]
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), rtol=0, atol=MEL_TOL)
    assert not mel[1, 31:].any() and not mel[3].any()  # zero past each row's frames


def test_batched_plain_log_mel_matches_rows():
    """log_mel_frames_plain over [B, N] equals the 1-D call on each row,
    within MEL_TOL after the (x + 4) / 4 scaling (the batched convolution
    sums in another order: raw log10 of the quietest bins moves ~7e-4)."""
    cfg = MelConfig()
    basis, fb = device_tables(cfg, torch.device("cpu"))
    x = torch.from_numpy(np.stack([_speech(6400, s) for s in range(3)]).astype(np.float32))
    padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    got = log_mel_frames_plain(padded, basis, fb, 40, cfg.hop_length)
    assert got.shape == (3, 40, cfg.n_mels)
    for i in range(3):
        want = log_mel_frames_plain(padded[i], basis, fb, 40, cfg.hop_length)
        np.testing.assert_allclose(got[i].numpy() / 4, want.numpy() / 4, rtol=0, atol=MEL_TOL)
