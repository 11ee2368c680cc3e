"""The traffic's draws: the same for a seed, other for another seed, and spread."""

from __future__ import annotations

import numpy as np

from gpubench import manifest
from gpubench.traffic import files, streams, synth


def _file_pcm(seed: int, client: int = 0, n: int = 2) -> list:
    mix = manifest.cell("nano-bf16.files-novad").mix
    rng = np.random.default_rng([seed, 1])
    tape = synth.speech_tape(rng, 50.0)
    hush = synth.noise(rng, 7.0)
    c = files._Client(client, seed, mix, tape, hush)
    return [c.next_file() for _ in range(n)]


def _stream(seed: int, i: int = 0):
    mix = manifest.cell("nano-bf16.streams").mix
    rng = np.random.default_rng([seed, 1])
    tape = synth.speech_tape(rng, 20.0)
    hush = synth.noise(rng, 13.0)
    return streams.stream_audio(seed, i, mix, 30.0, tape, hush)


def test_files_repeat_for_a_seed_and_differ_across_seeds():
    big = 2**31 + 7
    a, b = _file_pcm(big), _file_pcm(big)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = _file_pcm(big + 1)
    assert not np.array_equal(a[0][: len(c[0])], c[0][: len(a[0])])
    assert 60 * 16000 <= len(a[0]) <= 240 * 16000 + 16000


def test_streams_repeat_for_a_seed_and_differ_across_seeds():
    big = 2**33 + 5
    (p1, e1, c1), (p2, e2, c2) = _stream(big), _stream(big)
    assert np.array_equal(p1, p2) and e1 == e2 and c1 == c2
    p3, e3, c3 = _stream(big + 1)
    assert len(p1) == len(p3) == 30 * 16000
    assert e1 != e3 and c1 != c3 and 0 <= c1 <= 4.0
    assert all(0 < a < b for a, b in zip(e1, e1[1:]))


def test_quasi_random_lengths_keep_the_mean_across_seeds():
    means = []
    for seed in range(6):
        d = synth.Draws(np.random.default_rng(seed))
        xs = [d.lognormal("utterance", 5.0, 0.8, 0.5, 45.0) for _ in range(300)]
        means.append(np.mean(xs))
    assert max(means) / min(means) < 1.03
    d = synth.Draws(np.random.default_rng(0))
    xs = [d.uniform("pause", 1.2, 3.0) for _ in range(200)]
    assert 1.2 <= min(xs) and max(xs) <= 3.0 and abs(np.mean(xs) - 2.1) < 0.02


def test_wav_bytes_decode_to_the_samples():
    from sonicscribe_tpu_torch.serve.decode import decode_audio

    pcm = synth.to_pcm16(synth.speech_tape(np.random.default_rng(3), 1.0))
    x = decode_audio(synth.wav_bytes(pcm), "a.wav", device="cpu")
    assert np.allclose(x, pcm.astype(np.float32) / 32768.0, atol=1.5 / 32768)


def test_locate_finds_the_harness_samples_of_a_cut():
    pcm = _file_pcm(11, n=1)[0]
    lo, hi = 123_457, 123_457 + 40_000
    audio = pcm[lo:hi].astype(np.float32) / 32768.0
    req = {"audio": audio, "file": {"pcm": pcm, "plan": [(1.0, 2.0), (lo / 16000, 2.5)]}}
    assert np.array_equal(files.locate(req), pcm[lo:hi])
    req["audio"] = audio * 0.5
    assert files.locate(req) is None
