"""Port parity: the PyTorch audio front end vs the JAX package on the CPU.

Same numpy inputs through both; the port runs its plain PyTorch versions
(the CUDA mel kernel runs only for tensors on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicscribe_tpu.audio.mel import MelConfig as MelConfigJax
from sonicscribe_tpu.audio.mel import log_mel_spectrogram as log_mel_jax
from sonicscribe_tpu.audio.resample import resample as resample_jax
from sonicscribe_tpu.ops.mel_pallas import log_mel_pallas
from sonicscribe_tpu_torch.audio.mel import (
    MelConfig,
    device_tables,
    log_mel_spectrogram,
    mel_filter_bank,
    normalize_log_mel,
    reflect_pad,
)
from sonicscribe_tpu_torch.audio.resample import resample
from sonicscribe_tpu_torch.ops.mel import check_kernel_shape, frames_per_block, mel_bands


def _signal(n, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1337 * t)
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("sr", [8000, 22050, 44100, 48000])
def test_resample_matches_jax(sr):
    x = _signal(int(0.3 * sr) + 7, sr)
    want = np.asarray(resample_jax(x, sr, 16000))
    got = resample(x, sr, 16000, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# tiny-random serves the buckets (128, 256); lengths leave a ragged last frame
@pytest.mark.parametrize(
    "n_samples,bucket", [(100, 128), (159, 128), (16000 + 37, 128), (40000 + 91, 256)]
)
def test_log_mel_matches_jax(n_samples, bucket):
    x = _signal(n_samples, 16000, seed=n_samples)
    want = np.asarray(log_mel_jax(x, MelConfigJax(), pad_to_frames=bucket))
    got = log_mel_spectrogram(x, MelConfig(), pad_to_frames=bucket, device="cpu").numpy()
    assert got.shape == want.shape == (bucket, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_samples,bucket", [(16000 + 37, 128), (40000 + 91, 256)])
def test_log_mel_matches_pallas_kernel(n_samples, bucket):
    """The Pallas kernel (interpret mode) agrees where it has >= 1 true frame;
    under 160 samples it returns zeros while the XLA path, and the port,
    pre-pad to one frame."""
    x = _signal(n_samples, 16000, seed=1)
    want = np.asarray(
        log_mel_pallas(jnp.asarray(x), MelConfigJax(), pad_to_frames=bucket, interpret=True)
    )
    got = log_mel_spectrogram(torch.from_numpy(x), MelConfig(), pad_to_frames=bucket).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---- the CUDA kernel's arithmetic (csrc/log_mel.cu), emulated in numpy


def _speech(sec, seed):
    """The speech-like signal of chip_smoke.py: four partials under a 3 Hz
    envelope + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * sec)) / 16000
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _quiet_then_loud(seed=7):
    """6 s near silence, then 6 s of speech-like signal."""
    quiet = 0.0006 * np.random.default_rng(seed).standard_normal(16000 * 6)
    return np.concatenate([quiet.astype(np.float32), _speech(6.0, seed)])


def _tf32(a):
    """cvt.rna.tf32.f32: round to a 10-bit mantissa, to nearest, ties away
    from zero (the float32 bit pattern with its low 13 bits cleared)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _log_mel_tf32(padded, basis, fb, n_frames, hop, passes):
    """log10(max(mel, 1e-10)) with the DFT as the kernel computes it: each
    operand split into big = tf32(v) and small = tf32(v - big); per k-step
    of 8, float32 sums of big*small and small*big (passes=3), then
    big*big, added to float32 accumulators. passes=1: one TF32 pass."""
    n_fft = basis.shape[0]
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = padded[idx]
    a_big, b_big = _tf32(frames), _tf32(basis)
    a_small, b_small = _tf32(frames - a_big), _tf32(basis - b_big)
    acc = np.zeros((n_frames, basis.shape[1]), np.float32)
    for k in range(0, n_fft, 8):
        s = slice(k, k + 8)
        if passes == 3:
            acc += a_big[:, s] @ b_small[s]
            acc += a_small[:, s] @ b_big[s]
        acc += a_big[:, s] @ b_big[s]
    n_bins = fb.shape[0]
    power = acc[:, :n_bins] ** 2 + acc[:, n_bins:] ** 2
    return np.log10(np.maximum(power @ fb, np.float32(1e-10)))


@pytest.mark.parametrize("signal", ["speech", "quiet_then_loud"])
def test_3xtf32_dft_matches_jax_and_one_pass_does_not(signal):
    """The kernel's 3xTF32 DFT, emulated, against the JAX front end within
    1e-3 normalised (chip_smoke's MEL_TOL); one TF32 pass misses by far
    more, which is why the kernel takes three."""
    x = _speech(12.0, 2) if signal == "speech" else _quiet_then_loud()
    cfg = MelConfig()
    padded, n_frames = reflect_pad(torch.from_numpy(x), cfg)
    basis, fb = (t.numpy() for t in device_tables(cfg, torch.device("cpu")))
    want = np.asarray(log_mel_jax(x, MelConfigJax()))
    errs = {}
    for passes in (3, 1):
        raw = _log_mel_tf32(padded.numpy(), basis, fb, n_frames, cfg.hop_length, passes)
        got = normalize_log_mel(torch.from_numpy(raw), cfg).numpy()
        assert got.shape == want.shape
        errs[passes] = float(np.abs(got - want).max())
    assert errs[3] <= 1e-3, errs
    assert errs[1] > 1e-3, errs


def test_mel_bands_cover_the_filter_bank():
    """Each filter's band holds all its nonzero bins, and the banded sum of
    a random power spectrum equals the dense product within 1e-6."""
    fb = mel_filter_bank(MelConfig())
    bands = mel_bands(fb)
    assert bands.shape == (fb.shape[1], 2) and bands.dtype == np.int32
    inside = np.zeros(fb.shape, bool)
    for m, (start, end) in enumerate(bands):
        assert 0 <= start < end <= fb.shape[0]
        inside[start:end, m] = True
    assert not (fb[~inside] != 0).any()
    power = np.random.default_rng(0).random((37, fb.shape[0])).astype(np.float32) * 10.0
    banded = np.stack([power[:, s:e] @ fb[s:e, m] for m, (s, e) in enumerate(bands)], axis=1)
    dense = power @ fb
    np.testing.assert_allclose(banded, dense, rtol=1e-6, atol=0)


def test_mel_bands_of_empty_filters():
    fb = np.zeros((5, 3), np.float32)
    fb[1:3, 0] = 1.0
    fb[4, 2] = 2.0
    np.testing.assert_array_equal(mel_bands(fb), [[1, 3], [0, 0], [4, 5]])


@pytest.mark.parametrize("n_frames,tile", [(1, 16), (1200, 16), (2112, 16), (2113, 32),
                                           (3072, 32)])
def test_frames_per_block(n_frames, tile):
    """16-frame tiles while they are at most one block per SM (132), then
    32."""
    assert frames_per_block(n_frames, 132) == tile


@pytest.mark.parametrize("n_fft,hop,n_mels,ok", [
    (400, 160, 128, True),   # Whisper's front end
    (400, 160, 80, True),
    (400, 160, 16, True),    # filters of 61 bins: the kernel reads past its registers
    (432, 100, 128, True),   # 217 bins
    (448, 160, 128, False),  # 225 bins
    (512, 160, 128, False),  # 257 bins
    (392, 160, 128, False),  # n_fft % 16
    (400, 162, 128, False),  # hop % 4
])
def test_log_mel_kernel_shapes(n_fft, hop, n_mels, ok):
    """The front ends the card's log-mel kernel takes, and device_tables
    rejecting the others for a CUDA device before it copies anything (the
    CPU, which runs the plain version, takes them all)."""
    cfg = MelConfig(n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    if ok:
        check_kernel_shape(cfg.n_fft, cfg.hop_length, cfg.n_freq_bins)
    else:
        with pytest.raises(ValueError, match="log-mel kernel takes"):
            check_kernel_shape(cfg.n_fft, cfg.hop_length, cfg.n_freq_bins)
        with pytest.raises(ValueError, match="log-mel kernel takes"):
            device_tables(cfg, torch.device("cuda"))
    basis, fb = device_tables(cfg, torch.device("cpu"))
    assert basis.shape == (n_fft, 2 * cfg.n_freq_bins) and fb.shape == (cfg.n_freq_bins, n_mels)
