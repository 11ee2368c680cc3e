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
from sonicscribe_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from sonicscribe_tpu_torch.audio.resample import resample


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
