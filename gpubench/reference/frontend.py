"""Whisper's log-mel front end, written out plainly in float32.

Periodic Hann window of n_fft samples, hop samples apart, centred by
reflect padding of n_fft / 2 on each side; power of the real FFT; a
Slaney-scale, Slaney-normalised mel filter bank; log10 of at least 1e-10;
the last frame dropped (N // hop frames); every value clamped to the
maximum less 8; then (x + 4) / 4. Audio is peak-normalised first.

Two entries, as the serving paths cut their audio:

- ``file_mel``: a segment of an uploaded file, padded only at its own ends;
- ``ring_mel``: a window of a stream's 64 ms chunks, zero past its true
  samples up to the chunk bucket that holds it, reflect-padded at the
  bucket's ends; the maximum is taken over the true frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * 27.0
                    / np.log(6.4), lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0), lin)


def mel_filters(fe: dict) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] Slaney triangles with Slaney area norm."""
    n_bins = fe["n_fft"] // 2 + 1
    freqs = np.linspace(0.0, fe["sampling_rate"] / 2.0, n_bins)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fe["fmin"]), _hz_to_mel(fe["fmax"]),
                                 fe["n_mels"] + 2))
    fb = np.zeros((n_bins, fe["n_mels"]))
    for j in range(fe["n_mels"]):
        lo, mid, hi = pts[j], pts[j + 1], pts[j + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, j] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def _peak_normalize(x: torch.Tensor) -> torch.Tensor:
    peak = x.abs().max()
    return x / peak if float(peak) > 1e-8 else x


def _log_power_mel(padded: torch.Tensor, n_frames: int, fe: dict) -> torch.Tensor:
    """padded [N'] (already centre-padded) -> log10 mel [n_frames, n_mels]."""
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    frames = padded.unfold(0, n_fft, hop)[:n_frames]  # [T, n_fft]
    n = torch.arange(n_fft, dtype=torch.float64, device=padded.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float()
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2  # [T, n_bins]
    fb = torch.from_numpy(mel_filters(fe)).to(padded.device)
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def _scale(log_spec: torch.Tensor) -> torch.Tensor:
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def file_mel(audio: torch.Tensor, fe: dict) -> torch.Tensor:
    """A file segment's float32 samples [N] -> mel [N // hop, n_mels]."""
    half = fe["n_fft"] // 2
    x = _peak_normalize(audio.float())
    min_len = max(fe["hop_length"], half + 1)
    if x.shape[0] < min_len:
        x = F.pad(x, (0, min_len - x.shape[0]))
    n_frames = x.shape[0] // fe["hop_length"]
    padded = F.pad(x[None, None], (half, half), mode="reflect")[0, 0]
    return _scale(_log_power_mel(padded, n_frames, fe))


def chunk_bucket(n_chunks: int, buckets: list, chunk_samples: int, hop: int) -> int:
    """The smallest chunk bucket (mel-frame buckets in chunks) that holds
    n_chunks, else the largest."""
    sizes = sorted(b * hop // chunk_samples for b in buckets)
    return next((s for s in sizes if s >= n_chunks), sizes[-1])


def ring_mel(audio: torch.Tensor, bucket_samples: int, fe: dict) -> torch.Tensor:
    """A stream window's float32 samples [N] -> mel [N // hop, n_mels],
    computed over `bucket_samples` with zeros past N."""
    half, hop = fe["n_fft"] // 2, fe["hop_length"]
    x = _peak_normalize(audio.float())
    x = F.pad(x, (0, bucket_samples - x.shape[0]))
    padded = F.pad(x[None, None], (half, half), mode="reflect")[0, 0]
    n_true = audio.shape[0] // hop
    log_spec = _log_power_mel(padded, bucket_samples // hop, fe)[:n_true]
    return _scale(log_spec)
