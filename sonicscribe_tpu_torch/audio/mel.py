"""Whisper-compatible log-mel spectrogram front end.

Port of the JAX package's ``audio/mel.py`` (the reference's Whisper feature
extractor inside its HF processor, backend/asr.py:66,393): periodic Hann
window, reflect center-padding, real DFT as a matmul basis, Slaney-scale /
Slaney-norm mel filter bank, log10 with the 8-dB dynamic-range clamp and
(x+4)/4 scaling.

The spectral chain (framing, windowed DFT, power, mel projection, log10)
is ``ops.mel.log_mel_frames``: a hand-written CUDA kernel for a tensor on
the card, its plain PyTorch version for a tensor on the CPU. The global-max
clamp, the scaling and the zero padding to a bucket run here in plain
PyTorch, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.ops.mel import check_kernel_shape, log_mel_frames


@dataclass(frozen=True)
class MelConfig:
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    fmin: float = 0.0
    fmax: float = 8000.0
    dynamic_range_db_factor: float = 8.0  # max - 8.0 clamp, Whisper convention

    @property
    def n_freq_bins(self) -> int:
        return self.n_fft // 2 + 1


# ---- Slaney mel scale (matches transformers.audio_utils mel_scale="slaney") ----

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = 27.0 / np.log(6.4)


def hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) * _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= _MIN_LOG_MEL
    freq = np.where(
        log_region, _MIN_LOG_HZ * np.exp((mels - _MIN_LOG_MEL) / _LOGSTEP), freq
    )
    return freq


@lru_cache(maxsize=8)
def mel_filter_bank(cfg: MelConfig) -> np.ndarray:
    """Triangular Slaney-normalized filter bank, shape [n_freq_bins, n_mels]."""
    fft_freqs = np.linspace(0.0, cfg.sampling_rate / 2.0, cfg.n_freq_bins)
    mel_min = hertz_to_mel_slaney(np.array(cfg.fmin))
    mel_max = hertz_to_mel_slaney(np.array(cfg.fmax))
    mel_pts = np.linspace(mel_min, mel_max, cfg.n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    slopes = hz_pts[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    # Slaney area normalization
    enorm = 2.0 / (hz_pts[2 : cfg.n_mels + 2] - hz_pts[: cfg.n_mels])
    fb *= enorm[np.newaxis, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=8)
def _dft_conv_weights(cfg: MelConfig) -> np.ndarray:
    """Windowed real-DFT basis as conv filters, shape [2*n_bins, n_fft].

    Row b (b < n_bins) is  hann * cos(2*pi*b*n/n_fft)   (real part)
    Row n_bins + b is     -hann * sin(2*pi*b*n/n_fft)   (imag part)
    """
    n_fft, n_bins = cfg.n_fft, cfg.n_freq_bins
    window = np.hanning(n_fft + 1)[:-1]  # periodic Hann, torch.hann_window parity
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)
    return (basis * window[None, :]).astype(np.float32)


_TABLES: dict = {}


def device_tables(cfg: MelConfig, device: torch.device):
    """(basis [n_fft, 2*n_bins], fb [n_bins, n_mels]) f32 on `device`,
    copied there once per (cfg, device). For a CUDA device it first raises
    ValueError if the log-mel kernel does not take cfg's shape."""
    key = (cfg, str(device))
    if key not in _TABLES:
        if torch.device(device).type == "cuda":
            check_kernel_shape(cfg.n_fft, cfg.hop_length, cfg.n_freq_bins)
        basis = torch.from_numpy(np.ascontiguousarray(_dft_conv_weights(cfg).T))
        fb = torch.from_numpy(mel_filter_bank(cfg))
        _TABLES[key] = (basis.to(device), fb.to(device))
    return _TABLES[key]


def frame_count(num_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Output frame count for a given sample count (HF drops the final frame)."""
    return num_samples // cfg.hop_length


def log_mel_spectrogram(
    audio,
    cfg: MelConfig = MelConfig(),
    pad_to_frames: int | None = None,
    device=None,
) -> torch.Tensor:
    """Mono float32 audio [N] -> log-mel features [T, n_mels], T = N // hop.

    A tensor is processed on its own device; anything else goes to `device`
    (see device.resolve_device). If `pad_to_frames` is given, the output is
    zero-padded on the time axis to that length.
    """
    if isinstance(audio, torch.Tensor):
        audio = audio.to(torch.float32)
        resolve_device(audio.device)  # sets the float32 conv switches
    else:
        audio = torch.as_tensor(
            np.asarray(audio, np.float32), device=resolve_device(device)
        )
    padded, n_frames = reflect_pad(audio, cfg)
    basis, fb = device_tables(cfg, audio.device)
    log_spec = log_mel_frames(padded, basis, fb, n_frames, cfg.hop_length)
    return normalize_log_mel(log_spec, cfg, pad_to_frames)


def reflect_pad(audio: torch.Tensor, cfg: MelConfig = MelConfig()):
    """audio [N] f32 -> (reflect-padded audio, true frame count), with the
    same pre-pad of short audio as log_mel_spectrogram."""
    half = cfg.n_fft // 2
    # Audio shorter than one frame (or too short for reflect padding) is
    # zero-padded up to the minimum; produces >= 1 output frame.
    min_len = max(cfg.hop_length, half + 1)
    if audio.shape[0] < min_len:
        audio = F.pad(audio, (0, min_len - int(audio.shape[0])))
    padded = F.pad(audio[None, None], (half, half), mode="reflect")[0, 0]
    return padded, int(audio.shape[0]) // cfg.hop_length


def normalize_log_mel(
    log_spec: torch.Tensor, cfg: MelConfig = MelConfig(), pad_to_frames: int | None = None
) -> torch.Tensor:
    """Whisper's global-max clamp and (x+4)/4 scaling over the true frames
    [T, n_mels], then zero frames up to `pad_to_frames`."""
    n_frames = log_spec.shape[0]
    log_spec = torch.maximum(log_spec, log_spec.max() - cfg.dynamic_range_db_factor)
    log_spec = (log_spec + 4.0) / 4.0
    if pad_to_frames is not None and pad_to_frames > n_frames:
        log_spec = F.pad(log_spec, (0, 0, 0, pad_to_frames - n_frames))
    return log_spec
