"""Polyphase windowed-sinc resampler in PyTorch.

Port of the JAX package's ``audio/resample.py`` (the reference used
torchaudio's ``Resample``, backend/asr.py:257-261). Numerics match
``scipy.signal.resample_poly`` with its default Kaiser(5.0) window: the FIR
low-pass is designed once per (up, down) pair on the host in numpy, and the
hot path zero-stuffs the signal by `up` and runs one strided ``conv1d``
(the JAX package's dilated convolution, written out).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.device import resolve_device

_KAISER_BETA = 5.0
_HALF_LEN_MULT = 10  # taps per rate unit, matching scipy.resample_poly


@lru_cache(maxsize=32)
def _design_filter(up: int, down: int) -> np.ndarray:
    """Windowed-sinc low-pass at cutoff 1/max(up,down), DC gain `up`.

    Equivalent to scipy's ``firwin(2*half_len+1, 1/max_rate,
    window=("kaiser", 5.0))`` with scale=True, times `up`.
    """
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = _HALF_LEN_MULT * max_rate
    m = np.arange(2 * half_len + 1, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * m)
    h *= np.kaiser(2 * half_len + 1, _KAISER_BETA)
    h /= h.sum()  # unity DC gain
    return (h * up).astype(np.float32)


def _upfirdn_len(n_in: int, n_taps: int, up: int, down: int) -> int:
    return (-(-((n_in - 1) * up + n_taps) // down))


def _upfirdn(x: torch.Tensor, h: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Zero-stuff by `up`, full-convolve with `h`, keep every `down`-th sample."""
    k = h.shape[0]
    stuffed = x.new_zeros((x.shape[0] - 1) * up + 1)
    stuffed[::up] = x
    stuffed = F.pad(stuffed, (k - 1, k - 1))
    # conv1d correlates, so the filter is flipped to convolve
    return F.conv1d(stuffed[None, None], h.flip(0)[None, None], stride=down)[0, 0]


@lru_cache(maxsize=64)
def _plan(n_in: int, up: int, down: int):
    """Precompute the scipy-compatible trim for a given input length."""
    h = _design_filter(up, down)
    half_len = (len(h) - 1) // 2
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    n_post_pad = 0
    while (
        _upfirdn_len(n_in, len(h) + n_pre_pad + n_post_pad, up, down)
        < n_out + n_pre_remove
    ):
        n_post_pad += 1
    h_full = np.concatenate(
        [np.zeros(n_pre_pad, np.float32), h, np.zeros(n_post_pad, np.float32)]
    )
    return h_full, n_pre_remove, n_out


def resample(x, orig_sr: int, target_sr: int, device=None) -> torch.Tensor:
    """Resample a mono signal to `target_sr` -> float32 [N'].

    A tensor stays on its device; anything else goes to `device`
    (see device.resolve_device). Matches scipy.signal.resample_poly.
    """
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        resolve_device(x.device)  # sets the float32 conv switches
    else:
        x = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h_full, n_pre_remove, n_out = _plan(int(x.shape[0]), up, down)
    y = _upfirdn(x, torch.from_numpy(h_full).to(x.device), up, down)
    return y[n_pre_remove : n_pre_remove + n_out]
