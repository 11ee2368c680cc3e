"""Log-mel spectral chain: framing, windowed DFT, power, mel, log10.

Port of the TPU kernel ``sonicscribe_tpu/ops/mel_pallas.py``
(``log_mel_pallas``). ``log_mel_frames`` launches the hand-written CUDA
kernel ``csrc/log_mel.cu`` for tensors on the card and runs
``log_mel_frames_plain`` for tensors on the CPU; there is no other
fallback. The caller (audio/mel.py) owns the padding, the global-max clamp
and the scaling.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.ops import _build


def log_mel_frames_plain(padded, basis, fb, n_frames: int, hop: int) -> torch.Tensor:
    """padded [N] f32 reflect-padded audio; basis [n_fft, 2*n_bins] windowed
    cos | -sin; fb [n_bins, n_mels] -> log10(max(mel, 1e-10)) [n_frames,
    n_mels] f32 for frames t = padded[t*hop : t*hop + n_fft]. The JAX
    package's strided-convolution form (audio/mel.py:log_mel_spectrogram).
    On the card it is full float32 only with cuDNN's TF32 off, as
    device.resolve_device sets it."""
    n_bins = fb.shape[0]
    spec = F.conv1d(padded[None, None], basis.T[:, None, :], stride=hop)[0]
    spec = spec[:, :n_frames]  # [2*n_bins, T]
    power = spec[:n_bins] ** 2 + spec[n_bins:] ** 2
    mel = power.T @ fb
    return torch.log10(torch.clamp(mel, min=1e-10))


@functools.cache
def _lib():
    fn = _build.load("log_mel").log_mel
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_longlong, P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def log_mel_frames_cuda(padded, basis, fb, n_frames: int, hop: int) -> torch.Tensor:
    """Launch the CUDA kernel; arguments as log_mel_frames_plain. Raises on
    any input the kernel does not take, and on a failed launch."""
    for name, t in (("padded", padded), ("basis", basis), ("fb", fb)):
        if t.device.type != "cuda" or t.device != padded.device:
            raise ValueError(f"{name} must be on {padded.device}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32, got {t.dtype}")
    if padded.dim() != 1 or basis.dim() != 2 or fb.dim() != 2:
        raise ValueError("padded must be [N], basis [n_fft, 2*n_bins], fb [n_bins, n_mels]")
    n_fft, cols = basis.shape
    n_bins, n_mels = fb.shape
    if cols != 2 * n_bins:
        raise ValueError(f"basis has {cols} columns for {n_bins} bins")
    if n_frames < 1 or (n_frames - 1) * hop + n_fft > padded.shape[0]:
        raise ValueError(f"{n_frames} frames do not fit {padded.shape[0]} samples")
    out = torch.empty((n_frames, n_mels), device=padded.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = _lib()(
        padded.data_ptr(), padded.shape[0], basis.data_ptr(), fb.data_ptr(),
        out.data_ptr(), n_frames, hop, n_fft, n_bins, n_mels, stream,
    )
    if err != 0:
        raise RuntimeError(f"log_mel kernel launch failed: cudaError {err}")
    _build.launch_counts["log_mel"] += 1
    return out


def log_mel_frames(padded, basis, fb, n_frames: int, hop: int) -> torch.Tensor:
    """The CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    if padded.device.type == "cpu":
        return log_mel_frames_plain(padded, basis, fb, n_frames, hop)
    return log_mel_frames_cuda(padded, basis, fb, n_frames, hop)
