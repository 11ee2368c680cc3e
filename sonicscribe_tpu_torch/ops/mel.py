"""Log-mel spectral chain: framing, windowed DFT, power, mel, log10.

Port of the TPU kernel ``sonicscribe_tpu/ops/mel_pallas.py``
(``log_mel_pallas``). ``log_mel_frames`` launches the hand-written CUDA
kernel ``csrc/log_mel.cu`` (the DFT as 3xTF32 on the tensor cores) for
tensors on the card and runs ``log_mel_frames_plain`` for tensors on the
CPU; there is no other fallback. Both take one row of audio or a batch of
rows (the batcher's ring prefill): a batch is one launch. The caller (audio/mel.py) owns the
padding, the global-max clamp and the scaling.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from sonicscribe_tpu_torch.ops import _build


def log_mel_frames_plain(padded, basis, fb, n_frames: int, hop: int) -> torch.Tensor:
    """padded [N] or [B, N] f32 reflect-padded audio; basis [n_fft, 2*n_bins]
    windowed cos | -sin; fb [n_bins, n_mels] -> log10(max(mel, 1e-10))
    [n_frames, n_mels] (or [B, n_frames, n_mels]) f32 for frames t =
    padded[..., t*hop : t*hop + n_fft]. The JAX package's strided-convolution
    form (audio/mel.py:log_mel_spectrogram, and log_mel_batch over rows).
    On the card it is full float32 only with cuDNN's TF32 off, as
    device.resolve_device sets it."""
    rows = padded if padded.dim() == 2 else padded[None]
    n_bins = fb.shape[0]
    spec = F.conv1d(rows[:, None], basis.T[:, None, :], stride=hop)
    spec = spec[:, :, :n_frames]  # [B, 2*n_bins, T]
    power = spec[:, :n_bins] ** 2 + spec[:, n_bins:] ** 2
    mel = power.transpose(1, 2) @ fb
    out = torch.log10(torch.clamp(mel, min=1e-10))
    return out if padded.dim() == 2 else out[0]


def mel_bands(fb: np.ndarray) -> np.ndarray:
    """[n_bins, n_mels] filter bank -> [n_mels, 2] int32 [start, end) of
    each filter's nonzero bins (a triangle: one contiguous band); [0, 0)
    for a filter with none. The kernel sums only these bins."""
    nz = np.asarray(fb) != 0
    any_nz = nz.any(axis=0)
    start = np.where(any_nz, nz.argmax(axis=0), 0)
    end = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
    return np.stack([start, end], axis=1).astype(np.int32)


FRAMES_PER_BLOCK = (16, 32)  # the kernel's frame tiles (one or two m-tiles of 16)
MAX_BINS = 224  # 2 * n_bins columns in at most 8 warps x 7 n-tiles of 8 (csrc kMaxNT)


def frames_per_block(n_frames: int, n_sms: int, rows: int = 1) -> int:
    """Frames per block: 16 while 16-frame blocks (of all `rows` rows) are
    at most one per SM, then 32. Every block reads the whole basis from L2,
    so once the card is full larger tiles halve that traffic (chip_smoke.py
    times both)."""
    return 16 if rows * -(-n_frames // 16) <= n_sms else 32


def check_kernel_shape(n_fft: int, hop: int, n_bins: int) -> None:
    """Raise ValueError for a front end the kernel does not take: more than
    MAX_BINS bins (n_fft above 446), n_fft not a multiple of 16 or hop not a
    multiple of 4 (frames and basis rows arrive as bulk copies of whole
    16-byte pieces). Whisper's 400 / 160 / 201 bins passes; the JAX kernel
    takes any shape."""
    if n_bins > MAX_BINS or n_fft % 16 or hop % 4:
        raise ValueError(f"the log-mel kernel takes at most {MAX_BINS} bins, n_fft % 16 == 0 "
                         f"and hop % 4 == 0, got {n_bins} bins, n_fft {n_fft}, hop {hop}")


# id(fb) -> (weakref to fb, fb._version, bands on its device)
_BANDS: dict[int, tuple] = {}


def _bands_of(fb: torch.Tensor) -> torch.Tensor:
    """mel_bands of fb on fb's device, made once per filter bank (and again
    if it is written to)."""
    hit = _BANDS.get(id(fb))
    if hit is None or hit[0]() is not fb or hit[1] != fb._version:
        bands = torch.from_numpy(mel_bands(fb.cpu().numpy())).to(fb.device)
        hit = (weakref.ref(fb), fb._version, bands)
        _BANDS[id(fb)] = hit
    return hit[2]


@functools.cache
def _lib():
    fn = _build.load("log_mel").log_mel
    P, I = ctypes.c_void_p, ctypes.c_int
    L = ctypes.c_longlong
    fn.argtypes = [P, L, L, I, P, P, P, P, I, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def _launch(padded, basis, fb, n_frames: int, hop: int, tile: int) -> tuple[torch.Tensor, int]:
    """One launch of the kernel with `tile` frames per block on checked
    inputs, padded [N] or [B, N] (one launch for every row). -> (out,
    cudaError of the launch). Counts nothing."""
    n_fft, (n_bins, n_mels) = basis.shape[0], fb.shape
    rows = padded.shape[0] if padded.dim() == 2 else 1
    out = torch.empty((*padded.shape[:-1], n_frames, n_mels), device=padded.device,
                      dtype=torch.float32)
    err = _lib()(
        padded.data_ptr(), padded.shape[-1], padded.stride(0) if rows > 1 else 0, rows,
        basis.data_ptr(), fb.data_ptr(), _bands_of(fb).data_ptr(), out.data_ptr(), n_frames,
        hop, n_fft, n_bins, n_mels, tile, torch.cuda.current_stream(padded.device).cuda_stream,
    )
    return out, err


def log_mel_frames_cuda(padded, basis, fb, n_frames: int, hop: int) -> torch.Tensor:
    """Launch the CUDA kernel; arguments as log_mel_frames_plain. Raises on
    any input the kernel does not take, and on a failed launch."""
    for name, t in (("padded", padded), ("basis", basis), ("fb", fb)):
        if t.device.type != "cuda" or t.device != padded.device:
            raise ValueError(f"{name} must be on {padded.device}, got {t.device}")
        if t.dtype != torch.float32 or t.stride(-1) != 1 or (t is not padded
                                                             and not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32, got {t.dtype}")
    if padded.dim() not in (1, 2) or basis.dim() != 2 or fb.dim() != 2:
        raise ValueError("padded must be [N] or [B, N], basis [n_fft, 2*n_bins], "
                         "fb [n_bins, n_mels]")
    n_fft, cols = basis.shape
    n_bins = fb.shape[0]
    if cols != 2 * n_bins:
        raise ValueError(f"basis has {cols} columns for {n_bins} bins")
    check_kernel_shape(n_fft, hop, n_bins)
    rows = padded.shape[0] if padded.dim() == 2 else 1
    if padded.data_ptr() % 16 or basis.data_ptr() % 16 or (rows > 1 and padded.stride(0) % 4):
        raise ValueError("the log-mel kernel takes 16-byte aligned audio rows and basis")
    if n_frames < 1 or (n_frames - 1) * hop + n_fft > padded.shape[-1]:
        raise ValueError(f"{n_frames} frames do not fit {padded.shape[-1]} samples")
    if rows < 1 or rows > 65535:
        raise ValueError(f"the log-mel kernel takes 1 to 65535 rows, got {rows}")
    tile = frames_per_block(n_frames, _build.n_sms(padded.device), rows)
    out, err = _launch(padded, basis, fb, n_frames, hop, tile)
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
