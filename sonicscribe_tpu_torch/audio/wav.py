"""In-process WAV parsing/writing (no temp files, no libsndfile).

The reference round-trips every transcription through a temporary WAV file on
disk (reference: backend/asr.py:272-277 writes, then the HF processor re-reads
it). This package keeps audio as arrays end-to-end; WAV only appears at the
upload/debug boundaries, parsed in-process here.

Supports PCM 8/16/24/32-bit and IEEE float32/64, any channel count (mixed down
by taking channel 0, matching reference backend/utils.py:43-94 semantics).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    num_frames: int
    format_tag: int


class WavError(ValueError):
    pass


def parse_wav(data: bytes) -> tuple[np.ndarray, WavInfo]:
    """Parse a WAV byte string -> (float32 samples in [-1, 1] shaped [C, N], info)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is not None and payload is not None:
            break
    if fmt is None or payload is None:
        raise WavError("missing fmt/data chunk")
    if len(fmt) < 16:
        raise WavError("truncated fmt chunk")
    format_tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", fmt, 0)
    if format_tag == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        (format_tag,) = struct.unpack_from("<H", fmt, 24)  # SubFormat GUID head
    if channels < 1:
        raise WavError("zero channels")

    if format_tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8)
            raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise WavError(f"unsupported PCM depth {bits}")
    elif format_tag == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(payload, dtype=dtype).astype(np.float32)
    else:
        raise WavError(f"unsupported WAV format tag 0x{format_tag:04x}")

    x = x[: len(x) - len(x) % channels].reshape(-1, channels).T  # [C, N]
    info = WavInfo(rate, channels, bits, x.shape[1], format_tag)
    return np.ascontiguousarray(x), info


def read_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 [N], sample_rate). Channel 0 wins on multichannel
    (matching reference backend/utils.py:70-76)."""
    x, info = parse_wav(data)
    return x[0], info.sample_rate


def write_wav(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono float32 [-1,1] -> 16-bit PCM WAV bytes (reference debug tap format,
    backend/debug.py:33-36: 16 kHz / 16-bit / mono)."""
    pcm = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2").tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(pcm16)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM, 1, sample_rate,
                          sample_rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(pcm16)))
    buf.write(pcm16)
    return buf.getvalue()


def pcm16_bytes_to_float(data: bytes) -> np.ndarray:
    """Raw little-endian int16 PCM bytes -> float32 [-1, 1] (the WS wire format:
    2048-byte frames, reference backend/vad_processor_manager.py:84-99).
    A trailing odd byte is dropped."""
    if len(data) % 2:
        data = data[:-1]
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0


def float_to_pcm16_bytes(x: np.ndarray) -> bytes:
    return (np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
