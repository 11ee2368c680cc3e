"""Upload decoding: bytes of WAV/MP3/FLAC/M4A/OGG/WebM -> mono float32 16 kHz.

WAV is parsed in-process (sonicscribe_tpu_torch.audio.wav). Compressed codecs are a
host-side job, not a device workload (SURVEY.md §2.9): they are decoded through
an ffmpeg subprocess when the binary exists (the reference used pydub->ffmpeg,
backend/utils.py:7-19); without ffmpeg a clear UnsupportedFormat error is
raised instead of a silent failure.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

from sonicscribe_tpu_torch.audio.resample import resample
from sonicscribe_tpu_torch.audio.wav import WavError, read_wav

TARGET_SR = 16000


class UnsupportedFormat(ValueError):
    pass


def sniff_format(data: bytes, filename: str = "") -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        return "mp3"
    if data[:4] == b"OggS":
        return "ogg"
    if len(data) > 11 and data[4:8] == b"ftyp":
        return "m4a"
    if data[:4] == b"\x1a\x45\xdf\xa3":
        return "webm"
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    if ext in ("wav", "mp3", "flac", "m4a", "aac", "ogg", "webm"):
        return ext
    return "unknown"


def decode_audio(data: bytes, filename: str = "", device=None) -> np.ndarray:
    """-> mono float32 @ 16 kHz. A WAV at another rate is resampled on
    `device` (see device.resolve_device)."""
    fmt = sniff_format(data, filename)
    if fmt == "wav":
        samples, sr = read_wav(data)
        if sr != TARGET_SR:
            samples = resample(samples, sr, TARGET_SR, device=device).cpu().numpy()
        return samples
    return _decode_via_ffmpeg(data, fmt)


def _decode_via_ffmpeg(data: bytes, fmt: str) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise UnsupportedFormat(
            f"cannot decode '{fmt}': ffmpeg not available on this host; "
            "upload 16 kHz mono WAV instead"
        )
    proc = subprocess.run(
        [
            ffmpeg, "-hide_banner", "-loglevel", "error",
            "-i", "pipe:0",
            "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1",
            "-ar", str(TARGET_SR), "pipe:1",
        ],
        input=data,
        capture_output=True,
    )
    if proc.returncode != 0 or not proc.stdout:
        raise UnsupportedFormat(
            f"ffmpeg failed to decode '{fmt}': {proc.stderr.decode(errors='replace')[:200]}"
        )
    return np.frombuffer(proc.stdout, dtype="<i2").astype(np.float32) / 32768.0
