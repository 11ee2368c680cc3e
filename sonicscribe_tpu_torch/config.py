"""Application configuration and wire-protocol constants.

A copy of the JAX package's ``AppConfig`` (the reference's env-backed
config, backend/config.py:9-44: same timing constants, same env variables),
cut to the fields this package reads. The continuous batcher's, streaming
path's and quantization knobs come back with the slices that use them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class AppConfig:
    """Runtime configuration: an instance owned by the server; per-request
    overrides are scoped (the reference mutated class attributes globally
    from ``/vad/config``, backend/main.py:651-668)."""

    # ---- server (reference: backend/config.py:11-20) ----
    host: str = field(default_factory=lambda: _env("HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: int(_env("PORT", "8081")))
    checkpoint_path: str = field(
        default_factory=lambda: _env("CHECKPOINT_PATH", "./models/GLM-ASR-Nano-2512")
    )
    log_level: str = field(default_factory=lambda: _env("LOG_LEVEL", "INFO"))

    # ---- audio / wire protocol (reference: backend/config.py:22-25) ----
    # 64 ms chunks: 1024 samples @ 16 kHz, int16 mono => 2048 bytes.
    audio_sample_rate: int = 16000
    audio_chunk_duration_ms: int = 64
    audio_chunk_size: int = 2048  # bytes
    max_audio_buffer_seconds: int = 30

    # ---- VAD gate (reference: backend/config.py:28-37) ----
    vad_smoothing_window: int = 2
    vad_speech_threshold: float = 0.6
    vad_process_window: int = 10  # chunks per VAD decision (640 ms)

    # ---- streaming transcription (reference: backend/config.py:40-44) ----
    temporary_transcription_interval: int = 20  # chunks (1.28 s) per interim decode
    max_segment_duration: float = 20.0

    # ---- decode budgets (reference: transcription_manager.py:25,37; main.py:440) ----
    interim_max_new_tokens: int = 15
    final_max_tokens: int = 200
    file_max_new_tokens: int = 256

    # ---- engine (no reference counterpart) ----
    # only "native" is ported; build_runtime refuses the int8 modes
    quant_mode: str = field(default_factory=lambda: _env("QUANT_MODE", "native"))
    # mel-frame bucket sizes: one prompt shape per bucket
    prefill_buckets: List[int] = field(
        default_factory=lambda: [128, 256, 512, 1024, 2048, 3072]
    )

    @property
    def samples_per_chunk(self) -> int:
        return self.audio_chunk_size // 2

    def protocol_constants(self) -> dict:
        """Derived constants exposed by /debug/config (reference: main.py:171-191)."""
        return {
            "audio_sample_rate": self.audio_sample_rate,
            "audio_chunk_duration_ms": self.audio_chunk_duration_ms,
            "audio_chunk_size": self.audio_chunk_size,
            "samples_per_chunk": self.samples_per_chunk,
            "vad_process_window": self.vad_process_window,
            "vad_window_ms": self.audio_chunk_duration_ms * self.vad_process_window,
            "temporary_transcription_interval": self.temporary_transcription_interval,
            "max_segment_duration": self.max_segment_duration,
            "max_audio_buffer_seconds": self.max_audio_buffer_seconds,
        }
