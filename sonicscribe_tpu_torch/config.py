"""Application configuration and wire-protocol constants.

A copy of the JAX package's ``AppConfig`` (the reference's env-backed
config, backend/config.py:9-44: same timing constants, same env variables),
cut to the fields this package reads. Of the continuous batcher's knobs
the decode slots, fused dual decode and the Silero weights are here; flash
decode and data parallel come back with the slices that use them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


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
    debug_audio_enabled: bool = field(
        default_factory=lambda: _env_bool("DEBUG_AUDIO_ENABLED", False)
    )
    debug_audio_base_dir: str = field(
        default_factory=lambda: _env("DEBUG_AUDIO_BASE_DIR", "./debug_audio")
    )
    use_https: bool = field(default_factory=lambda: _env_bool("USE_HTTPS", False))
    ssl_certfile: str = field(default_factory=lambda: _env("SSL_CERTFILE", ""))
    ssl_keyfile: str = field(default_factory=lambda: _env("SSL_KEYFILE", ""))

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
    # dynamic threshold state machine (vad/gate.py)
    vad_dynamic_base_threshold: float = 0.3
    vad_dynamic_max_threshold: float = 0.9
    vad_dynamic_start_boost: float = 0.1
    vad_dynamic_continue_boost: float = 0.03

    # ---- streaming transcription (reference: backend/config.py:40-44) ----
    temporary_transcription_interval: int = 20  # chunks (1.28 s) per interim decode
    # the reference's code says 30.0, its docs 20.0 (README-en.md:124)
    max_segment_duration: float = 20.0
    vad_processing_interval_ms: int = 64
    max_speech_segments: int = 3

    # ---- decode budgets (reference: transcription_manager.py:25,37; main.py:440) ----
    interim_max_new_tokens: int = 15
    final_base_tokens: int = 50
    final_tokens_per_second: int = 5
    final_max_tokens: int = 200
    file_max_new_tokens: int = 256

    # ---- engine (no reference counterpart) ----
    # continuous batcher (engine/batcher.py): long-pool decode slots, i.e.
    # concurrent finals / file segments
    decode_slots: int = field(default_factory=lambda: int(_env("DECODE_SLOTS", "32")))
    # "native" | "int8" | "int8-decoder" | "int8-decoder-a8" (serve/runtime.py)
    quant_mode: str = field(default_factory=lambda: _env("QUANT_MODE", "native"))
    # speculative finals and interims: the session passes a segment's banked
    # interim tokens as a draft; the batched engine spends them on its
    # verify program (w draft tokens a round), and ThreadedEngine ignores
    # them, as the JAX one does
    speculative_finals: bool = field(
        default_factory=lambda: _env("SPECULATIVE_FINALS", "true").lower()
        in ("1", "true", "yes")
    )
    # eager finals: the gate confirms a speech end at the second silent
    # window; the session starts the final's decode at the first and
    # commits it on confirmation (discarded if speech resumes)
    eager_finals: bool = field(default_factory=lambda: _env_bool("EAGER_FINALS", True))
    speculative_interims: bool = field(
        default_factory=lambda: _env_bool("SPECULATIVE_INTERIMS", False)
    )
    # fused dual-pool decode on the batcher: both pools in one program per
    # tick, the weights read once a step (off by default, as in JAX)
    fuse_dual_decode: bool = field(
        default_factory=lambda: _env_bool("FUSE_DUAL_DECODE", False)
    )
    # converted Silero weights (.npz from tools/convert_silero.py); when set,
    # `--vad silero` serves these. Without them the random-init net is
    # refused (it would gate garbage) and serving falls back to the energy gate
    silero_weights: str = field(default_factory=lambda: _env("SONIC_SILERO_WEIGHTS", ""))
    # mel-frame bucket sizes: one prompt shape per bucket
    prefill_buckets: List[int] = field(
        default_factory=lambda: [128, 256, 512, 1024, 2048, 3072]
    )
    # batched engine replicas, one per card (engine/replicas.py); on the CPU
    # (device "cpu") this many replicas all on the CPU
    data_parallel: int = field(default_factory=lambda: int(_env("DATA_PARALLEL", "1")))

    @property
    def samples_per_chunk(self) -> int:
        return self.audio_chunk_size // 2

    @property
    def chunks_per_second(self) -> float:
        return 1000.0 / self.audio_chunk_duration_ms

    def final_token_budget(self, duration_s: float) -> int:
        """Duration-scaled final decode budget (reference: transcription_manager.py:37)."""
        return min(
            self.final_base_tokens + int(self.final_tokens_per_second * duration_s),
            self.final_max_tokens,
        )

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
