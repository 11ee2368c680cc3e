"""Per-session audio chunk ring buffer and speech-segment bookkeeping.

The port's copy of the JAX package's ``stream/buffer.py`` (the reference's
AudioBufferManager + data types, backend/audio_manager.py:21-123,
backend/data_basic.py:11-75, with its quirks fixed as there):

- `committed_audio()` reads exactly [segment.start, segment.end], not
  "start -> newest chunk" (fixes audio_manager.py:119);
- chunk duration derives from the owning buffer's config, not a global.

This is host-side session state (bytes + counters); the card sees only the
arrays the engine assembles from it. Full-size chunks live in the native
ring (``sonicscribe_tpu_torch/native``), the rest in a dict.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from sonicscribe_tpu_torch.audio.wav import pcm16_bytes_to_float
from sonicscribe_tpu_torch.native import NativeChunkRing


@dataclass
class AudioChunk:
    chunk_id: int
    timestamp: float
    data: bytes
    vad_confidence: float = 0.0


@dataclass
class SpeechSegment:
    segment_id: int
    start_chunk_id: int
    start_time: float
    end_chunk_id: Optional[int] = None
    end_time: Optional[float] = None
    transcript: str = ""
    is_final: bool = False

    def finalize(self, end_chunk_id: int, end_time: float) -> None:
        self.end_chunk_id = end_chunk_id
        self.end_time = end_time
        self.is_final = True

    @property
    def duration(self) -> float:
        if self.end_time is None:
            return 0.0
        return self.end_time - self.start_time


class ChunkBuffer:
    """Monotonic-id chunk store with time-based eviction and segment tracking.

    Reference constants: 30 s retention (MAX_AUDIO_BUFFER_SECONDS), at most 3
    live segments (MAX_SPEECH_SEGMENTS), interim window = last 20 chunks
    (TEMPORARY_TRANSCRIPTION_INTERVAL) — backend/config.py:25,40,44.
    """

    def __init__(
        self,
        chunk_duration_ms: int = 64,
        max_buffer_seconds: float = 30.0,
        max_segments: int = 3,
        interim_chunks: int = 20,
        clock=time.monotonic,
        chunk_bytes: int = 2048,
        use_native: bool = True,
    ):
        self.chunk_duration_s = chunk_duration_ms / 1000.0
        self.max_buffer_seconds = max_buffer_seconds
        self.max_segments = max_segments
        self.interim_chunks = interim_chunks
        self.chunk_bytes = chunk_bytes
        self._clock = clock
        self._chunks: Dict[int, AudioChunk] = {}
        self._next_id = 0
        self._next_segment_id = 0
        self._last_cleanup = 0.0
        self.segments: List[SpeechSegment] = []
        self.current_segment: Optional[SpeechSegment] = None

        # native C++ ring storage for the hot per-chunk path; Python dict
        # fallback when the library cannot be built
        self._ring = None
        if use_native and NativeChunkRing.available():
            capacity = int(max_buffer_seconds / self.chunk_duration_s) + 64
            self._ring = NativeChunkRing(capacity, chunk_bytes)

    @property
    def backend(self) -> str:
        return "native" if self._ring is not None else "python"

    # ---- chunk ingestion ----

    def add_chunk(self, data: bytes) -> AudioChunk:
        now = self._clock()
        if self._ring is not None and len(data) == self.chunk_bytes:
            cid = self._ring.push(data)
            self._next_id = cid + 1
            return AudioChunk(cid, now, data)
        chunk = AudioChunk(self._next_id, now, data)
        self._chunks[chunk.chunk_id] = chunk
        self._next_id += 1
        if now - self._last_cleanup >= 1.0:
            self._evict(now)
            self._last_cleanup = now
        return chunk

    def _evict(self, now: float) -> None:
        # never evict chunks still needed by the open segment
        protect_from = (
            self.current_segment.start_chunk_id
            if self.current_segment is not None
            else None
        )
        cutoff = now - self.max_buffer_seconds
        for cid in [c for c, ch in self._chunks.items() if ch.timestamp < cutoff]:
            if protect_from is not None and cid >= protect_from:
                continue
            del self._chunks[cid]

    @property
    def newest_chunk_id(self) -> int:
        return self._next_id - 1

    def chunk_count(self) -> int:
        if self._ring is not None:
            return self._ring.next_id - self._ring.oldest_id
        return len(self._chunks)

    # ---- range access ----

    def chunks_in_range(self, start_id: int, end_id: int) -> List[AudioChunk]:
        """Inclusive range; missing (evicted) ids are skipped."""
        return [
            self._chunks[c] for c in range(start_id, end_id + 1) if c in self._chunks
        ]

    def audio_in_range(self, start_id: int, end_id: int) -> np.ndarray:
        if self._ring is not None:
            # fused read + int16->float32 conversion in C++
            return self._ring.read_f32(start_id, end_id)
        data = b"".join(c.data for c in self.chunks_in_range(start_id, end_id))
        return pcm16_bytes_to_float(data)

    # ---- segments ----

    def start_segment(self, start_chunk_id: int) -> SpeechSegment:
        seg = SpeechSegment(
            segment_id=self._next_segment_id,
            start_chunk_id=start_chunk_id,
            start_time=start_chunk_id * self.chunk_duration_s,
        )
        self._next_segment_id += 1
        self.current_segment = seg
        self.segments.append(seg)
        if len(self.segments) > self.max_segments:
            self.segments = self.segments[-self.max_segments :]
        return seg

    def finalize_segment(self, end_chunk_id: int) -> Optional[SpeechSegment]:
        seg = self.current_segment
        if seg is None:
            return None
        seg.finalize(end_chunk_id, (end_chunk_id + 1) * self.chunk_duration_s)
        self.current_segment = None
        return seg

    # ---- transcription windows ----

    def interim_audio(self) -> tuple[np.ndarray, int, int] | None:
        """Last `interim_chunks` chunks of the open segment
        (reference: audio_manager.py:106-114). Returns (audio, start_id, end_id)."""
        seg = self.current_segment
        if seg is None:
            return None
        end = self.newest_chunk_id
        start = max(seg.start_chunk_id, end - self.interim_chunks + 1)
        if end < start:
            return None
        return self.audio_in_range(start, end), start, end

    def committed_audio(self, seg: SpeechSegment) -> tuple[np.ndarray, int, int]:
        """Full audio of a finalized segment [start, end] — exact range, not
        'to newest' (fixes reference audio_manager.py:119)."""
        end = seg.end_chunk_id if seg.end_chunk_id is not None else self.newest_chunk_id
        return self.audio_in_range(seg.start_chunk_id, end), seg.start_chunk_id, end
