"""File-transcription pipeline: decode -> VAD segment -> per-segment decode,
streamed as NDJSON.

Message-sequence parity with the reference's /transcribe/file
(reference: backend/main.py:193-523, schema SURVEY.md §2.7):
initialization -> segments_summary -> N x segment_result | segment_error ->
final_summary; VAD failure falls back to one whole-audio segment
(main.py:352-363); over-long segments are pre-split with `cut_long_segments`
semantics (main.py:527-567); a semaphore caps concurrent segment decodes
(main.py:429-430).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

import numpy as np

from sonicscribe_tpu_torch.vad.segments import get_speech_timestamps

logger = logging.getLogger(__name__)

SR = 16000


@dataclass
class FileTranscriptionConfig:
    """Request-scoped config (reference pydantic TranscriptionConfig,
    main.py:101-116: vad_enabled, hotwords, max_segment_duration in [1, 30])."""

    vad_enabled: bool = True
    hotwords: list[str] = field(default_factory=list)
    max_segment_duration: float = 20.0
    vad_threshold: float = 0.5
    max_new_tokens: int = 256
    concurrency: int = 3

    @classmethod
    def from_dict(
        cls, d: dict, default_threshold: float | None = None
    ) -> "FileTranscriptionConfig":
        """default_threshold: the server's configured VAD threshold — the
        file path honors it unless the request overrides (reference reads
        the runtime-mutable AppConfig.VAD_SPEECH_THRESHOLD, main.py:312)."""
        cfg = cls()
        if default_threshold is not None:
            cfg.vad_threshold = float(default_threshold)
        if "vad_enabled" in d:
            cfg.vad_enabled = bool(d["vad_enabled"])
        if "hotwords" in d and isinstance(d["hotwords"], list):
            cfg.hotwords = [str(w) for w in d["hotwords"]][:10]
        if "max_segment_duration" in d:
            cfg.max_segment_duration = float(
                np.clip(float(d["max_segment_duration"]), 1.0, 30.0)
            )
        if "vad_threshold" in d:
            cfg.vad_threshold = float(np.clip(float(d["vad_threshold"]), 0.05, 0.95))
        return cfg


@dataclass
class PlannedSegment:
    index: int
    original_index: int
    start_s: float
    end_s: float
    is_long_segment: bool = False
    sub_segment_index: int = 0


def plan_segments(
    audio: np.ndarray,
    vad,
    cfg: FileTranscriptionConfig,
) -> list[PlannedSegment]:
    """VAD segmentation + long-segment cutting (reference main.py:274-370,527-567)."""
    n = len(audio)
    duration = n / SR
    spans: list[tuple[float, float]] = []
    if cfg.vad_enabled and vad is not None:
        try:
            stamps = get_speech_timestamps(
                audio,
                vad,
                threshold=cfg.vad_threshold,
                min_speech_duration_ms=300,
                min_silence_duration_ms=1000,
                max_speech_duration_s=float("inf"),
            )
            spans = [(s.start / SR, s.end / SR) for s in stamps]
        except Exception:
            logger.exception("VAD segmentation failed; falling back to whole audio")
    if not spans:
        spans = [(0.0, duration)] if duration > 0 else []

    out: list[PlannedSegment] = []
    idx = 0
    for orig, (s, e) in enumerate(spans):
        seg_dur = e - s
        if seg_dur <= cfg.max_segment_duration:
            out.append(PlannedSegment(idx, orig, s, e))
            idx += 1
        else:
            n_parts = int(np.ceil(seg_dur / cfg.max_segment_duration))
            per = seg_dur / n_parts
            for i in range(n_parts):
                out.append(
                    PlannedSegment(
                        idx,
                        orig,
                        s + i * per,
                        e if i == n_parts - 1 else s + (i + 1) * per,
                        is_long_segment=True,
                        sub_segment_index=i,
                    )
                )
                idx += 1
    return out


async def transcribe_file_stream(
    audio: np.ndarray,
    engine,
    vad,
    cfg: FileTranscriptionConfig,
    filename: str = "",
) -> AsyncIterator[dict]:
    """Yields the NDJSON message sequence (one dict per line)."""
    t_start = time.perf_counter()
    duration = len(audio) / SR

    loop = asyncio.get_running_loop()
    segments = await loop.run_in_executor(None, plan_segments, audio, vad, cfg)

    yield {
        "type": "initialization",
        "filename": filename,
        "audio_duration": duration,
        "vad_enabled": cfg.vad_enabled,
        "hotwords": cfg.hotwords,
        "max_segment_duration": cfg.max_segment_duration,
        "total_segments": len(segments),
    }
    yield {
        "type": "segments_summary",
        "total_segments": len(segments),
        "segments": [
            {
                "segment_index": s.index,
                "original_index": s.original_index,
                "start_time": round(s.start_s, 3),
                "end_time": round(s.end_s, 3),
                "duration": round(s.end_s - s.start_s, 3),
                "is_long_segment": s.is_long_segment,
            }
            for s in segments
        ],
    }

    sem = asyncio.Semaphore(cfg.concurrency)
    results: dict[int, dict] = {}
    done_count = 0

    async def run_one(seg: PlannedSegment) -> dict:
        async with sem:
            lo, hi = int(seg.start_s * SR), int(seg.end_s * SR)
            try:
                r = await engine.transcribe(
                    audio[lo:hi],
                    SR,
                    max_new_tokens=cfg.max_new_tokens,
                    hotwords=cfg.hotwords or None,
                )
                return {
                    "type": "segment_result",
                    "segment_index": seg.index,
                    "original_index": seg.original_index,
                    "sub_segment_index": seg.sub_segment_index,
                    "start_time": round(seg.start_s, 3),
                    "end_time": round(seg.end_s, 3),
                    "text": r.text,
                    "is_long_segment": seg.is_long_segment,
                    "hotwords_used": bool(cfg.hotwords),
                    "rtf": round(r.timings.get("rtf", 0.0), 4),
                }
            except Exception as e:  # per-segment isolation (main.py:640-649)
                logger.exception("segment %d failed", seg.index)
                return {
                    "type": "segment_error",
                    "segment_index": seg.index,
                    "original_index": seg.original_index,
                    "start_time": round(seg.start_s, 3),
                    "end_time": round(seg.end_s, 3),
                    "error": str(e)[:300],
                }

    tasks = [asyncio.ensure_future(run_one(s)) for s in segments]
    for fut in asyncio.as_completed(tasks):
        msg = await fut
        done_count += 1
        msg["progress"] = round(done_count / max(len(segments), 1), 4)
        results[msg["segment_index"]] = msg
        yield msg

    ok = [results[i] for i in sorted(results) if results[i]["type"] == "segment_result"]
    failed = [r for r in results.values() if r["type"] == "segment_error"]
    yield {
        "type": "final_summary",
        "total_segments": len(segments),
        "successful_segments": len(ok),
        "failed_segments": len(failed),
        "audio_duration": round(duration, 3),
        "processing_time": round(time.perf_counter() - t_start, 3),
        "rtf": round((time.perf_counter() - t_start) / max(duration, 1e-6), 4),
        "full_text": " ".join(r["text"] for r in ok if r["text"]).strip(),
    }
