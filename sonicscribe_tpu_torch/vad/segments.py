"""Speech-timestamp extraction from per-window VAD probabilities.

Port of the SEMANTICS of silero's `get_speech_timestamps` as parameterized by
the reference (file mode: min_speech=300 ms, min_silence=1000 ms,
max_speech=inf — reference backend/vad.py:71-79; stream gate mode:
100 ms / 1000 ms — vad.py:116-124), reimplemented over the port's VAD
probability stream. Pure host-side logic: runs once per file / per gate
window, so it stays in Python by design (it is control flow, not FLOPs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sonicscribe_tpu_torch.vad.model import SAMPLE_RATE, WINDOW_SAMPLES, window_probs


@dataclass
class SpeechTimestamp:
    start: int  # sample index
    end: int  # sample index (exclusive)

    @property
    def duration_s(self) -> float:
        return (self.end - self.start) / SAMPLE_RATE


def timestamps_from_probs(
    probs: np.ndarray,
    num_samples: int,
    threshold: float = 0.5,
    neg_threshold: float | None = None,
    min_speech_duration_ms: float = 300.0,
    min_silence_duration_ms: float = 1000.0,
    max_speech_duration_s: float = float("inf"),
    speech_pad_ms: float = 30.0,
) -> list[SpeechTimestamp]:
    """probs: one probability per 512-sample window."""
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)
    w = WINDOW_SAMPLES
    min_speech = int(min_speech_duration_ms * SAMPLE_RATE / 1000)
    min_silence = int(min_silence_duration_ms * SAMPLE_RATE / 1000)
    pad = int(speech_pad_ms * SAMPLE_RATE / 1000)
    max_speech = (
        int(max_speech_duration_s * SAMPLE_RATE) - w - 2 * pad
        if np.isfinite(max_speech_duration_s)
        else float("inf")
    )

    segments: list[SpeechTimestamp] = []
    triggered = False
    start = 0
    temp_end = 0  # candidate end during a silence run

    for i, p in enumerate(probs):
        pos = i * w
        if p >= threshold and temp_end:
            temp_end = 0
        if not triggered and p >= threshold:
            triggered = True
            start = pos
            continue
        if triggered and (pos - start) > max_speech:
            end = temp_end if temp_end else pos
            segments.append(SpeechTimestamp(start, end))
            triggered = False
            temp_end = 0
            if p >= threshold:
                triggered = True
                start = pos
            continue
        if triggered and p < neg_threshold:
            if not temp_end:
                temp_end = pos
            if pos - temp_end >= min_silence:
                if temp_end - start >= min_speech:
                    segments.append(SpeechTimestamp(start, temp_end))
                triggered = False
                temp_end = 0

    if triggered:
        end = num_samples
        if end - start >= min_speech:
            segments.append(SpeechTimestamp(start, end))

    # apply symmetric padding, clamped, without overlapping neighbours
    out: list[SpeechTimestamp] = []
    for j, seg in enumerate(segments):
        s = max(0, seg.start - pad)
        e = min(num_samples, seg.end + pad)
        if j > 0 and out and s < out[-1].end:
            mid = (segments[j - 1].end + seg.start) // 2
            out[-1].end = min(out[-1].end, mid)
            s = max(s, mid)
        out.append(SpeechTimestamp(s, e))
    return out


def get_speech_timestamps(
    audio: np.ndarray,
    vad,
    threshold: float = 0.5,
    min_speech_duration_ms: float = 300.0,
    min_silence_duration_ms: float = 1000.0,
    max_speech_duration_s: float = float("inf"),
    speech_pad_ms: float = 30.0,
) -> list[SpeechTimestamp]:
    """Whole-file segmentation (reference file-mode parameterization,
    backend/vad.py:71-79). `audio` must be mono float32 @ 16 kHz."""
    probs = window_probs(vad, np.asarray(audio, np.float32))
    return timestamps_from_probs(
        probs,
        num_samples=len(audio),
        threshold=threshold,
        min_speech_duration_ms=min_speech_duration_ms,
        min_silence_duration_ms=min_silence_duration_ms,
        max_speech_duration_s=max_speech_duration_s,
        speech_pad_ms=speech_pad_ms,
    )
