"""Streaming VAD gate: the dynamic-threshold hysteresis state machine.

The port's copy of the JAX package's ``vad/gate.py``, an exact semantic
port of the reference's VADProcessorManager
(reference: backend/vad_processor_manager.py:42-182, documented SURVEY.md §2.1
B5 and §2.8):

- decisions every `process_window` chunks (10 x 64 ms = 640 ms);
- dynamic threshold: starts at 0.3; +0.1 on speech start; +0.03 per window
  while speech continues (i.e. while speech_count > 0 — including a silent
  window whose decayed speech_count is still positive,
  vad_processor_manager.py:142-151); reset to 0.3 on speech end; clamped
  [0.3, 0.9];
- hysteresis: speech/silence counters capped at `smoothing_window` (2), and
  the OPPOSING counter decays by 1 per window (`max(0, count-1)`,
  vad_processor_manager.py:110,114 — NOT reset to zero; identical end
  behavior at the default window of 2, divergent for >= 3);
  speech STARTS when speech_count >= 1, ENDS when silence_count >= 2;
- on start, the segment is backdated to the first chunk of the deciding
  window (vad_processor_manager.py:126-128).

The gate consumes a per-window speech probability computed by the engine
(``ThreadedEngine.vad_window_prob``); this class is pure-Python per-session
control flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class VadGateConfig:
    process_window: int = 10  # chunks per decision (640 ms)
    smoothing_window: int = 2
    base_threshold: float = 0.3
    max_threshold: float = 0.9
    start_boost: float = 0.1
    continue_boost: float = 0.03


@dataclass
class GateEvent:
    state_changed: bool = False
    speech_start_chunk: Optional[int] = None
    speech_end_chunk: Optional[int] = None
    # FIRST consecutive silent window while speaking: speech end will be
    # confirmed exactly one window later (silence_count >= 2) unless speech
    # resumes — the hook for eager (speculative-endpoint) finals: the
    # would-be final's audio [segment start .. maybe_end_chunk] is already
    # fully buffered, and the window after it is gate-certified silence.
    maybe_end_chunk: Optional[int] = None
    # speech continued after a maybe_end (silence_count reset before
    # reaching 2): any eager final launched for it must be discarded
    resumed: bool = False


@dataclass
class VadGate:
    cfg: VadGateConfig = field(default_factory=VadGateConfig)
    threshold: float = 0.0
    is_speaking: bool = False
    speech_count: int = 0
    silence_count: int = 0

    def __post_init__(self):
        self.threshold = self.cfg.base_threshold

    def update(
        self, window_prob: float, first_chunk_id: int, last_chunk_id: int
    ) -> GateEvent:
        """Feed one 640 ms window decision probability. Returns events."""
        cfg = self.cfg
        active = window_prob >= self.threshold
        ev = GateEvent()
        prev_silence = self.silence_count

        if active:
            self.speech_count = min(self.speech_count + 1, cfg.smoothing_window)
            # opposing counter DECAYS (max(0, n-1)), matching the reference
            # exactly (vad_processor_manager.py:110,114); a reset-to-zero
            # variant is end-identical at smoothing_window=2 but diverges
            # for >= 3, which /vad/config accepts
            self.silence_count = max(0, self.silence_count - 1)
            if self.is_speaking and prev_silence > 0:
                ev.resumed = True
        else:
            self.silence_count = min(self.silence_count + 1, cfg.smoothing_window)
            self.speech_count = max(0, self.speech_count - 1)
            if (
                self.is_speaking
                and prev_silence == 0
                and self.silence_count < cfg.smoothing_window
            ):
                ev.maybe_end_chunk = last_chunk_id

        if not self.is_speaking and self.speech_count >= 1:
            self.is_speaking = True
            ev.state_changed = True
            ev.speech_start_chunk = first_chunk_id  # backdate to window start
            self.threshold = min(
                self.threshold + cfg.start_boost, cfg.max_threshold
            )
        elif self.is_speaking and self.speech_count > 0:
            # continue-boost keyed to the decayed speech counter, not to the
            # instantaneous window: it keeps firing through a silent window
            # whose speech_count is still positive (reference :142-151)
            self.threshold = min(
                self.threshold + cfg.continue_boost, cfg.max_threshold
            )
        elif self.is_speaking and self.silence_count >= cfg.smoothing_window:
            self.is_speaking = False
            ev.state_changed = True
            ev.speech_end_chunk = last_chunk_id
            self.threshold = cfg.base_threshold

        return ev

    def reset(self) -> None:
        self.is_speaking = False
        self.speech_count = 0
        self.silence_count = 0
        self.threshold = self.cfg.base_threshold
