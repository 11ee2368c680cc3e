"""Async engine facade: all device work happens off the event loop.

Port of the JAX package's ``ThreadedEngine`` (the reference ran its ASR
call on the asyncio loop, backend/transcription_manager.py:58, stalling
every session). Here every device call goes through one worker thread and
the serving layer only awaits: a stream's VAD windows queue behind its
decodes on that thread, as in JAX.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from sonicscribe_tpu_torch.engine.transcriber import Transcriber, TranscribeResult
from sonicscribe_tpu_torch.vad.model import WINDOW_SAMPLES


class ThreadedEngine:
    """Serializes device work on one worker thread; async interface."""

    def __init__(self, transcriber: Transcriber, vad):
        self.transcriber = transcriber
        self.vad = vad
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device")
        # reference parity: 3 concurrent file-segment decodes (main.py:429-430)
        self.concurrency_hint = 3

    @property
    def stats(self) -> dict:
        """Requests served and decode steps run (scalar counters: /health
        reports them)."""
        return dict(self.transcriber.stats)

    async def transcribe(
        self,
        audio: np.ndarray,
        sample_rate: int,
        max_new_tokens: int,
        hotwords: Optional[list[str]] = None,
        draft_tokens=None,  # accepted for the session's interface, as in JAX:
        # one sequential decode gains nothing from speculation
        speculative: bool = False,  # ditto (no k scheduling to protect)
    ) -> TranscribeResult:
        del draft_tokens, speculative
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool,
            lambda: self.transcriber.transcribe(
                audio, sample_rate, max_new_tokens=max_new_tokens, hotwords=hotwords
            ),
        )

    async def vad_window_prob(self, audio: np.ndarray, state) -> tuple[float, object]:
        """Max speech probability over the 512-sample sub-windows of one
        gate window, and the stream's VAD state after them (None: a fresh
        stream). Runs on the device thread."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, self._vad_window, audio, state)

    def _vad_window(self, audio: np.ndarray, state) -> tuple[float, object]:
        """The window's 512-sample sub-windows through the VAD's
        whole-window method (window_probs_state: for the energy gate one
        matmul on the device and the noise-floor recursion on the host, for
        Silero the front end of every sub-window in one pass and the cells
        in turn; JAX scans forward over the sub-windows in one program)."""
        n_win = max(1, len(audio) // WINDOW_SAMPLES)
        x = np.asarray(audio[: n_win * WINDOW_SAMPLES], np.float32).reshape(n_win, WINDOW_SAMPLES)
        probs, state = self.vad.window_probs_state(x, state)
        return float(probs.max()), state

    def warmup(self, budgets=(15, 200, 256)) -> None:
        self.transcriber.warmup(budgets=budgets)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
