"""Async engine facade: all device work happens off the event loop.

Port of the JAX package's ``ThreadedEngine`` (the reference ran its ASR
call on the asyncio loop, backend/transcription_manager.py:58, stalling
every session). Here every device call goes through one worker thread and
the serving layer only awaits. The streaming path's ``vad_window_prob``
comes with the streaming slice.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from sonicscribe_tpu_torch.engine.transcriber import Transcriber, TranscribeResult


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
    ) -> TranscribeResult:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool,
            lambda: self.transcriber.transcribe(
                audio, sample_rate, max_new_tokens=max_new_tokens, hotwords=hotwords
            ),
        )

    def warmup(self, budgets=(15, 200, 256)) -> None:
        self.transcriber.warmup(budgets=budgets)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
