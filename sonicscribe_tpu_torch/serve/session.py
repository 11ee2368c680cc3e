"""Per-WebSocket-connection streaming session.

The port's copy of the JAX package's ``serve/session.py`` (the reference's
ConnectionManager + VADProcessorManager + TranscriptionManager object graph,
backend/connection_manager.py, vad_processor_manager.py,
transcription_manager.py), event-driven as there:

- VAD windows are processed as chunks arrive (no 64 ms polling task);
- all device work is awaited through the async engine (never blocks the loop);
- WS hotwords are actually wired into transcription (the reference stored but
  never used them — main.py:910, SURVEY.md §3.4);
- interim cadence >= 1 s while speaking, final on gate speech-end, long finals
  split into `_part_i` sub-segments (connection_manager.py:204-242 semantics).

The device-ring branches (``stream_idx``, ``engine.ingest``,
``vad_window_ring``, ``transcribe_ring``, ``free_stream``) are the JAX
continuous batcher's; they stay inert on ``ThreadedEngine``, which has no
``has_ring``. No module imported here imports aiohttp.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Optional

import numpy as np

from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.native import rms_peak
from sonicscribe_tpu_torch.stream.buffer import ChunkBuffer, SpeechSegment
from sonicscribe_tpu_torch.vad.gate import VadGate, VadGateConfig

logger = logging.getLogger(__name__)

SendFn = Callable[[dict], Awaitable[None]]
# chunk arrivals kept (by chunk id modulo this): ~33 s of 64 ms chunks
_ARRIVALS = 512


class StreamSession:
    def __init__(
        self,
        client_id: str,
        config: AppConfig,
        engine,
        send: SendFn,
        clock=time.monotonic,
    ):
        self.client_id = client_id
        self.config = config
        self.engine = engine
        self.send = send
        self.clock = clock

        self.buffer = ChunkBuffer(
            chunk_duration_ms=config.audio_chunk_duration_ms,
            max_buffer_seconds=config.max_audio_buffer_seconds,
            max_segments=config.max_speech_segments,
            interim_chunks=config.temporary_transcription_interval,
            clock=clock,
        )
        self.gate = VadGate(
            VadGateConfig(
                process_window=config.vad_process_window,
                smoothing_window=config.vad_smoothing_window,
                base_threshold=config.vad_dynamic_base_threshold,
                max_threshold=config.vad_dynamic_max_threshold,
                start_boost=config.vad_dynamic_start_boost,
                continue_boost=config.vad_dynamic_continue_boost,
            )
        )
        self.vad_enabled = True
        self.hotwords: list[str] = []
        self.vad_state = None  # device VAD model state (non-ring engines)
        # device audio-ring stream slot (BatchedEngine): audio is shipped to
        # the device once per chunk (packed across sessions) and every VAD
        # window / interim / final is sliced on device — no re-uploads
        self.stream_idx = None
        if getattr(engine, "has_ring", False):
            self.stream_idx = engine.alloc_stream()
        self._window_chunks: list[int] = []  # chunk ids awaiting a VAD decision
        # (chunk id, time.perf_counter() at its arrival) by id modulo
        # _ARRIVALS: a ring request's t_arrival is its newest chunk's
        self._arrivals: list[tuple[int, float]] = [(-1, 0.0)] * _ARRIVALS
        self._last_interim_t = 0.0
        self._saved_interim_text = ""
        self._last_interim_current = ""
        self._last_interim_start: Optional[int] = None
        # speculative-finals draft: interim TOKENS banked alongside the text
        # (same window-slide semantics); the final's decode verifies them
        # losslessly (engine verify path, test_spec_decode.py)
        self._draft_banked: list = []
        self._last_interim_tokens = None
        # eager (speculative-endpoint) final: (task, start_chunk, end_chunk)
        # launched at the gate's FIRST silent window — speech end confirms
        # exactly one window later, so the confirmed commit usually finds
        # this decode already done (config.eager_finals)
        self._eager: Optional[tuple] = None
        self._decode_lock = asyncio.Lock()
        self._tasks: set[asyncio.Task] = set()
        # VAD windows are processed by a per-session worker task so that
        # ingest never blocks on the device (and, on the JAX batcher, windows
        # of many sessions batch into one program)
        self._vad_queue: asyncio.Queue = asyncio.Queue()
        self._vad_worker_task: Optional[asyncio.Task] = None
        self.active = True

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    async def on_audio(self, data: bytes) -> None:
        """One size-repaired 2048-byte frame."""
        chunk = self.buffer.add_chunk(data)
        if self.stream_idx is not None:
            self._arrivals[chunk.chunk_id % _ARRIVALS] = (chunk.chunk_id, time.perf_counter())
            self.engine.ingest(self.stream_idx, chunk.chunk_id, data)
        # per-chunk RMS/peak telemetry (reference main.py:687-699), sampled
        if logger.isEnabledFor(logging.DEBUG) and chunk.chunk_id % 100 == 0:
            rms, peak = rms_peak(data)
            logger.debug(
                "[%s] chunk %d rms=%.4f peak=%.4f",
                self.client_id, chunk.chunk_id, rms, peak,
            )
        self._window_chunks.append(chunk.chunk_id)
        if len(self._window_chunks) >= self.config.vad_process_window:
            window_ids = self._window_chunks[: self.config.vad_process_window]
            self._window_chunks = self._window_chunks[self.config.vad_process_window :]
            self._vad_queue.put_nowait(window_ids)
            if self._vad_worker_task is None or self._vad_worker_task.done():
                self._vad_worker_task = asyncio.ensure_future(self._vad_worker())

    async def _vad_worker(self) -> None:
        """Processes this session's VAD windows in order, off the ingest path."""
        while self.active:
            try:
                window_ids = await self._vad_queue.get()
            except (asyncio.CancelledError, RuntimeError):
                return
            try:
                await self._process_vad_window(window_ids)
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("[%s] vad window failed", self.client_id)

    async def _process_vad_window(self, window_ids: list[int]) -> None:
        first, last = window_ids[0], window_ids[-1]
        if not self.vad_enabled:
            # VAD off: treat everything as one rolling speech segment
            if self.buffer.current_segment is None:
                self.buffer.start_segment(first)
            await self._maybe_interim()
            return

        if self.stream_idx is not None:
            prob = await self.engine.vad_window_ring(self.stream_idx, first)
        else:
            audio = self.buffer.audio_in_range(first, last)
            prob, self.vad_state = await self.engine.vad_window_prob(
                audio, self.vad_state
            )
        ev = self.gate.update(prob, first, last)

        if ev.state_changed and ev.speech_start_chunk is not None:
            self._cancel_eager()  # stale speculation from a prior segment
            self.buffer.start_segment(ev.speech_start_chunk)
            self._saved_interim_text = ""
            self._last_interim_current = ""
            self._last_interim_start = None
            # re-anchor the interim cadence at speech start, plus a
            # per-stream phase from the engine where it has one (the JAX
            # batcher's, against lockstep interim waves; 0 here)
            self._last_interim_t = self.clock() + self._interim_stagger()
            self._draft_banked = []
            self._last_interim_tokens = None
        elif ev.state_changed and ev.speech_end_chunk is not None:
            seg = self.buffer.finalize_segment(ev.speech_end_chunk)
            if seg is not None:
                self._spawn(self._commit_segment(seg))
        elif self.gate.is_speaking:
            if ev.resumed:
                # speech continued after one silent window: the speculation
                # lost its bet — discard before the next interim fires and
                # feed the engine's adaptive launch gate
                if self._cancel_eager():
                    self._report_eager(False)
            launched = False
            if ev.maybe_end_chunk is not None and self.config.eager_finals:
                # first silent window: the segment's audio is complete up to
                # here (the window itself is below threshold). Start the
                # final decode now instead of an interim over trailing
                # silence; confirmation (or a resume) arrives next window.
                launched = self._start_eager(ev.maybe_end_chunk)
            if not launched:
                await self._maybe_interim()

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # ------------------------------------------------------------------
    # interim ("tentative") path
    # ------------------------------------------------------------------

    def _interim_stagger(self) -> float:
        """Per-stream cadence phase from the engine (0.0 when absent or the
        cohort is small) — de-synchronizes lockstep interim waves."""
        st = getattr(self.engine, "interim_stagger", None)
        return st(self.stream_idx) if st is not None else 0.0

    async def _maybe_interim(self) -> None:
        now = self.clock()
        if now - self._last_interim_t < 1.0:
            return
        window = self.buffer.interim_audio()
        if window is None:
            return
        self._last_interim_t = now
        self._spawn(self._run_interim(*window))

    async def _transcribe_range(
        self, audio, start_id: int, end_id: int, max_new_tokens: int,
        draft_tokens=None, speculative: bool = False,
    ):
        """Dispatch to the zero-upload ring path when available."""
        extra = {"draft_tokens": draft_tokens} if draft_tokens is not None else {}
        if speculative:
            # unconfirmed eager final: the engine denies it quiet-window
            # k-escalation until confirm_speculative() promotes it
            extra["speculative"] = True
        if self.stream_idx is not None:
            seen, t = self._arrivals[end_id % _ARRIVALS]
            if seen == end_id:
                extra["t_arrival"] = t
            return await self.engine.transcribe_ring(
                self.stream_idx,
                start_id,
                end_id - start_id + 1,
                max_new_tokens,
                hotwords=self.hotwords or None,
                duration_s=(end_id - start_id + 1)
                * self.config.audio_chunk_duration_ms / 1000.0,
                **extra,
            )
        return await self.engine.transcribe(
            audio,
            self.config.audio_sample_rate,
            max_new_tokens=max_new_tokens,
            hotwords=self.hotwords or None,
            **extra,
        )

    def _segment_draft(self):
        """Banked + current interim tokens for the open segment — the
        speculative draft for its final decode. The interim windows covered
        the same audio with the same model, so with real weights the
        final's greedy output largely re-derives this sequence; the verify
        path accepts matching spans w tokens per weights-read and rejects
        the rest at zero quality cost (lossless)."""
        if not self.config.speculative_finals:
            return None
        parts = list(self._draft_banked)
        if self._last_interim_tokens is not None:
            parts.append(self._last_interim_tokens)
        if not parts:
            return None
        d = np.concatenate([np.asarray(p, np.int32) for p in parts])
        return d if len(d) > 1 else None

    async def _run_interim(self, audio, start_id: int, end_id: int) -> None:
        if self._decode_lock.locked():
            return  # drop interim if a decode is already in flight
        async with self._decode_lock:
            t0 = time.monotonic()  # wall time: processing_delay is a latency
            # speculative interims: when the window START is unchanged, this
            # decode's audio is a superset of the previous interim's, so its
            # greedy output usually re-derives the previous tokens as a
            # prefix — pass them as the verify draft (lossless; the engine's
            # acceptance gate prices divergent workloads)
            draft = None
            if (
                self.config.speculative_interims
                and self._last_interim_start == start_id
                and self._last_interim_tokens is not None
                and len(self._last_interim_tokens) > 1
            ):
                draft = self._last_interim_tokens
            try:
                result = await self._transcribe_range(
                    audio, start_id, end_id,
                    self.config.interim_max_new_tokens,
                    draft_tokens=draft,
                )
            except Exception:
                logger.exception("[%s] interim decode failed", self.client_id)
                return
            # cumulative text semantics (reference connection_manager.py:146-153):
            # when the interim window slides past the previous one, bank its text
            if (
                self._last_interim_start is not None
                and start_id > self._last_interim_start
            ):
                self._saved_interim_text += self._last_interim_current
                if self._last_interim_tokens is not None:
                    self._draft_banked.append(self._last_interim_tokens)
            self._last_interim_start = start_id
            self._last_interim_current = result.text
            self._last_interim_tokens = result.tokens
            if not self.active:
                return
            await self.send(
                {
                    "type": "tentative_output",
                    "current_text": result.text,
                    "text": self._saved_interim_text + result.text,
                    "start_chunk_id": start_id,
                    "end_chunk_id": end_id,
                    "duration": (end_id - start_id + 1)
                    * self.config.audio_chunk_duration_ms
                    / 1000.0,
                    "confidence": "tentative",
                    "processing_delay": time.monotonic() - t0,
                }
            )

    # ------------------------------------------------------------------
    # final ("committed") path
    # ------------------------------------------------------------------

    def _start_eager(self, end_chunk: int) -> bool:
        """Launch the speculative final for the open segment at the gate's
        first silent window (config.eager_finals). The engine's launch gate
        (capacity slack + measured bet-confirmation rate) keeps discarded
        speculation from displacing confirmed work. Returns whether a
        launch happened — the caller falls back to the interim cadence
        when it did not."""
        if self._eager is not None:
            return True
        seg = self.buffer.current_segment
        if seg is None:
            return False
        start = seg.start_chunk_id
        chunk_s = self.config.audio_chunk_duration_ms / 1000.0
        duration = (end_chunk - start + 1) * chunk_s
        # long segments take the _part_i split path at confirmation — the
        # single-decode speculation would be discarded there, so skip it
        if duration > self.config.max_segment_duration:
            return False
        ok = getattr(self.engine, "eager_ok", None)
        # the gate of the engine (the replica, behind a data-parallel
        # router) that owns this session's ring row
        if callable(ok) and not ok(self.stream_idx):
            return False
        task = asyncio.ensure_future(self._run_eager_final(start, end_chunk))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        self._eager = (task, start, end_chunk)
        return True

    async def _run_eager_final(self, start_id: int, end_id: int):
        async with self._decode_lock:
            chunk_s = self.config.audio_chunk_duration_ms / 1000.0
            duration = (end_id - start_id + 1) * chunk_s
            audio = self.buffer.audio_in_range(start_id, end_id)
            return await self._transcribe_range(
                audio, start_id, end_id,
                self.config.final_token_budget(duration),
                draft_tokens=self._segment_draft(),
                speculative=True,
            )

    def _cancel_eager(self) -> bool:
        """-> whether a live speculation was discarded (a lost bet when
        called from the resume path; callers there report it to the
        engine's launch gate)."""
        if self._eager is None:
            return False
        task, _, _ = self._eager
        self._eager = None
        task.cancel()
        return True

    def _report_eager(self, confirmed: bool) -> None:
        report = getattr(self.engine, "eager_outcome", None)
        if callable(report):
            report(confirmed, self.stream_idx)

    async def _commit_segment(self, seg: SpeechSegment) -> None:
        t0 = time.monotonic()  # speech-end -> committed_output latency
        # consume the speculative final if one is in flight for this segment:
        # it was launched one gate window before this confirmation, over the
        # same audio minus the trailing gate-certified-silent window
        eager, self._eager = self._eager, None
        if eager is not None:
            task, e_start, _ = eager
            audio, start_id, end_id = self.buffer.committed_audio(seg)
            duration = len(audio) / self.config.audio_sample_rate
            if (
                e_start == start_id
                and duration <= self.config.max_segment_duration
            ):
                # the bet is confirmed: promote the in-flight decode so the
                # engine may k-escalate its remaining steps during quiet
                promote = getattr(self.engine, "confirm_speculative", None)
                if callable(promote) and self.stream_idx is not None:
                    promote(self.stream_idx)
                try:
                    result = await task
                except asyncio.CancelledError:
                    result = None
                except Exception:
                    logger.exception(
                        "[%s] eager final failed; falling back", self.client_id
                    )
                    result = None
                if result is not None:
                    self._report_eager(True)
                    seg.transcript = result.text
                    await self._send_committed(
                        str(seg.segment_id), result.text, start_id, end_id,
                        seg.start_time, seg.end_time, t0,
                    )
                    return
            else:
                # launched but unusable at commit (range/duration mismatch):
                # a wasted decode, priced like a lost bet
                task.cancel()
                self._report_eager(False)
        async with self._decode_lock:
            audio, start_id, end_id = self.buffer.committed_audio(seg)
            duration = len(audio) / self.config.audio_sample_rate
            max_d = self.config.max_segment_duration
            chunk_s = self.config.audio_chunk_duration_ms / 1000.0
            try:
                if duration <= max_d:
                    result = await self._transcribe_range(
                        audio, start_id, end_id,
                        self.config.final_token_budget(duration),
                        draft_tokens=self._segment_draft(),
                    )
                    seg.transcript = result.text
                    await self._send_committed(
                        str(seg.segment_id), result.text, start_id, end_id,
                        seg.start_time, seg.end_time, t0,
                    )
                else:
                    # split long finals into chunk-aligned _part_i sub-segments
                    # (reference connection_manager.py:204-242)
                    n_parts = int(duration // max_d) + (1 if duration % max_d else 0)
                    total_chunks = end_id - start_id + 1
                    chunks_per = max(1, total_chunks // n_parts)
                    spc = self.config.samples_per_chunk
                    for i in range(n_parts):
                        c_lo = start_id + i * chunks_per
                        c_hi = end_id if i == n_parts - 1 else c_lo + chunks_per - 1
                        lo = (c_lo - start_id) * spc
                        hi = min(len(audio), (c_hi - start_id + 1) * spc)
                        part = await self._transcribe_range(
                            audio[lo:hi], c_lo, c_hi,
                            self.config.final_token_budget(
                                (c_hi - c_lo + 1) * chunk_s
                            ),
                        )
                        await self._send_committed(
                            f"{seg.segment_id}_part_{i}",
                            part.text,
                            c_lo,
                            c_hi,
                            c_lo * chunk_s,
                            (c_hi + 1) * chunk_s,
                            t0,
                        )
            except Exception:
                logger.exception("[%s] committed decode failed", self.client_id)

    async def _send_committed(
        self, segment_id, text, start_id, end_id, start_time, end_time,
        t_start: float | None = None,
    ) -> None:
        if not self.active:
            return
        await self.send(
            {
                "type": "committed_output",
                "text": text,
                "segment_id": segment_id,
                "start_chunk_id": start_id,
                "end_chunk_id": end_id,
                "start_time": start_time,
                "end_time": end_time,
                "confidence": "high",
                # additive vs the reference schema (which timed only
                # tentatives): speech-end -> committed latency
                "processing_delay": (
                    time.monotonic() - t_start if t_start is not None else None
                ),
            }
        )

    # ------------------------------------------------------------------
    # state / lifecycle
    # ------------------------------------------------------------------

    def state_snapshot(self) -> dict:
        """For the `get_state` WS message (reference main.py:864-880)."""
        return {
            "type": "connection_state",
            "client_id": self.client_id,
            "is_speaking": self.gate.is_speaking,
            "vad_enabled": self.vad_enabled,
            "vad_threshold": self.gate.threshold,
            "buffered_chunks": self.buffer.chunk_count(),
            "newest_chunk_id": self.buffer.newest_chunk_id,
            "segments": len(self.buffer.segments),
            "hotwords": list(self.hotwords),
        }

    async def flush(self) -> None:
        """Finalize an open segment and drain in-flight decodes (on close)."""
        try:
            await asyncio.wait_for(self.flush_vad(), timeout=5.0)
        except asyncio.TimeoutError:
            pass
        if self.buffer.current_segment is not None:
            seg = self.buffer.finalize_segment(self.buffer.newest_chunk_id)
            if seg is not None:
                await self._commit_segment(seg)
        # a commit spawned by the gate moments before the close is still
        # decoding in a background task; cleanup() CANCELS those tasks, so
        # wait for them here or the client's last final is silently dropped
        # (found by driving the live server: close right after speech-end)
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def flush_vad(self) -> None:
        """Wait for queued VAD windows to be processed (used by flush/tests)."""
        while not self._vad_queue.empty():
            await asyncio.sleep(0.01)

    async def cleanup(self) -> None:
        self.active = False
        if self.stream_idx is not None:
            self.engine.free_stream(self.stream_idx)
            self.stream_idx = None
        if self._vad_worker_task is not None:
            self._vad_worker_task.cancel()
            self._vad_worker_task = None
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
