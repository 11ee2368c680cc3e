"""Realtime streams in an open loop: the generator of the "streams" kind.

The port's ``tools/loadtest.py:run_load`` (copied here, so that the
yardstick stays as it is): ``streams`` ``StreamSession``s on the engine,
each fed a 64 ms chunk of its own audio on a fixed schedule whatever the
system does, all in one event loop. Each stream connects at its own drawn
offset (so that the streams' 640 ms gate windows do not all close on the
same chunk, as run_load's all do), then sends utterances and pauses drawn
as the mix says.

Mix parameters: streams, utterance_s {median, sigma, lo, hi}, pause_s
[lo, hi], start_offset_s (connects spread over it), settle_s, drain_s, tape_s.

Time is the schedule's: chunk c of a stream that connected at slot s is
due at t_start + (s + c) x 64 ms. The window is the chunks due from ``settle_s`` for the run's
seconds; the feed goes on for ``drain_s`` after it, so that results due
inside the window but returned after it still count. The harness's own
clock times every result from when the audio it answers was due:

- a tentative result: from its last chunk's due time to its arrival (how
  long a speaker waits for words to appear);
- a committed result: from the due time of the chunk that holds the last
  speech sample of its range (the harness knows where each utterance
  ends; a range holding no end, a part of a long final, takes its last
  chunk) to its arrival.

A result belongs to the window by that due time. How late the feed ran
(``ingest_lag_s``) is the largest delay of a chunk due in the window. A
traced run traces ``trace_s`` seconds of the drain, right after the window.
"""

from __future__ import annotations

import asyncio
import bisect
import time

import numpy as np

from gpubench.traffic import synth

KIND = "streams"
CHUNK_SAMPLES = 1024
CHUNK_BYTES = 2 * CHUNK_SAMPLES


def stream_audio(seed: int, i: int, mix: dict, total_s: float, tape: np.ndarray,
                 hush: np.ndarray) -> tuple[np.ndarray, list, float]:
    """-> (int16 samples of `total_s`, the sample index after each
    utterance's last sample, the seconds after the start at which the
    stream connects)."""
    draws = synth.Draws(np.random.default_rng([seed, 3, i]))
    connect = draws.uniform("connect", 0.0, mix["start_offset_s"])
    u = mix["utterance_s"]
    n_total = int(total_s * synth.SR)
    parts = []
    ends = []
    at = 0

    def pause(seconds):
        nonlocal at
        n = int(seconds * synth.SR)
        o = int(draws.next_u("offset") * (len(hush) - n))
        parts.append(hush[o : o + n])
        at += n

    pause(draws.uniform("pause", *mix["pause_s"]) / 2)
    while at < n_total:
        x = synth.take(tape, draws, draws.lognormal("utterance", u["median"], u["sigma"],
                                                     u["lo"], u["hi"]))
        parts.append(x)
        at += len(x)
        ends.append(at)
        pause(draws.uniform("pause", *mix["pause_s"]))
    pcm = synth.to_pcm16(np.concatenate(parts))[:n_total]
    return pcm, [e for e in ends if e <= n_total], connect


async def run(ctx) -> dict:
    from sonicscribe_tpu_torch.serve.session import StreamSession

    mix, conf, engine = ctx.mix, ctx.conf, ctx.engine
    period = conf.audio_chunk_duration_ms / 1000.0
    total_s = mix["settle_s"] + ctx.seconds + mix["drain_s"]
    rng = np.random.default_rng([ctx.seed, 1])
    tape = synth.speech_tape(rng, mix["tape_s"])
    hush = synth.noise(rng, mix["start_offset_s"] + 2 * mix["pause_s"][1] + 1.0)
    audio = [stream_audio(ctx.seed, i, mix, total_s, tape, hush) for i in range(mix["streams"])]
    pcm_bytes = [a[0].tobytes() for a in audio]

    events = []  # (arrival, stream, msg)
    sessions = []
    for i in range(mix["streams"]):
        async def send(msg, _i=i):
            if msg["type"] in ("tentative_output", "committed_output"):
                events.append((time.perf_counter(), _i, msg))

        sessions.append(StreamSession(f"bench{i}", conf, engine, send))
    rows = {s.stream_idx: i for i, s in enumerate(sessions) if s.stream_idx is not None}

    n_chunks = int(total_s / period)
    slot = [int(a[2] / period) for a in audio]  # the schedule slot each stream connects at
    c_open = int(round(mix["settle_s"] / period))
    c_close = c_open + int(round(ctx.seconds / period))
    trace_until = None
    errors = []
    lag = 0.0
    shift = 0.0  # how far the feed's pacing moved after the window (a trace's start)
    t_start = time.perf_counter()
    for c in range(n_chunks):
        target = t_start + shift + c * period
        now = time.perf_counter()
        if target > now:
            await asyncio.sleep(target - now)
        elif c_open <= c < c_close:
            lag = max(lag, now - target)
        if c == c_open:
            ctx.open_window()
        if c == c_close:
            ctx.close_window()
            if ctx.trace_s:
                t_hold = time.perf_counter()
                await ctx.start_trace()
                shift = time.perf_counter() - t_hold  # pace the drain from here on
                trace_until = time.perf_counter() + ctx.trace_s
        if trace_until is not None and time.perf_counter() >= trace_until:
            await ctx.stop_trace()
            trace_until = None
        with ctx.spans.span("feed"):
            for i, s in enumerate(sessions):
                if c < slot[i]:
                    continue
                off = (c - slot[i]) * CHUNK_BYTES
                frame = pcm_bytes[i][off : off + CHUNK_BYTES]
                if len(frame) == CHUNK_BYTES:
                    try:
                        await s.on_audio(frame)
                    except Exception as e:
                        errors.append((time.perf_counter(), repr(e)))
    if trace_until is not None:
        await ctx.stop_trace()
    ctx.stage("feed.done")
    for s in sessions:
        await s.cleanup()
    ctx.stage("sessions.closed")

    w0, w1 = t_start + c_open * period, t_start + c_close * period
    interim, commit = [], []
    for t, i, msg in events:
        first, last = msg["start_chunk_id"], msg["end_chunk_id"]
        t_zero = t_start + slot[i] * period  # when the stream's chunk 0 was due
        if msg["type"] == "tentative_output":
            due = t_zero + last * period
            if w0 <= due < w1:
                interim.append((t - due) * 1e3)
            continue
        ends = audio[i][1]
        j = bisect.bisect_right(ends, (last + 1) * CHUNK_SAMPLES) - 1
        if j >= 0 and ends[j] > first * CHUNK_SAMPLES:
            due = t_zero + ((ends[j] - 1) // CHUNK_SAMPLES) * period
        else:
            due = t_zero + last * period
        if w0 <= due < w1:
            commit.append((t - due) * 1e3)
    t_end = time.perf_counter()
    failed = [f for f in engine.sink["failed"] + errors if w0 <= f[0] <= t_end]
    done = [r for r in engine.sink["done"]
            if w0 <= r["t"] <= t_end and r["path"] == "ring" and r["stream"] in rows]
    candidates = []
    for r in done:
        i = rows[r["stream"]]
        lo = r["start_chunk"] * CHUNK_SAMPLES
        candidates.append(dict(r, pcm=audio[i][0][lo : lo + r["chunk_count"] * CHUNK_SAMPLES]))
    return {
        "attempted": len(interim) + len(commit) + len(failed),
        "failed": len(failed),
        "samples": {
            "interim_ms": interim + [float("inf")] * len(failed),
            "commit_ms": commit + [float("inf")] * len(failed),
            "ingest_lag_s": lag,
            "host_path_sessions": mix["streams"] - len(rows),
        },
        "work": [],
        "candidates": candidates,
    }
