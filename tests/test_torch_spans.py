"""The batcher's spans and counters (engine/spans.py), on the CPU: the
scheduler's time split, the profiler ranges, the decode programs' device
time, row steps and emitted tokens, the ring requests' lead, and
``between_ticks``, on the benches' tiny f32 engine (EOS suppressed, so that
every request runs its budget)."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import drive_stepped
from sonicscribe_tpu_torch.config import AppConfig
from sonicscribe_tpu_torch.engine import spans as spans_module
from sonicscribe_tpu_torch.engine.spans import SCHED_PIECES, Spans, tick_phases
from sonicscribe_tpu_torch.serve.app import build_app
from sonicscribe_tpu_torch.tools.loadtest import bench_engine

SR = 16000


def _audio(seconds, seed):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
    return (x + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


def _speech(sec, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * sec)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    x = 0.25 * env * sum(np.sin(2 * np.pi * f * t) for f in (200, 700, 1500, 2600))
    return (x + 0.002 * rng.standard_normal(len(t))).astype(np.float32)


def _silence(sec, seed=1):
    return (0.0006 * np.random.default_rng(seed).standard_normal(int(SR * sec))).astype(
        np.float32)


@pytest.fixture(scope="module")
def engine():
    eng = bench_engine(True, "cpu", max_decode_tokens=32, n_streams=4)
    yield eng
    eng.shutdown()


async def _wave(eng, n=5, seed=0):
    budgets = [8, 24, 12, 32, 16, 20][:n]
    return await asyncio.gather(*[eng.transcribe(_audio(0.3 + 0.1 * i, seed + i), SR,
                                                 max_new_tokens=b)
                                  for i, b in enumerate(budgets)])


def _delta(eng, before, key):
    return eng.stats[key] - before.get(key, 0)


def test_scheduler_pieces_cover_its_wall_time():
    """sched.idle + sched.vad_gather + sched.capture + sched.loop + tick
    sum to 95-101% of the wall time of a run (two waves of requests with
    an idle pause between them), measured from the scheduler's start."""
    eng = bench_engine(True, "cpu", max_decode_tokens=32, n_streams=4)

    async def run():
        await eng.start()
        t0 = time.perf_counter()
        before = dict(eng.stats)
        await _wave(eng, seed=0)
        await asyncio.sleep(0.3)
        await _wave(eng, seed=10)
        t1 = time.perf_counter()
        eng.shutdown()
        return t1 - t0, {n: _delta(eng, before, "span_s." + n) for n in SCHED_PIECES}

    wall, pieces = asyncio.run(run())
    assert pieces["tick"] > 0 and pieces["sched.idle"] >= 0.25 and pieces["sched.loop"] > 0
    assert 0.95 <= sum(pieces.values()) / wall <= 1.01, (wall, pieces)


@pytest.mark.parametrize("fuse", [False, True])
def test_decode_tokens_are_the_served_tokens(fuse):
    """The tokens the decode programs' rows emitted are every served token
    but each request's first (the prefill's), no more than the rows the
    programs computed; each program's device time is counted once (a dual
    program once for both pools)."""
    eng = bench_engine(True, "cpu", max_decode_tokens=32, n_streams=4, fuse_dual_decode=fuse)

    async def run():
        try:
            await _wave(eng, n=6)
        finally:
            eng.shutdown()

    asyncio.run(run())
    st = eng.stats
    emitted = st["decode_tokens.short"] + st["decode_tokens.long"]
    assert st["requests"] == 6 and emitted == st["tokens"] - st["requests"] > 0
    for pool in ("short", "long"):
        assert 0 < st[f"decode_tokens.{pool}"] <= st[f"decode_row_steps.{pool}"]
    assert st["device_s.decode"] > 0
    if fuse:
        assert st["dual_decodes"] > 0 and st["device_steps.decode"] < st["decode_steps"]
    else:
        assert st["device_steps.decode"] == st["decode_steps"]


def test_profiler_ranges_carry_the_span_names(engine, monkeypatch):
    """A torch.profiler started and stopped on the device thread
    (between_ticks) holds the tick's spans as ranges of their names; with
    no profiler running, no range is entered."""
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)

    async def run():
        await _wave(engine, n=3, seed=20)
        quiet = len(entered)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        await engine.between_ticks(prof.start)
        await _wave(engine, n=3, seed=30)
        await engine.between_ticks(prof.stop)
        return quiet, prof

    quiet, prof = asyncio.run(run())
    assert quiet == 0
    names = {e.key for e in prof.key_averages()}
    for name in ("tick", "tick.admit", "tick.decode_dispatch", "admit.prep", "admit.write",
                 "admit.dispatch"):
        assert name in names, name
    assert set(entered) <= set(spans_module.SPAN_NAMES)


def test_between_ticks_never_overlaps_a_tick(engine):
    """fn runs on the device thread between two ticks: while the engine
    serves, no call of fn overlaps a tick span, and no tick is running."""
    calls, busy = [], []

    def fn():
        t0 = time.perf_counter()
        busy.append(engine._tick_busy)
        time.sleep(0.002)
        calls.append((t0, time.perf_counter()))
        return threading.get_ident()

    async def run():
        wave = asyncio.ensure_future(_wave(engine, n=6, seed=40))
        idents = set()
        while not wave.done():
            idents.add(await engine.between_ticks(fn))
            await asyncio.sleep(0.001)
        await wave
        return idents

    idents = asyncio.run(run())
    assert len(calls) >= 3 and busy == [0] * len(calls)
    assert threading.get_ident() not in idents
    ticks = [(a, b) for n, a, b, _, _ in engine.spans.records() if n == "tick"]
    for c0, c1 in calls:
        assert all(c1 <= a or b <= c0 for a, b in ticks), (c0, c1)


def test_a_lead_for_every_ring_interim():
    """Through a StreamSession on the ring path, every ring request (the
    interims on the short pool) carries its newest chunk's arrival: a lead
    (enqueue less that arrival, ms, not negative) beside its queue and run."""
    eng = bench_engine(True, "cpu", max_decode_tokens=64, n_streams=4)
    pcm = (np.clip(np.concatenate([_silence(0.7, 11), _speech(2.6, 12), _silence(2.0, 13)]),
                   -1, 1) * 32767).astype("<i2").tobytes()
    frames = [pcm[i : i + 2048].ljust(2048, b"\0") for i in range(0, len(pcm), 2048)]

    async def run():
        try:
            return await drive_stepped(AppConfig(), eng, frames)
        finally:
            eng.shutdown()

    msgs = asyncio.run(run())
    short = eng.stats["short_lat_ms"]
    interims = sum(m["type"] == "tentative_output" for m in msgs)
    assert interims > 0 and len(short["lead"]) == len(short["queue"]) >= interims
    assert min(short["lead"]) >= 0.0
    long = eng.stats.get("long_lat_ms", {"queue": [], "lead": []})
    assert len(long["lead"]) == len(long["queue"])


def test_tick_phases_rebuild_the_tick_records():
    """tick_phases reads the ring's records back into per-tick records: each tick's
    phases, syncs and admit split, with the other threads' spans between
    the ticks left out."""
    stats: dict = {}
    sp = Spans(stats)
    sp.add("sched.loop", 0.0, 1.0)
    sp.add("tick.admit", 1.0, 1.5, "tick")
    sp.add("admit.write", 1.1, 1.2, "tick.admit", "short")
    sp.add("admit.dispatch", 1.2, 1.4, "tick.admit", "short")
    sp.add("sync", 1.6, 1.7, "tick.resolve")
    sp.add("tick.resolve", 1.5, 1.8, "tick")
    sp.add("request.short", 0.2, 1.7, None, ("stream", 0, 0))
    sp.add("tick", 1.0, 2.0, None, (("short", 1), ("long", 0)))
    sp.add("sched.idle", 2.0, 3.0)
    sp.add("tick", 3.0, 3.5, None, (("short", 0), ("long", 0)))
    first, second = tick_phases(sp.records())
    assert first["total_ms"] == pytest.approx(1000.0)
    assert first["admit_ms"] == pytest.approx(500.0) and first["resolve_ms"] == pytest.approx(300.0)
    assert first["sync_ms"] == pytest.approx(100.0) and not first["early"]
    assert first["admit_detail"]["groups_short"] == 1
    assert first["admit_detail"]["dispatch_ms"] == pytest.approx(200.0)
    assert first["active"] == [("short", 1), ("long", 0)]
    assert second["admit_ms"] == 0.0 and second["total_ms"] == pytest.approx(500.0)
    assert stats["span_s.tick"] == pytest.approx(1.5) and stats["span_n.tick"] == 2
    assert stats["span_n.sync"] == 1 and stats["span_s.sched.idle"] == pytest.approx(1.0)


def test_the_ring_keeps_whole_ticks_and_counts_the_lost():
    """The ring holds the newest RING ticks, each with every record since
    the tick before it: past that, the oldest tick read back still has all
    its phases and waits, `lost` counts the ticks that fell off, and
    clear() forgets the records and the count but not the counters."""
    stats: dict = {}
    sp = Spans(stats)
    n = spans_module.RING + 5
    for _ in range(n):
        with sp.piece("tick"):
            for phase in spans_module.TICK_PHASES:
                with sp.span("tick." + phase):
                    with sp.span("sync"):
                        pass
        sp.add("request.short", 0.0, 1.0)
    assert sp.lost == 5 and len(sp.ring) == spans_module.RING
    records = sp.records()
    assert records[0][0] == "request.short" and records[-1][0] == "request.short"
    ticks = tick_phases(records)
    assert len(ticks) == spans_module.RING
    for t in ticks[:2] + ticks[-2:]:
        assert all(t[p + "_ms"] > 0 for p in spans_module.TICK_PHASES)
        assert t["sync_ms"] > 0
    assert sum(n == "sync" for n, *_ in records) == 6 * spans_module.RING
    sp.clear()
    assert sp.records() == [] and sp.lost == 0
    assert stats["span_n.tick"] == n and stats["span_n.sync"] == 6 * n


async def test_debug_profile_holds_the_tick_spans(engine, aiohttp_client, tmp_path):
    """/debug/profile on the batched engine starts and stops its profiler
    on the device thread: its trace holds the ticks' spans."""
    client = await aiohttp_client(build_app(AppConfig(), engine, engine.vad,
                                            {"engine": "batched"}))
    prof = asyncio.ensure_future(client.get("/debug/profile",
                                            params={"seconds": "1.0", "dir": str(tmp_path)}))
    await asyncio.sleep(0.2)
    await _wave(engine, n=3, seed=50)
    r = await prof
    assert r.status == 200
    trace = json.loads((tmp_path / (await r.json())["trace"].rsplit("/", 1)[-1]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"tick", "tick.decode_dispatch", "admit.dispatch"} <= names
    health = await (await client.get("/health")).json()
    assert health["engine_stats"]["span_n.tick"] > 0
    assert "device_s.decode" in health["engine_stats"]


def test_threads_keep_their_own_parents_and_counts():
    """Spans opened on many threads at once (more than the cores, a short
    switch interval): each span's parent is its own thread's open span, and
    every count and second is kept."""
    import sys

    stats: dict = {}
    sp = Spans(stats)
    n_threads, n_spans = 16, 300
    bad = []

    def work(i):
        for _ in range(n_spans):
            with sp.span(f"outer.{i}"):
                with sp.span(f"inner.{i}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for name, _, _, parent, _ in sp.records():
        i = name.split(".")[1]
        if name.startswith("inner.") and parent != f"outer.{i}":
            bad.append((name, parent))
    assert not bad
    for i in range(n_threads):
        assert stats[f"span_n.outer.{i}"] == stats[f"span_n.inner.{i}"] == n_spans
        assert stats[f"span_s.outer.{i}"] >= stats[f"span_s.inner.{i}"] > 0


def test_data_parallel_between_ticks_parks_the_other_replicas():
    """DataParallelEngine.between_ticks runs fn on the first replica's
    device thread while every other replica's device thread is held; the
    replicas' span seconds are summed in its stats."""
    from sonicscribe_tpu_torch.engine.replicas import DataParallelEngine
    from sonicscribe_tpu_torch.parallel.mesh import make_mesh
    from sonicscribe_tpu_torch.vad.model import EnergyVad

    tr = bench_engine(True, "cpu", max_decode_tokens=16, n_streams=4).transcriber
    eng = DataParallelEngine(tr, EnergyVad(device="cpu"), make_mesh(devices=["cpu"] * 3),
                             slots=3, max_decode_tokens=16, n_streams=6)

    def fn():
        # work sent to another replica's device thread now waits until fn is done
        probes = [r._device_thread().submit(time.perf_counter) for r in eng.replicas[1:]]
        time.sleep(0.05)
        held = [not p.done() for p in probes]
        return threading.current_thread().name, held

    async def run():
        try:
            await asyncio.gather(*[eng.transcribe(_audio(0.3, i), SR, max_new_tokens=8)
                                   for i in range(6)])
            return await eng.between_ticks(fn)
        finally:
            eng.shutdown()

    name, held = asyncio.run(run())
    assert name.startswith("batcher") and held == [True, True]
    assert eng.stats["span_s.tick"] == pytest.approx(
        sum(r.stats["span_s.tick"] for r in eng.replicas)) and eng.stats["span_n.tick"] > 0
