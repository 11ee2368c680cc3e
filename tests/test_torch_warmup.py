"""Warmup modes of the port's batcher on the CPU, held to the JAX package's
BatchedEngine (tests/test_warmup.py): the fast two-phase boot (which keys
wait, their order, the scheduler gated to registered programs until they
land, the idle ticks and warmup_join / drain_replays that register them)
and the full grid. On the CPU the port captures nothing: its deferred keys
queue and register as on the card, so the registered sets compare as they
are. The JAX engines are shared by the module (their compiles are the
cost); each test builds its own port engine. Every wait is on a condition
under a deadline."""

import asyncio
import threading
import time

import numpy as np
import pytest

from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.vad.model import EnergyVad
from test_torch_batcher import SR, _audio, _transcribers

KW = dict(slots=8, max_decode_tokens=16)  # the JAX tests' engine


@pytest.fixture(scope="module")
def stack():
    return _transcribers(buckets=(64,))


def _registered(eng) -> dict:
    return {p.name: {"host": set(p.compiled_prefill), "ring": set(p.compiled_ring_prefill),
                     "decode": set(p.compiled_decode), "verify": set(p.compiled_verify)}
            for p in eng.pools}


def _jax_deferred(thunks, eng) -> list[tuple]:
    """The JAX fast warmup's deferred programs, in its grid order, as
    (kind, pool, ...) from each thunk's default arguments."""
    out = []
    for thunk, _ in thunks:
        args = thunk.__defaults__[:-1]  # the last is lower_only
        pool = args[0].name
        if thunk.__name__ in ("host_prefill", "ring_prefill"):
            _, bucket, sb, B = args
            out.append(("prefill" if thunk.__name__ == "host_prefill" else "ring_prefill",
                        pool, bucket, B, sb))
        elif thunk.__code__.co_varnames[1] == "k":
            out.append(("decode", pool, args[1], args[2]))
        else:
            out.append(("verify", pool, eng.spec_w, args[1], args[2]))
    return out


def _jax_prio(key: tuple, eng) -> int:
    """The priority JAX's warmup gives a deferred program
    (sonicscribe_tpu/engine/batcher.py:1621-1626, :1666-1673, :1736-1740)."""
    kind, pool = key[0], key[1]
    short = pool == "short"
    if kind == "prefill":
        B, sb = key[3], key[4]
        return 2 if short or (B == 1 and sb == eng.suffix_buckets[0]) else 3
    if kind == "ring_prefill":
        cb, B = key[2], key[3]
        return (0 if short and cb == min(eng.chunk_buckets) else 1 if short
                else 2 if B == 1 else 3)
    if kind == "decode":
        k, rows = key[2], key[3]
        return 1 if short else 2 if rows is None and k <= eng.long_oversub_k_cap else 3
    return 3


@pytest.fixture(scope="module")
def jax_fast(stack):
    """A JAX engine after warmup(fast=True) with its background pass held
    back: the registered sets before it, its deferred programs, then the
    sets after warmup_join."""
    tr_j, _ = stack
    eng = BatchedEngineJax(tr_j, EnergyVadJax(), **KW)
    held = []
    real_thread = threading.Thread

    class Held(real_thread):
        def start(self):
            if self.name == "warmup-bg":
                held.append(self)
                return
            super().start()

    threading.Thread = Held
    try:
        eng.warmup(fast=True)
    finally:
        threading.Thread = real_thread
    before = _registered(eng)
    (bg,) = held
    cells = dict(zip(bg._target.__code__.co_freevars,
                     (c.cell_contents for c in bg._target.__closure__)))
    deferred = _jax_deferred(cells["deferred_thunks"], eng)
    real_thread.start(bg)
    eng.warmup_join(timeout=600)
    yield dict(engine=eng, before=before, deferred=deferred, after=_registered(eng))
    eng.shutdown()


def _port(stack, **kw) -> BatchedEngine:
    _, tr = stack
    return BatchedEngine(tr, EnergyVad(device="cpu"), **{**KW, **kw})


def _port_key(key: tuple) -> tuple:
    """A port program key as _jax_deferred writes it (no prefix length)."""
    return key[:-1] if key[0] in ("prefill", "ring_prefill") else key


async def until(cond, timeout: float = 30.0) -> bool:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            return False
        await asyncio.sleep(0.01)
    return True


def test_fast_warmup_defers_then_registers(stack, jax_fast):
    """fast=True registers JAX's critical subset and none of its deferred
    keys; a request served before they land gives the greedy tokens; after
    warmup_join + drain_replays the sets are JAX's after its background
    pass, and the tokens are the same again."""
    tr_j, tr = stack
    audio = _audio(0.4, seed=0)
    golden = tr_j.transcribe(audio, SR, max_new_tokens=8).tokens
    np.testing.assert_array_equal(tr.transcribe(audio, SR, max_new_tokens=8).tokens, golden)
    eng = _port(stack)
    try:
        w = eng.warmup(fast=True)
        assert _registered(eng) == jax_fast["before"]
        assert w["deferred"] == len(jax_fast["deferred"]) == eng.stats["warmup_replay_pending"]
        assert {k for k, r in eng.long.compiled_decode} == {1, 2, 4, 8}
        loop = asyncio.new_event_loop()
        try:
            r1 = loop.run_until_complete(eng.transcribe(audio, SR, max_new_tokens=8))
            eng.warmup_join(timeout=60)
            seconds = eng.drain_replays(timeout=60)
            assert seconds >= 0 and eng.stats["warmup_background_pending"] == 0
            assert eng.stats["warmup_replay_pending"] == 0
            assert eng.stats["warmup_capture_failures"] == 0
            assert _registered(eng) == jax_fast["after"]
            r2 = loop.run_until_complete(eng.transcribe(audio, SR, max_new_tokens=8))
        finally:
            loop.close()
        np.testing.assert_array_equal(r1.tokens, golden)
        np.testing.assert_array_equal(r2.tokens, golden)
    finally:
        eng.shutdown()


def test_fast_warmup_queue_is_jax_deferred_set_in_prio_order(stack, jax_fast):
    """The deferred queue holds exactly JAX's deferred programs, ordered by
    JAX's warmup priority, JAX's grid order within a priority."""
    eng = _port(stack)
    try:
        eng.warmup(fast=True)
        got = [_port_key(item.key) for item in eng._replay_queue]
        jax_eng = jax_fast["engine"]
        want = sorted(jax_fast["deferred"], key=lambda k: _jax_prio(k, jax_eng))
        assert got == want
        assert [item.prio for item in eng._replay_queue] == [_jax_prio(k, jax_eng) for k in want]
    finally:
        eng.shutdown()


def test_fast_warmup_b1_admission_before_deferred_keys(stack):
    """With the deferred keys held back, a wave of four long requests
    admits as four B = 1 groups (the group sizes are gated to registered
    programs) and decodes on full rows, with the greedy tokens."""
    tr_j, _ = stack
    audios = [_audio(0.4, f=250 + 40 * i, seed=i) for i in range(4)]
    golden = [tr_j.transcribe(a, SR, max_new_tokens=24).tokens for a in audios]
    eng = _port(stack, max_decode_tokens=32)
    try:
        eng.warmup(fast=True)
        eng._replay_queue.clear()  # no idle tick registers anything
        eng._note_deferred()

        async def go():
            rs = await asyncio.gather(*[eng.transcribe(a, SR, max_new_tokens=24)
                                        for a in audios])
            return [r.tokens for r in rs]

        got = asyncio.run(go())
        for g, w in zip(got, golden):
            np.testing.assert_array_equal(g, w)
        assert eng.stats["prefill_programs"] == 4 and eng.stats["prefills"] == 4
        assert all(rows is None for _, rows in eng.long.compiled_decode)
    finally:
        eng.shutdown()


def test_fast_warmup_pick_k_clamps_to_registered_rungs(stack, jax_fast):
    """Before the long pool's escalation rungs land, a quiet-window final
    that wants long_idle_k_cap gets the largest registered rung (JAX's
    registered full-rows ks); after they land, the escalation returns."""
    from types import SimpleNamespace

    eng = _port(stack, max_decode_tokens=200)
    try:
        eng.warmup(fast=True)
        ks0 = {k for k, r in eng.long.compiled_decode if r is None}
        assert ks0 == {k for k, r in jax_fast["before"]["long"]["decode"] if r is None}
        assert max(ks0) <= eng.long_live_k_cap
        assert eng.alloc_stream() is not None  # a live stream: the k caps apply
        slot = eng.long.slots[0]
        slot.active, slot.budget, slot.steps_seen = True, 200, 0
        slot.request = SimpleNamespace(speculative=False, stream_idx=None)
        eng._last_short_admit = time.perf_counter() - 10.0
        k = eng._pick_k(eng.long)
        assert (k, None) in eng.long.compiled_decode and k <= eng.long_live_k_cap
        eng.warmup_join(timeout=60)
        assert max(k for k, r in eng.long.compiled_decode if r is None) > eng.long_live_k_cap
        assert eng._pick_k(eng.long) == eng.long_idle_k_cap
        slot.active, slot.request = False, None
    finally:
        eng.shutdown()


def test_fast_warmup_idle_ticks_drain_the_queue(stack, jax_fast):
    """Served after a fast boot, the engine captures (here: registers) one
    deferred key per idle tick until none is left: the sets then are
    JAX's after its background pass."""
    tr_j, _ = stack
    audio = _audio(0.4, seed=0)
    golden = tr_j.transcribe(audio, SR, max_new_tokens=8).tokens
    eng = _port(stack)
    try:
        eng.warmup(fast=True)
        queued = len(eng._replay_queue)
        assert queued > 0

        async def go():
            r = await eng.transcribe(audio, SR, max_new_tokens=8)
            drained = await until(lambda: not eng._replay_queue and not eng._deferred_inflight)
            return r, drained

        r, drained = asyncio.run(go())
        np.testing.assert_array_equal(r.tokens, golden)
        assert drained, f"{len(eng._replay_queue)}/{queued} deferred keys still queued"
        assert _registered(eng) == jax_fast["after"]
        assert eng.stats["warmup_background_pending"] == 0
    finally:
        eng.shutdown()


def test_full_warmup_registers_jax_pairs(stack):
    """full=True registers every batch size of each pool: the JAX engine's
    full grid, pair for pair."""
    tr_j, _ = stack
    kw = dict(slots=4, max_decode_tokens=16, n_streams=4)
    eng_j = BatchedEngineJax(tr_j, EnergyVadJax(), **kw)
    eng = _port(stack, **kw)
    try:
        eng_j.warmup(full=True)
        eng.warmup(full=True)
        assert _registered(eng) == _registered(eng_j)
        assert {b for _, _, b in eng.long.compiled_prefill} == {1, 2, 4}
    finally:
        eng_j.shutdown()
        eng.shutdown()
