"""The batcher's crash self-heal on the CPU, held to the JAX package's
BatchedEngine (tests/test_batcher.py TestStallAbort): a tick wedged past
tick_stall_abort_s crashes the scheduler and fails every caller, `alive`
turns False, start() refuses while the wedged tick still runs, and once it
drains the next request restarts the engine and gets the tokens it got
before the crash. Every wait is on a condition under a deadline."""

import asyncio
import time

import numpy as np
import pytest

from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine
from sonicscribe_tpu_torch.vad.model import EnergyVad
from test_torch_batcher import SR, _audio, _transcribers

WEDGE_S = 3.0  # the wedged tick's sleep, as in the JAX tests: ten times the 0.3 s abort


@pytest.fixture(scope="module")
def stack():
    return _transcribers()


def _pair(stack):
    tr_j, tr = stack
    kw = dict(slots=2, max_decode_tokens=16, n_streams=2)
    return (BatchedEngineJax(tr_j, EnergyVadJax(), **kw),
            BatchedEngine(tr, EnergyVad(device="cpu"), **kw))


async def until(cond, timeout: float = 20.0) -> bool:
    """Poll cond every 10 ms until it holds (True) or the deadline (False)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            return False
        await asyncio.sleep(0.01)
    return True


def _wedge(eng) -> None:
    eng.tick_stall_dump_s, eng.tick_stall_abort_s = 0.1, 0.3
    eng._tick = lambda *_a, **_k: time.sleep(WEDGE_S)


def test_wedged_tick_crashes_engine_and_fails_futures(stack):
    """The request fails with a RuntimeError instead of hanging, and the
    engine reports itself dead, on both engines."""
    audio = _audio(0.3, seed=7)

    async def go(eng):
        _wedge(eng)
        try:
            await asyncio.wait_for(eng.transcribe(audio, SR, max_new_tokens=4), timeout=10.0)
            return "completed", eng.alive
        except RuntimeError:
            dead = await until(lambda: not eng.alive)
            return "failed", not dead
        except asyncio.TimeoutError:
            return "hung", eng.alive
        finally:
            eng.shutdown()

    outcomes = [asyncio.run(go(eng)) for eng in _pair(stack)]
    assert outcomes[0] == outcomes[1] == ("failed", False), outcomes


def test_start_refuses_while_wedged_then_restarts(stack):
    """Two requests, one admitted and one still queued when the crash
    lands: both fail; start() raises while the wedged tick runs; after it
    drains, the tick restored and sane thresholds back, the next request
    restarts the scheduler, `alive` is True again, and its tokens are the
    ones the engine gave before the crash, the same on both engines."""
    audio = _audio(0.3, seed=7)

    async def go(eng):
        real_tick = eng._tick
        before = (await eng.transcribe(audio, SR, max_new_tokens=4)).tokens
        _wedge(eng)
        try:
            f1 = asyncio.ensure_future(eng.transcribe(audio, SR, max_new_tokens=4))
            assert await until(lambda: eng._tick_busy > 0)
            f2 = asyncio.ensure_future(eng.transcribe(audio, SR, max_new_tokens=4))
            r1, r2 = await asyncio.gather(asyncio.wait_for(f1, 15), asyncio.wait_for(f2, 15),
                                          return_exceptions=True)
            assert isinstance(r1, RuntimeError), r1
            assert isinstance(r2, RuntimeError), r2  # queued at the crash: failed too
            assert await until(lambda: not eng.alive)
            refused = None
            if eng._tick_busy:
                with pytest.raises(RuntimeError, match="still"):
                    await eng.start()
                refused = True
            assert await until(lambda: not eng._tick_busy)
            eng._tick = real_tick
            eng.tick_stall_dump_s, eng.tick_stall_abort_s = 60.0, 600.0
            after = (await eng.transcribe(audio, SR, max_new_tokens=4)).tokens
            return before, after, eng.alive, refused
        finally:
            eng.shutdown()

    (b_j, a_j, alive_j, _), (b, a, alive, refused) = [asyncio.run(go(e)) for e in _pair(stack)]
    assert alive_j and alive and refused
    np.testing.assert_array_equal(b, b_j)
    np.testing.assert_array_equal(a, a_j)
    np.testing.assert_array_equal(a, b)


def test_wedged_tick_resweeps_after_crash(stack):
    """A tick that outlives the crash and admits a request the sweep
    missed fails it on its way out (_run_tick_guarded's re-sweep), and the
    executor thread's own busy count drops to 0."""
    _, tr = stack
    eng = BatchedEngine(tr, EnergyVad(device="cpu"), slots=2, max_decode_tokens=16,
                        n_streams=2)
    audio = _audio(0.3, seed=7)

    async def go():
        orphan = asyncio.get_running_loop().create_future()

        def wedged(*a, **k):
            time.sleep(WEDGE_S)
            # the crash handler has swept by now: an admission it missed
            eng.long.slots[0].active = True
            eng.long.slots[0].request = type("Req", (), {"future": orphan})()

        eng.tick_stall_dump_s, eng.tick_stall_abort_s = 0.1, 0.3
        eng._tick = wedged
        try:
            with pytest.raises(RuntimeError):
                await asyncio.wait_for(eng.transcribe(audio, SR, max_new_tokens=4), 15)
            assert await until(orphan.done)
            assert await until(lambda: not eng._tick_busy)
            return orphan.exception(), eng.long.slots[0].active
        finally:
            eng.shutdown()

    exc, active = asyncio.run(go())
    assert isinstance(exc, RuntimeError) and "crashed" in str(exc) and not active
