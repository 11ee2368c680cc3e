"""The eager-finals launch gate of the port's BatchedEngine against the JAX
package's, side by side: each case of the JAX package's
TestAdaptiveEagerGate (tests/test_eager_finals.py) drives both engines
through the same sequence of states and bet outcomes, and records every
eager_ok decision, every _pick_k value and every flag it reads. The two
records must be equal, and the port's must show what the JAX case asserts.
"""

import asyncio
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sonicscribe_tpu.engine.batcher import BatchedEngine as BatchedEngineJax
from sonicscribe_tpu.engine.batcher import _RingTranscribeReq as RingReqJax
from sonicscribe_tpu.engine.transcriber import Transcriber as TranscriberJax
from sonicscribe_tpu.models import tiny as tiny_jax
from sonicscribe_tpu.models.glm_asr import init_params
from sonicscribe_tpu.models.tokenizer import ByteTokenizer as ByteTokenizerJax
from sonicscribe_tpu.vad.model import EnergyVad as EnergyVadJax
from sonicscribe_tpu_torch.engine.batcher import BatchedEngine, _RingTranscribeReq
from sonicscribe_tpu_torch.engine.transcriber import Transcriber
from sonicscribe_tpu_torch.models import tiny
from sonicscribe_tpu_torch.models.tokenizer import ByteTokenizer
from sonicscribe_tpu_torch.models.weights import params_from_jax
from sonicscribe_tpu_torch.vad.model import EnergyVad


@pytest.fixture(scope="module")
def transcribers():
    params_j = init_params(tiny_jax(), jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    return (TranscriberJax(tiny_jax(), params_j, ByteTokenizerJax(tiny_jax()),
                           prefill_buckets=(64,)),
            Transcriber(tiny(), params, ByteTokenizer(tiny()), prefill_buckets=(64,)))


def _budget(eng) -> float:
    """The interim admission-wait budget (its name differs by package)."""
    return eng.eager_queue_budget_ms if isinstance(eng, BatchedEngineJax) \
        else eng.short_queue_budget_ms


def _ring_req(eng):
    return RingReqJax if isinstance(eng, BatchedEngineJax) else _RingTranscribeReq


def _prove_slack(eng):
    """Clear the congestion EMA as a run of healthy interim waves would."""
    eng.short_queue_ema = 0.0


def closes_on_lost_bets_probes_and_reopens(eng, rec):
    eng.eager_window_s = 0.0  # fold every outcome
    rec("fresh engine", eng.eager_ok())  # closed until slack is proven
    _prove_slack(eng)
    rec("slack", eng.eager_ok())
    for _ in range(10):
        eng.eager_outcome(False)
    rec("after 10 lost bets: ema < min", eng.eager_accept_ema < eng.eager_accept_min)
    rec("16 candidates (probes)", [eng.eager_ok() for _ in range(16)])
    for _ in range(10):
        eng.eager_outcome(True)
    rec("after 10 confirmed: ema >= min", eng.eager_accept_ema >= eng.eager_accept_min)
    rec("4 candidates", [eng.eager_ok() for _ in range(4)])
    rec("ema", round(eng.eager_accept_ema, 9))


def speculative_escalation_confidence_priced(eng, rec):
    idx = eng.alloc_stream()  # a live stream: the caps apply
    slot = eng.long.slots[0]
    slot.active, slot.budget, slot.steps_seen = True, 200, 0
    slot.request = SimpleNamespace(speculative=True, stream_idx=idx)
    eng._last_short_admit = time.perf_counter() - 10.0  # the short class quiet
    rec("quiet", eng._short_quiet())
    rec("k, healthy ema", eng._pick_k(eng.long))
    eng.eager_accept_ema = 0.0
    rec("k, collapsed ema", eng._pick_k(eng.long))
    eng.confirm_speculative(idx)
    rec("promoted", slot.request.speculative)
    rec("k, promoted", eng._pick_k(eng.long))
    eng._last_short_admit = time.perf_counter()  # interim traffic again
    rec("k, interims live", eng._pick_k(eng.long))
    rec("caps", (eng.long_idle_k_cap, eng.long_live_k_cap))
    slot.active, slot.request = False, None


def confirm_speculative_reaches_queued_requests(eng, rec):
    idx = eng.alloc_stream()
    loop = asyncio.new_event_loop()
    try:
        cls = _ring_req(eng)
        queued = cls(idx, 0, 10, 32, None, 0.64, loop.create_future(), 0.0, speculative=True)
        backlogged = cls(idx, 10, 10, 32, None, 0.64, loop.create_future(), 0.0,
                         speculative=True)
        other = cls(idx + 1, 0, 10, 32, None, 0.64, loop.create_future(), 0.0,
                    speculative=True)
        eng._ring_requests.put_nowait(queued)
        eng._ring_requests.put_nowait(other)
        eng._ring_backlog.append(backlogged)
        eng.confirm_speculative(idx)
        rec("queued, backlogged, another stream's",
            (queued.speculative, backlogged.speculative, other.speculative))
        eng._ring_backlog.clear()
    finally:
        loop.close()


def synchronized_confirmation_wave_counts_once(eng, rec):
    eng.eager_window_s = 0.0
    for _ in range(10):
        eng.eager_outcome(False)
    rec("closed", eng.eager_accept_ema < eng.eager_accept_min)
    eng.eager_window_s = 0.64
    eng._eager_fold_t -= 1.0  # the window elapsed before the wave
    for _ in range(50):
        eng.eager_outcome(True)
    rec("one fold: still closed", eng.eager_accept_ema < eng.eager_accept_min)
    rec("buffered", len(eng._eager_pending))
    rec("ema", round(eng.eager_accept_ema, 9))


def congestion_closes_gate(eng, rec):
    rec("starts above budget", eng.short_queue_ema > _budget(eng))
    rec("fresh", eng.eager_ok())
    _prove_slack(eng)
    rec("slack", eng.eager_ok())
    eng.short_queue_ema = _budget(eng) + 1.0
    rec("over budget", eng.eager_ok())
    _prove_slack(eng)
    eng._note_short_queue(20 * _budget(eng))
    rec("one congested reap", (eng.eager_ok(), eng.short_queue_ema))


def backlog_and_spec_cap_close_gate(eng, rec):
    _prove_slack(eng)
    rec("open", eng.eager_ok())
    eng._ring_backlog.append(SimpleNamespace(speculative=False))
    rec("final backlog", eng.eager_ok())
    eng._ring_backlog.clear()
    n_cap = max(1, len(eng.long.slots) // 2)
    for s in eng.long.slots[: n_cap - 1]:
        s.active, s.request = True, SimpleNamespace(speculative=True)
    rec("one below the speculative cap", eng.eager_ok())
    eng.long.slots[n_cap - 1].active = True
    eng.long.slots[n_cap - 1].request = SimpleNamespace(speculative=True)
    rec("at the cap", eng.eager_ok())
    for s in eng.long.slots:
        s.active, s.request = False, None


def stream_oversubscription_closes_gate(eng, rec):
    _prove_slack(eng)
    rec("open", eng.eager_ok())
    claimed = [eng.alloc_stream() for _ in range(len(eng.long.slots) + 1)]
    rec("streams > long slots", eng.eager_ok())
    eng.free_stream(claimed.pop())
    rec("streams == long slots", eng.eager_ok())
    for i in claimed:
        eng.free_stream(i)


def capacity_trumps_accept_rate(eng, rec):
    _prove_slack(eng)
    for n_busy in range(len(eng.long.slots) + 1):
        for i, s in enumerate(eng.long.slots):
            s.active = i < n_busy
        rec(f"{n_busy} slots busy", eng.eager_ok())
    for s in eng.long.slots:
        s.active = False


CASES = {f.__name__: f for f in (
    closes_on_lost_bets_probes_and_reopens, speculative_escalation_confidence_priced,
    confirm_speculative_reaches_queued_requests, synchronized_confirmation_wave_counts_once,
    congestion_closes_gate, backlog_and_spec_cap_close_gate,
    stream_oversubscription_closes_gate, capacity_trumps_accept_rate)}

# what the JAX package's own cases assert, on the port's record
EXPECT = {
    "closes_on_lost_bets_probes_and_reopens": lambda r: (
        r["fresh engine"] is False and r["slack"] is True
        and r["after 10 lost bets: ema < min"] and sum(r["16 candidates (probes)"]) == 2
        and r["after 10 confirmed: ema >= min"] and all(r["4 candidates"])),
    "speculative_escalation_confidence_priced": lambda r: (
        r["quiet"] and r["k, healthy ema"] == r["caps"][0]
        and r["k, collapsed ema"] <= r["caps"][1] and r["promoted"] is False
        and r["k, promoted"] == r["caps"][0] and r["k, interims live"] <= r["caps"][1]),
    "confirm_speculative_reaches_queued_requests": lambda r: (
        r["queued, backlogged, another stream's"] == (False, False, True)),
    "synchronized_confirmation_wave_counts_once": lambda r: (
        r["closed"] and r["one fold: still closed"] and r["buffered"] <= 49),
    "congestion_closes_gate": lambda r: (
        r["starts above budget"] and r["fresh"] is False and r["slack"] is True
        and r["over budget"] is False and r["one congested reap"][0] is False),
    "backlog_and_spec_cap_close_gate": lambda r: (
        r["open"] and r["final backlog"] is False and r["one below the speculative cap"]
        and r["at the cap"] is False),
    "stream_oversubscription_closes_gate": lambda r: (
        r["open"] and r["streams > long slots"] is False and r["streams == long slots"]),
    "capacity_trumps_accept_rate": lambda r: (
        r["0 slots busy"] and r["4 slots busy"] is False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gate_decisions_match_jax(transcribers, case):
    tr_j, tr = transcribers
    records = []
    for eng in (BatchedEngineJax(tr_j, EnergyVadJax(), slots=4, max_decode_tokens=32),
                BatchedEngine(tr, EnergyVad(device="cpu"), slots=4, max_decode_tokens=32)):
        record = {}
        try:
            CASES[case](eng, lambda name, value: record.__setitem__(name, value))
        finally:
            eng.shutdown()
        records.append(record)
    want, got = records
    assert got == want
    assert EXPECT[case](got), got
