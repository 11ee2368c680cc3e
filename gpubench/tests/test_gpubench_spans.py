"""The readers of the engine's spans and counters, on synthetic readings:
each reads its counter deltas over the window, and returns nothing where
the program has no such counter (a program without the spans)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from gpubench import manifest

NEW = ("engine.loop_share.file", "engine.sync_share.file", "engine.tick_host_share.file",
       "batcher.long_row_use.file", "model.decode_step_ms.file", "model.decode_step_ms.stream",
       "session.interim_lead_p95_ms")


def _reading(start: dict, end: dict, class_lat=None, window_s=40.0):
    r = SimpleNamespace(window_s=window_s, counters={"start": start, "end": end},
                        class_lat=class_lat or {})

    def delta(key):
        if key not in start or key not in end:
            return None
        return end[key] - start[key]

    r.counter_delta = delta
    return r


def test_the_scheduler_shares_split_the_window():
    start = {"span_s.sched.loop": 3.0, "span_s.sync": 5.0, "span_s.tick": 20.0,
             "span_s.sched.idle": 1.0, "span_s.sched.vad_gather": 0.0}
    end = {"span_s.sched.loop": 9.0, "span_s.sync": 15.0, "span_s.tick": 50.0,
           "span_s.sched.idle": 5.0, "span_s.sched.vad_gather": 0.0}
    r = _reading(start, end)
    read = manifest.metric_reader
    loop = read("engine.loop_share.file")(r)
    sync = read("engine.sync_share.file")(r)
    host = read("engine.tick_host_share.file")(r)
    assert loop == pytest.approx(15.0) and sync == pytest.approx(25.0)
    assert host == pytest.approx(50.0)
    idle = 100.0 * (end["span_s.sched.idle"] - start["span_s.sched.idle"]) / r.window_s
    assert loop + sync + host + idle == pytest.approx(100.0)


def test_row_use_and_the_device_step():
    start = {"decode_tokens.long": 1000, "decode_row_steps.long": 2000,
             "device_s.decode": 1.5, "device_steps.decode": 300}
    end = {"decode_tokens.long": 31000, "decode_row_steps.long": 35000,
           "device_s.decode": 26.5, "device_steps.decode": 5300}
    r = _reading(start, end)
    assert manifest.metric_reader("batcher.long_row_use.file")(r) == pytest.approx(
        100.0 * 30000 / 33000)
    for cell in ("file", "stream"):
        assert manifest.metric_reader(f"model.decode_step_ms.{cell}")(r) == pytest.approx(5.0)


def test_the_interim_lead_is_the_short_pools_p95():
    lead = list(np.random.default_rng(3).exponential(80.0, size=301))
    r = _reading({}, {}, class_lat={"short": {"queue": [1.0] * 301, "lead": lead},
                                    "long": {"lead": [1e6]}})
    assert manifest.metric_reader("session.interim_lead_p95_ms")(r) == pytest.approx(
        np.percentile(lead, 95))


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_nothing(name):
    """The parent program has neither the counters nor the lead: every new
    reader returns None, and one with no steps in the window too."""
    r = _reading({"ticks": 1}, {"ticks": 9}, class_lat={"short": {"queue": [3.0]}})
    assert manifest.metric_reader(name)(r) is None
    still = {"decode_tokens.long": 5, "decode_row_steps.long": 7, "device_s.decode": 1.0,
             "device_steps.decode": 3}
    r = _reading(still, dict(still), class_lat={"short": {"lead": []}})
    if name.startswith(("batcher.", "model.", "session.")):
        assert manifest.metric_reader(name)(r) is None


def test_each_new_metric_is_in_the_manifest_with_its_cell():
    per_layer = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        cell = "nano-bf16.streams" if name.endswith(("stream", "lead_p95_ms")) \
            else "nano-bf16.files-novad"
        assert m["workloads"] == [cell] and m["source"] in ("program_span", "program_counter")


def test_idle_gaps_are_named_by_the_spans_open_at_their_middle():
    """tools/idle_gaps.py: the gaps between the union of the device events,
    each named by the engine's spans open at its middle on the host's clock
    (outermost first, request spans left out), summed by length and span."""
    from gpubench.tools import idle_gaps

    dev = [(10.0, 1.0), (10.5, 1.0), (11.6, 0.1), (11.7000005, 0.2999995), (13.0, 1.0),
           (14.5, 0.1)]
    gaps, first, last = idle_gaps.device_gaps(dev)
    assert [round(g, 7) for g, _ in gaps] == [0.1, 0.0000005, 1.0, 0.5]
    assert (first, last) == (10.0, pytest.approx(14.6))
    records = [("tick", 111.0, 113.0, None, None),
               ("tick.admit", 111.5, 112.9, "tick", None),
               ("admit.prep", 112.0, 112.8, "tick.admit", "long"),
               ("request.long", 100.0, 120.0, None, 7)]
    out = idle_gaps.summary(gaps, records, offset=100.0)
    assert out["n_gaps"] == 4 and out["idle_s"] == pytest.approx(1.6000005)
    names = {round(g, 7): name for g, name in out["longest"]}
    assert names == {1.0: "tick>tick.admit>admit.prep", 0.5: "no program span",
                     0.1: "tick>tick.admit", 0.0000005: "tick>tick.admit"}
    assert out["idle_by_gap_length"]["over_1ms"] == pytest.approx(1.6)
    assert out["idle_by_gap_length"]["under_10us"] == pytest.approx(0.0000005)
    assert out["idle_by_open_span"][0] == ("tick>tick.admit>admit.prep", pytest.approx(1.0))
