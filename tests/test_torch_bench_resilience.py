"""The port's tools/bench_resilience.py against the JAX package's.

The cases of tests/test_bench_resilience.py that need no bench.py: a
wedged epoch, recovery after a re-init, a probe that raises, a re-init
that raises, and phase children that finish, crash, outlive their bound
(abandoned, not killed) or write nothing. Each runs on both modules with
the same fakes; the port's result holds what the JAX test asserts, and
its dict has the JAX module's keys and statuses. Then what only the port
has: its default probe is a round trip on the card, in a child
interpreter, and without a card it raises, so an attempt records an
error and the wait fails; it never stands a CPU result in."""

import os
import sys
import time

import pytest
import torch

from sonicscribe_tpu.tools import bench_resilience as br_jax
from sonicscribe_tpu_torch.tools import bench_resilience as br

MODULES = (br_jax, br)


def _hang_probe():
    time.sleep(30)  # daemon thread; abandoned, ends with the test process
    return 0.0


def _shape(r: dict):
    """A result dict's keys, statuses and actions, without the times."""
    if "attempts" in r:
        return (sorted(r), r["ok"], r["hung_probes"],
                [(sorted(a), a["action"], a["status"]) for a in r["attempts"]])
    return sorted(r), r["status"], r.get("rc")


def _both(run):
    """run(module) on the JAX module and the port's: -> the port's result,
    after checking that both have the same shape."""
    got_jax, got = (run(m) for m in MODULES)
    assert _shape(got) == _shape(got_jax), (got, got_jax)
    return got


# ---------------------------------------------------------------- wait_for_device


def test_wedged_epoch_fails_after_bounded_retries():
    calls = []

    def run(m):
        sleeps, reinits = [], []
        r = m.wait_for_device(probe=_hang_probe, attempts=3, timeout_s=0.1, spacing_s=0.2,
                              reinit=lambda: reinits.append(1), sleep=sleeps.append)
        calls.append((sleeps, reinits))
        return r

    r = _both(run)
    assert r["ok"] is False
    probes = [a for a in r["attempts"] if a["action"] == "probe"]
    assert len(probes) == 3 and all(p["status"] == "hung" for p in probes)
    assert r["hung_probes"] == 3
    for sleeps, reinits in calls:
        assert sleeps == [0.2, 0.2]  # spaced, not hammered
        assert len(reinits) == 2  # a re-init between every retry


def test_recovery_after_reinit():
    """The first probe hangs, the re-init 'fixes' the device, the second
    probe answers: the wait succeeds."""

    def run(m):
        state = {"fixed": False}

        def probe():
            if not state["fixed"]:
                time.sleep(30)
            return 1.0

        def reinit():
            state["fixed"] = True

        return m.wait_for_device(probe=probe, attempts=3, timeout_s=0.1, spacing_s=0.0,
                                 reinit=reinit, sleep=lambda s: None)

    r = _both(run)
    assert r["ok"] is True and r["hung_probes"] == 1
    assert [a["status"] for a in r["attempts"] if a["action"] == "probe"] == ["hung", "ok"]


def test_probe_exception_is_recorded_not_fatal():
    def run(m):
        calls = {"n": 0}

        def probe():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return 1.0

        return m.wait_for_device(probe=probe, attempts=2, timeout_s=1.0, spacing_s=0.0,
                                 reinit=lambda: None, sleep=lambda s: None)

    r = _both(run)
    assert r["ok"] is True
    assert r["attempts"][0]["status"] == "error" and "transient" in r["attempts"][0]["error"]


def test_reinit_failure_does_not_abort_retry():
    def run(m):
        def reinit():
            raise RuntimeError("re-init blew up")

        calls = {"n": 0}

        def probe():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("sick")
            return 1.0

        return m.wait_for_device(probe=probe, attempts=2, timeout_s=1.0, spacing_s=0.0,
                                 reinit=reinit, sleep=lambda s: None)

    r = _both(run)
    assert r["ok"] is True  # probed again despite the re-init's failure
    assert "blew up" in r["attempts"][1]["status"]


# ---------------------------------------------------------------- run_phase


def test_ok_phase_returns_parsed_result(tmp_path):
    def run(m):
        out = str(tmp_path / f"{m.__name__}.json")
        cmd = [sys.executable, "-c",
               "import json,sys; json.dump({'value': 0.01}, open(sys.argv[1],'w'))", out]
        return m.run_phase(cmd, out, timeout_s=30)

    r = _both(run)
    assert r["status"] == "ok" and r["result"] == {"value": 0.01}


def test_crashed_phase_reports_rc_and_log_tail(tmp_path):
    def run(m):
        out = str(tmp_path / f"{m.__name__}.json")
        cmd = [sys.executable, "-c", "import sys; print('boom-detail'); sys.exit(7)"]
        return m.run_phase(cmd, out, timeout_s=30)

    r = _both(run)
    assert r["status"] == "crashed" and r["rc"] == 7 and "boom-detail" in r["log_tail"]


def test_wedged_phase_is_abandoned_not_killed(tmp_path):
    """A child past its bound is abandoned: run_phase returns 'timeout'
    promptly, and the child lives on to finish its work."""
    outs = []

    def run(m):
        out = str(tmp_path / f"{m.__name__}.json")
        outs.append(out)
        cmd = [sys.executable, "-c",
               "import json,sys,time; time.sleep(1.5); "
               "json.dump({'late': True}, open(sys.argv[1],'w'))", out]
        t0 = time.monotonic()
        r = m.run_phase(cmd, out, timeout_s=0.3)
        assert time.monotonic() - t0 < 1.0  # returned at the bound
        return r

    r = _both(run)
    assert r["status"] == "timeout"
    deadline = time.monotonic() + 10
    while not all(os.path.exists(o) for o in outs) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert all(os.path.exists(o) for o in outs), "a child was killed instead of abandoned"


def test_empty_output_is_distinguished(tmp_path):
    def run(m):
        out = str(tmp_path / f"{m.__name__}.json")
        return m.run_phase([sys.executable, "-c", "pass"], out, timeout_s=30)

    assert _both(run)["status"] == "no-output"


def test_phase_cmd_is_the_jax_modules():
    args = ("bench.py", "file", "/tmp/out.json", ["--quick", "--cpu"])
    assert br.phase_cmd(*args) == br_jax.phase_cmd(*args)
    assert br.phase_cmd(*args)[2:6] == ["--phase", "file", "--out", "/tmp/out.json"]


# ---------------------------------------------------------------- the card's probe


def test_default_probe_without_a_card_records_an_error():
    """No card: the default probe's child fails, the attempt records
    "error" (not "ok", not "hung"), the wait is not ok; and the probe
    raises rather than return a CPU result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would succeed")
    r = br.wait_for_device(attempts=1, timeout_s=90.0)
    assert r["ok"] is False and r["hung_probes"] == 0
    assert [a["status"] for a in r["attempts"]] == ["error"]
    assert "CUDA is not available" in r["attempts"][0]["error"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        br.default_probe(timeout_s=90.0)


def test_reinit_backend_reports_and_touches_no_device():
    before = torch.cuda.is_initialized()
    assert "fresh child" in br.reinit_backend()
    assert torch.cuda.is_initialized() == before
