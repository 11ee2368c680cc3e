"""A measurement pipeline that outlives a sick card: probe-retry and phase children.

The port's twin of the JAX package's ``tools/bench_resilience.py``, with
the same functions and result dicts, so that a benchmark harness can wait
for a healthy device before it measures and keep the phases that finished
when a later one fails:

- ``wait_for_device``: a bounded probe-retry loop. A probe that hangs or
  fails is retried after ``spacing_s``, up to ``attempts`` probes, with
  ``reinit`` called between them. -> ``{"ok", "attempts", "hung_probes",
  "waited_s"}``.
- ``run_phase``: one measurement phase as a subprocess that writes its
  JSON result to a file, with a bounded wait. -> a status of ``ok``,
  ``crashed``, ``timeout``, ``no-output`` or ``bad-output``.

What differs from JAX is the device under it. Only a real round trip
shows that a card works: a context can be made, kernels enqueued and the
device counted while the card does not complete work. ``default_probe``
therefore puts 8 ones on the card, sums them there and reads the sum
back. A CUDA context cannot be re-made inside a process: after a sticky
error (an illegal address, a launch failure) every later call in that
process fails. So each probe runs in a child interpreter, with a fresh
context of its own, and the parent's process holds none. JAX's
``reinit_backend`` clears its backend clients between attempts; the
port's has nothing to clear in this process and only reports that each
probe starts its own context.

A probe that does not return within its bound is abandoned, never killed:
``probe_once`` leaves it in a daemon thread (and ``default_probe`` leaves
its child running), and a phase child past its bound is left to finish on
its own; its result file may still land. Without a card the default probe
raises: it never stands a CPU result in for the card's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

PROBE_TIMEOUT_S = 120.0  # a probe (its child included) past this is abandoned

# the child's round trip: 8 ones on the card, summed there, read back
_PROBE_CHILD = r"""
import sys
import torch
if not torch.cuda.is_available():
    sys.exit("CUDA is not available")
print(torch.ones(8, device="cuda").sum().item())
"""


def default_probe(timeout_s: float = PROBE_TIMEOUT_S) -> float:
    """One real round trip on the card, in a child interpreter with a
    fresh CUDA context: torch.ones(8) on the card, summed, read back with
    .item(). -> 8.0. Raises when the child fails (no card: "CUDA is not
    available"), prints anything else, or has not exited within timeout_s
    (then it is left running, not killed)."""
    proc = subprocess.Popen([sys.executable, "-c", _PROBE_CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=subprocess.DEVNULL, text=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"the device probe's child (pid {proc.pid}) did not exit within "
                           f"{timeout_s} s; left running") from None
    if proc.returncode != 0:
        raise RuntimeError(f"device probe failed (rc {proc.returncode}): {err.strip()[-400:]}")
    value = float(out.strip().splitlines()[-1])
    if value != 8.0:
        raise RuntimeError(f"device probe read back {value}, not 8.0")
    return value


def reinit_backend() -> str:
    """Between attempts: nothing to re-initialise in this process, which
    holds no CUDA context; each default probe makes its own in a child.
    -> what was done."""
    return "nothing re-initialised: each probe runs in a fresh child with its own CUDA context"


def probe_once(probe: Callable[[], float], timeout_s: float) -> dict:
    """Run `probe` in a daemon thread with a bounded join. A probe still
    running at timeout_s is abandoned (daemon threads do not hold up the
    interpreter's exit). -> {"status": "ok" | "error" | "hung", "took_s"}
    (and "error" with the exception's repr)."""
    box: dict = {}

    def run():
        try:
            box["value"] = probe()
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            box["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True, name="device-probe")
    start = time.monotonic()
    t.start()
    t.join(timeout_s)
    took = round(time.monotonic() - start, 1)
    if t.is_alive():
        return {"status": "hung", "took_s": took}
    if "error" in box:
        return {"status": "error", "error": box["error"], "took_s": took}
    return {"status": "ok", "took_s": took}


def wait_for_device(
    probe: Callable[[], float] = default_probe,
    attempts: int = 3,
    timeout_s: float = PROBE_TIMEOUT_S,
    spacing_s: float = 240.0,
    reinit: Callable[[], object] = reinit_backend,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Bounded probe-retry: probe, and on failure wait `spacing_s`, call
    `reinit`, probe again, up to `attempts` probes. -> ``{"ok": bool,
    "attempts": [...], "hung_probes": int, "waited_s": s}``; each attempt
    is a dict with "action" ("probe" or "reinit") and its "status"."""
    t0 = time.monotonic()
    history = []
    hung = 0
    ok = False
    for i in range(max(1, attempts)):
        if i > 0:
            sleep(spacing_s)
            try:
                reinit()
                history.append({"action": "reinit", "status": "ok"})
            except Exception as e:  # noqa: BLE001 - recovery is best-effort
                history.append({"action": "reinit", "status": repr(e)})
        r = probe_once(probe, timeout_s)
        r["action"] = "probe"
        history.append(r)
        if r["status"] == "hung":
            hung += 1
        if r["status"] == "ok":
            ok = True
            break
    return {
        "ok": ok,
        "attempts": history,
        "hung_probes": hung,
        "waited_s": round(time.monotonic() - t0, 1),
    }


def run_phase(
    cmd: list[str],
    out_path: str,
    timeout_s: float,
    log_path: Optional[str] = None,
    env: Optional[dict] = None,
) -> dict:
    """Run one measurement phase as a subprocess that writes its JSON result
    to `out_path`; wait at most `timeout_s`. Returns one of:

    - ``{"status": "ok", "result": <parsed json>, "took_s": s}``
    - ``{"status": "crashed", "rc": n, "log_tail": "...", "took_s": s}``
    - ``{"status": "timeout", "took_s": s, "log": path}``: the child is
      left running, not killed; its result file may still land.
    - ``{"status": "no-output", "took_s": s, "log": path}``: exited 0
      without writing the file.
    - ``{"status": "bad-output", "error": "...", "took_s": s}``: the file
      is no JSON.

    The child's stdout and stderr go to `log_path` (default: out_path +
    ".log"), so that the parent's stdout carries only its own lines.
    """
    log_path = log_path or out_path + ".log"
    if os.path.exists(out_path):
        os.unlink(out_path)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            env=env,
        )
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return {
                "status": "timeout",
                "took_s": round(time.monotonic() - t0, 1),
                "log": log_path,
            }
    took = round(time.monotonic() - t0, 1)
    if rc != 0:
        tail = ""
        try:
            with open(log_path) as f:
                tail = f.read()[-800:]
        except OSError:
            pass
        return {"status": "crashed", "rc": rc, "log_tail": tail, "took_s": took}
    if not os.path.exists(out_path):
        return {"status": "no-output", "took_s": took, "log": log_path}
    try:
        with open(out_path) as f:
            return {"status": "ok", "result": json.load(f), "took_s": took}
    except (OSError, json.JSONDecodeError) as e:
        return {"status": "bad-output", "error": repr(e), "took_s": took}


def phase_cmd(script: str, phase: str, out_path: str, flags: list[str]) -> list[str]:
    """Command line for a bench phase child (same interpreter + flags)."""
    return [sys.executable, script, "--phase", phase, "--out", out_path, *flags]

