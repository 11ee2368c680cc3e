"""The traced second's idle gaps named by the engine's own spans.

    python3 gpubench/tools/idle_gaps.py --gaps-out <file.json> --workload <cell> \
        --seed <n> --seconds <s> --trace 1

Runs ``gpubench/run.py`` with the given arguments (its result line and
exit code unchanged) and, with ``--trace 1``, writes to ``--gaps-out`` the
device trace's idle gaps, each named by the program spans open at its
middle, outermost first (``tick>tick.admit>admit.prep``); the request spans
are left out, since a request is open across ticks. The engine's span
records are copied when the trace stops, so they cover the traced second.
Written: the traced and the busy seconds, the idle seconds by gap length,
the longest gaps, the idle seconds by the (at most three) outermost spans
open, the stretch before the first device event and after the last, and
the window's deltas of the engine's span, device and decode counters.
"""

from __future__ import annotations

import json
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# idle seconds by gap length: (name, shortest, longest)
BY_LENGTH = (("under_10us", 0.0, 1e-5), ("10us_100us", 1e-5, 1e-4), ("100us_1ms", 1e-4, 1e-3),
             ("over_1ms", 1e-3, float("inf")))
COUNTERS = ("span_s.", "span_n.", "device_", "decode_")


def device_gaps(dev) -> tuple[list, float | None, float | None]:
    """dev: [(start, duration)] of the device events, in seconds on one
    clock -> ([(length, start)] of the gaps between their union, the first
    event's start, the last event's end)."""
    gaps, end, first = [], None, None
    for t, d in sorted(dev):
        if end is None:
            first = t
        elif t > end:
            gaps.append((t - end, end))
        end = t + d if end is None else max(end, t + d)
    return gaps, first, end


def open_spans(records, t: float) -> str:
    """The engine's spans open at host time t, outermost first, joined by
    '>' (the request spans left out); "no program span" if none."""
    open_ = sorted((r for r in records if r[1] <= t <= r[2] and not r[0].startswith("request.")),
                   key=lambda r: r[1])
    return ">".join(r[0] for r in open_) or "no program span"


def summary(gaps, records, offset: float) -> dict:
    """gaps on the trace's clock, records on the host's; offset: host time
    less trace time."""
    named = [(g, open_spans(records, at + g / 2 + offset)) for g, at in gaps]
    by_span: dict = {}
    for g, name in named:
        key = ">".join(name.split(">")[:3])
        by_span[key] = by_span.get(key, 0.0) + g
    return {
        "idle_s": sum(g for g, _ in named),
        "n_gaps": len(named),
        "idle_by_gap_length": {name: sum(g for g, _ in named if lo <= g < hi)
                               for name, lo, hi in BY_LENGTH},
        "longest": sorted(named, reverse=True)[:12],
        "idle_by_open_span": sorted(by_span.items(), key=lambda kv: -kv[1])[:15],
        "span_records": len(records),
    }


def main(argv: list) -> None:
    i = argv.index("--gaps-out")
    out_path = argv[i + 1]
    run_args = argv[:i] + argv[i + 2 :]
    sys.path.insert(0, ROOT)
    from gpubench import harness, trace

    state: dict = {}
    init, stop, read = harness.Window.__init__, trace.DeviceTrace.stop, trace.DeviceTrace.read
    close = harness.Window.close_window

    def window_init(self, *a, **k):
        init(self, *a, **k)
        state["window"] = self

    def close_window(self):
        close(self)
        a, b = self.counters["start"], self.counters["end"]
        state["window_s"] = self.t1 - self.t0
        state["deltas"] = {k: b[k] - a.get(k, 0) for k in sorted(b) if k.startswith(COUNTERS)}

    def trace_stop(self):
        stop(self)
        spans = getattr(harness._engines(state["window"].program)[0], "spans", None)
        state["records"] = spans.records() if spans is not None else []

    def trace_read(self, spans):
        out = read(self, spans)
        dev, mark = [], None
        for e in self._prof.profiler.kineto_results.events():
            if e.name() == "gpubench.mark":
                mark = e.start_ns() / 1e9
            elif e.device_type().name == "CUDA":
                dev.append((e.start_ns() / 1e9, e.duration_ns() / 1e9))
        if mark is None:
            return out
        offset = self._mark - mark
        gaps, first, last = device_gaps(dev)
        result = {"window_s": out["window_s"], "busy_s": out["busy_s"],
                  **summary(gaps, state.get("records", []), offset),
                  "before_first_event_s": first + offset - self.t_start if dev else None,
                  "after_last_event_s": self.t_stop - (last + offset) if dev else None,
                  "measured_window_s": state.get("window_s"),
                  "window_deltas": state.get("deltas")}
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return out

    harness.Window.__init__ = window_init
    harness.Window.close_window = close_window
    trace.DeviceTrace.stop = trace_stop
    trace.DeviceTrace.read = trace_read
    sys.argv = ["gpubench/run.py"] + run_args
    runpy.run_path(os.path.join(ROOT, "gpubench", "run.py"), run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1:])
