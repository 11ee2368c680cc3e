"""The batcher's span recorder, always on.

A span is a named interval on ``time.perf_counter()`` (the clock of every
latency the engine keeps): ``(name, start, end, parent, ident)``, where
`parent` is the name of the span open around it on the same thread (None
at the top) and `ident` what it is about (a request span's request, an
admit span's pool, a tick's active slots per pool). Each closed span is

- folded into the engine's flat ``stats``: ``span_s.<name>`` (seconds)
  and ``span_n.<name>`` (count), so that any reader of ``stats`` (the
  server's ``/health``, a benchmark's counter deltas) sees it;
- kept in ``ring``, which holds the newest ``RING`` ticks whole: one entry
  a tick, the records since the previous tick with the tick last (the
  records since the last tick wait in ``since``); ``lost`` counts the
  ticks that fell off since ``clear()``, and ``records()`` reads it all
  back, oldest first;
- while a ``torch.profiler`` records on the span's thread (one C call
  decides), also a ``record_function`` range of the same name, so that the
  profiler's trace shows the program's phases beside the device's work.
  The profiler's host callbacks are per thread: a profiler started on the
  engine's device thread (``BatchedEngine.between_ticks``) sees the tick's
  spans, one started on the event loop's thread the scheduler's.

The scheduler's top-level spans partition its wall time (``piece``):
``sched.idle``, ``sched.vad_gather``, ``sched.capture``, ``tick`` and,
between any two of them, ``sched.loop``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import torch

RING = 4096  # ticks

# the scheduler's partition of its wall time
SCHED_PIECES = ("sched.idle", "sched.vad_gather", "sched.capture", "sched.loop", "tick")
# a tick's phases (the JAX package's tick keys) and the admit phase's split
TICK_PHASES = ("ingest", "vad_dispatch", "admit", "early_resolve", "decode_dispatch", "resolve")
ADMIT_PARTS = ("prep", "write", "dispatch")
# every span the batcher records; their counters exist from the start, so
# that a delta over any stretch has both ends
SPAN_NAMES = (SCHED_PIECES + tuple("tick." + p for p in TICK_PHASES)
              + tuple("admit." + p for p in ADMIT_PARTS)
              + ("sync", "request.short", "request.long"))

_profiling = torch._C._autograd._profiler_enabled
_perf = time.perf_counter
_thread = threading.get_ident


class _Span:
    __slots__ = ("rec", "name", "ident", "start", "parent", "rf", "open")

    def __init__(self, rec: "Spans", name: str, ident):
        self.rec, self.name, self.ident = rec, name, ident
        self.open = False

    def __enter__(self) -> "_Span":
        stack = self.rec._stacks.get(_thread())
        if stack is None:
            stack = self.rec._stacks[_thread()] = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.open = True
        self.start = _perf()
        return self

    def close(self) -> Optional[float]:
        """End the span -> its end (again: nothing, None)."""
        if not self.open:
            return None
        end = _perf()
        self.open = False
        self.rec._stacks[_thread()].pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.rec.add(self.name, self.start, end, self.parent, self.ident)
        return end

    def __exit__(self, *exc) -> None:
        self.close()


class _Piece(_Span):
    """A top-level span of the scheduler's partition: the time since the
    last piece ended goes to ``sched.loop`` first."""

    __slots__ = ()

    def __enter__(self) -> "_Piece":
        rec = self.rec
        now = _perf()
        if rec.t_mark is not None and now > rec.t_mark:
            rec.add("sched.loop", rec.t_mark, now)
        return super().__enter__()

    def close(self) -> Optional[float]:
        end = super().close()
        if end is not None:
            self.rec.t_mark = end
        return end


class Spans:
    """The recorder of one engine; `stats` is the engine's stats dict."""

    def __init__(self, stats: dict):
        self.stats = stats
        self.ring: deque = deque(maxlen=RING)
        self.since: deque = deque(maxlen=RING)
        self.lost = 0
        self._stacks: dict = {}  # the open spans' names by thread
        self._keys: dict = {}
        # the end of the scheduler's last piece (None: no scheduler yet)
        self.t_mark: Optional[float] = None
        for name in SPAN_NAMES:
            s_key, n_key = self._key(name)
            stats.setdefault(s_key, 0.0)
            stats.setdefault(n_key, 0)

    def _key(self, name: str) -> tuple:
        keys = self._keys.get(name)
        if keys is None:
            keys = self._keys[name] = ("span_s." + name, "span_n." + name)
        return keys

    def span(self, name: str, ident=None) -> _Span:
        """A span as a context manager (or ``.__enter__()`` then
        ``.close()``, which may come twice)."""
        return _Span(self, name, ident)

    def piece(self, name: str) -> _Piece:
        return _Piece(self, name, None)

    def add(self, name: str, start: float, end: float, parent: Optional[str] = None,
            ident=None) -> None:
        """Record a closed span (one that no profiler range can show: the
        loop gaps, a request's life across ticks and threads)."""
        rec = (name, start, end, parent, ident)
        if name == "tick":
            # a record another thread adds to the old `since` meanwhile
            # stays in the ring, after the tick, as if added after the swap
            group, self.since = self.since, deque(maxlen=RING)
            group.append(rec)
            self.lost += len(self.ring) == RING
            self.ring.append(group)
        else:
            self.since.append(rec)
        s_key, n_key = self._keys.get(name) or self._key(name)
        stats = self.stats
        stats[s_key] = stats.get(s_key, 0.0) + (end - start)
        stats[n_key] = stats.get(n_key, 0) + 1

    def records(self) -> list:
        """Every record kept, oldest first."""
        return [r for group in list(self.ring) for r in list(group)] + list(self.since)

    def clear(self) -> None:
        """Forget the records kept (the counters in `stats` stay)."""
        self.ring.clear()
        self.since = deque(maxlen=RING)
        self.lost = 0


def tick_phases(records) -> list[dict]:
    """Per tick of `records` (``Spans.records()``), oldest first, the JAX package's tick record
    (host ms): "t" (the tick's start), "<phase>_ms" for each of
    TICK_PHASES, "total_ms", "sync_ms" (waits on the card inside it),
    "early" (an early resolve ran), "active" ([(pool, active slots)] at its
    end) and "admit_detail" ({"prep_ms", "write_ms", "dispatch_ms",
    "groups_short", "groups_long"})."""
    out, since = [], []
    for r in records:
        if r[0] != "tick":
            since.append(r)
            continue
        _, t0, t1, _, ident = r
        rec = {"t": t0, "total_ms": (t1 - t0) * 1e3, "sync_ms": 0.0, "early": False,
               "active": list(ident or ())}
        rec.update({p + "_ms": 0.0 for p in TICK_PHASES})
        detail = {p + "_ms": 0.0 for p in ADMIT_PARTS}
        detail.update(groups_short=0, groups_long=0)
        # a tick's own spans close before it does: they are the records
        # since the previous tick that start inside it
        for name, a, b, parent, who in since:
            if not t0 <= a <= t1:
                continue
            if parent == "tick" and name.startswith("tick."):
                rec[name[5:] + "_ms"] += (b - a) * 1e3
                rec["early"] |= name == "tick.early_resolve"
            elif name.startswith("admit."):
                detail[name[6:] + "_ms"] += (b - a) * 1e3
                if name == "admit.dispatch" and who in ("short", "long"):
                    detail["groups_" + who] += 1
            elif name == "sync":
                rec["sync_ms"] += (b - a) * 1e3
        since = []
        rec["admit_detail"] = detail
        out.append(rec)
    return out
