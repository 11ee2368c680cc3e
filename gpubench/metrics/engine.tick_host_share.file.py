"""Share of the window the engine's ticks spent on host work (``tick``
less its ``sync`` waits on the card), %."""


def read(r):
    tick, sync = r.counter_delta("span_s.tick"), r.counter_delta("span_s.sync")
    if tick is None or sync is None or not r.window_s:
        return None
    return 100.0 * (tick - sync) / r.window_s
