"""Share of the window the engine's ticks waited on the card (``sync``), %."""


def read(r):
    d = r.counter_delta("span_s.sync")
    if d is None or not r.window_s:
        return None
    return 100.0 * d / r.window_s
