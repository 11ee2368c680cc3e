"""Share of the window the engine's scheduler spent between its pieces
(``sched.loop``: the event loop's turn and the executor hop), %."""


def read(r):
    d = r.counter_delta("span_s.sched.loop")
    if d is None or not r.window_s:
        return None
    return 100.0 * d / r.window_s
