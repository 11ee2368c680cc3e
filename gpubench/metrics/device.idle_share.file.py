"""Share of the traced stretch with no device operation running, %."""


def read(r):
    if r.trace is None or not r.trace["window_s"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
