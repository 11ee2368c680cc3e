"""Device ms of a decode step in the window: the decode family's programs
timed on the card by CUDA events, over their steps."""


def read(r):
    seconds, steps = r.counter_delta("device_s.decode"), r.counter_delta("device_steps.decode")
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps
