"""Graphs captured on a request's path during the window (router counter delta)."""


def read(r):
    return r.counter_delta("captured_on_run")
