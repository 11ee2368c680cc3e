"""Largest delay of a 64 ms chunk due in the window behind its schedule."""


def read(r):
    return r.samples.get("ingest_lag_s")
