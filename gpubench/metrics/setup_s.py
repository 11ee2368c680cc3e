"""Set-up: process start to the window's opening (weights, build, warmup, settle)."""


def read(r):
    return r.setup_s
