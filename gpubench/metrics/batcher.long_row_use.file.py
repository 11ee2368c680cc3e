"""Tokens the long pool's decode rows emitted over the rows its plain and
dual decode programs computed (times their k) in the window, %."""


def read(r):
    tokens = r.counter_delta("decode_tokens.long")
    rows = r.counter_delta("decode_row_steps.long")
    if tokens is None or not rows:
        return None
    return 100.0 * tokens / rows
