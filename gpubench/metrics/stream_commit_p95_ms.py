"""95th percentile of every commit whose speech ended in the window, speech end to arrival."""

from gpubench.stats import percentile


def read(r):
    return percentile(r.samples.get("commit_ms", []), 95)
