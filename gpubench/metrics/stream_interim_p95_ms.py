"""95th percentile of every tentative result due in the window, due to arrival."""

from gpubench.stats import percentile


def read(r):
    return percentile(r.samples.get("interim_ms", []), 95)
