"""95th percentile of the short pool's queue ms (enqueue to prefill) over the window."""

from gpubench.stats import percentile


def read(r):
    return percentile(r.class_lat.get("short", {}).get("queue", []), 95)
