"""95th percentile of the short pool's lead ms over the window: a ring
request's enqueue less the arrival of the newest chunk it covers."""

from gpubench.stats import percentile


def read(r):
    return percentile(r.class_lat.get("short", {}).get("lead", []), 95)
