"""The 95th percentile of request latency (submission to edited weights
returned and synchronised) over every request completed in the window,
exact."""
from portbench.lib.stats import percentile


def read(r):
    if not r.requests:
        return None
    return percentile([q["latency_s"] for q in r.requests], 95.0)
