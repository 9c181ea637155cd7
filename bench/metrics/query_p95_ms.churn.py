"""The churn cell's query tail: the nearest-rank 95th percentile, over
every query due in the window, from its Poisson due time to its answer
(read in a ``--trace 1`` run from its untraced window)."""
import math


def read(obs):
    lat = obs.window.get("latency_ms")
    if lat is None or not len(lat):
        return None
    s = sorted(lat)
    return float(s[min(len(s) - 1, max(0, math.ceil(0.95 * len(s)) - 1))])
