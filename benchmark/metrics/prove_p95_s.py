"""prove_p95_s (s): the 95th percentile of every proof's latency in the
window (nearest rank)."""

import math


def read(run):
    lat = sorted(run.latencies())
    return lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
