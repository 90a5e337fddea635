"""95th percentile of every request of the window, ms on the host clock
from issue to the synchronize after its last call."""

import statistics


def read(rec):
    if len(rec.latencies) < 2:
        return None
    return statistics.quantiles(rec.latencies, n=100)[94] * 1e3
