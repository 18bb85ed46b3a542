"""The 95th percentile of the latency of every call of the window, in
ms (host clock around each call, which returns its results on the
host)."""

import statistics


def read(rec):
    lat = rec.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method='inclusive')[94] * 1e3
