"""solve_p95_ms (ms, host clock): the 95th percentile of every call's
latency in the window, from the verb's call to its return with the NumPy
solution in hand (``statistics.quantiles``, inclusive method)."""

import statistics


def read(rec):
    lat = [(c1 - c0) * 1e3 for c0, c1, _ in rec.calls]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
