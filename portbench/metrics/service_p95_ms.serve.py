"""The 95th percentile of the service times of every request in the
untraced window, from the call to ``predict`` until the scores are on the
host, ms (the host's clock).  The closed loop keeps no queue, so this is
the time one request takes; it moves with the candidates a second."""

import statistics


def read(view):
    lat = getattr(view, "latencies", None)
    if not lat or len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
