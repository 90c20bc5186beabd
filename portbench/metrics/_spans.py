"""The device's idle time inside the program's spans.

A span (``deepctr_tpu_torch/tracing.py``) is a host operation of the
profiler's trace, named ``<layer>.<part>``, on the clock of the device's
records.  The idle time inside spans of a name is the overlap of the
union of their intervals with the device's idle gaps (``Records.gaps``);
a nested span counts in its parent as well.  A program without such
spans (as before they were added) records none, and the metric is not
reported.
"""


def merged(intervals):
    """The union of ``[(start, end)]`` as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_ns(records, name):
    """Nanoseconds of the device's idle gaps inside spans named ``name``,
    or None where the window holds no such span."""
    spans = merged((s, s + d) for s, d, n in records.host if n == name)
    if not spans:
        return None
    gaps = sorted((a, b) for _, a, b in records.gaps)
    total, i = 0, 0
    for a, b in gaps:
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            total += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return total


def idle_ms_per_request(view, name):
    """The device's idle ms inside spans named ``name``, a request of the
    traced serving window; None where no device operation or no such span
    was recorded."""
    if view.records.busy_s <= 0 or not view.requests:
        return None
    ns = idle_ns(view.records, name)
    return None if ns is None else ns * 1e-6 / view.requests
