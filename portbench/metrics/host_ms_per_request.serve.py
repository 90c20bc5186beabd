"""The traced window's time with the device idle, a request, ms: what
``predict``'s host path (assembly, upload, replays, read-back) adds."""



def read(view):
    r = view.records
    if r.busy_s <= 0 or not view.requests:
        return None
    return 1e3 * (r.window_s - r.busy_s) / view.requests
