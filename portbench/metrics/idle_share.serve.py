"""The share of the traced serving window in which no operation ran on the
device, in percent."""



def read(view):
    r = view.records
    if r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
