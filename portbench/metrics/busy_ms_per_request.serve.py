"""Device busy time a served request, ms."""



def read(view):
    if view.records.busy_s <= 0 or not view.requests:
        return None
    return 1e3 * view.records.busy_s / view.requests
