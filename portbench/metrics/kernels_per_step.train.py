"""Device operations (kernels, copies, fills) a train step."""



def read(view):
    n = view.records.launches()
    if n == 0 or not view.units:
        return None
    return n / view.units
