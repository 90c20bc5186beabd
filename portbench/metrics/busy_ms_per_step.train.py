"""Device busy time a train step (graph replay + ``_train_step``), ms."""



def read(view):
    if view.records.busy_s <= 0 or not view.units:
        return None
    return 1e3 * view.records.busy_s / view.units
