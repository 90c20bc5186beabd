"""The system under test, ``deepctr_tpu_torch``, built from a
configuration file through its public constructors, and the two readings of
its state that the check of a training cell needs."""

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import models


def feature_columns(config):
    """The configuration's columns as the port's feature columns."""
    cols = []
    for c in config["columns"]:
        if c["kind"] == "sparse":
            cols.append(pt.SparseFeat(c["name"], c["vocab"], c["dim"]))
        elif c["kind"] == "dense":
            cols.append(pt.DenseFeat(c["name"], c["dim"]))
        elif c["kind"] == "varlen":
            cols.append(pt.VarLenSparseFeat(
                pt.SparseFeat(c["name"], c["vocab"], c["dim"],
                              embedding_name=c["table"]),
                maxlen=c["maxlen"], length_name=c["length"]))
        else:
            raise ValueError("unknown column kind %r" % c["kind"])
    return cols


def build(config, device, seed):
    """The configuration's model on ``device``, in its compute dtype (a
    process-wide setting of the port)."""
    pt.set_compute_dtype(config["compute_dtype"])
    cols = feature_columns(config)
    given = {"linear_columns": cols if config["linear_columns"] == "all"
             else [],
             "dnn_columns": cols,
             "history_feature_list": config.get("history_feature_list")}
    args = [given[a] for a in config["constructor"]]
    kwargs = {k: (tuple(config[k]) if isinstance(config[k], list)
                  else config[k]) for k in config["model_args"]}
    return getattr(models, config["class"])(*args, seed=seed,
                                            device=device, **kwargs)


def compile_model(model, config):
    model.compile(config["optimizer"], "binary_crossentropy",
                  learning_rate=config["learning_rate"],
                  sparse_table_updates=config["sparse_table_updates"])


def layout(model):
    """``[(name, shape, is a parameter)]`` of the model's state, in the
    order of its ``state_dict``: what the benchmark draws weights for."""
    params = {n for n, _ in model.named_parameters()}
    return [(n, tuple(t.shape), n in params)
            for n, t in model.state_dict().items()]


def optimizer_state(model):
    """``{parameter name: (state tensors)}`` of the named optimizer: the
    dense optimizer's (``_dense_opt``) and the sparse tables'
    (``_table_state``).  The check works the first gradient out of it."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    out = {}
    opt = model._dense_opt
    for p, st in zip(opt.params, opt.state):
        out[name_of[id(p)]] = tuple(st)
    tables = model._tables()
    for path, st in model._table_state.items():
        out[name_of[id(tables[path])]] = tuple(st)
    return out
