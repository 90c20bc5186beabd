"""Model and train-state persistence, every file written with
``torch.save``.

Counterpart of ``deepctr_tpu/utils/serialization.py:22-127``.  Tensors are
stored moved to the CPU, so that a file written from the card loads on a
host without one.  Weights files and checkpoints hold tensors, numbers,
strings, lists and dicts only, and load with ``torch.load(...,
weights_only=True)``; a whole-model file holds the model's class and
constructor arguments, and ``load_model`` loads it with
``weights_only=False``.

- ``save_weights``/``load_weights``: the ``state_dict`` (BatchNorm's
  running statistics included).
- ``save_model``/``load_model``: the class, ``_init_kwargs`` and the
  weights; ``load_model`` builds the model again from those arguments (on
  the device they name) and loads the weights.
- ``save_checkpoint``/``load_checkpoint``: a directory holding one file,
  ``checkpoint.pt``: the weights and, with ``include_optimizer``, the
  optimizer's name and learning rate, the dense parameters' optimizer state
  and step count (``DenseOptimizer``, or the ``state_dict`` of a
  ``torch.optim`` optimizer) and every sparse table's state and adam step
  count (``_table_state``, ``_table_t``; under rowwise adam a table's
  state holds its per-row counts ``t`` too), for an exact resume.  A saved
  state whose layout (tensor count or shapes) differs from the compiled
  model's raises ``ValueError``: it is never reinterpreted.

On a mesh (``parallel/``) every rank calls these.  The saves gather each
row-sharded table, and its optimizer state, over the mesh's ``model`` axis
and rank 0 writes a file equal to the one rank's run; the loads read the
full tensors and each rank keeps its block.  So it is with the state of a
``torch.optim`` optimizer: a state tensor of a row-sharded table's shape
(Adagrad's ``sum``, Adam's ``exp_avg`` and ``exp_avg_sq``) is gathered
whole, a scalar (``step``) written as it is.  The file has the layout of
a run without a mesh, and loads into a model on any mesh or none.
"""

import os

import torch
import torch.distributed as dist

CHECKPOINT_FILE = "checkpoint.pt"


def _cpu_weights(model):
    return {k: v.cpu() for k, v in model.full_state_dict().items()}


def _writes(model):
    """Whether this process writes ``model``'s files: always, but on a
    mesh only rank 0 does."""
    return model.mesh is None or dist.get_rank() == 0


def _optimizer_params(model):
    """``(parameter, table path)`` of each parameter of the ``torch.optim``
    optimizer, by its index in the optimizer's ``state_dict``; the path is
    what ``_gather_table`` and ``_block`` read (None for a parameter that
    is not the model's)."""
    keys = model._param_paths()
    paths = {id(p): keys[k] for k, p in model.named_parameters()}
    return [(p, paths.get(id(p))) for g in model.optim.param_groups
            for p in g["params"]]


def _torch_state(model):
    """The optimizer object's ``state_dict`` on the CPU, each state tensor
    of a row-sharded table's shape gathered whole over the ``model``
    axis."""
    state = model.optim.state_dict()
    params = _optimizer_params(model)
    out = {}
    for i, st in state["state"].items():
        p, path = params[i]
        out[i] = {k: (model._gather_table(path, v) if v.shape == p.shape
                      else v).detach().cpu()
                  if isinstance(v, torch.Tensor) else v
                  for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def _torch_state_blocks(model, saved):
    """A saved ``torch.optim`` state with each whole state tensor of a
    row-sharded table cut to this rank's block."""
    params = _optimizer_params(model)
    state = {i: {k: model._block(params[i][1], v)
                 if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                 for k, v in st.items()}
             for i, st in saved["state"].items()}
    return {"state": state, "param_groups": saved["param_groups"]}


def _cpu(tensors):
    return [t.detach().cpu() for t in tensors]


def _save(payload, path):
    """``torch.save`` into a file beside ``path``, then renamed over it, so
    that an interrupted save leaves the earlier file whole."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_weights(model, path):
    weights = _cpu_weights(model)
    if _writes(model):
        _save(weights, path)


def load_weights(model, path):
    model.set_weights(torch.load(path, map_location="cpu",
                                 weights_only=True))
    return model


def save_model(model, path):
    weights = _cpu_weights(model)
    if _writes(model):
        _save({"model_class": type(model),
               "init_kwargs": model._init_kwargs, "weights": weights,
               "version": 1}, path)


def load_model(path):
    """The model saved by :func:`save_model`, built again from its class
    and constructor arguments.  Loads with ``weights_only=False``, which
    runs the pickled class's code: load only files you trust."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    model = payload["model_class"](**payload["init_kwargs"])
    model.set_weights(payload["weights"])
    return model


def _optimizer_payload(model):
    opt = model._dense_opt
    out = {"name": model._optimizer_name or type(model.optim).__name__,
           "learning_rate": model._learning_rate, "count": opt.count,
           "table_state": {p: _cpu(model._gather_table(p, t) for t in st)
                           for p, st in model._table_state.items()},
           "table_t": dict(model._table_t)}
    if model._optimizer_name is None:
        out["torch_state"] = _torch_state(model)
    else:
        out["dense_state"] = [_cpu(model._gather_table(p, t) for t in st)
                              for p, st in zip(model._dense_paths,
                                               opt.state)]
    return out


def save_checkpoint(model, directory, include_optimizer=True):
    """Write the train state of ``model`` into ``directory`` (made if
    missing): its weights and, with ``include_optimizer`` and a compiled
    model, its optimizer state."""
    payload = {"version": 1, "weights": _cpu_weights(model)}
    if include_optimizer and getattr(model, "optim", None) is not None:
        payload["optimizer"] = _optimizer_payload(model)
    if _writes(model):
        os.makedirs(directory, exist_ok=True)
        _save(payload, os.path.join(directory, CHECKPOINT_FILE))


def load_checkpoint(model, directory):
    """Restore the weights, and the optimizer state where the checkpoint
    holds it and ``model`` is compiled.  The model drops its captured
    graphs, so that the next step reads the loaded tensors."""
    payload = torch.load(os.path.join(directory, CHECKPOINT_FILE),
                         map_location="cpu", weights_only=True)
    # set_weights starts the optimizer state afresh; it is restored after
    model.set_weights(payload["weights"])
    saved = payload.get("optimizer")
    if saved is None or getattr(model, "optim", None) is None:
        return model
    name = model._optimizer_name or type(model.optim).__name__
    if saved["name"] != name:
        raise ValueError("checkpointed optimizer %r does not match this "
                         "model's %r" % (saved["name"], name))
    opt = model._dense_opt
    if model._optimizer_name is None:
        _restore_torch_state(model.optim,
                             _torch_state_blocks(model, saved["torch_state"]))
    else:
        _restore_like([t for st in opt.state for t in st],
                      [model._block(p, t)
                       for p, st in zip(model._dense_paths,
                                        saved["dense_state"])
                       for t in st],
                      "dense optimizer state")
    paths = sorted(model._table_state)
    if sorted(saved["table_state"]) != paths:
        raise ValueError(
            "checkpointed table_state layout does not match this model's "
            "(saved under another sparse_table_updates setting?): tables "
            "%s here vs %s in the checkpoint. Load under the same "
            "configuration it was saved with."
            % (paths, sorted(saved["table_state"])))
    _restore_like([t for p in paths for t in model._table_state[p]],
                  [model._block(p, t) for p in paths
                   for t in saved["table_state"][p]],
                  "table_state")
    opt.count = saved["count"]
    model._table_t = {p: int(saved["table_t"][p]) for p in paths}
    return model


def _layout_error(what, ref_sig, new_sig):
    diff = [(a, b) for a, b in zip(ref_sig, new_sig) if a != b]
    first = ("expected shape %s, checkpoint has %s" % diff[0] if diff
             else "%d tensors here vs %d in the checkpoint"
             % (len(ref_sig), len(new_sig)))
    return ValueError(
        "checkpointed %s layout does not match this model's (saved under "
        "a different optimizer, sparse_table_updates or adam step-count "
        "(config.set_adam_t) setting?): %s. Load under the same "
        "configuration it was saved with." % (what, first))


def _restore_like(ref, saved, what):
    """Copy ``saved`` into the tensors ``ref`` in place, but only when the
    count and every shape agree (``deepctr_tpu/utils/serialization.py:
    102-127``): a state of another layout would seed the optimizer from
    reinterpreted buffers, so it raises instead."""
    ref_sig = [tuple(t.shape) for t in ref]
    new_sig = [tuple(t.shape) for t in saved]
    if ref_sig != new_sig:
        raise _layout_error(what, ref_sig, new_sig)
    with torch.no_grad():
        for r, n in zip(ref, saved):
            r.copy_(n)


def _restore_torch_state(optimizer, saved):
    """A ``torch.optim`` optimizer's saved ``state_dict`` into
    ``optimizer``, once every saved state tensor of a parameter's shape
    (all but the scalar step counts) matches that parameter."""
    order = [p for g in optimizer.param_groups for p in g["params"]]
    groups = saved["param_groups"]
    ref_sig = [len(g["params"]) for g in optimizer.param_groups]
    new_sig = [len(g["params"]) for g in groups]
    if ref_sig != new_sig:
        raise _layout_error("optimizer parameter group", ref_sig, new_sig)
    ref_sig, new_sig = [], []
    for i, st in sorted(saved["state"].items()):
        for k, v in sorted(st.items()):
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                ref_sig.append(tuple(order[i].shape))
                new_sig.append(tuple(v.shape))
    if ref_sig != new_sig:
        raise _layout_error("optimizer state", ref_sig, new_sig)
    optimizer.load_state_dict(saved)
