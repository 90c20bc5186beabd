"""The rank side of the port's mesh tests: model legs that a test runs on
gloo ranks (``deepctr_tpu_torch.tools.multiprocess_sim.spawn``) and, for
its references, in the test process.  Imports neither JAX nor the JAX
package, so that a rank starts in a few seconds; the columns and models
are built from plain specs with either package.

A leg is a dict: ``model`` (``"DeepFM"``, ``"DIN"``, ``"DIEN"``,
``"MMOE"``, ``"PLE"``), ``cols`` (specs: ``("sparse", name, vocab,
dim)``, ``("dense", name, dim)``, ``("varlen", name, vocab, dim, maxlen,
embedding name or None, length name or None[, combiner])``), ``kw``
(constructor arguments), ``optimizer``, ``sparse``
(``sparse_table_updates``), ``epochs``, ``batch``, ``exchange`` (None or
``(mode, slack, on_overflow)``), ``threshold`` (the packing threshold, or
None), ``fit`` (False: predict only) and ``weights`` (the key of the JAX
weights it loads).  A streamed leg fits ``x`` in ``chunks`` (their row
counts) through ``fit(x=callable)``, with ``steps_per_epoch``; any leg
may name ``metrics``, ``verbose``, ``shuffle`` and ``validation`` (a
``(first, stop)`` row range of its data).  ``steps`` records each step's
``(data loss, total loss)``; ``local_count`` runs DIEN's auxiliary loss
over each rank's own count of pairs (the mistake the pair-count witness
must catch); ``adam_t`` sets ``config.set_adam_t`` for the leg, and the
leg then returns each sparse table's per-row counts (``counts``)."""

import os
import types

import torch

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import config, inputs, serving
from deepctr_tpu_torch.models import dien, multitask
from deepctr_tpu_torch.parallel import make_mesh
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights


def columns(pkg, specs):
    """Feature columns of ``pkg`` (``deepctr_tpu`` or the port)."""
    out = []
    for spec in specs:
        if spec[0] == "sparse":
            out.append(pkg.SparseFeat(spec[1], spec[2], spec[3]))
        elif spec[0] == "dense":
            out.append(pkg.DenseFeat(spec[1], spec[2]))
        else:
            name, vocab, dim, maxlen, emb, length = spec[1:7]
            extra = {"combiner": spec[7]} if len(spec) > 7 else {}
            out.append(pkg.VarLenSparseFeat(
                pkg.SparseFeat(name, vocab, dim, embedding_name=emb),
                maxlen=maxlen, length_name=length, **extra))
    return out


MULTITASK = ("MMOE", "PLE")


def make_model(pkg, models, leg, **kw):
    """The leg's model from ``pkg``'s columns and ``models`` (its models
    module, or its multitask module for MMOE and PLE)."""
    cols = columns(pkg, leg["cols"])
    cls = getattr(models, leg["model"])
    if leg["model"] == "DeepFM":
        args = (cols, cols)
    elif leg["model"] in ("DIN", "DIEN"):
        args = (cols, leg["history"])
    else:
        args = (cols,)
    return cls(*args, **dict(leg.get("kw", {}), **kw))


def loss_of(leg):
    if leg["model"] in MULTITASK:
        return ["binary_crossentropy", "binary_crossentropy"]
    return "binary_crossentropy"


def chunked(x, y, sizes):
    """A zero-argument callable over consecutive chunks of ``sizes`` rows
    of ``(x, y)``, as ``fit(x=callable)`` takes it."""
    bounds = [0]
    for n in sizes:
        bounds.append(bounds[-1] + n)

    def make_iter():
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            yield {k: v[lo:hi] for k, v in x.items()}, y[lo:hi]
    return make_iter


def fit_leg(model, leg, x, y):
    """``fit`` as the leg says (streamed where it has ``chunks``); returns
    the history."""
    kw = dict(batch_size=leg["batch"], epochs=leg.get("epochs", 1),
              verbose=leg.get("verbose", 0), shuffle=leg.get("shuffle", True))
    if leg.get("validation"):
        lo, hi = leg["validation"]
        kw["validation_data"] = ({k: v[lo:hi] for k, v in x.items()},
                                 y[lo:hi])
    if leg.get("chunks"):
        return model.fit(chunked(x, y, leg["chunks"]),
                         steps_per_epoch=leg.get("steps_per_epoch"), **kw)
    return model.fit(x, y, **kw)


def _record_steps(model):
    """Each train step's ``(data loss, total loss)``, as floats, appended
    to the returned list."""
    steps = []
    step = model._train_step

    def recorded(*args):
        out = step(*args)
        steps.append((float(out[0]), float(out[1])))
        return out
    model._train_step = recorded
    return steps


def run_leg(leg, x, y, weights, mesh=None, device="cpu"):
    """Train (``fit``) and predict the leg; returns its losses, its
    predictions, the table blocks it holds and their shapes."""
    saved = (inputs.PACKED_VOCAB_THRESHOLD, config.embedding_exchange(),
             config.a2a_on_overflow(), dien.context, config.adam_t())
    try:
        config.set_adam_t(leg.get("adam_t", "table"))
        if leg.get("local_count"):
            dien.context = types.SimpleNamespace(data_sum=lambda t: t)
        if leg.get("threshold"):
            inputs.PACKED_VOCAB_THRESHOLD = leg["threshold"]
        exchange = leg.get("exchange")
        if exchange and mesh is not None:
            config.set_embedding_exchange(exchange[0], mesh,
                                          a2a_slack=exchange[1],
                                          on_overflow=exchange[2])
        models = multitask if leg["model"] in MULTITASK else pt.models
        model = make_model(pt, models, leg, seed=3, device=device,
                           mesh=mesh, shard_embeddings=mesh is not None)
        load_jax_weights(model, weights)
        out = {"loss": None}
        if leg.get("fit", True):
            model.compile(leg["optimizer"], loss_of(leg),
                          metrics=leg.get("metrics"),
                          sparse_table_updates=leg.get("sparse", False))
            if leg.get("steps"):
                out["steps"] = _record_steps(model)
            hist = fit_leg(model, leg, x, y)
            model.__dict__.pop("_train_step", None)
            out["loss"] = hist.history["loss"]
            out["history"] = hist.history
            out["state"] = {p: [tuple(t.shape) for t in st]
                            for p, st in model._table_state.items()}
            if leg.get("adam_t") == "rowwise":
                out["counts"] = {p: st[2].clone()
                                 for p, st in model._table_state.items()}
            out["dense_state"] = {
                p: [tuple(t.shape) for t in st]
                for p, st in zip(model._dense_paths, model._dense_opt.state)
                if p in model._shards}
        out["pred"] = model.predict(x, leg["batch"])
        out["blocks"] = {p: s[:2] for p, s in model._shards.items()}
        out["local"] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        return out
    finally:
        inputs.PACKED_VOCAB_THRESHOLD = saved[0]
        config._EMBEDDING_EXCHANGE, config._EXCHANGE_MESH, \
            config._A2A_SLACK = saved[1]
        config._A2A_ON_OVERFLOW = saved[2]
        dien.context = saved[3]
        config.set_adam_t(saved[4])


def run_legs(rank, world, device, mesh_shape, legs, data, weights):
    """A rank: every leg on one mesh; ``data`` maps a leg's ``data`` key
    to its ``(x, y)``."""
    mesh = make_mesh(mesh_shape, devices="cpu")
    return [run_leg(leg, *data[leg["data"]], weights[leg["weights"]],
                    mesh=mesh, device=device) for leg in legs]


def sharded_persistence(rank, world, device, mesh_shape, leg, x, y,
                        directory):
    """A rank: the leg's model (seed 3) on the mesh with row-sharded
    tables, one epoch, then ``save_checkpoint`` (rank 0 writes) and its
    weights; then a fresh model on the mesh (seed 5) loads the checkpoint
    back and predicts."""
    mesh = make_mesh(mesh_shape, devices="cpu")
    model = make_model(pt, pt.models, leg, seed=3, device=device, mesh=mesh,
                       shard_embeddings=True)
    model.compile(leg["optimizer"], loss_of(leg),
                  sparse_table_updates=leg.get("sparse", False))
    model.fit(x, y, batch_size=leg["batch"], epochs=1, verbose=0)
    model.save_checkpoint(directory)
    torch.distributed.barrier()
    full = model.get_weights()
    again = make_model(pt, pt.models, leg, seed=5, device=device, mesh=mesh,
                       shard_embeddings=True)
    again.compile(leg["optimizer"], loss_of(leg),
                  sparse_table_updates=leg.get("sparse", False))
    again.load_checkpoint(directory)
    return {"full": full, "pred": model.predict(x, leg["batch"]),
            "pred_loaded": again.predict(x, leg["batch"]),
            "state": {p: [t.clone() for t in st]
                      for p, st in again._table_state.items()},
            "blocks": {p: s[:2] for p, s in model._shards.items()}}


def export_on_mesh(rank, world, device, mesh_shape, leg, x, y, weights,
                   directory):
    """A rank: the leg's model on the mesh with row-sharded tables, from
    the JAX weights, fitted as the leg says; then ``export_predict`` and
    ``save_exported`` to ``rank<r>.pt2``, and ``save`` to
    ``model<r>.pt`` (every rank calls both, rank 0 writes).  Returns the
    mesh's predictions, the artifact's in this rank and the shapes of the
    artifact's weights."""
    mesh = make_mesh(mesh_shape, devices="cpu")
    model = make_model(pt, pt.models, leg, seed=3, device=device, mesh=mesh,
                       shard_embeddings=True)
    load_jax_weights(model, weights)
    model.compile(leg["optimizer"], loss_of(leg))
    fit_leg(model, leg, x, y)
    exported = serving.export_predict(model)
    serving.save_exported(exported,
                          os.path.join(directory, "rank%d.pt2" % rank))
    model.save(os.path.join(directory, "model%d.pt" % rank))
    torch.distributed.barrier()
    X = torch.from_numpy(model._assemble_x(x))
    return {"pred": model.predict(x, leg["batch"]),
            "exported": exported.call(X).numpy(),
            "blocks": {p: s[:2] for p, s in model._shards.items()},
            "shapes": {k: tuple(v.shape) for k, v in
                       exported.program.state_dict.items()}}


def optimizer_object(name, model):
    """A ``torch.optim`` optimizer over ``model``'s parameters:
    ``"Adagrad"`` at lr 0.01 or ``"Adam"`` at lr 0.001."""
    lr = {"Adagrad": 0.01, "Adam": 0.001}[name]
    return getattr(torch.optim, name)(model.parameters(), lr=lr)


def optim_checkpoint(rank, world, device, mesh_shape, leg, x, y, directory,
                     optimizer):
    """A rank: the leg's model (seed 3) on the mesh with row-sharded
    tables under a ``torch.optim`` ``optimizer``, one epoch, then
    ``save_checkpoint`` (rank 0 writes) and a second epoch; a fresh model
    (seed 3 again: the seed also draws the shuffle) loads the checkpoint
    and takes the second epoch too.  Returns both runs' second-epoch
    loss, predictions, weights and optimizer state."""
    mesh = make_mesh(mesh_shape, devices="cpu")

    def build():
        model = make_model(pt, pt.models, leg, seed=3, device=device,
                           mesh=mesh, shard_embeddings=True)
        model.compile(optimizer_object(optimizer, model), loss_of(leg))
        return model

    def second_epoch(model):
        hist = model.fit(x, y, batch_size=leg["batch"], epochs=2,
                         initial_epoch=1, verbose=0)
        return {"loss": hist.history["loss"][-1],
                "pred": model.predict(x, leg["batch"]),
                "weights": model.get_weights(),
                "state": [t.clone() for st in model._dense_opt.state
                          for t in st]}
    whole = build()
    whole.fit(x, y, batch_size=leg["batch"], epochs=1, verbose=0)
    whole.save_checkpoint(directory)
    torch.distributed.barrier()
    resumed = build()
    resumed.load_checkpoint(directory)
    return {"whole": second_epoch(whole), "resumed": second_epoch(resumed),
            "blocks": {p: s[:2] for p, s in whole._shards.items()}}


def raise_on_rank_one(rank, world, device):
    """A rank 1 that raises while rank 0 waits in a collective."""
    mesh = make_mesh((world, 1), devices="cpu")
    del mesh
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def lookups(rank, world, device, cases):
    """A rank: ``psum_lookup``/``a2a_lookup`` of each case on a ``(1,
    world)`` mesh: the rank's block of the case's table, its ids; returns
    the rows, the dropped counts and the block's gradient of
    ``sum(sin(rows))``."""
    from deepctr_tpu_torch.parallel.embedding import a2a_lookup, psum_lookup
    mesh = make_mesh((1, world), devices="cpu")
    out = []
    for table, ids, kind, slack in cases:
        table = torch.as_tensor(table)
        per = table.shape[0] // world
        block = table[rank * per:(rank + 1) * per].clone().requires_grad_()
        ids = torch.as_tensor(ids)
        if kind == "psum":
            rows = psum_lookup(mesh, block, ids)
            dropped = None
        else:
            rows, dropped = a2a_lookup(mesh, block, ids, slack=slack,
                                       return_overflow=True)
            dropped = int(dropped)
        torch.sin(rows).sum().backward()
        out.append({"rows": rows.detach().numpy(), "dropped": dropped,
                    "grad": block.grad.numpy()})
    return out


def mesh_layout(rank, world, device, tables):
    """A rank of a ``(world / 2, 2)`` mesh from ``distributed.
    global_mesh``: its coordinates, its rows of a global batch of 8 and of
    a replicated tensor of 10, its rows of each ``(vocab, width)`` table
    in ``tables`` (``embedding_sharding``), and the errors of a batch of 7
    and of a model axis that does not divide the ranks."""
    from deepctr_tpu_torch.parallel import (batch_sharding, distributed,
                                            embedding_sharding, replicated)
    mesh = distributed.global_mesh(model_axis=2, devices="cpu")
    errors = []
    for bad in (lambda: batch_sharding(mesh, 7),
                lambda: distributed.global_mesh(model_axis=3,
                                                devices="cpu")):
        try:
            bad()
        except ValueError as err:
            errors.append(str(err))
    return {"shape": tuple(mesh.mesh.shape),
            "coordinate": tuple(mesh.get_coordinate()),
            "batch": batch_sharding(mesh, 8), "replicated":
            replicated(mesh, 10),
            "tables": [embedding_sharding(mesh, v, w) for v, w in tables],
            "errors": errors}
