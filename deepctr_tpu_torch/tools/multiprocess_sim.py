"""Ranks of one machine joined into one mesh: the multi-process path
without a cluster.

Counterpart of ``tools/multiprocess_sim.py``.  :func:`spawn` starts one
process a rank (``python -m deepctr_tpu_torch.tools.multiprocess_sim
--rank ...``), each of which joins the process group through a file store
in the run's directory (``distributed.initialize``, a 60 s timeout on
every collective), calls a target function and writes what it returns to
``rank<r>.pt`` there; a rank that fails or outlives the wall-clock limit
ends every rank and raises.  Ranks run on the card by default (gloo with
CUDA tensors puts them all on one card, which NCCL refuses); ``device=
"cpu"`` runs them on the CPU, and a CUDA device without CUDA raises.

Run as a program, it is the check of the multi-process path: each rank
builds the mesh, takes its host-local rows of a global batch
(``distributed.host_local_rows`` and ``global_batch_from_host_local``),
trains DeepFM on them for a few steps with row-sharded tables and
predicts the whole set::

    python -m deepctr_tpu_torch.tools.multiprocess_sim --out /tmp/sim
    python -m deepctr_tpu_torch.tools.multiprocess_sim --mesh 2,1 \\
        --device cpu --out /tmp/sim

Each rank's predictions, losses and table blocks go into ``--out``; the
program exits 0 when every rank finished and all predict the same, else 1.
The workers import neither JAX nor the JAX package.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
import uuid

import numpy as np
import torch

PG_TIMEOUT = 60


def _target(spec):
    """``"module:function"`` or ``"path/to/file.py:function"``."""
    where, name = spec.rsplit(":", 1)
    if where.endswith(".py"):
        mod_spec = importlib.util.spec_from_file_location(
            "_sim_target_%s" % uuid.uuid4().hex, where)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def spawn(target, n_ranks, out_dir, kwargs=None, timeout=120,
          backend="gloo", device="cuda"):
    """Run ``target(rank=, world=, device=, **kwargs)`` in ``n_ranks``
    processes joined into one process group; returns what each returned,
    by rank.  ``target`` is ``"module:function"`` or ``"file.py:function"``;
    ``kwargs`` are saved with ``torch.save`` and loaded by every rank.
    Raises RuntimeError, with the ranks' output, when a rank fails or the
    run outlasts ``timeout`` seconds (every rank is then ended), and
    before it starts one when ``device`` is CUDA's and CUDA is missing."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the ranks on the CPU")
    os.makedirs(out_dir, exist_ok=True)
    run = uuid.uuid4().hex[:12]
    args_path = os.path.join(out_dir, "args-%s.pt" % run)
    torch.save(kwargs or {}, args_path)
    store = os.path.join(out_dir, "store-%s" % run)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    logs = [os.path.join(out_dir, "rank%d-%s.log" % (r, run))
            for r in range(n_ranks)]
    procs = []
    for r in range(n_ranks):
        cmd = [sys.executable, "-m", "deepctr_tpu_torch.tools.multiprocess_sim",
               "--rank", str(r), "--world", str(n_ranks), "--target", target,
               "--args", args_path, "--store", store, "--backend", backend,
               "--device", device, "--out", out_dir]
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = "rank %d exited with %d" % (
                    bad[0], procs[bad[0]].returncode)
                break
            if time.monotonic() > deadline:
                failed = "the ranks outlasted %d s" % timeout
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = "rank %d exited with %d" % (
                    bad[0], procs[bad[0]].returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed:
        text = []
        for r, path in enumerate(logs):
            with open(path) as f:
                text.append("--- rank %d ---\n%s" % (r, f.read()[-4000:]))
        raise RuntimeError("%s\n%s" % (failed, "\n".join(text)))
    return [torch.load(os.path.join(out_dir, "rank%d-%s.pt" % (r, run)),
                       weights_only=False)
            for r in range(n_ranks)]


def _rank_main(a):
    """One rank: join the group, run the target, save its result."""
    torch.set_num_threads(1)
    from deepctr_tpu_torch.parallel import distributed
    distributed.initialize(init_method="file://" + a.store,
                           world_size=a.world, rank=a.rank,
                           backend=a.backend, timeout=PG_TIMEOUT)
    try:
        kwargs = torch.load(a.args, weights_only=False)
        result = _target(a.target)(rank=a.rank, world=a.world,
                                   device=a.device, **kwargs)
        run = os.path.basename(a.args)[len("args-"):-len(".pt")]
        torch.save(result, os.path.join(a.out, "rank%d-%s.pt"
                                        % (a.rank, run)))
    finally:
        torch.distributed.destroy_process_group()


def deepfm_worker(rank, world, device, mesh_shape, steps=3, batch=32):
    """The program's rank: DeepFM with row-sharded tables on the mesh
    ``mesh_shape``, ``steps`` adagrad steps on this rank's host-local rows
    of one global batch, then predict of the whole set."""
    from deepctr_tpu_torch import DenseFeat, SparseFeat
    from deepctr_tpu_torch.models import DeepFM
    from deepctr_tpu_torch.parallel import distributed, make_mesh
    mesh = make_mesh(mesh_shape, devices=torch.device(device).type)
    cols = [SparseFeat("c0", 64, 8), SparseFeat("c1", 32, 8),
            DenseFeat("d0", 1)]
    model = DeepFM(cols, cols, dnn_hidden_units=(16,), seed=3, mesh=mesh,
                   shard_embeddings=True, device=device)
    model.compile("adagrad", "binary_crossentropy")
    rng = np.random.default_rng(0)
    x = {"c0": rng.integers(0, 64, batch), "c1": rng.integers(0, 32, batch),
         "d0": rng.random(batch)}
    X_all = model._assemble_x(x)
    y_all = rng.integers(0, 2, batch).astype(np.float32)[:, None]
    sw_all = np.ones((batch,), np.float32)
    lo, hi = distributed.host_local_rows(batch, mesh)
    X, y, sw = distributed.global_batch_from_host_local(
        mesh, X_all[lo:hi], y_all[lo:hi], sw_all[lo:hi], device=device)
    model._begin_steps(steps)
    losses = [float(model._train_step(X, y, sw)[1]) for _ in range(steps)]
    return {"rank": rank, "rows": (lo, hi), "losses": losses,
            "pred": model.predict(x, batch_size=batch),
            "tables": {k: tuple(v.shape)
                       for k, v in model.state_dict().items()
                       if ".tables." in k}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--mesh", default="1,2",
                   help="n_data,n_model; their product is --ranks")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cuda",
                   help="the ranks' device: cuda (all on one card), or cpu")
    p.add_argument("--timeout", type=int, default=300)
    p.add_argument("--out", required=True)
    # one rank of a run that spawn() started
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--target")
    p.add_argument("--args")
    p.add_argument("--store")
    a = p.parse_args(argv)
    if a.rank is not None:
        try:
            _rank_main(a)
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        return 0
    shape = tuple(int(s) for s in a.mesh.split(","))
    try:
        results = spawn("deepctr_tpu_torch.tools.multiprocess_sim:"
                        "deepfm_worker", a.ranks, a.out,
                        {"mesh_shape": shape, "steps": a.steps},
                        timeout=a.timeout, backend=a.backend,
                        device=a.device)
    except RuntimeError as err:
        print(err)
        print("MULTIPROCESS SIM FAILED")
        return 1
    preds = [r["pred"] for r in results]
    same = all(np.array_equal(preds[0], q) for q in preds[1:])
    summary = {"mesh": shape, "backend": a.backend, "device": a.device,
               "losses": [r["losses"] for r in results],
               "rows": [list(r["rows"]) for r in results],
               "tables": [r["tables"] for r in results],
               "predictions_agree": bool(same),
               "finite": bool(all(np.isfinite(q).all() for q in preds))}
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=list)
    print(json.dumps(summary, default=list))
    if not (same and summary["finite"]):
        print("MULTIPROCESS SIM DIVERGED")
        return 1
    print("MULTIPROCESS SIM OK (%d ranks, mesh %s)" % (a.ranks, a.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
