"""What a run is made of, found by name under a checkout's root: the cell
in ``BENCHMARK.json``, its configuration, its traffic mix, its limits, its
plain reference and the readers of its per-layer metrics."""

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# top-level module names that may not be loaded in a run's process: the
# JAX package and what it runs on (compared whole: the port's own name,
# deepctr_tpu_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepctr_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """One cell of the benchmark under ``root`` (a checkout)."""

    def __init__(self, workload, root=ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit("no workload %r in BENCHMARK.json (%s)"
                             % (workload, ", ".join(sorted(cells))))
        self.cell = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic = self._json("traffic", self.cell["traffic"])
        self.limits = self._json("limits", workload)
        self.chips = int(self.cell["chips"])

    def _json(self, folder, name):
        return json.loads((self.root / "portbench" / folder
                           / ("%s.json" % name)).read_text())

    def reference(self):
        """The configuration's plain reference module."""
        name = self.cell["config"]
        return _load_file(self.root / "portbench" / "reference"
                          / ("%s.py" % name), "portbench_reference_" + name)

    def metrics(self, kind):
        """``[(name, unit, reader module)]`` of the cell's metrics of
        ``kind`` (``end_to_end`` or ``per_layer``): those that list this
        cell, or list no cells and move an end-to-end metric the cell
        reports.  End-to-end metrics have no reader (None)."""
        e2e = {m["name"] for m in self._listed("end_to_end")}
        out = []
        for m in self._listed(kind):
            if kind == "per_layer" and m["moves"] not in e2e:
                continue
            reader = None
            if kind == "per_layer":
                reader = _load_file(
                    self.root / "portbench" / "metrics"
                    / ("%s.py" % m["name"]),
                    "portbench_metric_" + m["name"].replace(".", "_"))
            out.append((m["name"], m["unit"], reader))
        return out

    def _listed(self, kind):
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]
