"""The harness's plumbing on the CPU at a tiny size: the last line's shape
for every cell, traced and not; no result without a card; a new mix added
as files and entries alone; nothing of JAX loaded, and nothing of the
program imported by the references."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.harness.spec import FORBIDDEN
from portbench.tests import tiny

REPO = tiny.REPO
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


def _dry_run(root, cell, trace, capsys, seed=2 ** 31 + 3):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], root=root,
                  device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_shape(tiny_root, cell, trace, capsys):
    line, err = _dry_run(tiny_root, cell, trace, capsys)
    keys = list(line)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no device operation runs: no reader of the device
        # trace finds anything
        host = {m["name"] for m in bench["per_layer"]
                if m["source"] != "device_trace"}
        assert set(line["metrics"]) <= host
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    # each number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(t.startswith("check %s " % name) for t in tail)


def test_a_new_mix_needs_no_edit(tiny_root, tmp_path, capsys):
    root = tiny.make_root(tmp_path / "root")
    mix = tiny.tiny_traffic("train_zipf")
    mix["by_kind"]["sparse"] = {"draw": "uniform"}
    (root / "portbench/traffic/train_uniform.json").write_text(
        json.dumps(mix))
    cell = "deepfm_criteo_kaggle.train_uniform"
    (root / "portbench/limits" / (cell + ".json")).write_text("{}")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": cell, "config": "deepfm_criteo_kaggle",
        "traffic": "train_uniform", "chips": 1, "why": "uniform ids"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deepfm_criteo_kaggle.train_zipf" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = _dry_run(root, cell, 0, capsys)
    assert "train_examples_per_s" in line["metrics"]


def _subprocess(code, cwd):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_dry_run_loads_nothing_of_jax(tiny_root):
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.harness.spec import forbidden_modules\n"
        "rc = run.main(['--workload', 'dien_amazon_books.train', '--seed', "
        "'5', '--seconds', '0.2', '--trace', '0'], root=%r, "
        "device=torch.device('cpu'))\n"
        "assert rc == 0, rc\n"
        "assert 'deepctr_tpu_torch' in sys.modules\n"
        "print('FORBIDDEN', forbidden_modules())\n" % str(tiny_root))
    proc = _subprocess(code, REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    argv = ["-m", "portbench.run", "--workload",
            "deepfm_criteo_kaggle.train_zipf", "--seed", "1", "--seconds",
            "1", "--trace", "0"]
    proc = subprocess.run([sys.executable] + argv, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    # a directory that holds only BENCHMARK.json and the files under paths
    alone = tmp_path / "alone"
    alone.mkdir()
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", alone)
    shutil.copytree(REPO / "portbench", alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable] + argv, cwd=alone,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert files
    for f in files:
        tops = _imports(f)
        assert not tops & set(FORBIDDEN), f
        # nothing reads the JAX package's benchmark or its tools
        assert not tops & {"bench", "tools", "chip_smoke"}, f
        if "reference" in f.parts:
            assert tops <= {"torch", "numpy", "re", "portbench"}, f
    ref_imports = set()
    for f in (REPO / "portbench/reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                ref_imports.add(node.module)
    assert all(m.startswith("portbench.reference") for m in ref_imports
               if m.startswith("portbench"))


def test_check_steps_go_through_the_window_loop(tiny_root):
    """The first steps run in the loop the window replays, on the rows its
    shuffled permutation gave them; a later fit over the whole data finds
    that same loop."""
    from portbench.harness import train
    from portbench.harness.spec import Spec
    spec = Spec("deepfm_criteo_kaggle.train_zipf", tiny_root)
    cell = train.Cell(spec, 2 ** 31 + 41, torch.device("cpu"))
    B = cell.B
    rows = cell.rows.tolist()
    assert len(rows) == train.CHECK_STEPS * B == len(set(rows))
    assert rows != list(range(len(rows)))
    assert rows == cell.loop.perm[:len(rows)].tolist()
    assert len(cell.readings["losses"]) == train.CHECK_STEPS
    cell.model.fit(cell.X, cell.y, batch_size=B, epochs=1, verbose=0,
                   shuffle=True)
    assert cell.window_loop_is_checked()
