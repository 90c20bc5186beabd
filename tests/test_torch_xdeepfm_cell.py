"""The benchmark's xDeepFM cell (``portbench``'s ``xdeepfm_criteo_kaggle``)
on the CPU at a tiny size: the port against the cell's plain reference
(predict, and the first three training steps as the check reads them), a
dry run of the cell through ``portbench.run``, the CIN's spans in a
profiled eager step, the K6 roofline's and the reference's counts worked
by hand, and the reference's imports.  The test marked ``card`` needs an
NVIDIA GPU and skips here; on the card it runs without the repository's
conftest::

    python -m pytest tests/test_torch_xdeepfm_cell.py -m card --noconftest

The tiny checkout is ``portbench.tests.tiny``'s, with a tiny xDeepFM
configuration of this file's own written into it: five fields of the tiny
DeepFM's vocabularies, E=4, the cell's CIN (no split_half, no activation)
at 8-4-4, DNN 16-8, every table on the touched-row path, float32."""

import ast
import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepctr_tpu_torch import config as pt_config
from portbench.harness import check, program, traffic, train, weights
from portbench.harness.spec import FORBIDDEN, Spec
from portbench.tests import tiny

REPO = tiny.REPO
CELL = "xdeepfm_criteo_kaggle.train_zipf"
CONFIG = REPO / "portbench/configs/xdeepfm_criteo_kaggle.json"
REFERENCE = REPO / "portbench/reference/xdeepfm_criteo_kaggle.py"
CPU = torch.device("cpu")


def tiny_xdeepfm():
    cfg = json.loads(CONFIG.read_text())
    cfg["columns"] = ([{"kind": "sparse", "name": "C%d" % (i + 1),
                        "vocab": v, "dim": 4}
                       for i, v in enumerate(tiny.TINY_FM_VOCABS)]
                      + [{"kind": "dense", "name": "I%d" % (i + 1), "dim": 1}
                         for i in range(3)])
    cfg.update(embedding_dim=4, cin_layer_size=[8, 4, 4],
               dnn_hidden_units=[16, 8], sparse_table_updates=True,
               compute_dtype="float32")
    return cfg


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE, pt_config.cin_dtype()
    yield
    pt_config._COMPUTE_DTYPE = saved[0]
    pt_config.set_cin_dtype(saved[1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(tmp_path_factory.mktemp("tiny_xdeepfm"))
    (r / "portbench/configs/xdeepfm_criteo_kaggle.json").write_text(
        json.dumps(tiny_xdeepfm()))
    return r


def test_predict_agrees_with_the_reference(root):
    spec = Spec(CELL, root)
    cfg = spec.config
    model = program.build(cfg, CPU, seed=3)
    lay = program.layout(model)
    w = weights.draw(cfg, lay, 3, CPU)
    model.load_state_dict(w)
    cols, _ = traffic.train_data(spec.traffic, cfg, 3, CPU)
    X = traffic.flat(cols, model.feature_index, spec.traffic["rows"], CPU)
    with torch.no_grad():
        got = torch.from_numpy(model.predict(X, batch_size=32))[:, 0]
        want, aux = spec.reference().forward(cfg, w, cols, training=False)
    assert aux is None
    assert torch.allclose(got.float(), want, atol=2e-6, rtol=1e-5)
    # the CIN's share of the logit is not nought at these weights
    w0 = dict(w, **{"cin_linear.weight": torch.zeros_like(
        w["cin_linear.weight"])})
    without, _ = spec.reference().forward(cfg, w0, cols, training=False)
    assert float((want - without).abs().max()) > 1e-4


def test_first_steps_agree_with_the_reference(root):
    spec = Spec(CELL, root)
    run = train.Cell(spec, 2 ** 31 + 77, CPU)
    # every state entry the cell draws is a parameter the check reads
    names = {n for n, _, is_param in run.layout if is_param}
    assert {"cin.conv_w_0", "cin.conv_w_1", "cin.conv_w_2", "cin.conv_b_0",
            "cin.conv_b_1", "cin.conv_b_2", "cin_linear.weight"} <= names
    run.free_program()
    ref = train.reference_readings(spec, run)
    numbers = check.training_numbers(run.readings, ref)
    # float32 on both sides: sums in other orders only
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3
    # the reference's gradient reaches every CIN weight
    for n in ("cin.conv_w_0", "cin.conv_w_1", "cin.conv_w_2",
              "cin_linear.weight"):
        assert ref["grad_norms"][n] > 0, n


def test_a_dry_run_is_correct_traced_and_not(root):
    """``portbench.run`` on the cell, in a process of its own (this one has
    loaded JAX, which a run refuses): ``correct`` true, traced and not,
    with the last line's shape."""
    code = (
        "import json, sys, torch\n"
        "from portbench import run\n"
        "for trace in ('0', '1'):\n"
        "    rc = run.main(['--workload', %r, '--seed', str(2 ** 31 + 3),\n"
        "                   '--seconds', '0.5', '--trace', trace],\n"
        "                  root=%r, device=torch.device('cpu'))\n"
        "    assert rc == 0, rc\n" % (CELL, str(root)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    assert len(lines) == 2
    bench = json.loads((root / "BENCHMARK.json").read_text())
    limits = json.loads((REPO / "portbench/limits" / (CELL + ".json"))
                        .read_text())
    for trace, line in enumerate(lines):
        keys = list(line)
        assert keys[:3] == ["correct", "attempted", "failed"]
        assert keys[-1] == "checks"
        assert line["correct"] is True
        assert line["attempted"] > 0 and line["failed"] == 0
        assert set(line["checks"]) == set(limits)
        if trace:
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            # no device operation runs on the CPU: no device reader reads
            assert line["metrics"] == {}
        else:
            want = {m["name"] for m in bench["end_to_end"]
                    if CELL in m.get("workloads", [CELL])}
            assert set(line["metrics"]) == want == {"train_examples_per_s",
                                                    "setup_s"}


def test_an_eager_step_records_the_cin_spans(root):
    """``cin`` inside the step's forward and one ``cin.mix`` a layer inside
    it; on the CPU the backward is autograd's through the plain version,
    so no ``cin.backward`` (``CinMix``'s, on the card only)."""
    spec = Spec(CELL, root)
    cfg = spec.config
    model = program.build(cfg, CPU, seed=5)
    program.compile_model(model, cfg)
    cols, y = traffic.train_data(spec.traffic, cfg, 5, CPU)
    x = {k: v.numpy() for k, v in cols.items()}
    B = spec.traffic["batch"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit({k: v[:B] for k, v in x.items()}, y[:B].numpy(),
                  batch_size=B, epochs=1, verbose=0)
    layers = len(cfg["cin_layer_size"])
    wanted = ("train_step.forward", "cin", "cin.mix", "cin.backward")
    spans = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name() in wanted), key=lambda e: e.start_ns())
    names = [e.name() for e in spans]
    assert names.count("cin") == 1
    assert names.count("cin.mix") == layers
    assert names.count("cin.backward") == 0
    by = {n: [e for e in spans if e.name() == n] for n in set(names)}
    cin_span = by["cin"][0]
    assert _inside(cin_span, by["train_step.forward"][0])
    assert all(_inside(e, cin_span) for e in by["cin.mix"])


def _inside(child, parent):
    return (parent.start_ns() <= child.start_ns() and
            child.start_ns() + child.duration_ns()
            <= parent.start_ns() + parent.duration_ns())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_the_cin_backward_span_on_the_card(card):
    """At bf16 on the card every layer's backward is ``CinMix``'s, inside
    one ``cin.backward`` span a layer, each inside the backward pass."""
    from deepctr_tpu_torch.layers.interaction import CIN
    pt_config.set_compute_dtype("bfloat16")
    g = torch.Generator(device=card)
    g.manual_seed(1)
    layer = CIN(5, (8, 4, 4), activation="linear", split_half=False,
                device=card, generator=g)
    x = (torch.randn(64, 5, 4, device=card, generator=g) * 0.05
         ).requires_grad_()
    for step in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = layer(x, training=True)
            with torch.profiler.record_function("backward_pass"):
                out.float().sum().backward()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    back = [e for e in events if e.name() == "cin.backward"]
    outer = [e for e in events if e.name() == "backward_pass"]
    assert len(back) == 3 and len(outer) == 1
    assert [e.name() for e in events].count("cin.mix") == 3
    assert all(_inside(e, outer[0]) for e in back)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in layer.parameters())


def _reader():
    path = REPO / "portbench/metrics/cin_mix_roofline.train.py"
    s = importlib.util.spec_from_file_location("cin_mix_roofline", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


def _reference():
    s = importlib.util.spec_from_file_location("xdeepfm_reference",
                                               REFERENCE)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


@pytest.mark.parametrize("which", ["bench", "tiny"])
def test_k6_counts_and_matmul_flops_by_hand(which):
    cfg = json.loads(CONFIG.read_text()) if which == "bench" \
        else tiny_xdeepfm()
    B = 4096 if which == "bench" else 16
    reader, ref = _reader(), _reference()
    if which == "bench":
        # layer 0: 26 fields -> 200 maps; layers 1 and 2: all 200 carried
        assert reader.cin_layers(cfg) == [(26, 200), (200, 200), (200, 200)]
        E, size = 10, 2
        want = [(size * (B * E * 26 + B * E * 26 + 200 * 26 * 26
                         + B * E * 200), 2 * B * E * 26 * 26 * 200)] + [
                (size * (B * E * 200 + B * E * 26 + 200 * 200 * 26
                         + B * E * 200), 2 * B * E * 200 * 26 * 200)] * 2
        # CIN 2,704,000 + 2 * 20,800,000 and its output layer 2 * 600; DNN
        # 273 -> 400 -> 400 -> 1
        flops = (2704000 + 2 * 20800000 + 1200
                 + 2 * (273 * 400 + 400 * 400 + 400))
    else:
        assert reader.cin_layers(cfg) == [(5, 8), (8, 4), (4, 4)]
        E, size = 4, 4
        want = [(size * (B * E * 5 + B * E * 5 + 8 * 5 * 5 + B * E * 8),
                 2 * B * E * 5 * 5 * 8),
                (size * (B * E * 8 + B * E * 5 + 4 * 8 * 5 + B * E * 4),
                 2 * B * E * 8 * 5 * 4),
                (size * (B * E * 4 + B * E * 5 + 4 * 4 * 5 + B * E * 4),
                 2 * B * E * 4 * 5 * 4)]
        flops = (2 * E * (5 * 5 * 8 + 8 * 5 * 4 + 4 * 5 * 4)
                 + 2 * (8 + 4 + 4) + 2 * (23 * 16 + 16 * 8 + 8))
    assert reader.cin_mix_counts(cfg, B) == want
    assert ref.matmul_flops(cfg, None, True) == float(flops)


def _bwd_reader():
    path = REPO / "portbench/metrics/cin_mix_bwd_roofline.train.py"
    s = importlib.util.spec_from_file_location("cin_mix_bwd_roofline", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


@pytest.mark.parametrize("which", ["bench", "tiny"])
def test_cin_bwd_counts_by_hand(which):
    """The CIN backward's least work a layer: the two products' 4 B E H F O
    operations; g, hidden, x0 and wt read once, dh, dx and dwt written
    once."""
    cfg = json.loads(CONFIG.read_text()) if which == "bench" \
        else tiny_xdeepfm()
    B = 4096 if which == "bench" else 16
    reader = _bwd_reader()
    if which == "bench":
        E, size = 10, 2
        # layer 0: 26 -> 200; layers 1 and 2: 200 -> 200, 26 fields
        want = [(size * (B * E * 200 + 2 * (B * E * 26 + B * E * 26
                                            + 26 * 26 * 200)),
                 4 * B * E * 26 * 26 * 200)] + [
                (size * (B * E * 200 + 2 * (B * E * 200 + B * E * 26
                                            + 200 * 26 * 200)),
                 4 * B * E * 200 * 26 * 200)] * 2
        # 363 GFLOP a step, 0.367 ms at 989 TFLOP/s; 141 MB, 0.042 ms
        assert sum(f for _, f in want) == 362938368000
        assert sum(b for b, _ in want) == 140588160
    else:
        E, size = 4, 4
        want = [(size * (B * E * 8 + 2 * (B * E * 5 + B * E * 5 + 5 * 5 * 8)),
                 4 * B * E * 5 * 5 * 8),
                (size * (B * E * 4 + 2 * (B * E * 8 + B * E * 5 + 8 * 5 * 4)),
                 4 * B * E * 8 * 5 * 4),
                (size * (B * E * 4 + 2 * (B * E * 4 + B * E * 5 + 4 * 5 * 4)),
                 4 * B * E * 4 * 5 * 4)]
    assert reader.cin_mix_bwd_counts(cfg, B) == want
    # the forward's operations, twice: the backward's two products
    fwd = _reader().cin_mix_counts(cfg, B)
    assert [2 * f for _, f in fwd] == [f for _, f in want]


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    tree = ast.parse(REFERENCE.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module)
    assert tops == {"torch", "portbench.reference._common"}
    assert not {t.split(".")[0] for t in tops} & (set(FORBIDDEN)
                                                   | {"deepctr_tpu_torch"})
    # the shared helpers it reads import torch alone
    common = ast.parse((REPO / "portbench/reference/_common.py").read_text())
    assert {a.name for n in ast.walk(common) if isinstance(n, ast.Import)
            for a in n.names} == {"torch"}
    assert not any(isinstance(n, ast.ImportFrom) for n in ast.walk(common))


def test_the_config_keeps_the_published_widths():
    cfg = json.loads(CONFIG.read_text())
    sparse = [c for c in cfg["columns"] if c["kind"] == "sparse"]
    assert [c["vocab"] for c in sparse] == cfg["vocabulary_sizes"]
    assert len(sparse) == 26 and sum(cfg["vocabulary_sizes"]) == 33762577
    assert {c["dim"] for c in sparse} == {cfg["embedding_dim"]} == {10}
    # section 4.1.3's Criteo widths: 200 maps a CIN layer, 400 units a DNN
    # layer; every map goes on (no split_half), no activation
    assert cfg["cin_layer_size"] == [200, 200, 200]
    assert cfg["cin_split_half"] is False
    assert cfg["cin_activation"] == "linear"
    assert cfg["dnn_hidden_units"] == [400, 400]
    assert (cfg["optimizer"], cfg["learning_rate"]) == ("adam", 0.001)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "xdeepfm_criteo_kaggle")
    assert entry["reduced"] == ["dnn_dropout"]
    assert set(cfg["assumed"]) >= {"cin_layer_size", "cin_split_half",
                                   "cin_activation", "dnn_hidden_units",
                                   "l2", "cin_bias", "cin_dtype"}
    # every state entry of the model has an init rule (weights.draw raises
    # where one has none)
    model = program.build(tiny_xdeepfm(), CPU, seed=1)
    w = weights.draw(cfg, program.layout(model), 1, CPU)
    assert not torch.count_nonzero(w["cin.conv_b_0"])
    np.testing.assert_allclose(float(w["cin.conv_w_0"].std()),
                               1 / np.sqrt(25), rtol=0.3)
