"""Each plain reference agrees with ``deepctr_tpu_torch`` at a tiny size on
the CPU, in float32: the forward (predict and the training forward), and
three training steps read as the check reads them."""

import pytest
import torch

import deepctr_tpu_torch as pt
from portbench.harness import check, program, traffic, train, weights
from portbench.harness.spec import Spec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def float32_compute():
    yield
    pt.set_compute_dtype("float32")


def _spec(tiny_root, cell):
    spec = Spec(cell, tiny_root)
    spec.config["compute_dtype"] = "float32"
    return spec


@pytest.mark.parametrize("config,mix", [("deepfm_criteo_kaggle", "train_zipf"),
                                        ("dien_amazon_books", "train")])
def test_forward_agrees(tiny_root, config, mix):
    spec = _spec(tiny_root, "%s.%s" % (config, mix))
    cfg = spec.config
    model = program.build(cfg, CPU, seed=3)
    lay = program.layout(model)
    w = weights.draw(cfg, lay, 3, CPU)
    model.load_state_dict(w)
    cols, _ = traffic.train_data(spec.traffic, cfg, 3, CPU)
    X = traffic.flat(cols, model.feature_index, spec.traffic["rows"], CPU)
    ref = spec.reference()
    with torch.no_grad():
        got = torch.from_numpy(model.predict(X, batch_size=32))[:, 0]
        want, _ = ref.forward(cfg, w, cols, training=False)
    assert torch.allclose(got.float(), want, atol=2e-6, rtol=1e-5)
    # the columns read back from the flat input are those drawn
    back = traffic.columns_of(X, model.feature_index, cfg)
    for k, v in cols.items():
        assert torch.equal(back[k].to(v.dtype), v)


@pytest.mark.parametrize("cell", ["deepfm_criteo_kaggle.train_zipf",
                                  "dien_amazon_books.train"])
def test_first_steps_agree(tiny_root, cell):
    spec = _spec(tiny_root, cell)
    run = train.Cell(spec, 2 ** 31 + 77, CPU)
    run.free_program()
    ref = train.reference_readings(spec, run)
    numbers = check.training_numbers(run.readings, ref)
    # float32 on both sides: sums in other orders only
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3


def test_serving_scores_agree(tiny_root):
    from portbench.harness import serve
    spec = _spec(tiny_root, "dien_amazon_books.serve")
    run = serve.Cell(spec, 12345, CPU)
    run.window(0, count=2 * len(run.pool))
    run.free_program()
    gap = serve.score_gap(run.answers, serve.reference_scores(spec, run))
    assert gap < 1e-5
