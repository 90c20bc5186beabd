"""The control (the plain reference with float8 operands in the program's
place, the precision below the configuration's bfloat16) and the planted
faults read far above the sound program: at a tiny size on the CPU, and
at the cells' own sizes against their limits on the card
(``python -m pytest portbench/tests -m card``)."""

import pytest
import torch

import deepctr_tpu_torch as pt
from portbench import control
from portbench.harness import check
from portbench.harness.spec import Spec
from portbench.tests import tiny

CELLS = ["deepfm_criteo_kaggle.train_zipf", "dien_amazon_books.train",
         "dien_amazon_books.serve"]


@pytest.fixture(autouse=True)
def float32_compute_after():
    yield
    pt.set_compute_dtype("float32")


def _readings(spec, seed, device, count=None):
    if spec.traffic["driver"] == "train":
        return dict(control.train_readings(spec, seed, device, True))
    return dict(control.serve_readings(spec, seed, device, True, 2.0, count))


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(tiny_root, cell):
    spec = Spec(cell, tiny_root)
    # every request of the pool answered, however loaded the CPU is
    rows = _readings(spec, 2 ** 31 + 21, torch.device("cpu"),
                     count=2 * spec.traffic.get("pool", 0) or None)
    sound = rows.pop("sound")
    for kind, numbers in rows.items():
        assert any(numbers[k] >= 3.0 * max(sound[k], 1e-12)
                   for k in sound), (kind, numbers, sound)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(card, cell):
    spec = Spec(cell, tiny.REPO)
    rows = _readings(spec, 2 ** 31 + 23, card)
    assert check.judge(rows.pop("sound"), spec.limits)[0]
    for kind, numbers in rows.items():
        assert not check.judge(numbers, spec.limits)[0], (kind, numbers)
