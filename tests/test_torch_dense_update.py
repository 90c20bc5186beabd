"""The dense parameters' optimizer step in one launch
(``deepctr_tpu_torch/ops/dense_update.py``, ``csrc/dense_update.cu``).

On the CPU: the plain version against the step it replaced in
``DenseOptimizer.step`` (kept here as it was), bit for bit; the launch
plan expanded as the kernel walks it; the argument structs against the
kernel's source.  The tests marked ``card`` need an NVIDIA GPU and skip
here; on the card they run without the repository's conftest, which
imports JAX:

    python -m pytest tests/test_torch_dense_update.py -m card --noconftest
"""

import copy
import ctypes
import re
import types

import numpy as np
import pytest
import torch

from deepctr_tpu_torch.models import basemodel
from deepctr_tpu_torch.ops import _build
from deepctr_tpu_torch.ops._args import DeviceArgs
from deepctr_tpu_torch.ops import dense_update as DU
from deepctr_tpu_torch.ops import row_update as RU

MODES = ("sgd", "adagrad", "rmsprop", "adam")
SHAPES = ((1,), (3,), (4,), (5,), (1023,), (400, 273))
LR = {"sgd": 0.01, "adagrad": 0.0123, "rmsprop": 0.01, "adam": 0.001}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@torch.no_grad()
def _old_step(name, lr, params, state, bias=None):
    """``DenseOptimizer.step`` before the multi-tensor kernel, verbatim."""
    if name == "adam" and params:
        bc1, bc2 = bias[0], bias[1]
    for p, st in zip(params, state):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if name == "sgd":
            u = -lr * g
        elif name == "adagrad":
            st[0].add_(g * g)
            u = -lr * g / (torch.sqrt(st[0]) + RU.ADAGRAD_EPS)
        elif name == "rmsprop":
            v = st[0]
            v.copy_(RU.RMS_DECAY * v + (1 - RU.RMS_DECAY) * (g * g))
            u = -lr * g / (torch.sqrt(v) + RU.RMS_EPS)
        else:
            m, v = st
            b1, b2 = RU.ADAM_B1, RU.ADAM_B2
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + RU.ADAM_EPS))
        p.add_(u)


def _problem(name, shapes, seed, device="cpu", offsets=None):
    """Parameters, a state tuple each (random, the sums non-negative) and
    adam's bias pair at step 3."""
    rng = np.random.default_rng(seed)
    n_state = RU.MODES[name][1]
    params, states = [], []
    for i, shape in enumerate(shapes):
        n = int(np.prod(shape))
        off = offsets[i] if offsets else 0
        buf = torch.empty(n + off, device=device)
        p = buf[off:].view(shape)
        p.copy_(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
        params.append(p)
        st = []
        for j in range(n_state):
            a = rng.normal(size=shape).astype(np.float32)
            if j == n_state - 1 and name != "sgd":
                a = a * a      # adagrad's and rmsprop's sum, adam's v
            s = torch.empty(n + off, device=device)[off:].view(shape)
            st.append(s.copy_(torch.from_numpy(a)))
        states.append(tuple(st))
    bias = torch.tensor(RU.adam_bias_corrections(3), dtype=torch.float32,
                        device=device)
    return params, states, bias


def _grads(shapes, seed, device="cpu", none=False):
    rng = np.random.default_rng(seed)
    return [None if none else torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(device) for s in shapes]


def _bits(ts):
    return [t.detach().cpu().view(torch.int32).clone() for t in ts]


def _same_bits(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("grads", ["given", "none"])
@pytest.mark.parametrize("name", MODES)
def test_the_plain_version_is_the_step_it_replaced_bit_for_bit(name, grads):
    """Three steps through ``DenseOptimizer.step`` (on the CPU: the plain
    version) and through the old step, from the same parameters and state,
    give the same bits, with gradients and with none (a zero one)."""
    params, states, bias = _problem(name, SHAPES, 7)
    old_p = [p.clone() for p in params]
    old_s = [tuple(s.clone() for s in st) for st in states]
    opt = basemodel.DenseOptimizer(name, LR[name], params)
    opt.state = states
    for step in range(3):
        gs = _grads(SHAPES, 100 + step, none=grads == "none")
        for p, q, g in zip(params, old_p, gs):
            p.grad = g
            q.grad = None if g is None else g.clone()
        opt.step(bias)
        _old_step(name, LR[name], old_p, old_s, bias)
    assert _same_bits(_bits(params), _bits(old_p))
    assert _same_bits(_bits(s for st in states for s in st),
                      _bits(s for st in old_s for s in st))
    if grads == "none" and name != "adam":
        # a zero gradient leaves sgd, adagrad and rmsprop's parameters
        assert _same_bits(_bits(params), _bits(_problem(name, SHAPES, 7)[0]))


def _expand(plan, numels, capacity):
    """{(parameter, element): count} over the plan's launches, as the
    kernel's blocks take them: block b finds its parameter as the last
    whose first block is at or before b, and takes CHUNK floats of it
    from (b - first) * CHUNK."""
    seen = {}
    for launch in plan:
        assert 0 < len(launch) <= capacity
        first = [f for _, f, _ in launch] + [2 ** 31 - 1] * (
            capacity - len(launch))
        assert first[0] == 0
        n_blocks = launch[-1][1] + launch[-1][2]
        for b in range(n_blocks):
            t = sum(f <= b for f in first[1:])
            i, f, blocks = launch[t]
            assert f <= b < f + blocks
            base = (b - f) * DU.CHUNK
            n = min(DU.CHUNK, numels[i] - base)
            assert n > 0
            for e in range(base, base + n):
                seen[(i, e)] = seen.get((i, e), 0) + 1
    return seen


PLAN_CASES = {
    "the benchmark's DeepFM (27)": [53398 * 11 // 18] * 18 + [
        273 * 400, 400, 160000, 400, 160000, 400, 400, 1, 1],
    "empty parameters between": [5, 0, 4097, 0, 0, 2048, 1, 0],
    "capacity + 1": [7 + 301 * t for t in range(DU.CAPACITY + 1)],
    "twice the capacity + 3": [1 + (t % 5) * 1000
                               for t in range(2 * DU.CAPACITY + 3)],
}


@pytest.mark.parametrize("capacity", [DU.CAPACITY, 3])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_launch_plan_covers_every_element_once_in_order(case, capacity):
    numels = PLAN_CASES[case]
    plan = DU.launch_plan(numels, capacity)
    order = [i for launch in plan for i, _, _ in launch]
    assert order == [i for i, n in enumerate(numels) if n > 0]
    assert len(plan) == -(-len(order) // capacity)
    seen = _expand(plan, numels, capacity)
    assert set(seen.values()) == {1}
    assert len(seen) == sum(numels)


def test_launch_plan_of_nothing_is_empty():
    assert DU.launch_plan([]) == []
    assert DU.launch_plan([0, 0]) == []


def test_capacity_holds_each_benchmark_model_and_fits_the_parameter_space():
    """DeepFM's 27 and DIEN's 28 dense parameters go in one launch, and
    the struct stays in the classic 4 KB of kernel parameters."""
    assert DU.CAPACITY >= 32
    assert ctypes.sizeof(DU._Args) <= 4096
    assert len(DU.launch_plan([100] * 28)) == 1


def test_the_kernel_source_declares_the_layout_the_host_mirrors():
    src = (_build.SRC_DIR / "dense_update.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxTensors"]) == DU.CAPACITY
    assert int(consts["kThreads"]) * int(consts["kPerThread"]) == DU.CHUNK
    assert "const __grid_constant__ Args" in src
    for struct, mirror in (("Tensor", DU._Tensor), ("Args", DU._Args)):
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        fields = [f for decl in re.findall(r"([^;]+);", body)
                  for f in re.findall(r"(\w+)(?:\[\w+\])?\s*(?:,|$)",
                                      decl.strip())]
        assert fields == [name for name, _ in mirror._fields_], struct
    # the modes are row_update's
    for name, (mode, _) in RU.MODES.items():
        assert re.search(r"k%s = %d" % (name.capitalize(), mode), src)


@pytest.mark.parametrize("kernel", [DU._KERNEL, RU._KERNEL],
                         ids=["dense_update", "row_update"])
def test_the_struct_kernels_check_the_built_layout_once(monkeypatch, kernel):
    """Each struct-by-value kernel is bound once, its signature declared,
    after the library's layout exports agree with the ctypes mirror; a
    library that lays the struct out otherwise is refused."""
    def export(value):
        return lambda *args: value

    def library(**changed):
        layout = dict(kernel.layout, **changed)
        return types.SimpleNamespace(**{name: export(v)
                                        for name, v in layout.items()},
                                     **{kernel.name: export(0)})
    lib = library()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(kernel, "_fn", None)
    bound = kernel.bind()
    assert bound is getattr(lib, kernel.name) and kernel.bind() is bound
    assert bound.argtypes == [ctypes.c_void_p, ctypes.c_void_p]
    assert bound.restype is ctypes.c_int
    first = next(iter(kernel.layout))
    lib = library(**{first: kernel.layout[first] + 8})
    monkeypatch.setattr(kernel, "_fn", None)
    with pytest.raises(RuntimeError, match="layout"):
        kernel.bind()


def test_kernel_args_pass_every_parameter_by_value():
    """One host struct a launch: each parameter's pointers (0 for a
    gradient that is None and for a state it does not carry) and size,
    first blocks padded with INT_MAX, the bias pair's pointer, and the
    constants rounded to float32 as PyTorch rounds a scalar operand."""
    shapes = [(3, 7)] * (DU.CAPACITY + 2) + [(0,), (4097,)]
    for name in MODES:
        params, states, bias = _problem(name, shapes, 11)
        grads = _grads(shapes, 12)
        grads[1] = None
        args = DU.kernel_args(name, params, grads, states, LR[name], bias)
        plan = DU.launch_plan([p.numel() for p in params])
        assert len(args) == len(plan) == 2
        for a, launch in zip(args, plan):
            assert isinstance(a, DU._Args)
            assert (a.n_tensors, a.mode) == (len(launch), RU.MODES[name][0])
            assert a.n_blocks == launch[-1][1] + launch[-1][2]
            assert list(a.first_block) == [f for _, f, _ in launch] + [
                2 ** 31 - 1] * (DU.CAPACITY - len(launch))
            assert a.bias == (bias.data_ptr() if name == "adam" else None)
            f32 = lambda x: float(np.float32(x))  # noqa: E731
            assert a.neg_lr == f32(-LR[name])
            assert (a.eps, a.d1, a.c1, a.d2, a.c2) == tuple(
                f32(x) for x in DU._CONSTS[name])
            for j, (i, _, _) in enumerate(launch):
                s = a.tensor[j]
                st = states[i]
                assert (s.p, s.g, s.s1, s.s2, s.numel) == (
                    params[i].data_ptr(),
                    None if grads[i] is None else grads[i].data_ptr(),
                    st[0].data_ptr() if st else None,
                    st[1].data_ptr() if len(st) > 1 else None,
                    params[i].numel())
        # the empty parameter is in no launch
        assert DU.CAPACITY + 2 not in [i for launch in plan
                                       for i, _, _ in launch]


def test_rounded_constants_are_the_ones_pytorch_multiplies_by():
    """A float32 tensor times a Python float multiplies by the float
    rounded to float32: the kernel's constants are those roundings."""
    x = torch.tensor([1.0], dtype=torch.float32)
    for name in MODES:
        for c in DU._CONSTS[name] + (-LR[name],):
            assert (c * x).item() == float(np.float32(c))


def test_launch_args_are_kept_until_a_pointer_changes():
    params, states, bias = _problem("adam", SHAPES, 3)
    grads = _grads(SHAPES, 4)
    cache = DeviceArgs()
    a = DU.cached_args(cache, "adam", params, grads, states, 0.001, bias)
    assert DU.cached_args(cache, "adam", params, grads, states, 0.001,
                          bias) is a
    grads[2] = grads[2].clone()
    b = DU.cached_args(cache, "adam", params, grads, states, 0.001, bias)
    assert b is not a and b[0].tensor[2].g == grads[2].data_ptr()
    assert DU.cached_args(cache, "adam", params, grads, states, 0.002,
                          bias) is not b
    # a copy (a deep-copied model's optimizer) starts empty
    assert copy.deepcopy(cache)._built == {}


def _raises(match, name, params, grads, states, bias=None):
    with pytest.raises(ValueError, match=match):
        DU.dense_update(name, params, grads, states, 0.01, bias)


def test_dense_update_raises_on_what_the_kernel_does_not_take():
    params, states, bias = _problem("adam", [(4, 3), (5,)], 5)
    grads = _grads([(4, 3), (5,)], 6)
    # float64
    p64 = [params[0].double(), params[1]]
    _raises("float32", "adam", p64, grads, states, bias)
    _raises("float32", "adam", params, [grads[0].double(), None], states,
            bias)
    # not contiguous
    t = torch.zeros(3, 4).t()
    _raises("contiguous", "sgd", [t], [None], [()])
    _raises("contiguous", "adagrad", [params[0]], [grads[0]],
            [(torch.zeros(3, 4).t(),)])
    # on two devices
    meta = torch.zeros(5, device="meta")
    _raises("one device", "adagrad", [params[0], meta], [None, None],
            [(torch.zeros(4, 3),), (torch.zeros(5, device="meta"),)])
    _raises("one device", "adam", params, grads, states,
            torch.zeros(2, device="meta"))
    # shapes, state counts, the optimizer, adam's pair
    _raises("one shape", "sgd", [params[0]], [grads[1]], [()])
    _raises("state tensors", "adam", params, grads, [(s[0],) for s in states],
            bias)
    _raises("supports", "adamw", params, grads, states, bias)
    _raises(r"\[2\]", "adam", params, grads, states, None)
    _raises(r"\[2\]", "adam", params, grads, states, bias.double())
    _raises("gradient", "sgd", params, grads[:1], [(), ()])


def test_no_parameters_is_no_step():
    DU.dense_update("adam", [], [], [], 0.001, None)
    before = _build.LAUNCHES["dense_update"]
    params, states, bias = _problem("adam", SHAPES, 1)
    DU.dense_update("adam", params, _grads(SHAPES, 2), states, 0.001, bias)
    assert _build.LAUNCHES["dense_update"] == before   # the plain version


# the card: the kernel against its plain version, and its launches in a
# captured step

CARD_SHAPES = ((1,), (3,), (4,), (5,), (1023,), (400, 273), (53398 // 18, 11),
               (2048,), (2049,), (8191,))


@pytest.mark.card
@pytest.mark.parametrize("name", MODES)
def test_kernel_equals_the_plain_version_bit_for_bit_on_the_card(card, name):
    """Three steps of the kernel and of ``dense_update_ref`` on the card
    from the same tensors: every parameter and state bit-equal, with
    gradients, with none, on arrays one float past a 16-byte boundary
    (the float route) and past a launch's capacity; each step advances
    the version counter of every tensor it writes."""
    shapes = list(CARD_SHAPES) * 7       # 70 parameters: two launches
    offsets = [(i % 3 == 1) * 1 for i in range(len(shapes))]
    got_p, got_s, bias = _problem(name, shapes, 21, card, offsets)
    want_p = [p.clone() for p in got_p]
    want_s = [tuple(s.clone() for s in st) for st in got_s]
    cache = DeviceArgs()
    written = got_p + [s for st in got_s for s in st]
    for step in range(3):
        grads = _grads(shapes, 200 + step, card)
        for i in range(0, len(grads), 4):
            grads[i] = None
        before = _build.LAUNCHES["dense_update"]
        versions = [t._version for t in written]
        DU.dense_update(name, got_p, grads, got_s, LR[name], bias,
                        cache=cache)
        assert _build.LAUNCHES["dense_update"] - before == 2
        # every tensor written in place advanced its version counter
        assert all(t._version > v for t, v in zip(written, versions))
        DU.dense_update_ref(name, want_p, grads, want_s, LR[name], bias)
    torch.cuda.synchronize()
    assert _same_bits(_bits(got_p), _bits(want_p))
    assert _same_bits(_bits(s for st in got_s for s in st),
                      _bits(s for st in want_s for s in st))


@pytest.mark.card
def test_a_captured_step_launches_the_kernel_once_a_plan_launch(card):
    """A DeepFM with more dense parameters than a launch holds (its
    tables under the "auto" split): the device loop's captured step
    holds the plan's two launches, and every replay adds them to the
    counter; the weights after the graphed epoch equal those of the same
    steps run eagerly."""
    import deepctr_tpu_torch as pt
    from deepctr_tpu_torch.models import DeepFM
    cols = [pt.SparseFeat("C%d" % i, 7 + i, 4) for i in range(70)]
    cols += [pt.DenseFeat("I0", 1)]
    rng = np.random.default_rng(0)
    n, B = 256, 32
    x = {"C%d" % i: rng.integers(0, 7 + i, n) for i in range(70)}
    x["I0"] = rng.random(n).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    models = []
    for _ in range(2):
        m = DeepFM(cols, cols, dnn_hidden_units=(16,), seed=3, device=card)
        m.compile("adam", "binary_crossentropy")
        models.append(m)
    graphed, eager = models
    n_params = len(graphed._dense_opt.params)
    launches = len(DU.launch_plan([p.numel()
                                   for p in graphed._dense_opt.params]))
    assert n_params > DU.CAPACITY and launches == 2
    X = graphed.assemble_device_input(x)
    before = _build.LAUNCHES["dense_update"]
    graphed.fit(X, y, batch_size=B, epochs=1, verbose=0, shuffle=False)
    assert _build.LAUNCHES["dense_update"] - before == launches * (n // B)
    assert any(k[0] == "fit" for k in graphed._graphs)
    y_dev = torch.as_tensor(y, device=card).view(-1, 1)
    sw = torch.ones(B, device=card)
    eager._begin_steps(n // B)
    for i in range(n // B):
        eager._train_step(X[i * B:(i + 1) * B], y_dev[i * B:(i + 1) * B], sw)
    torch.cuda.synchronize()
    for p, q in zip(graphed._dense_opt.params, eager._dense_opt.params):
        assert torch.equal(p.detach().view(torch.int32),
                           q.detach().view(torch.int32))
