"""The dense parameters' optimizer step in one launch
(``deepctr_tpu_torch/ops/dense_update.py``, ``csrc/dense_update.cu``).

On the CPU: the plain version against the step it replaced in
``DenseOptimizer.step`` (kept here as it was), bit for bit, and with L2
vectors against the eager autograd penalty before that step; the launch
plan expanded as the kernel walks it; the argument structs against the
kernel's source; the penalty's plain version against a float64 sum; a
tiny DeepFM's train step with the penalty folded into the dense
optimizer against the same step with the eager penalty.  The tests
marked ``card`` need an NVIDIA GPU and skip here; on the card they run
without the repository's conftest, which imports JAX:

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


# the L2 penalty folded into the step: each parameter's L2 vector

def _l2_problem(shapes, seed, device="cpu"):
    """An L2 vector a parameter: per column for a [rows, width] table of
    width under 32, [1] for any other shape, None for every fifth."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        if i % 5 == 4:
            out.append(None)
            continue
        width = shape[1] if len(shape) == 2 and shape[1] < 32 else 1
        v = rng.uniform(1e-3, 5e-2, width).astype(np.float32)
        out.append(torch.from_numpy(v).to(device))
    return out


def _eager_penalty_grads(params, grads, l2s):
    """Each parameter's gradient as the eager penalty gave it before the
    fold: ``sum(l2 * (p * p * mask))`` a (parameter, column) rule, as
    ``BaseModel._reg_loss`` sums its entries, differentiated by autograd
    into the gradient given (None: the penalty's alone)."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    total = torch.zeros(())
    for w, l2 in zip(leaves, l2s):
        if l2 is None:
            continue
        for c in range(l2.numel()):
            mask = None
            if l2.numel() > 1:
                mask = torch.zeros(l2.numel())
                mask[c] = 1.0
            sq = w * w
            total = total + torch.sum(
                float(l2[c]) * (sq if mask is None else sq * mask))
    for w, g in zip(leaves, grads):
        w.grad = None if g is None else g.clone()
    total.backward()
    return [w.grad for w in leaves]


L2_SHAPES = ((1,), (5,), (1023,), (400, 273), (37, 11), (2, 3, 4),
             (2049, 11), (16,), (64, 1), (7, 5))


@pytest.mark.parametrize("grads", ["given", "none"])
@pytest.mark.parametrize("name", MODES)
def test_the_plain_l2_step_is_the_eager_penalty_then_the_old_step(name,
                                                                  grads):
    """Three steps of ``dense_update_ref`` with an L2 vector a parameter
    (tables by column, vectors and other shapes by one float, some
    without) give the bits of the eager penalty's autograd gradient added
    to the gradient, then the step before the fold, with gradients and
    with none."""
    params, states, bias = _problem(name, L2_SHAPES, 31)
    l2s = _l2_problem(L2_SHAPES, 32)
    old_p = [p.clone() for p in params]
    old_s = [tuple(s.clone() for s in st) for st in states]
    for step in range(3):
        gs = _grads(L2_SHAPES, 300 + step, none=grads == "none")
        DU.dense_update(name, params, gs, states, LR[name], bias, l2s=l2s)
        for q, g in zip(old_p, _eager_penalty_grads(old_p, gs, l2s)):
            q.grad = g
        _old_step(name, LR[name], old_p, old_s, bias)
    assert _same_bits(_bits(params), _bits(old_p))
    assert _same_bits(_bits(s for st in states for s in st),
                      _bits(s for st in old_s for s in st))


def test_kernel_args_carry_each_parameters_l2_vector():
    """Each parameter's struct holds its L2 vector's pointer and floats
    (0 and 0 without one); a new vector rebuilds the cached structs."""
    shapes = list(L2_SHAPES) * 7          # 70 parameters: two launches
    params, states, bias = _problem("adam", shapes, 41)
    grads = _grads(shapes, 42)
    l2s = _l2_problem(shapes, 43)
    args = DU.kernel_args("adam", params, grads, states, 0.001, bias, l2s)
    plan = DU.launch_plan([p.numel() for p in params])
    assert len(args) == len(plan) == 2
    for a, launch in zip(args, plan):
        for j, (i, _, _) in enumerate(launch):
            s, l2 = a.tensor[j], l2s[i]
            if l2 is None:
                assert (s.l2, s.period) == (None, 0)
            else:
                assert (s.l2, s.period) == (l2.data_ptr(), l2.numel())
                assert s.period in (1, params[i].shape[-1])
    # without vectors, none at all
    bare = DU.kernel_args("adam", params, grads, states, 0.001, bias)
    assert all(a.tensor[j].l2 is None and a.tensor[j].period == 0
               for a in bare for j in range(a.n_tensors))
    cache = DeviceArgs()
    a = DU.cached_args(cache, "adam", params, grads, states, 0.001, bias,
                       l2s)
    assert DU.cached_args(cache, "adam", params, grads, states, 0.001, bias,
                          l2s) is a
    l2s[0] = l2s[0].clone()
    b = DU.cached_args(cache, "adam", params, grads, states, 0.001, bias,
                       l2s)
    assert b is not a and b[0].tensor[0].l2 == l2s[0].data_ptr()


def test_penalty_args_take_the_parameters_with_an_l2_vector_alone():
    """The penalty's structs plan the parameters with a vector (in order,
    past a launch's capacity); its workspace holds a float a block of the
    largest launch, a zero count and the float the sum goes to."""
    shapes = list(L2_SHAPES) * 9
    params, _, _ = _problem("sgd", shapes, 51)
    l2s = _l2_problem(shapes, 52)
    kept = [i for i, v in enumerate(l2s) if v is not None]
    structs, partials, done, out = DU.penalty_args(params, l2s)
    plan = DU.launch_plan([params[i].numel() for i in kept])
    assert len(structs) == len(plan) == 2
    for a, launch in zip(structs, plan):
        assert a.n_tensors == len(launch)
        assert a.n_blocks == launch[-1][1] + launch[-1][2]
        for j, (k, first, _) in enumerate(launch):
            i = kept[k]
            s = a.tensor[j]
            assert a.first_block[j] == first
            assert (s.p, s.l2, s.numel, s.period) == (
                params[i].data_ptr(), l2s[i].data_ptr(), params[i].numel(),
                l2s[i].numel())
            assert (s.g, s.s1, s.s2) == (None, None, None)
    assert partials.dtype == torch.float32
    assert partials.numel() == max(a.n_blocks for a in structs)
    assert done.dtype == torch.int32 and done.tolist() == [0]
    assert out.dtype == torch.float32 and out.numel() == 1


def test_the_plain_penalty_sums_each_column_by_its_l2():
    """``dense_penalty`` on the CPU (``dense_penalty_ref``): within 1e-6
    of a float64 sum of l2[i % period] * p_i^2; None where no parameter
    carries a vector."""
    params, _, _ = _problem("sgd", L2_SHAPES, 61)
    l2s = _l2_problem(L2_SHAPES, 62)
    got = DU.dense_penalty(params, l2s)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = sum(float(torch.sum(l2.double() * (p.double() ** 2).reshape(
        -1, l2.numel()))) for p, l2 in zip(params, l2s) if l2 is not None)
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert DU.dense_penalty(params, [None] * len(params)) is None
    assert DU.dense_penalty([], []) is None


def test_l2_vectors_of_another_shape_type_or_device_raise():
    params, states, bias = _problem("adam", [(4, 3), (5,)], 71)
    grads = _grads([(4, 3), (5,)], 72)
    bad = {"width": torch.ones(4), "dtype": torch.ones(3, dtype=torch.float64),
           "2-d": torch.ones(1, 3), "device": torch.ones(3, device="meta")}
    for what, v in bad.items():
        with pytest.raises(ValueError, match="L2 vector"):
            DU.dense_update("adam", params, grads, states, 0.001, bias,
                            l2s=[v, None])
        with pytest.raises(ValueError, match="L2 vector"):
            DU.dense_penalty(params, [v, None])
    with pytest.raises(ValueError, match="L2 vector or None"):
        DU.dense_update("adam", params, grads, states, 0.001, bias,
                        l2s=[None])


# the fold in a model's train step: a tiny DeepFM whose "auto" split puts
# one table on the sparse path and leaves two on the dense one, the gate's
# thresholds lowered as the benchmark's Criteo tables cross them

MIXED_B, MIXED_N = 32, 96


def _mixed_columns():
    import deepctr_tpu_torch as pt
    return [pt.SparseFeat("a", 100, 4), pt.SparseFeat("b", 30, 4),
            pt.SparseFeat("c", 7, 4), pt.DenseFeat("d", 2)]


def _mixed_data(cols, seed=0):
    rng = np.random.default_rng(seed)
    x = {f.name: (rng.integers(0, f.vocabulary_size, MIXED_N)
                  if hasattr(f, "vocabulary_size") else
                  rng.random((MIXED_N, f.dimension)).astype(np.float32))
         for f in cols}
    return x, rng.integers(0, 2, MIXED_N).astype(np.float32)


def _mixed_deepfm(monkeypatch, optimizer="adam", cols=None, **l2):
    """The model, its weights redrawn at std 0.1 from a fixed seed, and
    compiled with ``optimizer`` (a name, or a function of the model that
    builds a ``torch.optim`` optimizer)."""
    from deepctr_tpu_torch.models import DeepFM
    monkeypatch.setattr(basemodel, "_AUTO_MIN_MODEL_ROWS", 100)
    monkeypatch.setattr(basemodel, "_AUTO_MIN_TABLE_ROWS", 60)
    cols = cols or _mixed_columns()
    kw = dict(l2_reg_linear=1e-2, l2_reg_embedding=2e-2, l2_reg_dnn=5e-3)
    kw.update(l2)
    m = DeepFM(cols, cols, dnn_hidden_units=(8,), seed=1, device="cpu",
               **kw)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)))
    m.compile(optimizer if isinstance(optimizer, str) else optimizer(m),
              "binary_crossentropy")
    return m


def _as_before_the_fold(m):
    """``m``'s train step as it was before the fold: every rule's term in
    the eager penalty, through autograd, and no L2 vector on the dense
    optimizer."""
    m._ensure_compiled()
    m._step_rules = (m._reg_entries(), m._step_rules[1])
    m._dense_opt.l2 = [None] * len(m._dense_opt.params)


def _mixed_steps(m, n=3, seed=0, before=None):
    """``n`` train steps on the tiny data; ``before(m)`` ahead of each.
    Returns each step's (data loss, total loss)."""
    x, y = _mixed_data(m.dnn_feature_columns, seed)
    X = m.assemble_device_input(x)
    y = torch.as_tensor(y).view(-1, 1)
    sw = torch.ones(MIXED_B)
    m._begin_steps(n)
    out = []
    for i in range(n):
        if before is not None:
            before(m)
        rows = slice(i * MIXED_B, (i + 1) * MIXED_B)
        data, total, _ = m._train_step(X[rows], y[rows], sw)
        out.append((float(data), float(total)))
    return out


def test_a_steps_total_is_its_data_loss_plus_the_regularization_loss(
        monkeypatch):
    """With the penalty folded (no eager term left), each step's total
    loss is its data loss plus ``get_regularization_loss()`` of the
    weights it started from, to 1e-6, and the sparse table is left out of
    both, as before."""
    m = _mixed_deepfm(monkeypatch)
    assert [s[0] for s in m._sparse_specs] == ["embedding_dict/a"]
    reg, _ = m._ensure_compiled()
    assert reg == []
    with_l2 = [path for path, v in zip(m._dense_paths, m._dense_opt.l2)
               if v is not None]
    assert "embedding_dict/b" in with_l2 and "linear_model/weight" in with_l2
    assert "embedding_dict/a" not in m._dense_paths
    seen = []
    steps = _mixed_steps(
        m, before=lambda m: seen.append(m.get_regularization_loss()))
    for (data, total), r in zip(steps, seen):
        assert r > 0
        assert total == pytest.approx(data + r, rel=1e-6)


@pytest.mark.parametrize("name, l1", [(n, 0.0) for n in MODES]
                         + [("adam", 1e-3)])
def test_three_folded_steps_match_the_eager_penalty(monkeypatch, name, l1):
    """Three steps with the penalty in the dense optimizer and three with
    it eager through autograd, from the same weights and batches: every
    weight, the dense optimizer's and the sparse table's state and each
    step's losses within 1e-6 of the tensor's scale (a table row's
    gradient takes its L2 term after the rows' scatter now, before it
    then: an ulp).  An L1 rule stays in the eager term."""
    def model():
        m = _mixed_deepfm(monkeypatch, name)
        if l1:
            m.add_regularization_rule(r"^dnn/", l1=l1, l2=1e-3)
        return m
    folded, eager = model(), model()
    _as_before_the_fold(eager)
    reg, _ = folded._ensure_compiled()
    assert [(e[1], e[2]) for e in reg] == ([(l1, 0.0)] * 2 if l1 else [])
    assert eager._step_rules[0] and all(
        v is None for v in eager._dense_opt.l2)
    got, want = _mixed_steps(folded), _mixed_steps(eager)
    np.testing.assert_allclose(got, want, rtol=1e-6)

    def close(a, b, what):
        torch.testing.assert_close(
            a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()), msg=what)
    for (n, p), q in zip(folded.named_parameters(), eager.parameters()):
        close(p.detach(), q.detach(), n)
    for st, sq in zip(folded._dense_opt.state, eager._dense_opt.state):
        for a, b in zip(st, sq):
            close(a, b, "dense state")
    for path, st in folded._table_state.items():
        for a, b in zip(st, eager._table_state[path]):
            close(a, b, path)


def test_a_torch_optimizer_finds_the_penalty_gradient_in_p_grad(monkeypatch):
    """Under a ``torch.optim`` optimizer every rule's term stays eager:
    after a step, a parameter's ``p.grad`` is the data gradient plus
    ``2 l2 w`` (the fused wide column of a table by l2_reg_linear, its
    deep columns by l2_reg_embedding), against the same model without
    rules."""
    def sgd(m):
        return torch.optim.SGD(m.parameters(), lr=0.01)
    m = _mixed_deepfm(monkeypatch, sgd)
    bare = _mixed_deepfm(monkeypatch, sgd)
    bare.regularization_rules = []
    reg, _ = m._ensure_compiled()
    assert reg and all(l2 > 0 for _, _, l2, _ in reg)
    assert not hasattr(m._dense_opt, "l2")
    w0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    _mixed_steps(m, n=1)
    _mixed_steps(bare, n=1)
    got, data = dict(m.named_parameters()), dict(bare.named_parameters())
    table = "embedding_dict.tables.b"
    width = got[table].shape[1]
    for name, l2 in (("linear_model.weight", torch.tensor([1e-2])),
                     (table, torch.tensor([2e-2] * (width - 1) + [1e-2]))):
        want = data[name].grad + 2 * l2 * w0[name]
        torch.testing.assert_close(got[name].grad, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("model", ["mixed", "all sparse"])
def test_the_penalty_runs_once_a_step_only_where_a_dense_parameter_has_l2(
        monkeypatch, model):
    """The mixed DeepFM computes a penalty with ``dense_penalty`` once a
    step; a model whose tables are all on the sparse path and whose dense
    parameters have no rule (DIEN's shape: no dense field, l2_reg_dnn 0)
    never does, and its total is its data loss."""
    import deepctr_tpu_torch as pt
    calls = []
    real = basemodel.dense_penalty

    def counted(*args, **kw):
        out = real(*args, **kw)
        if out is not None:
            calls.append(1)
        return out
    monkeypatch.setattr(basemodel, "dense_penalty", counted)
    if model == "mixed":
        m = _mixed_deepfm(monkeypatch)
    else:
        cols = [pt.SparseFeat("a", 100, 4), pt.SparseFeat("b", 130, 4)]
        m = _mixed_deepfm(monkeypatch, cols=cols, l2_reg_dnn=0.0)
        assert len(m._sparse_specs) == 2
    steps = _mixed_steps(m)
    if model == "mixed":
        assert len(calls) == len(steps)
    else:
        assert calls == [] and all(v is None for v in m._dense_opt.l2)
        assert m._step_rules[0] == []
        assert all(total == data for data, total in steps)


# the card: the L2 term and the penalty's launch

@pytest.mark.card
@pytest.mark.parametrize("name", MODES)
def test_the_l2_term_equals_the_plain_version_bit_for_bit_on_the_card(
        card, name):
    """Three steps of the kernel with L2 vectors (a table's columns, one
    float, none) and of ``dense_update_ref`` on the card: bit-equal,
    with gradients and without, on arrays one float past a 16-byte
    boundary, past a launch's capacity, and at a table width of 11 that
    a chunk does not divide."""
    shapes = list(CARD_SHAPES) * 7
    offsets = [(i % 3 == 1) * 1 for i in range(len(shapes))]
    got_p, got_s, bias = _problem(name, shapes, 81, card, offsets)
    l2s = _l2_problem(shapes, 82, card)
    want_p = [p.clone() for p in got_p]
    want_s = [tuple(s.clone() for s in st) for st in got_s]
    cache = DeviceArgs()
    for step in range(3):
        grads = _grads(shapes, 800 + step, card)
        for i in range(0, len(grads), 4):
            grads[i] = None
        DU.dense_update(name, got_p, grads, got_s, LR[name], bias,
                        cache=cache, l2s=l2s)
        DU.dense_update_ref(name, want_p, grads, want_s, LR[name], bias,
                            l2s=l2s)
    torch.cuda.synchronize()
    assert _same_bits(_bits(got_p), _bits(want_p))
    assert _same_bits(_bits(s for st in got_s for s in st),
                      _bits(s for st in want_s for s in st))


@pytest.mark.card
def test_the_penalty_launch_is_deterministic_and_near_float64(card):
    """The penalty over 70 parameters (two launches, the second adding to
    the first) and over DeepFM's benchmark shapes: the same bits in two
    calls through one cached workspace (whose count the last block sets
    back to 0) and through a fresh one, within 1e-6 of a float64 sum and
    of the plain version; one launch a plan launch."""
    cases = {"70 parameters": list(CARD_SHAPES) * 7,
             "DeepFM": PLAN_CASES["the benchmark's DeepFM (27)"]}
    for what, numels in cases.items():
        shapes = [s if isinstance(s, tuple) else (s // 11, 11)
                  if s % 11 == 0 else (s,) for s in numels]
        offsets = [(i % 3 == 1) * 1 for i in range(len(shapes))]
        params, _, _ = _problem("sgd", shapes, 91, card, offsets)
        l2s = _l2_problem(shapes, 92, card)
        n_launches = len(DU.launch_plan(
            [p.numel() for p, v in zip(params, l2s) if v is not None]))
        cache = DeviceArgs()
        before = _build.LAUNCHES["dense_penalty"]
        runs = [DU.dense_penalty(params, l2s, cache).clone()
                for _ in range(2)]
        runs.append(DU.dense_penalty(params, l2s))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["dense_penalty"] - before == 3 * n_launches
        assert _same_bits(_bits(runs[:1]), _bits(runs[1:2])), what
        assert _same_bits(_bits(runs[:1]), _bits(runs[2:])), what
        want = sum(float(torch.sum(l2.double() * (p.double() ** 2).reshape(
            -1, l2.numel()))) for p, l2 in zip(params, l2s)
            if l2 is not None)
        assert float(runs[0]) == pytest.approx(want, rel=1e-6), what
        plain = DU.dense_penalty_ref(params, l2s)
        assert float(runs[0]) == pytest.approx(float(plain), rel=1e-6), what


@pytest.mark.card
def test_a_captured_deepfm_step_launches_the_penalty_once_a_replay(card):
    """A DeepFM of a few dense tables (under 64 with L2): its device
    loop's captured step holds one penalty launch, which each replay
    adds to the counter; the losses and weights after the graphed epoch
    equal those of the same steps run eagerly."""
    import deepctr_tpu_torch as pt
    from deepctr_tpu_torch.models import DeepFM
    cols = [pt.SparseFeat("C%d" % i, 50 + i, 4) for i in range(6)]
    cols += [pt.DenseFeat("I0", 1)]
    rng = np.random.default_rng(1)
    n, B = 256, 32
    x = {"C%d" % i: rng.integers(0, 50 + i, n) for i in range(6)}
    x["I0"] = rng.random(n).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    models = []
    for _ in range(2):
        m = DeepFM(cols, cols, dnn_hidden_units=(16,), seed=3, device=card,
                   l2_reg_dnn=1e-3)
        m.compile("adam", "binary_crossentropy")
        models.append(m)
    graphed, eager = models
    graphed._ensure_compiled()
    with_l2 = [v for v in graphed._dense_opt.l2 if v is not None]
    assert 0 < len(with_l2) <= DU.CAPACITY
    X = graphed.assemble_device_input(x)
    before = _build.LAUNCHES["dense_penalty"]
    h = graphed.fit(X, y, batch_size=B, epochs=1, verbose=0, shuffle=False)
    assert _build.LAUNCHES["dense_penalty"] - before == n // B
    assert any(k[0] == "fit" for k in graphed._graphs)
    y_dev = torch.as_tensor(y, device=card).view(-1, 1)
    sw = torch.ones(B, device=card)
    eager._begin_steps(n // B)
    totals = []
    for i in range(n // B):
        totals.append(eager._train_step(X[i * B:(i + 1) * B],
                                        y_dev[i * B:(i + 1) * B], sw)[1])
    torch.cuda.synchronize()
    # a step's loss is its batch's sum; the epoch's, the mean over rows
    assert h.history["loss"][0] == pytest.approx(
        float(torch.stack(totals).sum()) / n, rel=1e-6)
    for p, q in zip(graphed._dense_opt.params, eager._dense_opt.params):
        assert torch.equal(p.detach().view(torch.int32),
                           q.detach().view(torch.int32))
