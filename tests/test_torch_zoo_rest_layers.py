"""The layers of the rest of the zoo against the JAX package's, on the same
numpy-seeded inputs and weights: ``KMaxPooling`` (CCPM) with tied values,
``Conv2dSame`` and ``ConvLayer`` (CCPM), ``LogTransformLayer`` (AFN) in
training and at inference with its running statistics, and the stacked
expert towers of MMOE and PLE (``models/multitask/utils.py:StackedDNN``)
against the JAX package's vmapped ``stacked_dnn``; forwards and gradients
(``jax.grad``), and the initializers' draws.

None of these layers reaches a Pallas kernel in the JAX package, so both
sides run their plain forms.

Tolerances.  ``KMaxPooling``: exact, values and gradient (it picks and
copies values).  The others: 1e-5, relative above 1 (another order of
float32 sums: the unfolded convolution against ``lax.conv_general_
dilated``, the LTL's product and its exp); the convolution's, relative
to the magnitude of the terms each value sums (the same sums over the
inputs' and weights' magnitudes), as its kernel gradient sums B·H·W
products; the LTL's gradients, whose batch-norm backward cancels, against
a float64 evaluation: within 1e-5 of it, or of twice the JAX package's
own float32 error, where that is larger."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_tpu.layers.core import Conv2dSame as JConv2dSame
from deepctr_tpu.layers.interaction import ConvLayer as JConvLayer
from deepctr_tpu.layers.interaction import (
    LogTransformLayer as JLogTransformLayer)
from deepctr_tpu.layers.sequence import KMaxPooling as JKMaxPooling
from deepctr_tpu.models.multitask.mmoe import stacked_dnn
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import (Conv2dSame, ConvLayer, KMaxPooling,
                                      LogTransformLayer)
from deepctr_tpu_torch.models.multitask.utils import StackedDNN
from deepctr_tpu_torch.utils.jax_weights import jax_to_state_dict

TOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def assert_close(got, want, tol=TOL, scale=None):
    """Within ``tol`` of max(1, |want|), or of max(1, ``scale``): the
    magnitude of the terms each value sums, where given."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    mag = np.abs(want) if scale is None else np.maximum(np.abs(want),
                                                        np.asarray(scale))
    rel = np.abs(got - want) / np.maximum(mag, 1.0)
    assert rel.max() <= tol, rel.max()


def load(module, variables):
    """The flax variables into the port's module (``kernel`` leaves of
    these layers keep their layout)."""
    state = jax_to_state_dict(
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})},
        {k: tuple(v.shape) for k, v in module.state_dict().items()})
    module.load_state_dict({k: torch.tensor(v) for k, v in state.items()})


# ---------------------------------------------------------------------------
# KMaxPooling
# ---------------------------------------------------------------------------

def tied(shape, seed):
    """Values from {-1, -0.5, 0.5, 1}: most rows hold ties, as CCPM's tanh
    saturated to +-1 at bfloat16 gives them."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.float32([-1, -0.5, 0.5, 1]), size=shape)


@pytest.mark.parametrize("shape, k, axis", [
    ((1, 5), 2, 1), ((6, 9), 4, 1), ((4, 2, 7, 3), 3, 2),
    ((4, 2, 7, 3), 7, 2), ((5, 8, 2), 1, 0)])
def test_kmax_pooling_breaks_ties_by_the_lower_index_as_lax_top_k(
        shape, k, axis):
    """Forward and gradient exact against the JAX layer on tied inputs:
    the gradient lands on the fields ``lax.top_k`` picks.  The first case
    is ``x = [0.5, 1, 1, 0.2, 1]``, k = 2: ``lax.top_k`` takes indices 1
    and 2, ``torch.topk`` may take 2 and 4."""
    x = (np.float32([[0.5, 1, 1, 0.2, 1]]) if shape == (1, 5)
         else tied(shape, seed=sum(shape) + k))
    jl = JKMaxPooling(k=k, axis=axis)
    out_shape = list(shape)
    out_shape[axis] = k
    w = np.random.default_rng(7).normal(size=out_shape).astype(np.float32)
    want = jl.apply({}, jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jl.apply({}, v) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = KMaxPooling(k, axis)(xt)
    torch.sum(got * torch.tensor(w)).backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    if shape == (1, 5):
        np.testing.assert_array_equal(np.asarray(want_g)[0] != 0,
                                      [False, True, True, False, False])


def test_kmax_pooling_raises_where_the_jax_layer_does():
    x = torch.zeros(2, 3)
    for k, axis in ((1, 2), (4, 1), (0, 1)):
        with pytest.raises(ValueError):
            KMaxPooling(k, axis)(x)


# ---------------------------------------------------------------------------
# Conv2dSame and ConvLayer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_ch, out_ch, kernel, stride, hw", [
    (1, 2, (3, 1), (1, 1), (7, 4)), (2, 4, (6, 1), (1, 1), (26, 16)),
    (3, 2, (3, 2), (2, 2), (7, 5)), (2, 3, (4, 3), (1, 2), (5, 6))])
def test_conv2d_same_matches_jax(in_ch, out_ch, kernel, stride, hw):
    """TF "SAME" padding (asymmetric where the pad is odd), strides, bias:
    forward and the kernel's, bias's and input's gradients."""
    rng = np.random.default_rng(sum(hw))
    x = rng.normal(size=(5, in_ch) + hw).astype(np.float32)
    jl = JConv2dSame(in_ch, out_ch, kernel, stride)
    v = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": jnp.asarray(rng.normal(size=out_ch),
                                        jnp.float32)}}
    w = rng.normal(size=jl.apply(v, jnp.asarray(x)).shape).astype(np.float32)
    pl = Conv2dSame(in_ch, out_ch, kernel, stride)
    load(pl, v)

    def loss(params, xx, ww=w):
        return jnp.sum(jl.apply({"params": params}, xx) * ww)
    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    # the magnitudes of the terms: the same sums over |x|, |kernel|, |w|
    mags = jax.tree_util.tree_map(jnp.abs, v["params"])
    sp, sx = jax.grad(loss, argnums=(0, 1))(mags, jnp.abs(jnp.asarray(x)),
                                            np.abs(w))
    xt = torch.tensor(x, requires_grad=True)
    out = pl(xt)
    assert_close(out, jl.apply(v, jnp.asarray(x)),
                 scale=jl.apply({"params": mags}, jnp.abs(jnp.asarray(x))))
    torch.sum(out * torch.tensor(w)).backward()
    assert_close(xt.grad, gx, scale=sx)
    assert_close(pl.kernel.grad, gp["kernel"], scale=sp["kernel"])
    assert_close(pl.bias.grad, gp["bias"], scale=sp["bias"])


def test_conv2d_same_init_draws_the_jax_bound():
    """``kernel`` from flax's xavier_uniform over jax's fans of the OIHW
    shape, ``bias`` from zeros."""
    shape = (4, 4, 6, 1)
    v = JConv2dSame(4, 4, (6, 1)).init(jax.random.PRNGKey(1),
                                        jnp.zeros((2, 4, 9, 3)))
    jk = np.asarray(v["params"]["kernel"])
    pl = Conv2dSame(4, 4, (6, 1),
                    generator=torch.Generator().manual_seed(1))
    bound = (6.0 / ((shape[2] + shape[3]) * shape[0] * shape[1])) ** 0.5
    for k in (jk, pl.kernel.detach().numpy()):
        assert k.shape == shape and np.abs(k).max() <= bound
        assert np.abs(k).max() > 0.9 * bound
    assert not pl.bias.detach().numpy().any()


@pytest.mark.parametrize("field_size", [1, 2, 3, 5, 26])
@pytest.mark.parametrize("filters", [(2, 1), (4, 4), (3, 2, 2)])
def test_conv_layer_schedule_matches_jax(field_size, filters):
    assert (ConvLayer.compute_shapes(field_size, filters)
            == JConvLayer.compute_shapes(field_size, filters))


@pytest.mark.parametrize("field_size, widths, filters, dtype", [
    (5, (3, 2), (2, 1), "float32"), (7, (6, 5), (4, 4), "float32"),
    (6, (3, 2, 2), (3, 2, 2), "float32"), (7, (6, 5), (4, 4), "bfloat16")])
def test_conv_layer_matches_jax(field_size, widths, filters, dtype):
    """The stack on [B, 1, F, E] with tied values (the pooling's ties):
    forward and every gradient.  At bfloat16 both sides round the same
    products to bfloat16, and the tanh's saturation is where ties come
    from; held to two bf16 ulps of 1."""
    rng = np.random.default_rng(field_size)
    x = (rng.normal(size=(6, 1, field_size, 4)) * 3).astype(np.float32)
    x[:, :, 1] = x[:, :, 0]                      # two tied fields
    jnp_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jl = JConvLayer(field_size, widths, filters)
    v = jl.init(jax.random.PRNGKey(2), jnp.asarray(x))
    v = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
        v["params"])}
    pl = ConvLayer(field_size, widths, filters)
    load(pl, v)
    from deepctr_tpu import config as dc_config
    saved = dc_config._COMPUTE_DTYPE
    dc_config._COMPUTE_DTYPE = jnp_dtype
    pt_config.set_compute_dtype(dtype)
    try:
        want = jl.apply(v, jnp.asarray(x))
        w = rng.normal(size=want.shape).astype(np.float32)
        gp = jax.grad(lambda p: jnp.sum(
            jl.apply({"params": p}, jnp.asarray(x)).astype(jnp.float32)
            * w))(v["params"])
        got = pl(torch.tensor(x))
        torch.sum(got.float() * torch.tensor(w)).backward()
    finally:
        dc_config._COMPUTE_DTYPE = saved
    tol = TOL if dtype == "float32" else 2 * 2.0 ** -7
    assert_close(got.float(), jnp.asarray(want, jnp.float32), tol)
    if dtype == "float32":
        for i in range(1, len(filters) + 1):
            conv = getattr(pl, "conv_%d" % i)
            assert_close(conv.kernel.grad, gp["conv_%d" % i]["kernel"])
            assert_close(conv.bias.grad, gp["conv_%d" % i]["bias"])


# ---------------------------------------------------------------------------
# LogTransformLayer
# ---------------------------------------------------------------------------

def ltl_f64(x, w, layer, training):
    """The gradients of ``sum(LTL(x) * w)`` in float64, from ``layer``'s
    weights: ``{"x": ..., "ltl_weights": ..., "bn_0.scale": ...}``."""
    p = {k: v.detach().double().requires_grad_()
         for k, v in layer.named_parameters()}
    xx = torch.tensor(x, dtype=torch.float64, requires_grad=True)

    def bn(h, name):
        if training:
            mean = h.mean(dim=(0, 2))
            var = (h * h).mean(dim=(0, 2)) - mean * mean
        else:
            mod = getattr(layer, name)
            mean, var = mod.mean.double(), mod.var.double()
        h = (h - mean[:, None]) / torch.sqrt(var[:, None] + 1e-5)
        return h * p[name + ".scale"][:, None] + p[name + ".bias"][:, None]
    h = bn(torch.log(torch.clamp_min(xx.abs(), 1e-7)).transpose(1, 2),
           "bn_0")
    h = torch.exp(h @ p["ltl_weights"] + p["ltl_biases"])
    out = bn(h, "bn_1").reshape(h.shape[0], -1)
    torch.sum(out * torch.tensor(w, dtype=torch.float64)).backward()
    grads = {k: v.grad.numpy() for k, v in p.items()}
    grads["x"] = xx.grad.numpy()
    return grads


def assert_near(got, want, truth):
    """A float32 gradient whose batch-norm backward cancels: within TOL of
    max(1, |truth|) of the float64 ``truth``, or within twice the JAX
    package's own float32 error there, where that is larger."""
    got = got.detach().numpy()
    want, truth = np.asarray(want), np.asarray(truth)
    assert got.shape == want.shape == truth.shape
    bound = np.maximum(TOL * np.maximum(np.abs(truth), 1.0),
                       2 * np.abs(want - truth))
    assert (np.abs(got - truth) <= bound).all(), (
        np.abs(got - truth).max(), np.abs(want - truth).max())


@pytest.mark.parametrize("training", [True, False])
def test_log_transform_layer_matches_jax(training):
    """Both batch norms over axis 1 of [B, E, F]: in training with the
    batch's statistics, which move the running ones (held after two
    calls), at inference with running statistics drawn from a seed;
    forward and every gradient, the input's included."""
    B, F, E, H = 8, 5, 4, 6
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(B, F, E)) * 0.3).astype(np.float32)
    x[0, 0, 0] = 0.0                             # clipped at 1e-7
    jl = JLogTransformLayer(F, E, H)
    v = jl.init(jax.random.PRNGKey(3), jnp.asarray(x))
    v = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.3, jnp.float32),
        v["params"]),
         "batch_stats": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 2.0, size=a.shape),
                              jnp.float32), v["batch_stats"])}
    pl = LogTransformLayer(F, E, H)
    load(pl, v)
    w = rng.normal(size=(B, E * H)).astype(np.float32)

    def loss(params, xx):
        out = jl.apply({"params": params, "batch_stats": v["batch_stats"]},
                       xx, training, mutable=["batch_stats"])[0]
        return jnp.sum(out * w)
    want, stats = jl.apply(v, jnp.asarray(x), training,
                           mutable=["batch_stats"])
    _, stats = jl.apply({"params": v["params"], **stats}, jnp.asarray(x),
                        training, mutable=["batch_stats"])
    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    truth = ltl_f64(x, w, pl, training)
    xt = torch.tensor(x, requires_grad=True)
    got = pl(xt, training)
    pl(torch.tensor(x), training)
    assert_close(got, want)
    torch.sum(got * torch.tensor(w)).backward()
    assert_near(xt.grad, gx, truth["x"])
    assert_near(pl.ltl_weights.grad, gp["ltl_weights"], truth["ltl_weights"])
    assert_near(pl.ltl_biases.grad, gp["ltl_biases"], truth["ltl_biases"])
    for bn in ("bn_0", "bn_1"):
        for leaf in ("scale", "bias"):
            assert_near(getattr(getattr(pl, bn), leaf).grad,
                        gp[bn][leaf], truth["%s.%s" % (bn, leaf)])
        for leaf in ("mean", "var"):
            assert_close(getattr(getattr(pl, bn), leaf),
                         stats["batch_stats"][bn][leaf])
            moved = not np.allclose(np.asarray(
                stats["batch_stats"][bn][leaf]),
                np.asarray(v["batch_stats"][bn][leaf]))
            assert moved == training


def test_log_transform_layer_init_matches_the_jax_draws():
    """``ltl_weights`` from normal(0.1), ``ltl_biases`` zeros, each batch
    norm's scale 1, bias 0, running mean 0 and var 1."""
    pl = LogTransformLayer(30, 4, 200,
                           generator=torch.Generator().manual_seed(0))
    assert pl.ltl_weights.shape == (30, 200)
    assert abs(pl.ltl_weights.std().item() - 0.1) < 0.005
    assert not pl.ltl_biases.any()
    for bn in (pl.bn_0, pl.bn_1):
        assert bn.scale.shape == bn.mean.shape == (4,)
        assert bn.scale.eq(1).all() and bn.var.eq(1).all()
        assert not bn.bias.any() and not bn.mean.any()


# ---------------------------------------------------------------------------
# the stacked expert towers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_bn, training", [
    (False, False), (True, True), (True, False)])
def test_stacked_dnn_matches_the_jax_vmapped_dnn(use_bn, training):
    """[B, D] -> [B, K, units]: kernels [K, in, out] kept as they are,
    each tower's batch norm with its own statistics; forward, gradients
    and the moved running statistics."""
    K, B, D, units = 3, 64, 5, (6, 4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, D)).astype(np.float32)
    jl = stacked_dnn(K, hidden_units=units, use_bn=use_bn, init_std=0.3)
    v = jl.init({"params": jax.random.PRNGKey(4)}, jnp.asarray(x), False)
    v = dict(v)
    v["params"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.5, jnp.float32),
        v["params"])
    assert v["params"]["dense_0"]["kernel"].shape == (K, D, units[0])
    pl = StackedDNN(K, D, units, use_bn=use_bn)
    load(pl, v)
    w = rng.normal(size=(B, K, units[-1])).astype(np.float32)
    stats = v.get("batch_stats", {})

    def loss(params):
        out = jl.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), training, mutable=["batch_stats"])[0]
        return jnp.sum(out * w)
    want, moved = jl.apply(v, jnp.asarray(x), training,
                           mutable=["batch_stats"])
    gp = jax.grad(loss)(v["params"])
    got = pl(torch.tensor(x), training)
    assert_close(got, want)
    torch.sum(got * torch.tensor(w)).backward()
    for i in range(len(units)):
        dense = getattr(pl, "dense_%d" % i)
        assert_close(dense.kernel.grad, gp["dense_%d" % i]["kernel"])
        if use_bn and training:
            # a bias right before a batch norm in training: its exact
            # gradient is 0, both sides hold rounding noise
            for g in (dense.bias.grad.numpy(), gp["dense_%d" % i]["bias"]):
                assert np.abs(np.asarray(g)).max() <= 1e-4
        else:
            assert_close(dense.bias.grad, gp["dense_%d" % i]["bias"])
        if use_bn:
            bn = getattr(pl, "bn_%d" % i)
            for leaf in ("mean", "var"):
                assert_close(getattr(bn, leaf),
                             moved["batch_stats"]["bn_%d" % i][leaf])
