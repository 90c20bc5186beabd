"""The port's zoo interaction layers (``deepctr_tpu_torch/layers/
interaction.py``: BiInteractionPooling, SENETLayer, BilinearInteraction,
AFMLayer, InteractingLayer, CrossNet, CrossNetMix, InnerProductLayer,
OutterProductLayer) and ``ops.reference.cross_net_ref`` against the JAX
package's, on the same numpy-seeded inputs and weights, in every mode;
their gradients against ``jax.grad``; their initializers against the JAX
layers' draws; the pair indices built once.

None of these layers reaches a Pallas kernel in the JAX package
(``cross_net`` dispatches to its jnp reference), so both sides run their
plain forms.

Tolerances.  float32: 1e-6, relative above 1 to the magnitude of the
terms each output sums (another order of sums; the layer evaluated on the
magnitudes of its inputs and weights, see ``check_layer``).  bfloat16 compute: two bf16 ulps of the output's largest
magnitude.  Both sides round every product to bfloat16, but XLA may keep
float32 between fused elementwise operations where PyTorch rounds each,
and a one-ulp difference in a layer's intermediate (a score, a cross
term) carries into the terms of the output; two ulps of the output's
scale hold that and nothing larger."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepctr_tpu import config as dc_config
from deepctr_tpu.layers import interaction as jint
from deepctr_tpu.ops import reference as jref
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import interaction as pint
from deepctr_tpu_torch.ops import reference as pref
from deepctr_tpu_torch.utils.jax_weights import jax_to_state_dict

F32_TOL = 1e-6
BF16_ULPS = 2
B, F, E = 6, 5, 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_agree(got, want, dtype, scale=None):
    """float32: within F32_TOL of max(1, scale), ``scale`` the magnitude
    of the terms each output sums (|want| unless given); bfloat16: within
    BF16_ULPS ulps of the output's largest magnitude."""
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    if dtype == "float32":
        mag = np.abs(b) if scale is None else np.maximum(np.abs(b),
                                                         _np(scale))
        rel = diff / np.maximum(mag, 1.0)
        assert rel.max() <= F32_TOL, rel.max()
        return
    top = max(np.abs(b).max(), 2.0 ** -126)
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert diff.max() <= BF16_ULPS * ulp, (diff.max() / ulp)


def _redraw(tree, rng, std):
    return {k: _redraw(v, rng, std) if isinstance(v, dict)
            else rng.normal(0, std, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


def _set_dtype(dtype):
    dc_config.set_compute_dtype(DTYPES[dtype][0])
    pt_config.set_compute_dtype(DTYPES[dtype][1])


def _pair(jlayer, player, x, std=0.3, seed=0, call=()):
    """The JAX layer's parameters drawn at ``std`` from a seed and the
    port layer loaded with them: (params, the port layer)."""
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), *call)
    params = _redraw(variables.get("params", {}),
                     np.random.default_rng(seed), std)
    state = jax_to_state_dict({"params": params}, {
        k: tuple(v.shape) for k, v in player.state_dict().items()})
    assert set(state) == set(player.state_dict())
    player.load_state_dict({k: torch.from_numpy(v)
                            for k, v in state.items()})
    return params, player


def _inputs(shape=(B, F, E), seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _abs_tree(tree):
    return jax.tree_util.tree_map(jnp.abs, tree)


def check_layer(jlayer, player, x, dtype, std=0.3, call=()):
    """Forward at ``dtype``; at float32 also the gradients of
    sum(out * ct) with respect to the inputs and every parameter.  The
    JAX side runs jitted, as the JAX package's train step and predict do.
    The float32 scale of each output is the JAX layer evaluated on the
    magnitudes of the inputs, weights and cotangent: the magnitude of the
    terms it sums (exactly so for the products and sums; for relu,
    softmax and tanh, the magnitude of their operands' terms)."""
    params, player = _pair(jlayer, player, x, std, call=call)
    _set_dtype(dtype)

    def apply(p, xx):
        return jlayer.apply({"params": p}, xx, *call)
    xj = jnp.asarray(x)
    want = jax.jit(apply)(params, xj)
    xt = torch.from_numpy(x).requires_grad_(dtype == "float32")
    got = player(xt, *call)
    assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                         else torch.float32)
    if dtype != "float32":
        assert_agree(got, want, dtype)
        return got
    assert_agree(got, want, dtype, jax.jit(apply)(_abs_tree(params),
                                                  jnp.abs(xj)))
    ct = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)

    def grads(p, xx, c):
        return jax.grad(lambda p, xx: jnp.sum(apply(p, xx) * c),
                        argnums=(0, 1))(p, xx)
    gp, gx = jax.jit(grads)(params, xj, ct)
    sp, sx = jax.jit(grads)(_abs_tree(params), jnp.abs(xj), np.abs(ct))
    got.backward(torch.from_numpy(ct))
    assert_agree(xt.grad, gx, "float32", sx)
    shapes = {k: tuple(v.shape) for k, v in player.state_dict().items()}
    gstate, sstate = (jax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, t)}, shapes) for t in (gp, sp))
    for name, p in player.named_parameters():
        assert_agree(p.grad, gstate[name], "float32", sstate[name])
    return got


@pytest.mark.parametrize("num_fields", [1, 2, 5, 26])
def test_pair_indices_match_jax(num_fields):
    rows, cols = pint._pair_indices(num_fields, "cpu")
    jrows, jcols = jint._pair_indices(num_fields)
    assert rows.dtype == cols.dtype == torch.int64
    np.testing.assert_array_equal(rows.numpy(), jrows)
    np.testing.assert_array_equal(cols.numpy(), jcols)


def test_pair_indices_are_built_at_construction_not_in_a_forward(
        monkeypatch):
    """A captured graph keeps the addresses of the tensors it read: the
    pairwise layers build their indices once, as buffers outside the
    state_dict, and a forward builds none."""
    layers = [pint.BilinearInteraction(F, E, "each"),
              pint.AFMLayer(E, field_size=F),
              pint.InnerProductLayer(field_size=F),
              pint.OutterProductLayer(F, E)]
    for layer in layers:
        assert {"rows", "cols"} <= dict(layer.named_buffers()).keys()
        assert not {"rows", "cols"} & set(layer.state_dict())

    def no_triu(*args, **kwargs):
        raise AssertionError("pair indices built in a forward")
    monkeypatch.setattr(np, "triu_indices", no_triu)
    x = torch.from_numpy(_inputs())
    for layer in layers:
        layer(x)
        with pytest.raises(ValueError, match="expects"):
            layer(x[:, :F - 1])


@pytest.mark.parametrize("dim", [0, 1])
def test_pair_gather_backward_is_index_selects_in_a_fixed_order(dim):
    """The pair gather's backward (a product with the pairs' 0/1 matrix,
    so that the card sums in a fixed order) gives index_select's
    gradient."""
    layer = pint.BilinearInteraction(F, E, "each")
    g = torch.Generator().manual_seed(4)
    shape = (F, E, E) if dim == 0 else (B, F, E)
    x = torch.randn(shape, dtype=torch.float64, generator=g,
                    requires_grad=True)
    ct = torch.randn(shape[:dim] + (F * (F - 1) // 2,) + shape[dim + 1:],
                     dtype=torch.float64, generator=g)
    for name in ("rows", "cols"):
        got, = torch.autograd.grad(pint._gather(layer, x, name, dim), x, ct)
        want, = torch.autograd.grad(
            x.index_select(dim, getattr(layer, name)), x, ct)
        torch.testing.assert_close(got, want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parameterization", ["vector", "matrix"])
def test_cross_net_ref_matches_jax(parameterization, dtype):
    rng = np.random.default_rng(3)
    n, L = 12, 3
    x = rng.normal(size=(B, n)).astype(np.float32)
    k = rng.normal(0, 0.3, (L, n, 1 if parameterization == "vector"
                            else n)).astype(np.float32)
    b = rng.normal(0, 0.3, (L, n, 1)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jref.cross_net_ref(*(jnp.asarray(a, jd) for a in (x, k, b)),
                              parameterization)
    got = pref.cross_net_ref(*(torch.from_numpy(a).to(td)
                               for a in (x, k, b)), parameterization)
    assert got.dtype == td
    scale = jref.cross_net_ref(*(jnp.abs(jnp.asarray(a)) for a in (x, k, b)),
                               parameterization)
    assert_agree(got, want, dtype, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bi_interaction_pooling_matches_jax(dtype):
    """float32 whatever the compute dtype, as the JAX layer."""
    got = check_layer(jint.BiInteractionPooling(),
                      pint.BiInteractionPooling(), _inputs(), dtype)
    assert got.shape == (B, 1, E) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", [3, 10])
def test_senet_layer_matches_jax(ratio, dtype):
    """The dense layers in the compute dtype, the reweighting of the
    float32 fields in float32."""
    check_layer(jint.SENETLayer(F, ratio), pint.SENETLayer(F, ratio),
                _inputs(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bilinear_type", ["all", "each", "interaction"])
def test_bilinear_interaction_matches_jax(bilinear_type, dtype):
    got = check_layer(jint.BilinearInteraction(F, E, bilinear_type),
                      pint.BilinearInteraction(F, E, bilinear_type),
                      _inputs(), dtype)
    assert got.shape == (B, F * (F - 1) // 2, E)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention_factor", [4, 8])
def test_afm_layer_matches_jax(attention_factor, dtype):
    """float32 whatever the compute dtype, as the JAX layer."""
    got = check_layer(
        jint.AFMLayer(in_features=E, attention_factor=attention_factor),
        pint.AFMLayer(E, attention_factor, field_size=F), _inputs(), dtype)
    assert got.shape == (B, 1) and got.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_res, scaling, heads", [
    (True, False, 2), (False, False, 2), (True, True, 4), (False, True, 1)])
def test_interacting_layer_matches_jax(use_res, scaling, heads, dtype):
    got = check_layer(jint.InteractingLayer(E, heads, use_res, scaling),
                      pint.InteractingLayer(E, heads, use_res, scaling),
                      _inputs(), dtype)
    assert got.shape == (B, F, E)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parameterization", ["vector", "matrix"])
def test_cross_net_matches_jax(parameterization, dtype):
    n = 12
    check_layer(jint.CrossNet(n, 3, parameterization),
                pint.CrossNet(n, 3, parameterization),
                _inputs((B, n)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank, experts, layers", [(3, 2, 2), (4, 3, 1)])
def test_cross_net_mix_matches_jax(rank, experts, layers, dtype):
    n = 12
    check_layer(jint.CrossNetMix(n, rank, experts, layers),
                pint.CrossNetMix(n, rank, experts, layers),
                _inputs((B, n)), dtype)


def test_cross_net_mix_applies_c_not_its_transpose():
    """``C v`` (``out_s = sum_r C[s, r] v_r``), the reference's
    ``torch.matmul(C, v)``: with every C transposed the port's layer
    leaves the JAX layer's output by far more than the tolerance, so the
    parity test above fails under ``C^T v``."""
    n = 12
    x = _inputs((B, n))
    jl = jint.CrossNetMix(n, 4, 2, 2)
    params, pl = _pair(jl, pint.CrossNetMix(n, 4, 2, 2), x)
    want = jl.apply({"params": params}, jnp.asarray(x))
    scale = jl.apply({"params": _abs_tree(params)}, jnp.abs(jnp.asarray(x)))
    with torch.no_grad():
        assert_agree(pl(torch.from_numpy(x)), want, "float32", scale)
        pl.C_list.copy_(pl.C_list.transpose(-1, -2).clone())
        transposed = pl(torch.from_numpy(x))
    with pytest.raises(AssertionError):
        assert_agree(transposed, want, "float32", scale)
    diff = np.abs(_np(transposed) - _np(want)) / np.maximum(_np(scale), 1)
    assert diff.max() > 1e3 * F32_TOL


@pytest.mark.parametrize("reduce_sum", [True, False])
def test_inner_product_layer_matches_jax(reduce_sum):
    got = check_layer(jint.InnerProductLayer(reduce_sum),
                      pint.InnerProductLayer(reduce_sum, field_size=F),
                      _inputs(), "float32")
    assert got.shape == (B, F * (F - 1) // 2, 1 if reduce_sum else E)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel_type", ["mat", "vec", "num"])
def test_outter_product_layer_matches_jax(kernel_type, dtype):
    """``mat`` in the compute dtype; ``vec`` and ``num`` in the inputs'
    (float32), as the JAX layer."""
    got = check_layer(jint.OutterProductLayer(F, E, kernel_type),
                      pint.OutterProductLayer(F, E, kernel_type),
                      _inputs(), dtype)
    assert got.shape == (B, F * (F - 1) // 2)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         and kernel_type == "mat" else torch.float32)


# (JAX layer, its init input's shape, port layer) at widths where the
# draws' statistics are tight, every initializer of the slice
def _init_cases():
    g = torch.Generator().manual_seed(0)
    Fw, Ew = 26, 16
    return [
        (jint.CrossNet(3000, 3, "vector"), (2, 3000),
         pint.CrossNet(3000, 3, "vector", generator=g)),
        (jint.CrossNet(1000, 2, "matrix"), (2, 1000),
         pint.CrossNet(1000, 2, "matrix", generator=g)),
        (jint.CrossNetMix(3000, 32, 4, 2), (2, 3000),
         pint.CrossNetMix(3000, 32, 4, 2, generator=g)),
        (jint.InteractingLayer(128, 2), (2, 4, 128),
         pint.InteractingLayer(128, 2, generator=g)),
        (jint.BilinearInteraction(Fw, Ew, "interaction"), (2, Fw, Ew),
         pint.BilinearInteraction(Fw, Ew, "interaction", generator=g)),
        (jint.BilinearInteraction(Fw, Ew, "each"), (2, Fw, Ew),
         pint.BilinearInteraction(Fw, Ew, "each", generator=g)),
        (jint.BilinearInteraction(Fw, 64, "all"), (2, Fw, 64),
         pint.BilinearInteraction(Fw, 64, "all", generator=g)),
        (jint.OutterProductLayer(Fw, Ew, "mat"), (2, Fw, Ew),
         pint.OutterProductLayer(Fw, Ew, "mat", generator=g)),
        (jint.OutterProductLayer(Fw, Ew, "vec"), (2, Fw, Ew),
         pint.OutterProductLayer(Fw, Ew, "vec", generator=g)),
        (jint.AFMLayer(in_features=400, attention_factor=20000),
         (2, 3, 400), pint.AFMLayer(400, 20000, field_size=3, generator=g)),
        (jint.AFMLayer(in_features=20000, attention_factor=2),
         (2, 3, 20000), pint.AFMLayer(20000, 2, field_size=3, generator=g)),
        (jint.SENETLayer(325, 3), (2, 325, 4),
         pint.SENETLayer(325, 3, generator=g)),
    ]


# the initializers with a bound (uniform, or a normal truncated at two
# standard deviations): their largest magnitude is held too
BOUNDED = ("kernel", "gating", "attention_W", "projection_h",
           "projection_p", "reduce.weight", "expand.weight")


def test_init_draws_match_the_jax_initializers():
    """Each parameter as the JAX layer draws it: xavier-normal per leading
    slice (CrossNet's kernels, CrossNetMix's U, V, C), flax's
    xavier_normal (AFM, a normal truncated at two standard deviations),
    xavier_uniform (OutterProductLayer), variance_scaling(1/3, fan_in,
    uniform) (BilinearInteraction, the gating, on jax's fan-in of the
    stacked kernel), normal(0.05) (InteractingLayer), lecun-normal
    (SENETLayer's dense layers) and zeros (every bias).  The port's
    standard deviation within 3% of the JAX draw's, slice by slice, and,
    for the bounded initializers, its largest magnitude within 3%; each
    parameter of at least 10,000 values (a slice at least 1,000)."""
    for jl, shape, pl in _init_cases():
        jparams = jax.jit(jl.init)(jax.random.PRNGKey(0),
                                   jnp.zeros(shape, jnp.float32))["params"]
        want = jax_to_state_dict({"params": jparams}, {
            k: tuple(v.shape) for k, v in pl.state_dict().items()})
        for name, p in pl.named_parameters():
            got, ref = p.detach().numpy(), want[name]
            assert got.shape == ref.shape, name
            if not ref.any():
                assert not got.any(), (type(pl).__name__, name)
                continue
            if got.size < 10000:
                continue
            stacked = name.endswith("_list") or name == "kernels"
            for g, r in (zip(got, ref) if stacked else [(got, ref)]):
                assert g.size >= 1000
                assert abs(g.std() / r.std() - 1) < 0.03, (
                    type(pl).__name__, name, g.std(), r.std())
                if name in BOUNDED:
                    assert abs(np.abs(g).max() / np.abs(r).max() - 1) \
                        < 0.03, (type(pl).__name__, name)


def test_init_draws_hit_the_stated_scales():
    """The formulas themselves, on the port's draws: the per-slice
    xavier std sqrt(2 / (fan_in + fan_out)); U(+-1/sqrt(fan_in)) with the
    stacked axes in the fan-in; xavier_uniform's sqrt(6 / (fan_in +
    fan_out)); normal(0.05); the truncated xavier-normal's bound."""
    g = torch.Generator().manual_seed(1)
    cross = pint.CrossNet(3000, 2, "vector", generator=g)
    for s in cross.kernels.detach().numpy():
        assert abs(s.std() / math.sqrt(2 / 3001) - 1) < 0.05
    mix = pint.CrossNetMix(3000, 32, 4, 2, generator=g)
    for s in mix.U_list.detach().numpy():
        assert abs(s.std() / math.sqrt(2 / 3032) - 1) < 0.02
    for s in mix.C_list.detach().numpy():
        assert abs(s.std() / math.sqrt(2 / 64) - 1) < 0.05
    for p, bound in (
            (mix.gating, 1 / math.sqrt(3000 * 4)),
            (pint.BilinearInteraction(26, 16, generator=g).kernel,
             1 / math.sqrt(325 * 16)),
            (pint.BilinearInteraction(26, 16, "each", generator=g).kernel,
             1 / math.sqrt(26 * 16)),
            (pint.OutterProductLayer(26, 16, generator=g).kernel,
             math.sqrt(6 / (325 * 16 + 16 * 16))),
            (pint.OutterProductLayer(26, 16, "num", generator=g).kernel,
             math.sqrt(6 / (325 + 1)))):
        w = np.abs(p.detach().numpy())
        assert w.max() <= bound and w.max() > 0.98 * bound
    att = pint.InteractingLayer(128, 2, generator=g)
    for name in ("W_Query", "W_key", "W_Value", "W_Res"):
        assert abs(getattr(att, name).detach().numpy().std() / 0.05 - 1) \
            < 0.03
    afm = pint.AFMLayer(400, 300, field_size=3, generator=g)
    w, std = afm.attention_W.detach().numpy(), math.sqrt(2 / 700)
    assert abs(w.std() / std - 1) < 0.02
    assert np.abs(w).max() <= 2 * std / 0.8796256610342398
    assert not afm.attention_b.detach().any()
    assert not cross.bias.detach().any() and not mix.bias.detach().any()


def test_layers_raise_where_the_jax_layers_do():
    with pytest.raises(ValueError):
        pint.InteractingLayer(E, 0)
    with pytest.raises(ValueError):
        pint.InteractingLayer(E, 3)
    with pytest.raises(ValueError):
        pint.CrossNet(E, 2, "diagonal")
    with pytest.raises(ValueError):
        pint.OutterProductLayer(F, E, "tensor")
    with pytest.raises(NotImplementedError):
        pint.BilinearInteraction(F, E, "pairwise")
    with pytest.raises(NotImplementedError, match="dropout"):
        pint.AFMLayer(E, dropout_rate=0.5, field_size=F)
    x = torch.zeros(B, F * E)
    for layer in (pint.SENETLayer(F), pint.InteractingLayer(E)):
        with pytest.raises(ValueError, match=r"\[B, F, E\]"):
            layer(x)
