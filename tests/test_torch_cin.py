"""The port's CIN op and layer (deepctr_tpu_torch/ops/cin.py,
``layers.interaction.CIN``) against the JAX package: the plain versions
``cin_mix_ref``/``cin_layer_ref`` against the JAX ones, against the Pallas
CIN kernel in interpret mode (forward and gradients), the explicit
backward of ``CinMix`` (``cin_mix_bwd``) against ``jax.grad``, and the
layer with the JAX weights carried across.

On the CPU ``cin_mix`` takes its plain version; the CUDA kernel
(``csrc/cin_mix.cu``) is held against that plain version on the card by
``chip_smoke.py``.

Tolerances.  float32: 1e-5, relative to values above 1 (another order of
sums).  bfloat16: one bf16 ulp, or 1e-5 (both sides round the same
bf16-rounded products' float32 sum once).  The bfloat16 layer: 2e-2
relative to the output's scale, since a one-ulp difference in a layer's
maps carries into the next layer's products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepctr_tpu as dt
from deepctr_tpu.layers import CIN as JCIN
from deepctr_tpu.ops import pallas as P
from deepctr_tpu.ops import reference as jref
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import CIN as PCIN
from deepctr_tpu_torch.ops import cin as p_cin
from deepctr_tpu_torch.ops._build import LAUNCHES
from deepctr_tpu_torch.ops import dispatch as p_dispatch
from deepctr_tpu_torch.ops import reference as pref
from tests.test_torch_cin_bwd_card import BWD_PLANS

F32_ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, D, H, F, O): the slice's two layer shapes cut in B, a split_half=False
# layer-1 shape, and odd small ones (ragged rows, K and O)
SHAPES = [(8, 16, 26, 26, 64), (8, 16, 128, 26, 32), (4, 16, 256, 26, 16),
          (5, 3, 5, 3, 7), (1, 1, 1, 1, 1)]


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
    """float32: within F32_ATOL relative to max(1, scale), ``scale`` the
    sum of the magnitudes of the terms each output sums (|want| unless
    given); bfloat16: within one bf16 ulp of the larger magnitude, or
    that float32 tolerance."""
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(b) if scale is None else _np(scale), 1.0)
    if dtype == "float32":
        assert rel.max() <= F32_ATOL, rel.max()
        return
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = (diff > ulp) & (rel > F32_ATOL)
    assert not bad.any(), (diff / ulp).max()


def _scales(h, x, w3, g=None):
    """sum_k |w z| of every output, and with a cotangent g the sums of
    term magnitudes of dh, dx and dwt, in float32."""
    h, x, w3 = (torch.from_numpy(np.array(_np(a))).abs()
                for a in (h, x, w3))
    out = pref.cin_mix_ref(h, x, w3)
    if g is None:
        return out
    wt = p_cin.kernel_weight(w3, torch.float32)
    return (out,) + p_cin.cin_mix_bwd(h, x, wt,
                                      torch.from_numpy(np.array(_np(g))).abs())


def _inputs(shape, seed, w_std=0.3):
    B, D, H, F, O = shape
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (B, D, H)).astype(np.float32)
    x = rng.normal(0, 1, (B, D, F)).astype(np.float32)
    w3 = rng.normal(0, w_std, (O, H, F)).astype(np.float32)
    return h, x, w3


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cin_mix_ref_matches_jax(shape, dtype):
    (jh, jx, jw), (th, tx, tw) = _both(_inputs(shape, 0), dtype)
    got = pref.cin_mix_ref(th, tx, tw)
    want = jref.cin_mix_ref(jh, jx, jw)
    assert got.dtype == th.dtype and tuple(got.shape) == want.shape
    assert_agree(got, want, dtype, _scales(th, tx, tw))


def test_cin_layer_ref_matches_jax_and_cin_mix():
    B, D, H, F, O = 6, 8, 12, 5, 10
    rng = np.random.default_rng(1)
    hidden = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    x0 = rng.normal(0, 1, (B, F, D)).astype(np.float32)
    w = rng.normal(0, 0.3, (O, H * F)).astype(np.float32)
    b = rng.normal(0, 0.3, (O,)).astype(np.float32)
    got = pref.cin_layer_ref(*map(torch.from_numpy, (hidden, x0, w, b)))
    want = jref.cin_layer_ref(hidden, x0, w, b)
    assert_agree(got, want, "float32")
    got_d = p_dispatch.cin_layer(*map(torch.from_numpy, (hidden, x0, w, b)))
    assert_agree(got_d, want, "float32")
    mixed = pref.cin_mix_ref(torch.from_numpy(hidden).transpose(1, 2),
                             torch.from_numpy(x0).transpose(1, 2),
                             torch.from_numpy(w.reshape(O, H, F)))
    assert_agree(mixed.transpose(1, 2) + torch.from_numpy(b)[:, None], want,
                 "float32")


# ---------------------------------------------------------------------------
# against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def test_cin_mix_matches_the_pallas_kernel_forward_and_grads():
    """The wrapper on CPU tensors (its plain version, autograd through it)
    against ``deepctr_tpu.ops.pallas.cin_mix`` in interpret mode, at a
    shape its gate takes (B a multiple of 8, H = 128)."""
    shape = (8, 4, 128, 5, 16)
    h, x, w3 = _inputs(shape, 2, w_std=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = P.cin_mix(h, x, w3)
        jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(P.cin_mix(*a))),
                          argnums=(0, 1, 2))(h, x, w3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (h, x, w3)]
    got = p_cin.cin_mix(*leaves)
    scales = _scales(h, x, w3, np.ones(want.shape, np.float32))
    assert_agree(got, want, "float32", scales[0])
    torch.sin(got).sum().backward()
    O, H, F = w3.shape
    dw3_scale = scales[3].reshape(F, H, O).permute(2, 1, 0)
    for leaf, g, scale in zip(leaves, jgrads, scales[1:3] + (dw3_scale,)):
        assert_agree(leaf.grad, g, "float32", scale)


@pytest.mark.parametrize("shape", [(4, 16, 26, 26, 32), (3, 5, 7, 3, 9)])
def test_cin_mix_bwd_matches_jax_grad(shape):
    """``CinMix``'s backward (``cin_mix_bwd``, run here on CPU tensors)
    against ``jax.vjp`` through the JAX ``cin_mix_ref``; the weight's
    cotangent comes back in the kernel's layout wt [F*H, O]."""
    B, D, H, F, O = shape
    h, x, w3 = _inputs(shape, 3)
    g = np.random.default_rng(4).normal(0, 1, (B, D, O)).astype(np.float32)
    _, vjp = jax.vjp(jref.cin_mix_ref, h, x, w3)
    dh_j, dx_j, dw3_j = vjp(jnp.asarray(g))
    th, tx, tw3 = map(torch.from_numpy, (h, x, w3))
    wt = p_cin.kernel_weight(tw3, torch.float32)
    dh, dx, dwt = p_cin.cin_mix_bwd(th, tx, wt, torch.from_numpy(g))
    _, s_h, s_x, s_wt = _scales(h, x, w3, g)
    assert_agree(dh, dh_j, "float32", s_h)
    assert_agree(dx, dx_j, "float32", s_x)
    assert tuple(dwt.shape) == (F * H, O)
    assert_agree(dwt, np.transpose(np.asarray(dw3_j), (2, 1, 0)).reshape(
        F * H, O), "float32", s_wt)


def test_kernel_weight_is_the_pallas_layout():
    O, H, F = 7, 5, 3
    w3 = np.arange(O * H * F, dtype=np.float32).reshape(O, H, F)
    want = np.transpose(w3, (2, 1, 0)).reshape(F * H, O)   # pallas.py:130
    for dtype in (torch.float32, torch.bfloat16):
        wt = p_cin.kernel_weight(torch.from_numpy(w3), dtype)
        assert wt.dtype == dtype and wt.is_contiguous()
        np.testing.assert_array_equal(wt.float().numpy(),
                                      want.astype(np.float32)
                                      if dtype == torch.float32 else
                                      torch.from_numpy(want).to(dtype)
                                      .float().numpy())


def test_cin_mix_on_the_cpu_takes_the_plain_version_and_checks_shapes():
    h, x, w3 = map(torch.from_numpy, _inputs((2, 3, 4, 5, 6), 5))
    LAUNCHES["cin_mix"] = 0
    got = p_cin.cin_mix(h, x, w3)
    assert LAUNCHES["cin_mix"] == 0
    np.testing.assert_array_equal(got.numpy(),
                                  pref.cin_mix_ref(h, x, w3).numpy())
    with pytest.raises(ValueError):
        p_cin.cin_mix(h, x[:, :, :4], w3)
    with pytest.raises(ValueError):
        p_cin.cin_mix(h[0], x, w3)
    with pytest.raises(ValueError):
        p_cin.cin_mix(h, x[:1], w3)


def test_the_kernel_reads_split_half_views_at_their_row_stride():
    """The kernel takes [B, D, n] views whose (b, d) rows lie at one
    stride (the first half of a layer's maps); others are refused."""
    maps = torch.zeros(4, 16, 256)
    first, _ = torch.split(maps, 128, dim=-1)
    assert p_cin._rows(first) == 256
    assert p_cin._rows(torch.zeros(4, 16, 26)) == 26
    assert p_cin._rows(torch.zeros(1, 1, 5)) == 5
    assert p_cin._rows(torch.zeros(4, 26, 16).transpose(1, 2)) is None
    assert p_cin._rows(maps[:, ::2, :128]) == 512
    assert p_cin._rows(maps[:, :8, :128]) is None


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_pair(F, layer_size, split_half, activation, seed):
    """A JAX CIN's initial weights (biases redrawn, so that they count)
    and the port's layer holding them."""
    jl = JCIN(field_size=F, layer_size=layer_size, activation=activation,
              split_half=split_half)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (16, F, 8)).astype(np.float32)
    params = jax.tree_util.tree_map(np.array,
                                    jl.init(jax.random.PRNGKey(seed), x)
                                    ["params"])
    for i in range(len(layer_size)):
        params["conv_b_%d" % i] = rng.normal(
            0, 0.3, params["conv_b_%d" % i].shape).astype(np.float32)
    pl = PCIN(F, layer_size, activation=activation, split_half=split_half,
              device="cpu")
    pl.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return jl, params, pl, x


@pytest.mark.parametrize("activation", ["relu", "linear"])
@pytest.mark.parametrize("split_half", [True, False])
def test_cin_layer_matches_jax(split_half, activation):
    jl, params, pl, x = _layer_pair(6, (8, 6, 4), split_half, activation, 6)
    want = jl.apply({"params": params}, x)
    with torch.no_grad():
        got = pl(torch.from_numpy(x))
    maps = (4 + 3 + 4) if split_half else (8 + 6 + 4)
    assert tuple(got.shape) == (16, maps) == want.shape
    assert_agree(got, want, "float32")


def test_cin_layer_matches_jax_at_bf16():
    dt.set_compute_dtype("bfloat16")   # restored by the conftest
    pt_config.set_compute_dtype("bfloat16")
    jl, params, pl, x = _layer_pair(26, (16, 8), True, "relu", 7)
    want = _np(jl.apply({"params": params}, x))
    with torch.no_grad():
        got = pl(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-2 * scale)


def test_cin_init_draws_the_jax_bound():
    """U(+-1/sqrt(size)) on ``conv_w_<i> [size, in_ch]``, as the JAX
    layer's variance_scaling(1/3, fan_in, uniform) draws it; zero biases."""
    F, sizes = 26, (256, 128)
    jl = JCIN(field_size=F, layer_size=sizes)
    jparams = jl.init(jax.random.PRNGKey(0), np.zeros((2, F, 4), np.float32))
    pl = PCIN(F, sizes, device="cpu",
              generator=torch.Generator().manual_seed(0))
    for i, size in enumerate(sizes):
        bound = size ** -0.5
        jw = np.asarray(jparams["params"]["conv_w_%d" % i])
        pw = getattr(pl, "conv_w_%d" % i).detach().numpy()
        assert jw.shape == pw.shape
        for w in (jw, pw):
            assert np.abs(w).max() <= bound
            assert np.abs(w).max() > 0.99 * bound
            assert abs(w.std() - bound / np.sqrt(3)) < 0.01 * bound
        assert not getattr(pl, "conv_b_%d" % i).any()


def test_cin_raises_where_the_jax_layer_does():
    x = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(ValueError):
        JCIN(field_size=4, layer_size=()).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        PCIN(4, (), device="cpu")
    with pytest.raises(ValueError):
        JCIN(field_size=4, layer_size=(5, 4)).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        PCIN(4, (5, 4), device="cpu")
    # odd sizes are fine without split_half, and in the last layer
    PCIN(4, (5, 3), split_half=False, device="cpu")
    PCIN(4, (6, 3), device="cpu")
    with pytest.raises(ValueError):
        JCIN(field_size=4).init(jax.random.PRNGKey(0), x[0])
    with pytest.raises(ValueError):
        PCIN(4, device="cpu")(torch.from_numpy(x[0]))
    # one Dice shared by the layers: sizes that differ fail to broadcast in
    # the JAX layer's second layer (a TypeError) and raise here at
    # construction (tests/test_torch_param_activations.py)
    with pytest.raises(TypeError):
        JCIN(field_size=4, layer_size=(6, 4), activation="dice").init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        PCIN(4, (6, 4), activation="dice", device="cpu")
    PCIN(4, activation="dice", device="cpu")


# ---------------------------------------------------------------------------
# the tensor-core kernel's weight layout (ops.cin.mma_weight)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 26, 26, 256), (16, 128, 26, 128),
                                   (3, 5, 3, 7), (4, 26, 26, 100)])
def test_mma_weight_round_trips_to_w3(shape):
    """[Op, F*Hp], K contiguous: w3[o, h, f] at (o, f*Hp + h), zeros in the
    padding (H to a multiple of 16, O to a multiple of 8)."""
    _, H, F, O = shape
    w3 = np.random.default_rng(H).normal(0, 1, (O, H, F)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        wt = p_cin.kernel_weight(torch.from_numpy(w3), dtype)
        wm = p_cin.mma_weight(wt, H, F)
        Hp, Op = -(-H // 16) * 16, -(-O // 8) * 8
        assert wm.dtype == dtype and wm.is_contiguous()
        assert tuple(wm.shape) == (Op, F * Hp)
        grid = wm.reshape(Op, F, Hp)
        assert not grid[O:].any() and not grid[:, :, H:].any()
        back = grid[:O, :, :H].permute(0, 2, 1)
        np.testing.assert_array_equal(
            back.float().numpy(),
            torch.from_numpy(w3).to(dtype).float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 16, 26, 26, 64), (4, 16, 128, 26, 32),
                                   (5, 3, 5, 3, 7), (8, 4, 26, 26, 100)])
def test_cin_mix_mma_ref_matches_jax(shape, dtype):
    """The product in the tensor-core layout (padding included) against the
    JAX ``cin_mix_ref`` and the Pallas kernel's layout."""
    B, D, H, F, O = shape
    (jh, jx, jw), (th, tx, tw) = _both(_inputs(shape, 11), dtype)
    wm = p_cin.mma_weight(p_cin.kernel_weight(tw, th.dtype), H, F)
    got = p_cin.cin_mix_mma_ref(th, tx, wm, O)
    assert got.dtype == th.dtype and tuple(got.shape) == (B, D, O)
    assert_agree(got, jref.cin_mix_ref(jh, jx, jw), dtype,
                 _scales(th, tx, tw))
    assert_agree(got, pref.cin_mix_ref(th, tx, tw), dtype,
                 _scales(th, tx, tw))


def test_cin_mix_mma_ref_matches_the_pallas_kernel():
    shape = (8, 4, 128, 5, 16)
    h, x, w3 = _inputs(shape, 12, w_std=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = P.cin_mix(h, x, w3)
    th, tx, tw = map(torch.from_numpy, (h, x, w3))
    wm = p_cin.mma_weight(p_cin.kernel_weight(tw, torch.float32), 128, 5)
    assert_agree(p_cin.cin_mix_mma_ref(th, tx, wm, 16), want, "float32",
                 _scales(h, x, w3))


# ---------------------------------------------------------------------------
# the compute-dtype modes (config.set_cin_dtype, DEEPCTR_CIN_DTYPE)
# ---------------------------------------------------------------------------

@pytest.fixture
def _restore_cin_dtype():
    saved = pt_config.cin_dtype()
    yield
    pt_config.set_cin_dtype(saved)


# per mode: the forward's tolerance relative to max |output|, the
# gradients' relative to each leaf's max |gradient|.  f32 and carry: the
# float32 sums of one set of bfloat16 (carry) or float32 operands in
# another order.  bf16 and carry's gradients: a bf16 ulp (2^-8) of a map
# that differs carries into the next layer's products and the sums of the
# backward, a few ulps of the largest value.
MODE_TOL = {"bf16": (2e-2, 5e-2), "carry": (1e-3, 5e-2), "f32": (1e-5, 1e-5)}


@pytest.mark.parametrize("mode", sorted(MODE_TOL))
def test_cin_modes_match_the_jax_layer_in_bf16_training(
        mode, monkeypatch, _restore_cin_dtype):
    """The JAX CIN under ``DEEPCTR_CIN_DTYPE`` (in a training trace, its
    default) against the port's under ``set_cin_dtype`` in training, at
    bfloat16 compute: the output's dtype (float32 under carry and f32),
    the forward, and the gradients of every weight and of the input."""
    monkeypatch.setenv("DEEPCTR_CIN_DTYPE", mode)
    dt.set_compute_dtype("bfloat16")   # restored by the conftest
    pt_config.set_compute_dtype("bfloat16")
    pt_config.set_cin_dtype(mode)
    jl, params, pl, x = _layer_pair(26, (16, 8), True, "relu", 7)
    out, vjp = jax.vjp(lambda p, xx: jl.apply({"params": p}, xx), params,
                       jnp.asarray(x))
    g = np.random.default_rng(8).normal(0, 1, out.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(g, out.dtype))
    tx = torch.from_numpy(x).requires_grad_()
    got = pl(tx, training=True)
    want_dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    assert got.dtype == want_dtype and out.dtype == (
        jnp.bfloat16 if mode == "bf16" else jnp.float32)
    got.backward(torch.from_numpy(g).to(got.dtype))
    fwd_tol, grad_tol = MODE_TOL[mode]
    want = _np(out)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=fwd_tol * np.abs(want).max())
    pairs = [(getattr(pl, k).grad, gp[k], k) for k in params]
    for a, b, k in pairs + [(tx.grad, gx, "x")]:
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=grad_tol * np.abs(b).max(),
                                   err_msg=k)
    # at inference every mode runs the compute dtype, as the JAX layer
    with torch.no_grad():
        assert pl(torch.from_numpy(x)).dtype == torch.bfloat16


def test_cin_mix_ref_float32_output_matches_jax():
    """bfloat16 operands, float32 output: ``preferred_element_type`` in
    the JAX einsum; the same float32 sums of exact products, in another
    order (1e-5 relative to sum_k |w z|)."""
    shape = (8, 16, 26, 26, 64)
    (jh, jx, jw), (th, tx, tw) = _both(_inputs(shape, 11), "bfloat16")
    got = pref.cin_mix_ref(th, tx, tw, out_dtype=torch.float32)
    want = jref.cin_mix_ref(jh, jx, jw, out_dtype=jnp.float32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_agree(got, want, "float32", _scales(th, tx, tw))
    # the wrapper on CPU tensors takes it, and refuses other outputs
    np.testing.assert_array_equal(
        p_cin.cin_mix(th, tx, tw, out_dtype=torch.float32).numpy(),
        got.numpy())
    with pytest.raises(ValueError, match="out_dtype"):
        p_cin.cin_mix(th, tx, tw, out_dtype=torch.float16)


@pytest.mark.parametrize("shape", [(4, 16, 26, 26, 32), (3, 5, 7, 3, 9)])
def test_cin_mix_bwd_of_the_float32_output_matches_jax(shape):
    """``CinMix``'s backward under carry (bfloat16 operands, a float32
    cotangent) against ``jax.vjp`` of the JAX ``cin_mix_ref`` with
    ``out_dtype=float32``: the cotangent enters the products unrounded
    and each product rounds once to bfloat16, as JAX's transposes do
    (one bf16 ulp; rounding the cotangent to bfloat16 first leaves half
    the values an ulp off)."""
    B, D, H, F, O = shape
    (jh, jx, jw), (th, tx, tw) = _both(_inputs(shape, 12), "bfloat16")
    g = np.random.default_rng(13).normal(0, 1, (B, D, O)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jref.cin_mix_ref(*a, out_dtype=jnp.float32),
                     jh, jx, jw)
    dh_j, dx_j, dw3_j = vjp(jnp.asarray(g))
    wt = p_cin.kernel_weight(tw, torch.bfloat16)
    dh, dx, dwt = p_cin.cin_mix_bwd(th, tx, wt, torch.from_numpy(g))
    assert dh.dtype == dx.dtype == dwt.dtype == torch.bfloat16
    assert_agree(dh, dh_j, "bfloat16")
    assert_agree(dx, dx_j, "bfloat16")
    assert_agree(dwt, np.transpose(_np(dw3_j), (2, 1, 0)).reshape(F * H, O),
                 "bfloat16")


def test_set_cin_dtype_rejects_other_modes_and_keys_the_graphs(
        _restore_cin_dtype):
    from deepctr_tpu_torch.models.basemodel import BaseModel
    with pytest.raises(ValueError, match="CIN dtype"):
        pt_config.set_cin_dtype("fp16")
    keys = set()
    for mode in ("bf16", "carry", "f32"):
        pt_config.set_cin_dtype(mode)
        assert pt_config.cin_dtype() == mode
        keys.add(BaseModel._graph_key("fit", 4096))
    assert len(keys) == 3


# ---------------------------------------------------------------------------
# the hand-written backward's route and plain version (csrc/cin_mix_bwd.cu)
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,g_dtype,shape,want", [
    # the benchmark's xDeepFM layers and DeepCTR's 256-128 split_half
    (BF16, BF16, (26, 26, 200), "mma"), (BF16, BF16, (200, 26, 200), "mma"),
    (BF16, BF16, (26, 26, 256), "mma"), (BF16, BF16, (128, 26, 128), "mma"),
    # ragged H, O and F
    (BF16, BF16, (5, 3, 7), "mma"), (BF16, BF16, (26, 26, 61), "mma"),
    (BF16, BF16, (400, 26, 72), "mma"),
    # the carry mode's float32 cotangent, float32 compute
    (BF16, F32, (200, 26, 200), "einsum"), (F32, F32, (200, 26, 200),
                                            "einsum"),
    # hidden rows too wide for K6's tensor-core route (the backward keeps
    # no hid rows in shared memory), and cotangent rows too wide for it
    (BF16, BF16, (1000, 26, 256), "mma"), (BF16, BF16, (200, 26, 1024),
                                           "einsum")])
def test_cin_bwd_route_is_a_function_of_dtypes_and_shapes(
        monkeypatch, dtype, g_dtype, shape, want):
    """The library's plans (``BWD_PLANS``, which the card test holds
    ``bwd_plan`` to) stand in for it here, where it cannot be built."""
    asked = []

    def plan_of(*hfo):
        asked.append(hfo)
        return BWD_PLANS[hfo]
    monkeypatch.setattr(p_cin, "bwd_plan", plan_of)
    assert p_cin.bwd_route(dtype, g_dtype, *shape) == want
    # the dtypes decide first: the plan is asked for bfloat16 alone
    assert asked == ([shape] if dtype == g_dtype == BF16 else [])
    plan = BWD_PLANS[shape]
    if plan is None:
        return
    H, F, O = shape
    # the tiles cover H, F and O
    assert plan["nch"] * plan["NT"] >= H > (plan["nch"] - 1) * plan["NT"]
    assert plan["FG"] * plan["NT"] <= 208
    assert plan["XF"] >= F and plan["XF"] % 2 == 1
    assert plan["NO"] >= min(O, 256) and plan["NO"] in (64, 128, 208, 256)
    assert plan["hb_log2"] in (4, 5, 6)
    assert plan["FB"] << plan["hb_log2"] == 128
    assert 2 <= plan["stages"] <= 12 and 2 <= plan["w_stages"] <= 12


def test_cin_bwd_plan_at_the_benchmark_shapes_by_hand():
    # layer 0: H = 26 in one chunk of 32; layers 1-2: 200 in two of 104
    p0, p1 = BWD_PLANS[(26, 26, 200)], BWD_PLANS[(200, 26, 200)]
    assert (p0["NT"], p0["nch"], p0["NO"]) == (32, 1, 208)
    assert (p1["NT"], p1["nch"], p1["NO"]) == (104, 2, 208)
    # dwt's rows in tiles of 32 maps by 4 fields: 7 x 1 and 7 x 7 tiles
    assert p0["hb_log2"] == p1["hb_log2"] == 5
    # one block an SM on 132: 7 tiles x 18 splits fill 95% of one wave,
    # 49 x 8 of three
    assert p_cin.weight_splits(40960, 26, 26, 200, p0, 132) == (2304, 18)
    assert p_cin.weight_splits(40960, 200, 26, 200, p1, 132) == (5120, 8)
    # every split a whole number of 64-row chunks, none empty
    for M in (1, 63, 64, 770, 40960):
        rows, splits = p_cin.weight_splits(M, 26, 26, 61, p0, 132)
        assert rows % 64 == 0 and rows * splits >= M > rows * (splits - 1)


def _bf16_bound(got, want, scale):
    """|got - want| within 2^-8 of the terms' magnitude sum (dz, or z,
    rounded to bfloat16 before a float32 sum: 2^-9 relative each) and one
    bf16 ulp of |want| (the final rounding)."""
    a, b, s = _np(got), _np(want), _np(scale)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
    assert np.all(np.abs(a - b) <= 2.0 ** -8 * s + ulp + 1e-6), \
        np.max(np.abs(a - b) - 2.0 ** -8 * s - ulp)


@pytest.mark.parametrize("shape,rows", [((4, 16, 26, 26, 32), None),
                                        ((3, 5, 7, 3, 9), 64),
                                        ((77, 3, 26, 5, 61), 64)])
def test_cin_mix_bwd_mma_ref_matches_jax_grad(shape, rows):
    """The kernels' order of rounding and sums (``cin_mix_bwd_mma_ref``:
    dz rounded a field at a time, float32 dh and dx, dwt over row splits
    added in order) against ``jax.vjp`` through the JAX ``cin_mix_ref``:
    float32 within 1e-5 of the terms' magnitudes, bfloat16 inputs within
    the roundings' bound; and at bfloat16 beside the einsums'
    ``cin_mix_bwd`` within the same bound."""
    B, D, H, F, O = shape
    h, x, w3 = _inputs(shape, 7)
    g = np.random.default_rng(8).normal(0, 1, (B, D, O)).astype(np.float32)
    _, s_h, s_x, s_wt = _scales(h, x, w3, g)
    for dtype in ("float32", "bfloat16"):
        td = DTYPES[dtype][1]
        th, tx, tw3, tg = (torch.from_numpy(a).to(td) for a in (h, x, w3, g))
        # JAX in float32 from the same (bf16-rounded) values
        _, vjp = jax.vjp(jref.cin_mix_ref, *(jnp.asarray(_np(t))
                                             for t in (th, tx, tw3)))
        dh_j, dx_j, dw3_j = vjp(jnp.asarray(_np(tg)))
        dwt_j = np.transpose(np.asarray(dw3_j), (2, 1, 0)).reshape(F * H, O)
        wt = p_cin.kernel_weight(tw3, td)
        got = p_cin.cin_mix_bwd_mma_ref(th, tx, wt, tg, rows)
        assert [t.dtype for t in got] == [td] * 3
        assert tuple(got[2].shape) == (F * H, O)
        if dtype == "float32":
            for a, b, s in zip(got, (dh_j, dx_j, dwt_j), (s_h, s_x, s_wt)):
                assert_agree(a, b, "float32", s)
            continue
        einsum = p_cin.cin_mix_bwd(th, tx, wt, tg)
        for a, e, b, s in zip(got, einsum, (dh_j, dx_j, dwt_j),
                              (s_h, s_x, s_wt)):
            _bf16_bound(a, b, s)
            _bf16_bound(e, b, s)


def test_cin_bwd_on_the_cpu_takes_the_einsums_and_counts_no_launch():
    """On CPU tensors autograd differentiates the plain forward: neither
    backward counter moves."""
    h, x, w3 = (torch.from_numpy(a).requires_grad_()
                for a in _inputs((2, 3, 4, 5, 6), 9))
    LAUNCHES["cin_mix_bwd"] = LAUNCHES["cin_mix_bwd_einsum"] = 0
    p_cin.cin_mix(h, x, w3).sum().backward()
    assert LAUNCHES["cin_mix_bwd"] == LAUNCHES["cin_mix_bwd_einsum"] == 0
    assert h.grad is not None and w3.grad is not None
