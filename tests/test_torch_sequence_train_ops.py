"""The port's training ops for the sequence models against the JAX package:
the GRU scan's backward (deepctr_tpu_torch/ops/gru.py: ``gru_scan_bwd_ref``,
the plain version of ``csrc/gru_scan_bwd.cu``; ``GruScan``; autograd
through ``gru_scan`` on the CPU) against the Pallas kernel's VJP in
interpret mode, and the batch norms that train (Dice, ``DNN(use_bn=True)``)
against flax, with ``load_jax_weights`` for their leaves.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``.

Tolerances.  float32: 1e-5, relative to values above 1 (another order of
sums, other sigmoid and tanh implementations).  bfloat16: one bf16 ulp,
or 1e-5 (both sides are float32 results rounded once).  dW_hh and db_hh
are sums over every (t, b): within 1e-5 of the sum of the absolute values
of their terms (at least 1); at bfloat16 the JAX wrapper rounds dW_hh to
bf16, so the port's is rounded the same way and held to one bf16 ulp.
The batch norms: 1e-5 at float32 (sums over the batch in another
order); the parameter gradients of a two-layer batch-norm tower 1e-4:
each batch norm's backward subtracts batch means of products, terms of
order 1 that cancel, so two float32 evaluations part at about 1e-5 of
those terms a layer."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.layers.activation import Dice as JDice
from deepctr_tpu.layers.core import DNN as JDNN
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu.ops import pallas_gru as PG
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import activation as pact
from deepctr_tpu_torch.layers import core as pcore
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.ops import gru as p_gru
from deepctr_tpu_torch.utils.jax_weights import (jax_batch_stats,
                                                 jax_to_state_dict,
                                                 load_jax_weights)

F32_ATOL = 1e-5
BN_GRAD_ATOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = ("gru", "agru", "augru")


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_agree(got, want, dtype):
    """float32: within F32_ATOL relative to values above 1; bfloat16:
    within one bf16 ulp of the larger magnitude, or F32_ATOL."""
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    if dtype == "float32":
        rel = diff / np.maximum(np.abs(b), 1.0)
        assert rel.max() <= F32_ATOL, rel.max()
        return
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = (diff > ulp) & (diff > F32_ATOL)
    assert not bad.any(), (diff / ulp).max()


def _lengths(rng, B, T):
    lengths = rng.integers(0, T + 1, B)
    lengths[:3] = [0, 1, T]
    return lengths


def _inputs(mode, B, T, H, seed, masks="prefix"):
    """gi, whh_t, bhh, mask, att, and the cotangents of outs and h_last,
    from normal draws (the weights at std 0.3).  ``masks="holes"`` drops
    about 30% of the histories' steps, keeps row 3 valid at every step and
    row 0 at none: holes, trailing padding, an empty row and a full-length
    row in one batch."""
    rng = np.random.default_rng(seed)
    gi = rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32)
    whh_t = rng.normal(0, 0.3, (H, 3 * H)).astype(np.float32)
    bhh = rng.normal(0, 0.3, (3 * H,)).astype(np.float32)
    lengths = _lengths(rng, B, T)
    mask = np.arange(T)[None, :] < lengths[:, None]
    if masks == "holes":
        mask = mask & (rng.random((B, T)) < 0.7)
        mask[3] = True
        mask[0] = False
    mask = mask.astype(np.float32)
    att = None if mode == "gru" else rng.random((B, T)).astype(np.float32)
    douts = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    dh_last = rng.normal(0, 1, (B, H)).astype(np.float32)
    return dict(gi=gi, whh_t=whh_t, bhh=bhh, mask=mask, att=att,
                douts=douts, dh_last=dh_last, lengths=lengths)


@functools.lru_cache(maxsize=None)
def _jax_case(mode, dtype, seed, masks="prefix"):
    """The inputs of ``_inputs(mode, 64, 12, 8, seed, masks)`` and the
    Pallas kernel's outputs and VJP on them (interpret mode is slow: the
    two tests that read a case share it)."""
    d = _inputs(mode, 64, 12, 8, seed, masks)
    return d, _jax_vjp(d, mode, DTYPES[dtype][0])


def _jax_vjp(d, mode, jd):
    """The Pallas kernel (interpret mode) through jax.vjp: (outs, h_last),
    and the cotangents of gi, whh_t, bhh (and att)."""
    args = [jnp.asarray(d[k], jd) for k in ("gi", "whh_t", "bhh")]
    mask = jnp.asarray(d["mask"], jd)
    if mode != "gru":
        args.append(jnp.asarray(d["att"], jd))

    def f(gi, whh_t, bhh, *att):
        return PG.gru_scan(gi, whh_t, bhh, mask, att=att[0] if att else None,
                           mode=mode, interpret=True)
    out, vjp = jax.vjp(f, *args)
    cots = (jnp.asarray(d["douts"], jd), jnp.asarray(d["dh_last"], jd))
    return out, vjp(cots)


def _jax_carry(d, mode, jd):
    """The carries the Pallas forward saves for its backward (``_fwd_call``
    with save_carry, as ``gru_scan`` pads and lays out its inputs)."""
    T, B, H3 = d["gi"].shape
    _, B_blk, Tc = PG.gru_scan_supported(B, T, H3 // 3, jd)
    Tp = -(-T // Tc) * Tc
    pad = ((0, Tp - T), (0, 0), (0, 0))
    gi = jnp.pad(jnp.asarray(d["gi"], jd), pad)
    mask = jnp.pad(jnp.asarray(d["mask"].T[:, :, None], jd), pad)
    att = (None if mode == "gru" else
           jnp.pad(jnp.asarray(d["att"].T[:, :, None], jd), pad))
    _, _, carry = PG._fwd_call((mode, B_blk, Tc, True), gi,
                               jnp.asarray(d["whh_t"], jd),
                               jnp.asarray(d["bhh"], jd).reshape(1, -1),
                               mask, att)
    return carry[:T]


def _port(d, td, *keys):
    out = []
    for k in keys:
        v = d[k]
        if v is None:
            out.append(None)
        elif k == "mask":
            out.append(torch.from_numpy(v) != 0)
        elif k in ("whh_t", "bhh"):
            # the weights rounded to the storage type and held in float32,
            # as the layers give them
            out.append(torch.from_numpy(v).to(td).float())
        else:
            out.append(torch.from_numpy(v).to(td))
    return out


def _d_gh(d, carry, dgi, H):
    """d_gh = [d_pre_r, d_pre_z, d_pre_n * r], r recomputed in float32."""
    gh = carry @ d["whh_t"] + d["bhh"]
    r = 1.0 / (1.0 + np.exp(-(d["gi"][:, :, :H] + gh[:, :, :H])))
    return np.concatenate([dgi[:, :, :2 * H], dgi[:, :, 2 * H:] * r], -1)


def _check_bwd_ref_against_pallas(mode, dtype, masks):
    """gru_scan_bwd_ref from the carries the Pallas forward saved against
    the Pallas kernel's VJP: dgi, d(att), zeros on padded steps, dW_hh and
    db_hh against the sum of their terms' magnitudes."""
    jd, td = DTYPES[dtype]
    B, T, H = 64, 12, 8
    d, (_, grads) = _jax_case(mode, dtype, 1, masks)
    carry = _jax_carry(d, mode, jd)
    gi, whh_t, bhh, mask, att, douts, dh_last = _port(
        d, td, "gi", "whh_t", "bhh", "mask", "att", "douts", "dh_last")
    dgi, dwhh, dbhh, datt = p_gru.gru_scan_bwd_ref(
        gi, torch.from_numpy(_np(carry).copy()).to(td), whh_t, bhh, mask,
        att, douts, dh_last, mode)
    assert dgi.dtype == td and dgi.shape == (T, B, 3 * H)
    assert dwhh.dtype == dbhh.dtype == torch.float32
    assert_agree(dgi, grads[0], dtype)
    if mode == "gru":
        assert datt is None
    else:
        assert datt.dtype == td and datt.shape == (B, T)
        assert_agree(datt, grads[3], dtype)
    # padded steps give zero rows; an empty history no score cotangent
    pad = d["mask"].T == 0
    assert (_np(dgi)[pad] == 0).all()
    if datt is not None:
        assert (_np(datt)[pad.T] == 0).all()
    # dW_hh and db_hh against the sum of their terms' magnitudes
    h = _np(carry)
    d_gh = _d_gh(d, h, _np(dgi), H)
    scale_w = np.einsum("tbk,tbc->kc", np.abs(h), np.abs(d_gh))
    scale_b = np.abs(d_gh).sum(axis=(0, 1))
    for got, want, scale in ((dwhh, grads[1], scale_w),
                             (dbhh, grads[2], scale_b)):
        if dtype == "float32":
            err = np.abs(_np(got) - _np(want)) / np.maximum(scale, 1.0)
            assert err.max() <= F32_ATOL, err.max()
        else:
            assert_agree(got.to(td), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_gru_scan_bwd_ref_matches_the_pallas_kernel(mode, dtype):
    """B=64 (the Pallas kernel's tiling gate), T=12 (not a multiple of its
    time chunk, so it pads), lengths 0, 1 and T among the rows; the port's
    backward from the carries the Pallas forward saved."""
    _check_bwd_ref_against_pallas(mode, dtype, "prefix")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_gru_scan_bwd_ref_matches_the_pallas_kernel_on_masks_with_holes(
        mode, dtype):
    """Masks that are not prefixes, as the backward kernel's late start
    must take them: holes inside histories, trailing padding, an empty row
    and a full-length row in one batch."""
    _check_bwd_ref_against_pallas(mode, dtype, "holes")


@pytest.mark.parametrize("mode", MODES)
def test_autograd_through_gru_scan_matches_the_pallas_kernel(mode):
    """On CPU tensors ``gru_scan`` is the plain version and autograd
    differentiates it: float32, the same cotangents."""
    d, ((want_outs, want_h), grads) = _jax_case(mode, "float32", 1, "prefix")
    gi, whh_t, bhh, mask, att = _port(d, torch.float32, "gi", "whh_t", "bhh",
                                      "mask", "att")
    leaves = [t.requires_grad_() for t in (gi, whh_t, bhh, att)
              if t is not None]
    outs, h_last = p_gru.gru_scan(gi, whh_t, bhh, mask, att, mode)
    assert_agree(outs, want_outs, "float32")
    assert_agree(h_last, want_h, "float32")
    got = torch.autograd.grad(
        (outs, h_last), leaves,
        (torch.from_numpy(d["douts"]), torch.from_numpy(d["dh_last"])))
    for g, w in zip(got, grads):
        assert_agree(g, w, "float32")


@pytest.mark.parametrize("mode", MODES)
def test_gru_scan_function_matches_autograd_of_the_plain_version(mode):
    """``GruScan`` (what ``gru_scan`` runs on CUDA tensors under autograd)
    on CPU tensors, where its forward and backward take the plain
    versions: the same gradients as autograd through ``gru_scan_ref``,
    with gi a [T, B, 3H] view of a [B, T, 3H] product, bfloat16 scores
    whose cotangent comes back in bfloat16, and an output whose cotangent
    is absent (None reaches the backward)."""
    B, T, H = 9, 7, 4
    d = _inputs(mode, B, T, H, seed=3)
    gi_bt = torch.from_numpy(d["gi"].transpose(1, 0, 2).copy())
    whh_t, bhh, mask = _port(d, torch.float32, "whh_t", "bhh", "mask")
    att = (None if mode == "gru" else
           torch.from_numpy(d["att"]).to(torch.bfloat16))
    for use_outs in (True, False):
        runs = []
        for fn in (p_gru.GruScan.apply, p_gru.gru_scan_ref):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (gi_bt, whh_t, bhh, att) if t is not None]
            gi = leaves[0].transpose(0, 1)
            a = leaves[3] if att is not None else None
            outs, h_last = fn(gi, leaves[1], leaves[2], mask, a, mode)
            loss = (h_last * torch.from_numpy(d["dh_last"])).sum()
            if use_outs:
                loss = loss + (outs * torch.from_numpy(d["douts"])).sum()
            loss.backward()
            runs.append((outs, h_last, [t.grad for t in leaves]))
        (o1, h1, g1), (o2, h2, g2) = runs
        torch.testing.assert_close(o1, o2, rtol=0, atol=0)
        torch.testing.assert_close(h1, h2, rtol=0, atol=0)
        for a, b in zip(g1, g2):
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=1e-6 if a.dtype ==
                                       torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_scan_with_carry_saves_the_state_before_each_step(dtype):
    """The training forward gives the inference forward's outputs, and
    carry[t] = h_{t-1}: 0 at t = 0, then ``h + m * (h' - h)`` with h' the
    step's output (exact at float32; at bfloat16 the output is rounded
    once, so within one ulp)."""
    td = DTYPES[dtype][1]
    d = _inputs("augru", 16, 6, 4, seed=4)
    gi, whh_t, bhh, mask, att = _port(d, td, "gi", "whh_t", "bhh", "mask",
                                      "att")
    outs, h_last, carry = p_gru.gru_scan_with_carry(gi, whh_t, bhh, mask,
                                                    att, "augru")
    want = p_gru.gru_scan(gi, whh_t, bhh, mask, att, "augru")
    torch.testing.assert_close(outs, want[0], rtol=0, atol=0)
    torch.testing.assert_close(h_last, want[1], rtol=0, atol=0)
    assert carry.dtype == td and carry.shape == (6, 16, 4)
    assert not carry.requires_grad
    h = torch.zeros(16, 4)
    m = mask.float()
    for t in range(6):
        assert_agree(carry[t], h, dtype)
        h = h + m[:, t:t + 1] * (outs[t].float() - h)
    assert_agree(h_last, h, dtype)
    assert (carry[0] == 0).all()


def test_gru_scan_bwd_takes_absent_cotangents_as_zeros():
    d = _inputs("agru", 8, 5, 3, seed=5)
    gi, whh_t, bhh, mask, att, douts, dh_last = _port(
        d, torch.float32, "gi", "whh_t", "bhh", "mask", "att", "douts",
        "dh_last")
    _, _, carry = p_gru.gru_scan_with_carry(gi, whh_t, bhh, mask, att,
                                            "agru")
    for do, dl in ((None, dh_last), (douts, None), (None, None)):
        got = p_gru.gru_scan_bwd(gi, carry, whh_t, bhh, mask, att, do, dl,
                                 "agru")
        want = p_gru.gru_scan_bwd_ref(
            gi, carry, whh_t, bhh, mask, att,
            torch.zeros_like(douts) if do is None else do,
            torch.zeros_like(dh_last) if dl is None else dl, "agru")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    zero = p_gru.gru_scan_bwd(gi, carry, whh_t, bhh, mask, att, None, None,
                              "agru")
    assert all(not t.any() for t in zero)


def test_gru_scan_bwd_refuses_what_the_kernel_does_not_take():
    d = _inputs("gru", 4, 3, 2, seed=6)
    gi, whh_t, bhh, mask, douts = _port(d, torch.float32, "gi", "whh_t",
                                        "bhh", "mask", "douts")
    carry = torch.zeros(3, 4, 2)
    with pytest.raises(ValueError, match="carry"):
        p_gru.gru_scan_bwd(gi, carry[:, :2], whh_t, bhh, mask)
    with pytest.raises(ValueError, match="carry"):
        p_gru.gru_scan_bwd(gi, carry.double(), whh_t, bhh, mask)
    with pytest.raises(ValueError, match="douts"):
        p_gru.gru_scan_bwd(gi, carry, whh_t, bhh, mask, douts=douts[:2])
    with pytest.raises(ValueError, match="dh_last"):
        p_gru.gru_scan_bwd(gi, carry, whh_t, bhh, mask,
                           dh_last=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="attention"):
        p_gru.gru_scan_bwd(gi, carry, whh_t, bhh, mask, mode="augru")


# ---------------------------------------------------------------------------
# the batch norms that train
# ---------------------------------------------------------------------------

def _stats(rng, n):
    return {"mean": rng.normal(0, 0.3, n).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}


def _flax_train(module, variables, x, cot, **kw):
    """Two training calls of a flax module (the running stats move twice):
    the second call's output and its input gradient, and the stats."""
    def f(params, stats, x):
        return module.apply({"params": params, "batch_stats": stats}, x,
                            training=True, mutable=["batch_stats"], **kw)
    _, mutated = f(variables["params"], variables["batch_stats"], x)
    stats = mutated["batch_stats"]
    y, mutated = f(variables["params"], stats, x)
    (dparams, dx) = jax.vjp(lambda p, x: f(p, stats, x)[0],
                            variables["params"], x)[1](cot)
    return y, dx, dparams, mutated["batch_stats"]


@pytest.mark.parametrize("shape", [(12, 6), (5, 7, 6)])
def test_dice_in_training_matches_flax(shape):
    """Batch statistics over every axis but the last (biased, E[x^2] -
    E[x]^2), the gradient through them, and the running stats moved by
    momentum 0.9 at each call."""
    rng = np.random.default_rng(7)
    x = (rng.normal(0.4, 1.3, shape)).astype(np.float32)
    cot = rng.normal(0, 1, shape).astype(np.float32)
    variables = {"params": {"alpha": rng.normal(0, 0.5, 6).astype(
        np.float32)}, "batch_stats": {"bn": _stats(rng, 6)}}
    y, dx, dparams, stats = _flax_train(JDice(), variables, x, cot)
    dice = pact.Dice(6)
    state = jax_to_state_dict(variables, {k: tuple(v.shape) for k, v in
                                          dice.state_dict().items()})
    dice.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tx = torch.from_numpy(x).requires_grad_()
    dice(tx, training=True)
    got = dice(tx, training=True)
    np.testing.assert_allclose(_np(got), np.asarray(y), rtol=0,
                               atol=F32_ATOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(_np(dice.alpha.grad),
                               np.asarray(dparams["alpha"]), rtol=0,
                               atol=F32_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(getattr(dice.bn, k)),
                                   np.asarray(stats["bn"][k]), rtol=0,
                                   atol=F32_ATOL)
    # inference reads the running stats
    want = JDice().apply({"params": variables["params"],
                          "batch_stats": stats}, x, training=False)
    with torch.no_grad():
        np.testing.assert_allclose(_np(dice(tx)), np.asarray(want), rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("activation", ["relu", "dice"])
def test_dnn_with_batch_norm_matches_jax(activation):
    """DNN(use_bn=True): bn_<i> (scale, bias, epsilon 1e-5) after each
    dense layer and before its activation, trained twice, then at
    inference."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (10, 4, 5)).astype(np.float32)
    cot = rng.normal(0, 1, (10, 4, 3)).astype(np.float32)
    jdnn = JDNN((6, 3), activation=activation, use_bn=True, init_std=0.3)
    variables = jdnn.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda v: rng.normal(0.5, 0.3, np.shape(v)).astype(np.float32),
        variables["params"])
    stats = {k: {"bn": _stats(rng, v["bn"]["mean"].shape[0])}
             if k.startswith("Dice") else _stats(rng, v["mean"].shape[0])
             for k, v in variables["batch_stats"].items()}
    variables = {"params": params, "batch_stats": stats}
    y, dx, dparams, new_stats = _flax_train(jdnn, variables, x, cot)
    pdnn = pcore.DNN(5, (6, 3), activation=activation, use_bn=True)
    state = jax_to_state_dict(variables, {k: tuple(v.shape) for k, v in
                                          pdnn.state_dict().items()})
    pdnn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tx = torch.from_numpy(x).requires_grad_()
    pdnn(tx, training=True)
    got = pdnn(tx, training=True)
    np.testing.assert_allclose(_np(got), np.asarray(y), rtol=0,
                               atol=F32_ATOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), rtol=0,
                               atol=F32_ATOL)
    want = jax_to_state_dict({"params": dparams, "batch_stats": new_stats},
                             {k: tuple(v.shape)
                              for k, v in pdnn.state_dict().items()})
    for name, p in pdnn.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want[name], rtol=0,
                                   atol=BN_GRAD_ATOL, err_msg=name)
    for name, b in pdnn.named_buffers():
        np.testing.assert_allclose(_np(b), want[name], rtol=0,
                                   atol=F32_ATOL, err_msg=name)
    infer = jdnn.apply({"params": params, "batch_stats": new_stats}, x,
                       training=False)
    with torch.no_grad():
        np.testing.assert_allclose(_np(pdnn(tx)), np.asarray(infer), rtol=0,
                                   atol=F32_ATOL)


def test_load_jax_weights_carries_dnn_batch_norm_both_ways():
    """A DeepFM with dnn_use_bn: bn_<i>/{scale,bias} params and
    bn_<i>/{mean,var} batch_stats load, predict agrees, and
    ``jax_batch_stats`` reads the port's buffers back as the JAX tree."""
    def columns(m):
        sparse = [m.SparseFeat("a", 20, 4), m.SparseFeat("b", 9, 4)]
        return sparse + [m.DenseFeat("d", 1)]
    rng = np.random.default_rng(9)
    jm = JDeepFM(columns(dt), columns(dt), dnn_hidden_units=(8, 4),
                 dnn_use_bn=True)
    weights = jm.get_weights()
    weights["params"] = jax.tree_util.tree_map(
        lambda v: rng.normal(0, 0.3, np.shape(v)).astype(np.float32),
        weights["params"])
    weights["batch_stats"] = {"dnn": {k: _stats(rng, len(v["mean"]))
                                      for k, v in
                                      weights["batch_stats"]["dnn"].items()}}
    jm.set_weights(weights)
    pm = PDeepFM(columns(pt), columns(pt), dnn_hidden_units=(8, 4),
                 dnn_use_bn=True, device="cpu")
    loaded = load_jax_weights(pm, weights)
    assert {"dnn.bn_0.scale", "dnn.bn_1.bias", "dnn.bn_0.mean",
            "dnn.bn_1.var"} <= set(loaded)
    tree = jax_batch_stats(pm)
    assert set(tree["dnn"]) == {"bn_0", "bn_1"}
    for k, v in weights["batch_stats"]["dnn"].items():
        for leaf in ("mean", "var"):
            np.testing.assert_array_equal(tree["dnn"][k][leaf], v[leaf])
    x = {"a": rng.integers(0, 20, 32), "b": rng.integers(0, 9, 32),
         "d": rng.random(32)}
    np.testing.assert_allclose(pm.predict(x, 16), jm.predict(x, 16), rtol=0,
                               atol=F32_ATOL)
