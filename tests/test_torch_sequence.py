"""The port's sequence stack (deepctr_tpu_torch: masked pooling, Dice,
LocalActivationUnit, AttentionSequencePoolingLayer, the GRU family, the
varlen lookups, DIN and DIEN) against the JAX package, layer by layer and
then ``predict`` of whole models, with the JAX weights carried across by
``load_jax_weights``.

Weights are drawn at std 0.3 (the models' init_std=1e-4 puts every
prediction at 0.5), Dice's running mean at std 0.3 and its variance in
[0.5, 1.5) (at init they are 0 and 1, which would hide a mistake).
Tolerance 1e-5 at float32 throughout: the two packages sum in other
orders, and the port carries a masked GRU step as ``h + m * (h' - h)``
where the JAX scan selects ``h'``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.layers.activation import Dice as JDice, PReLU as JPReLU
from deepctr_tpu.layers.core import LocalActivationUnit as JLAU
from deepctr_tpu.layers import sequence as jseq
from deepctr_tpu.models import DIEN as JDIEN, DIN as JDIN, DeepFM as JDeepFM
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import activation as pact
from deepctr_tpu_torch.layers import core as pcore
from deepctr_tpu_torch.layers import sequence as pseq
from deepctr_tpu_torch.models import DIEN as PDIEN, DIN as PDIN
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                 load_jax_weights)

ATOL = 1e-5
V_ITEM, V_CATE, V_USER, E, T = 30, 7, 11, 4, 6


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _redraw(tree, rng, std=0.3):
    """Every leaf of a parameter tree from normal(std); a ``batch_stats``
    tree's means from normal(std) and variances from uniform[0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng, std)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0, std, np.shape(v)).astype(np.float32)
    return out


def _load(module, variables):
    """Carry a flax module's variables into its port (strict)."""
    state = jax_to_state_dict(
        variables, {k: tuple(v.shape)
                    for k, v in module.state_dict().items()})
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in state.items()}, strict=True)
    return module


def _jax_variables(jmod, rng, *args):
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    return {k: _redraw(v, rng) for k, v in variables.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=0, atol=atol)


def _lengths(rng, B, T):
    lengths = rng.integers(0, T + 1, B)
    lengths[:3] = [0, 1, T]
    return lengths


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("supports_masking", [True, False])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_masked_pooling_matches_jax(mode, supports_masking):
    rng = np.random.default_rng(0)
    seq = rng.normal(0, 1, (6, 5, 3)).astype(np.float32)
    if supports_masking:
        second = rng.random((6, 5)) < 0.5
        second[0] = False                     # an empty sequence
    else:
        second = np.array([[0], [5], [2.7], [1], [3], [4]], np.float32)
    want = jseq.masked_pooling([jnp.asarray(seq), jnp.asarray(second)], mode,
                               supports_masking)
    layer = pseq.SequencePoolingLayer(mode, supports_masking)
    got = layer([torch.from_numpy(seq), torch.from_numpy(second)])
    assert got.shape == (6, 1, 3)
    _close(got, want)
    assert (got[0] == 0).all()                # empty rows pool to 0


def test_dice_and_prelu_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (4, 5, 6)).astype(np.float32)
    variables = _jax_variables(JDice(), rng, x)
    want = JDice().apply(variables, x, training=False)
    dice = _load(pact.Dice(6), variables)
    _close(dice(torch.from_numpy(x)), want)
    # training mode normalises with the batch's statistics and moves the
    # running ones (tests/test_torch_sequence_train_ops.py holds its
    # gradient)
    want, mutated = JDice().apply(variables, x, training=True,
                                  mutable=["batch_stats"])
    _close(dice(torch.from_numpy(x), training=True), want)
    for leaf in ("mean", "var"):
        _close(getattr(dice.bn, leaf), mutated["batch_stats"]["bn"][leaf])

    # the JAX PReLU's ``init`` field shadows flax's Module.init, so its
    # variables are written out
    variables = {"params": {"alpha": np.array([-0.4], np.float32)}}
    want = JPReLU().apply(variables, x)
    _close(_load(pact.PReLU(), variables)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("activation", ["sigmoid", "dice"])
def test_local_activation_unit_matches_jax(activation):
    rng = np.random.default_rng(2)
    q = rng.normal(0, 0.5, (5, 1, E)).astype(np.float32)
    k = rng.normal(0, 0.5, (5, T, E)).astype(np.float32)
    jlau = JLAU(hidden_units=(6, 3), activation=activation)
    variables = _jax_variables(jlau, rng, q, k)
    want = jlau.apply(variables, q, k, training=False)
    plau = _load(pcore.LocalActivationUnit((6, 3), embedding_dim=E,
                                           activation=activation), variables)
    got = plau(torch.from_numpy(q), torch.from_numpy(k))
    assert got.shape == (5, T, 1)
    _close(got, want)


@pytest.mark.parametrize("return_score", [False, True])
@pytest.mark.parametrize("wnorm", [False, True])
def test_attention_sequence_pooling_layer_matches_jax(wnorm, return_score):
    """The composition (what the layer runs on the CPU, and on the card for
    Dice, the score path and training) and the fused readout (what it runs
    on CUDA tensors at inference, here through the kernel's plain version)
    against the JAX layer's composition."""
    rng = np.random.default_rng(3)
    q = rng.normal(0, 0.5, (8, 1, E)).astype(np.float32)
    k = rng.normal(0, 0.5, (8, T, E)).astype(np.float32)
    lengths = _lengths(rng, 8, T).astype(np.int32)
    jlayer = jseq.AttentionSequencePoolingLayer(
        att_hidden_units=(6, 3), att_activation="sigmoid",
        weight_normalization=wnorm, return_score=return_score)
    variables = _jax_variables(jlayer, rng, q, k, lengths)
    want = jlayer.apply(variables, q, k, lengths)
    player = _load(pseq.AttentionSequencePoolingLayer(
        (6, 3), "sigmoid", weight_normalization=wnorm,
        return_score=return_score, embedding_dim=E), variables)
    tq, tk, tl = map(torch.from_numpy, (q, k, lengths))
    got = player(tq, tk, tl)
    assert got.shape == ((8, 1, T) if return_score else (8, 1, E))
    _close(got, want)
    if not return_score:
        mask = torch.arange(T)[None, :] < tl[:, None]
        _close(player.fused_readout(tq, tk, mask), want)


def test_masked_gru_and_dynamic_grus_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.5, (9, T, 5)).astype(np.float32)
    att = rng.random((9, T)).astype(np.float32)
    lengths = _lengths(rng, 9, T).astype(np.int32)
    tx, tatt, tl = map(torch.from_numpy, (x, att, lengths))

    jgru = jseq.MaskedGRU(5, 3)
    variables = _jax_variables(jgru, rng, x, lengths)
    want = jgru.apply(variables, x, lengths, training=False)
    got = _load(pseq.MaskedGRU(5, 3), variables)(tx, tl)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0].shape == (9, T, 3) and got[1].shape == (9, 3)

    for gru_type in ("AGRU", "AUGRU"):
        jgru = jseq.DynamicGRU(5, 3, gru_type=gru_type)
        variables = _jax_variables(jgru, rng, x, att, lengths)
        want = jgru.apply(variables, x, att, lengths, training=False)
        pgru = _load(pseq.DynamicGRU(5, 3, gru_type=gru_type), variables)
        for g, w in zip(pgru(tx, tatt, tl), want):
            _close(g, w)


def test_gru_layers_see_a_change_of_their_weights():
    """The recurrence keeps float32 copies of W_hh and b_hh between calls;
    an in-place change or a load of new weights must reach it."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 1, (3, T, E)).astype(np.float32))
    att = torch.from_numpy(rng.random((3, T)).astype(np.float32))
    lengths = torch.tensor([T, 2, 0])
    for make, extra in ((lambda: pseq.MaskedGRU(E, E, init_std=0.3,
                                                device="cpu"), ()),
                        (lambda: pseq.DynamicGRU(E, E, "AUGRU", init_std=0.3,
                                                 device="cpu"), (att,))):
        layer, fresh = make(), make()
        with torch.no_grad():
            before, _ = layer(x, *extra, lengths)
            layer.weight_hh.mul_(2.0)
            layer.bias_hh.add_(0.5)
            after, _ = layer(x, *extra, lengths)
            fresh.load_state_dict(layer.state_dict())
            want, _ = fresh(x, *extra, lengths)
        assert not torch.equal(before, after)
        torch.testing.assert_close(after, want, rtol=0, atol=0)


@pytest.mark.parametrize("cell", ["AGRUCell", "AUGRUCell"])
def test_gru_cells_match_jax(cell):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.5, (4, 5)).astype(np.float32)
    h = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    a = rng.random((4, 1)).astype(np.float32)
    jcell = getattr(jseq, cell)(5, 3)
    variables = _jax_variables(jcell, rng, x, h, a)
    want = jcell.apply(variables, x, h, a)
    pcell = _load(getattr(pseq, cell)(5, 3), variables)
    _close(pcell(*map(torch.from_numpy, (x, h, a))), want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _seq_columns(m, use_neg):
    """The sequence bench's columns (tools/seq_train_bench.py), narrow."""
    cols = [m.SparseFeat("user", V_USER, E),
            m.SparseFeat("item_id", V_ITEM, E),
            m.SparseFeat("cate_id", V_CATE, E), m.DenseFeat("pay_score", 1)]
    for prefix in ("hist_", "neg_hist_") if use_neg else ("hist_",):
        for name, vocab in (("item_id", V_ITEM), ("cate_id", V_CATE)):
            cols.append(m.VarLenSparseFeat(
                m.SparseFeat(prefix + name, vocab, E, embedding_name=name),
                maxlen=T, length_name="seq_length"))
    return cols


def _seq_data(n, rng):
    x = {"user": rng.integers(0, V_USER, n),
         "item_id": rng.integers(1, V_ITEM, n),
         "cate_id": rng.integers(1, V_CATE, n),
         "pay_score": rng.random(n).astype(np.float32),
         "seq_length": _lengths(rng, n, T)}
    for prefix in ("hist_", "neg_hist_"):
        x[prefix + "item_id"] = rng.integers(1, V_ITEM, (n, T))
        x[prefix + "cate_id"] = rng.integers(1, V_CATE, (n, T))
    return x


def _pair(jcls, pcls, rng, use_neg=False, **kw):
    """A JAX model with weights redrawn from ``rng`` (the prediction tower
    at std 1, so that its narrow layers spread the predictions) and its
    port with the same weights."""
    jmodel = jcls(_seq_columns(dt, use_neg), ["item_id", "cate_id"],
                  dnn_hidden_units=(8, 4), **kw)
    weights = jmodel.get_weights()
    weights = {k: _redraw(v, rng) for k, v in weights.items()}
    for tower in ("dnn", "dnn_linear"):
        weights["params"][tower] = _redraw(weights["params"][tower], rng, 1.0)
    jmodel.set_weights(weights)
    pmodel = pcls(_seq_columns(pt, use_neg), ["item_id", "cate_id"],
                  dnn_hidden_units=(8, 4), device="cpu", **kw)
    loaded = load_jax_weights(pmodel, weights)
    assert set(loaded) == set(pmodel.state_dict())
    return jmodel, pmodel, weights


@pytest.mark.parametrize("att_activation", ["Dice", "sigmoid"])
def test_din_predict_matches_jax(att_activation):
    rng = np.random.default_rng(6)
    jmodel, pmodel, _ = _pair(JDIN, PDIN, rng, att_hidden_size=(6, 3),
                              att_activation=att_activation)
    x = _seq_data(40, rng)
    want = jmodel.predict(x, batch_size=16)
    got = pmodel.predict(x, batch_size=16)      # a ragged last batch
    assert got.shape == want.shape == (40, 1) and got.dtype == np.float64
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("gru_type", ["GRU", "AIGRU", "AGRU", "AUGRU"])
def test_dien_predict_matches_jax(gru_type):
    rng = np.random.default_rng(7)
    jmodel, pmodel, _ = _pair(JDIEN, PDIEN, rng, use_neg=True,
                              gru_type=gru_type, use_negsampling=True,
                              att_hidden_units=(6, 3))
    x = _seq_data(40, rng)
    want = jmodel.predict(x, batch_size=16)
    got = pmodel.predict(x, batch_size=16)
    assert got.shape == want.shape == (40, 1)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_deepfm_with_varlen_features_matches_jax():
    """Varlen columns in the deep part and the linear part (fused and
    linear-only tables): mean pooling by a length column, sum and max
    pooling by ``ids != 0``."""
    def columns(m):
        a = m.SparseFeat("a", 20, E)
        tags = m.VarLenSparseFeat(m.SparseFeat("tags", 20, E,
                                               embedding_name="a"),
                                  maxlen=T, length_name="tags_len")
        words = m.VarLenSparseFeat(m.SparseFeat("words", 12, E), maxlen=4,
                                   combiner="sum")
        clicks = m.VarLenSparseFeat(m.SparseFeat("clicks", 9, E), maxlen=3,
                                    combiner="max")
        lin_only = m.VarLenSparseFeat(m.SparseFeat("lin_only", 8, E),
                                      maxlen=3, combiner="mean")
        dense = m.DenseFeat("d", 1)
        deep = [a, tags, words, clicks, dense]
        return deep + [lin_only], deep
    rng = np.random.default_rng(8)
    n = 30
    x = {"a": rng.integers(0, 20, n), "d": rng.random(n),
         "tags": rng.integers(1, 20, (n, T)),
         "tags_len": _lengths(rng, n, T),
         "words": rng.integers(0, 12, (n, 4)) * (rng.random((n, 4)) < .6),
         "clicks": rng.integers(0, 9, (n, 3)) * (rng.random((n, 3)) < .5),
         "lin_only": rng.integers(0, 8, (n, 3))}
    x["words"][0] = 0
    jlin, jdnn = columns(dt)
    jmodel = JDeepFM(jlin, jdnn, dnn_hidden_units=(8,))
    weights = {k: _redraw(v, rng) for k, v in jmodel.get_weights().items()}
    jmodel.set_weights(weights)
    plin, pdnn = columns(pt)
    pmodel = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), device="cpu")
    load_jax_weights(pmodel, weights)
    want = jmodel.predict(x, batch_size=16)
    np.testing.assert_allclose(pmodel.predict(x, batch_size=16), want,
                               rtol=0, atol=ATOL)


def test_load_jax_weights_maps_dice_stats_and_dnn_batch_norm():
    rng = np.random.default_rng(9)
    _, pmodel, weights = _pair(JDIN, PDIN, rng, att_hidden_size=(6, 3))
    stats = weights["batch_stats"]["attention"]["local_att"]["dnn"]
    buffers = dict(pmodel.named_buffers())
    for i in range(2):
        for leaf in ("mean", "var"):
            np.testing.assert_array_equal(
                buffers["attention.local_att.dnn.Dice_%d.bn.%s" % (i, leaf)],
                stats["Dice_%d" % i]["bn"][leaf])
    with pytest.raises(KeyError, match="bn.mean"):
        load_jax_weights(pmodel, {"params": weights["params"]})
    bn = {"params": weights["params"], "batch_stats": {
        **weights["batch_stats"],
        "dnn": {"bn_0": {"mean": np.zeros(8), "var": np.ones(8)}}}}
    with pytest.raises(KeyError, match="bn_0"):
        load_jax_weights(pmodel, bn)
    # a DNN's batch norm: bn_<i> scale and bias, its running mean and var
    jmodel, pmodel, weights = _pair(JDIN, PDIN, rng, att_hidden_size=(6, 3),
                                    dnn_use_bn=True)
    buffers = dict(pmodel.named_buffers())
    params = dict(pmodel.named_parameters())
    for i in range(2):
        for leaf in ("mean", "var"):
            np.testing.assert_array_equal(
                buffers["dnn.bn_%d.%s" % (i, leaf)],
                weights["batch_stats"]["dnn"]["bn_%d" % i][leaf])
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(
                params["dnn.bn_%d.%s" % (i, leaf)].detach(),
                weights["params"]["dnn"]["bn_%d" % i][leaf])
    x = _seq_data(24, rng)
    np.testing.assert_allclose(pmodel.predict(x, batch_size=16),
                               jmodel.predict(x, batch_size=16), rtol=0,
                               atol=ATOL)


def test_fit_and_evaluate_run_on_sequence_models():
    """fit and evaluate on models with sequence features (their parity
    with the JAX package: tests/test_torch_sequence_train.py): the loss
    falls and Dice's running statistics move."""
    model = PDIN(_seq_columns(pt, False), ["item_id", "cate_id"],
                 dnn_hidden_units=(8, 4), device="cpu")
    x = _seq_data(16, np.random.default_rng(10))
    y = (x["item_id"] < V_ITEM // 2).astype(np.float32)
    model.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    stats = {k: v.clone() for k, v in model.named_buffers()}
    hist = model.fit(x, y, batch_size=8, epochs=5, verbose=0)
    assert np.isfinite(hist.history["loss"]).all()
    assert hist.history["loss"][-1] < hist.history["loss"][0]
    assert all(not torch.equal(v, stats[k])
               for k, v in model.named_buffers())
    assert set(model.evaluate(x, y, batch_size=8)) == {"auc"}
    assert model.predict(x, batch_size=8).shape == (16, 1)
