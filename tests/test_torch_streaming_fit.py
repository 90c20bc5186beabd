"""The port's streamed fit (``fit(x=callable)``,
``deepctr_tpu_torch/models/basemodel.py:_fit_stream``) against the JAX
package's (``deepctr_tpu/models/basemodel.py:1658-1845``), from the same
weights: epoch losses within 1e-5 relative, every weight within 1e-6 and
every optimizer state within 1e-6 (relative above 1), as
tests/test_torch_device_loop.py holds the device-resident loop.

Both packages shuffle within each chunk from one
``np.random.default_rng(seed)`` for the whole fit and pad each chunk with
zero rows at sample weight 0, so their steps see the same batches.  A
chunk cut by ``steps_per_epoch`` is held with ``shuffle=False``: the JAX
worker runs ahead of the cut and draws the permutations of chunks it
never trains, as many as its thread timing lets it, so its later epochs'
shuffles are not a function of the data; the port's worker stops at the
chunk that reaches the cap."""

import threading

import numpy as np
import pytest
import torch

from deepctr_tpu_torch.layers import core as pcore
from tests.test_torch_device_loop import _assert_same_training
from tests.test_torch_train import L2, _data, _pair
from tests.torch_mesh_workers import chunked as _chunks

B = 32
SIZES = (100, 37, 163)      # uneven chunks, none a multiple of B


def _fit_both(jm, pm, make_iter, opt, compile_kw=None, **fit_kw):
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", **(compile_kw or {}))
    fit_kw.setdefault("verbose", 0)
    hj = jm.fit(make_iter, batch_size=B, **fit_kw)
    hp = pm.fit(make_iter, batch_size=B, **fit_kw)
    return hj.history, hp.history


@pytest.mark.parametrize("opt, sparse", [("adagrad", False), ("adam", True)])
def test_stream_over_uneven_chunks_matches_jax(opt, sparse):
    """Two epochs over three uneven chunks, shuffled: losses, weights and
    optimizer states as the JAX package's."""
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, sum(SIZES), np.random.default_rng(31))
    hj, hp = _fit_both(jm, pm, _chunks(x, y, SIZES), opt,
                       {"sparse_table_updates": sparse}, epochs=2)
    assert bool(pm._sparse_specs) == sparse
    _assert_same_training(jm, pm, hj, hp)
    steps = sum(-(-n // B) for n in SIZES)
    assert pm._dense_opt.count == 2 * steps


def test_steps_per_epoch_cuts_a_chunk_with_validation_and_metrics():
    """``steps_per_epoch`` = 6 over chunks of 4 steps: each epoch trains
    the first chunk and the first two steps of the second; validation
    data, train metrics over the epoch's predictions (verbose) and the
    losses as the JAX package's."""
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, 400, np.random.default_rng(32))
    vx, vy = _data(cols, 50, np.random.default_rng(33))
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    kw = dict(batch_size=B, epochs=3, verbose=1, shuffle=False,
              steps_per_epoch=6, validation_data=(vx, vy))
    hj = jm.fit(_chunks(x, y, (128,) * 3), **kw).history
    hp = pm.fit(_chunks(x, y, (128,) * 3), **kw).history
    _assert_same_training(jm, pm, hj, hp)
    assert pm._dense_opt.count == 3 * 6
    for k in ("auc", "val_auc"):
        np.testing.assert_allclose(hp[k], hj[k], rtol=1e-6, err_msg=k)


def test_a_touched_rows_table_streams_as_the_jax_package():
    """A table of 20,000 rows on the sparse path (below the JAX package's
    packed storage, L2 off: ROADMAP.md section 3), adagrad."""
    jm, pm, cols = _pair(big=[20000], l2_reg_linear=0.0,
                         l2_reg_embedding=0.0)
    x, y = _data(cols, 200, np.random.default_rng(34))
    hj, hp = _fit_both(jm, pm, _chunks(x, y, (96, 104)), "adagrad",
                       {"sparse_table_updates": True}, epochs=2)
    assert "embedding_dict/big0" in [s[0] for s in pm._sparse_specs]
    _assert_same_training(jm, pm, hj, hp)


def test_a_worker_error_reaches_the_caller_and_the_worker_stops():
    _, pm, cols = _pair()
    x, y = _data(cols, 96, np.random.default_rng(35))
    pm.compile("sgd", "binary_crossentropy")
    before = threading.active_count()

    def bad():
        yield {k: v[:64] for k, v in x.items()}, y[:64]
        raise OSError("the stream broke")
    with pytest.raises(OSError, match="the stream broke"):
        pm.fit(bad, batch_size=B, verbose=0)
    # a chunk whose ids leave their table is refused on the host
    oob = {k: v.copy() for k, v in x.items()}
    oob["s0"][3] = 4
    pm.compile("sgd", "binary_crossentropy", sparse_table_updates=True)

    def wide():
        yield oob, y
    assert pm._sparse_specs
    with pytest.raises(ValueError, match="vocabulary"):
        pm.fit(wide, batch_size=B, verbose=0)
    assert threading.active_count() == before


def test_stream_equals_the_device_loop_dropout_and_adam_included():
    """The step numbering runs on across chunks: two chunks of whole
    batches, unshuffled, draw the dropout masks and take adam's bias
    corrections of one device-loop epoch over the same rows, so the two
    fits give the same bits; and every step draws a new mask."""
    def build():
        _, pm, cols = _pair(seed=3, dnn_dropout=0.5)
        pm.compile("adam", "binary_crossentropy", sparse_table_updates=True)
        return pm, cols
    streamed, cols = build()
    looped, _ = build()
    x, y = _data(cols, 4 * B, np.random.default_rng(36))
    masks = []
    real = pcore.Dropout.keep_mask

    def spy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        masks.append(out.detach().clone())
        return out
    pcore.Dropout.keep_mask = spy
    try:
        hs = streamed.fit(_chunks(x, y, (2 * B, 2 * B)), batch_size=B,
                          epochs=2, shuffle=False, verbose=0).history
        stream_masks, masks[:] = list(masks), []
        hl = looped.fit(looped.assemble_device_input(x), y, batch_size=B,
                        epochs=2, shuffle=False, verbose=0).history
    finally:
        pcore.Dropout.keep_mask = real
    assert len(stream_masks) == len(masks) > 0
    for a, b in zip(stream_masks, masks):
        assert torch.equal(a, b)
    per_epoch = len(masks) // 2
    firsts = [m.flatten()[:64] for m in stream_masks[:per_epoch]]
    assert len({tuple(f.tolist()) for f in firsts}) == len(firsts)
    np.testing.assert_array_equal(hs["loss"], hl["loss"])
    for k, v in streamed.get_weights().items():
        np.testing.assert_array_equal(v, looped.get_weights()[k], err_msg=k)
    assert streamed._dense_opt.count == looped._dense_opt.count == 8


def test_stream_matches_the_in_memory_fit():
    """As the JAX package's test: an unshuffled stream of whole-batch
    chunks trains as the host-array fit."""
    _, m1, cols = _pair(seed=4)
    _, m2, _ = _pair(seed=4)
    x, y = _data(cols, 4 * B, np.random.default_rng(37))
    for m in (m1, m2):
        m.compile("adam", "binary_crossentropy")
    m1.fit(x, y, batch_size=B, epochs=2, shuffle=False, verbose=0)
    m2.fit(_chunks(x, y, (2 * B, 2 * B)), batch_size=B, epochs=2,
           shuffle=False, verbose=0)
    want, got = m1.get_weights(), m2.get_weights()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_a_model_keeps_a_bounded_number_of_stream_loops():
    """One loop a chunk geometry, the least recently used dropped past
    ``_STREAM_LOOPS``; ``compile`` drops them all."""
    _, pm, cols = _pair()
    x, y = _data(cols, 600, np.random.default_rng(38))
    pm.compile("sgd", "binary_crossentropy")
    sizes = (32, 64, 96, 128, 160, 64)      # 1, 2, 3, 4, 5 and 2 steps
    pm.fit(_chunks(x, y, sizes), batch_size=B, verbose=0)
    streams = [k for k in pm._graphs if k[0] == "stream"]
    assert pm._STREAM_LOOPS == 4
    assert [k[2] for k in streams] == [3, 4, 5, 2]
    pm.compile("sgd", "binary_crossentropy")
    assert not pm._graphs
