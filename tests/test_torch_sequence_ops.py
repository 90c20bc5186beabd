"""The port's sequence ops (deepctr_tpu_torch/ops/gru.py, ops/attention.py,
ops/reference.py) against the JAX package's TPU kernels, run in interpret
mode on the CPU as tests/ops/ runs them, and against its plain versions.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``.

Tolerances: 1e-5 at float32 (another order of sums and other sigmoid and
tanh implementations); at bfloat16 the outputs are float32 results rounded
once, so they agree to one bf16 ulp (or 1e-5 where two float32 results
that differ by ~1e-7 straddle a rounding boundary near 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepctr_tpu.ops import reference as jref
from deepctr_tpu.ops.pallas_attention import (
    din_attention_fused as j_fused)
from deepctr_tpu.ops.pallas_gru import gru_scan as j_gru_scan
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.ops import _build
from deepctr_tpu_torch.ops import attention as p_att
from deepctr_tpu_torch.ops._args import ParamCache
from deepctr_tpu_torch.ops import gru as p_gru
from deepctr_tpu_torch.ops import reference as pref
from deepctr_tpu_torch.tools import attention_parts

F32_ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_agree(got, want, dtype):
    """float32: within F32_ATOL; bfloat16: within one bf16 ulp of the
    larger magnitude, or F32_ATOL."""
    a, b = _to_np(got), _to_np(want)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    if dtype == "float32":
        assert diff.max() <= F32_ATOL, diff.max()
        return
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    bad = (diff > ulp) & (diff > F32_ATOL)
    assert not bad.any(), (diff / ulp).max()


def _lengths(rng, B, T):
    lengths = rng.integers(0, T + 1, B)
    lengths[:3] = [0, 1, T]
    return lengths


def _holes(rng, mask):
    """The histories of ``mask`` with about 30% of their steps dropped, row
    3 valid at every step and row 0 at none: holes inside histories,
    trailing padding, an empty row and a full-length row in one batch."""
    mask = mask & (rng.random(mask.shape) < 0.7)
    mask[3] = True
    mask[0] = False
    return mask


def _gru_inputs(mode, B, T, H, seed, masks="prefix"):
    rng = np.random.default_rng(seed)
    gi = rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32)
    whh_t = rng.normal(0, 0.3, (H, 3 * H)).astype(np.float32)
    bhh = rng.normal(0, 0.3, (3 * H,)).astype(np.float32)
    lengths = _lengths(rng, B, T)
    mask = np.arange(T)[None, :] < lengths[:, None]
    if masks == "holes":
        mask = _holes(rng, mask)
    mask = mask.astype(np.float32)
    att = (None if mode == "gru"
           else rng.random((B, T)).astype(np.float32))
    return [gi, whh_t, bhh, mask, att], lengths


# ---------------------------------------------------------------------------
# gru_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["gru", "agru", "augru"])
def test_gru_scan_ref_matches_the_pallas_kernel(mode, dtype):
    # B=64: the Pallas kernel's tiling gate; T=12 is not a multiple of its
    # time chunk, so it pads
    jd, td = DTYPES[dtype]
    args, lengths = _gru_inputs(mode, 64, 12, 8, seed=1)
    j_args = [None if a is None else jnp.asarray(a, jd) for a in args]
    want_outs, want_h = j_gru_scan(*j_args[:4], att=j_args[4], mode=mode,
                                   interpret=True)
    p_args = [None if a is None else torch.from_numpy(a).to(td)
              for a in args]
    outs, h_last = p_gru.gru_scan_ref(*p_args[:4], att=p_args[4], mode=mode)
    assert outs.dtype == h_last.dtype == td
    assert outs.shape == (12, 64, 8) and h_last.shape == (64, 8)
    assert_agree(outs, want_outs, dtype)
    assert_agree(h_last, want_h, dtype)
    # padded steps emit zeros; an empty history keeps h = 0
    pad = np.arange(12)[:, None] >= lengths[None, :]
    assert (outs.float().numpy()[pad] == 0).all()
    assert (h_last.float().numpy()[lengths == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["gru", "agru", "augru"])
def test_gru_scan_ref_matches_the_pallas_kernel_on_masks_with_holes(mode,
                                                                    dtype):
    """Masks that are not prefixes, as the kernels' early stop must take
    them: holes inside histories, trailing padding, an empty row and a
    full-length row in one batch (B=64, T=12)."""
    jd, td = DTYPES[dtype]
    args, _ = _gru_inputs(mode, 64, 12, 8, seed=11, masks="holes")
    mask = args[3]
    assert (mask[0] == 0).all() and (mask[3] == 1).all()
    assert ((np.diff(mask, axis=1) > 0).any(axis=1)).any()   # a hole
    j_args = [None if a is None else jnp.asarray(a, jd) for a in args]
    want_outs, want_h = j_gru_scan(*j_args[:4], att=j_args[4], mode=mode,
                                   interpret=True)
    p_args = [None if a is None else torch.from_numpy(a).to(td)
              for a in args]
    outs, h_last = p_gru.gru_scan_ref(*p_args[:4], att=p_args[4], mode=mode)
    assert_agree(outs, want_outs, dtype)
    assert_agree(h_last, want_h, dtype)
    pad = mask.T == 0
    assert (outs.float().numpy()[pad] == 0).all()
    assert (h_last.float().numpy()[0] == 0).all()


def test_last_valid_steps_finds_each_rows_last_valid_step():
    """The rows' last valid steps the kernels walk to (and from), against
    a loop over the steps, on masks with holes, float and bool."""
    rng = np.random.default_rng(12)
    for B, T in ((64, 12), (9, 1), (5, 30)):
        lengths = rng.integers(0, T + 1, B)
        mask = _holes(rng, np.arange(T)[None, :] < lengths[:, None]) \
            if B > 3 else np.arange(T)[None, :] < lengths[:, None]
        want = np.array([max([t for t in range(T) if mask[b, t]],
                             default=-1) for b in range(B)])
        for m in (torch.from_numpy(mask), torch.from_numpy(
                mask.astype(np.float32))):
            got = p_gru.last_valid_steps(m)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
    assert p_gru.last_valid_steps(torch.zeros(3, 0)).tolist() == [-1] * 3


@pytest.mark.parametrize("mode", ["gru", "augru"])
def test_gru_scan_takes_a_ragged_batch_row_by_row(mode):
    """Any B: each row's recurrence is its own, so a batch of 37 rows gives
    the rows of the 64-row batch (1e-6: only the matmul blocking may
    differ between the two batch sizes)."""
    args, _ = _gru_inputs(mode, 64, 9, 8, seed=2)
    p_args = [None if a is None else torch.from_numpy(a) for a in args]
    outs, h_last = p_gru.gru_scan(*p_args[:4], att=p_args[4], mode=mode)
    sub = [p_args[0][:, :37], p_args[1], p_args[2], p_args[3][:37],
           None if p_args[4] is None else p_args[4][:37]]
    outs37, h37 = p_gru.gru_scan(*sub[:4], att=sub[4], mode=mode)
    torch.testing.assert_close(outs37, outs[:, :37], rtol=0, atol=1e-6)
    torch.testing.assert_close(h37, h_last[:37], rtol=0, atol=1e-6)
    # on CPU tensors the wrapper is the plain version, strides and all
    want = p_gru.gru_scan_ref(*p_args[:4], att=p_args[4], mode=mode)
    torch.testing.assert_close(outs, want[0], rtol=0, atol=0)
    gi_bt = p_args[0].transpose(0, 1).contiguous().transpose(0, 1)
    got = p_gru.gru_scan(gi_bt, *p_args[1:4], att=p_args[4], mode=mode)
    torch.testing.assert_close(got[0], outs, rtol=0, atol=0)


def test_gru_scan_refuses_what_the_kernel_does_not_take():
    args, _ = _gru_inputs("agru", 4, 3, 2, seed=3)
    gi, whh_t, bhh, mask, att = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="mode"):
        p_gru.gru_scan(gi, whh_t, bhh, mask, att, mode="lstm")
    with pytest.raises(ValueError, match="attention"):
        p_gru.gru_scan(gi, whh_t, bhh, mask, None, mode="agru")
    with pytest.raises(ValueError, match="attention"):
        p_gru.gru_scan(gi, whh_t, bhh, mask, att, mode="gru")
    with pytest.raises(ValueError, match="whh_t"):
        p_gru.gru_scan(gi, whh_t[:, :3], bhh, mask, att, mode="agru")
    with pytest.raises(ValueError, match="mask"):
        p_gru.gru_scan(gi, whh_t, bhh, mask[:, :2], att, mode="agru")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        p_gru.gru_scan(gi.double(), whh_t, bhh, mask, att, mode="agru")


# ---------------------------------------------------------------------------
# din_attention_fused and the composition
# ---------------------------------------------------------------------------

def _attention_inputs(B, T, E, hidden, seed):
    rng = np.random.default_rng(seed)
    query = rng.normal(0, 0.5, (B, 1, E)).astype(np.float32)
    keys = rng.normal(0, 0.5, (B, T, E)).astype(np.float32)
    lengths = _lengths(rng, B, T)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    widths = (4 * E,) + hidden + (1,)
    layers = [(rng.normal(0, 0.3, (i, o)).astype(np.float32),
               rng.normal(0, 0.3, (o,)).astype(np.float32))
              for i, o in zip(widths[:-1], widths[1:])]
    return query, keys, mask, layers, lengths


@pytest.mark.parametrize("wnorm", [False, True])
@pytest.mark.parametrize("act", ["sigmoid", "relu", "linear"])
def test_din_attention_fused_ref_matches_the_pallas_kernel(act, wnorm):
    q, k, m, layers, lengths = _attention_inputs(8, 16, 8, (16, 8), seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(m),
                       [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
                       act, wnorm)
    t = torch.from_numpy
    args = (t(q), t(k), t(m), [(t(w), t(b)) for w, b in layers], act, wnorm)
    got = p_att.din_attention_fused_ref(*args)
    assert got.shape == (8, 1, 8) and got.dtype == torch.float32
    assert_agree(got, want, "float32")
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(p_att.din_attention_fused(*args), got,
                               rtol=0, atol=0)
    empty = lengths == 0
    if wnorm:
        # every score at -2^32 + 1: the softmax is uniform over T
        np.testing.assert_allclose(got.numpy()[empty],
                                   k[empty].mean(axis=1, keepdims=True),
                                   rtol=0, atol=F32_ATOL)
    else:
        assert (got.numpy()[empty] == 0).all()


def test_din_attention_fused_ref_keeps_bfloat16_keys():
    """bf16 keys: the MLP runs in float32 and only the result is rounded,
    as in the Pallas kernel."""
    q, k, m, layers, _ = _attention_inputs(8, 8, 8, (16,), seed=5)
    kb = jnp.asarray(k, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = j_fused(jnp.asarray(q), kb, jnp.asarray(m),
                       [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
                       "relu", True)
    t = torch.from_numpy
    got = p_att.din_attention_fused_ref(
        t(q), t(k).to(torch.bfloat16), t(m),
        [(t(w), t(b)) for w, b in layers], "relu", True)
    assert got.dtype == torch.bfloat16
    assert_agree(got, want, "bfloat16")


def test_din_attention_fused_refuses_what_the_kernel_does_not_take():
    q, k, m, layers, _ = _attention_inputs(3, 4, 4, (8,), seed=6)
    t = torch.from_numpy
    args = [t(q), t(k), t(m), [(t(w), t(b)) for w, b in layers]]
    with pytest.raises(ValueError, match="activations"):
        p_att.din_attention_fused(*args, "dice", False)
    with pytest.raises(ValueError, match="output layer"):
        p_att.din_attention_fused(*args[:3], args[3][:-1], "relu", False)
    with pytest.raises(ValueError, match="query"):
        p_att.din_attention_fused(args[0][:1], *args[1:], "relu", False)
    packed = p_att.pack_params(args[3])
    with pytest.raises(ValueError, match="pack_params"):
        p_att.din_attention_fused(*args, "relu", False, packed=packed[:-1])
    with pytest.raises(ValueError, match="pack_params"):
        p_att.din_attention_fused(*args, "relu", False,
                                  packed=packed.double())
    big = torch.zeros(1, 2, 513)
    with pytest.raises(ValueError, match="E <= 512"):
        p_att.din_attention_fused(torch.zeros(1, 1, 513), big,
                                  torch.ones(1, 2), args[3], "relu", False)


def test_pack_params_folds_the_first_layer():
    """The kernel's weight buffer: q @ W_q + k @ (W_k + diag(q) W_qk) + b_0
    is the first layer over [q, k, q - k, q * k] (1e-5: another order of
    float32 sums), and the later layers follow as they are."""
    B, T, E, n1 = 4, 6, 8, 16
    q, k, _, layers, _ = _attention_inputs(B, T, E, (n1, 8), seed=8)
    t = torch.from_numpy
    params = [(t(w), t(b)) for w, b in layers]
    packed = p_att.pack_params(params)
    w_q, w_k, w_qk = packed[:3 * E * n1].reshape(3, E, n1)
    b_0 = packed[3 * E * n1:3 * E * n1 + n1]
    tq, tk = t(q), t(k)
    folded = (tq @ w_q + b_0 + torch.einsum(
        "bte,beo->bto", tk, w_k + tq[:, 0, :, None] * w_qk))
    qb = tq.expand(B, T, E)
    want = (torch.cat([qb, tk, qb - tk, qb * tk], dim=-1) @ params[0][0]
            + params[0][1])
    torch.testing.assert_close(folded, want, rtol=0, atol=F32_ATOL)
    rest = torch.cat([x.reshape(-1) for wb in params[1:] for x in wb])
    assert torch.equal(packed[3 * E * n1 + n1:], rest)


@pytest.mark.parametrize("wnorm", [False, True])
@pytest.mark.parametrize("hidden", [(20,), (40, 20), (16, 12, 6)])
def test_din_attention_fused_ref_matches_the_pallas_kernel_at_other_depths(
        hidden, wnorm):
    """One hidden layer, two wider than 32 units, and three: the plain
    version against the Pallas kernel in interpret mode (relu)."""
    q, k, m, layers, _ = _attention_inputs(6, 12, 8, hidden, seed=14)
    with pltpu.force_tpu_interpret_mode():
        want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(m),
                       [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
                       "relu", wnorm)
    t = torch.from_numpy
    got = p_att.din_attention_fused_ref(
        t(q), t(k), t(m), [(t(w), t(b)) for w, b in layers], "relu", wnorm)
    assert got.shape == (6, 1, 8)
    assert_agree(got, want, "float32")


def test_din_attention_fused_refuses_packed_weights_off_a_16_byte_boundary():
    """The kernel copies the packed buffer 16 bytes at a time: a buffer
    that starts elsewhere is refused, on the CPU as on the card."""
    q, k, m, layers, _ = _attention_inputs(3, 4, 4, (8,), seed=13)
    t = torch.from_numpy
    args = [t(q), t(k), t(m), [(t(w), t(b)) for w, b in layers]]
    packed = p_att.pack_params(args[3])
    shifted = torch.cat([packed.new_zeros(1), packed])[1:]
    with pytest.raises(ValueError, match="16-byte"):
        p_att.din_attention_fused(*args, "relu", False, packed=shifted)
    torch.testing.assert_close(
        p_att.din_attention_fused(*args, "relu", False, packed=packed),
        p_att.din_attention_fused_ref(*args, "relu", False), rtol=0, atol=0)


def test_attention_parts_finds_every_part_in_the_kernel_source():
    """tools/attention_parts.py cuts parts out of csrc/din_attention.cu by
    editing its text: every text it replaces is in the source once."""
    for without, (name, edits) in attention_parts.VARIANTS.items():
        source = (_build.SRC_DIR / ("%s.cu" % name)).read_text()
        for old, new in edits:
            assert source.count(old) == 1, (without, old)
            assert old != new


@pytest.mark.parametrize("wnorm", [False, True])
def test_din_attention_weights_ref_are_the_readouts_weights(wnorm):
    """The weights sum the keys into the readout; under the softmax each
    row sums to 1 and puts nothing on a padded step beside a valid one,
    without it a padded step weighs 0."""
    q, k, m, layers, lengths = _attention_inputs(8, 10, 4, (6,), seed=9)
    t = torch.from_numpy
    args = (t(q), t(k), t(m), [(t(w), t(b)) for w, b in layers], "relu",
            wnorm)
    s = p_att.din_attention_weights_ref(*args)
    assert s.shape == (8, 10)
    torch.testing.assert_close(
        torch.einsum("bt,bte->be", s, t(k))[:, None, :],
        p_att.din_attention_fused_ref(*args), rtol=0, atol=0)
    pad = t(m) == 0
    if wnorm:
        torch.testing.assert_close(s.sum(-1), torch.ones(8), rtol=0,
                                   atol=F32_ATOL)
        assert (s[pad & torch.from_numpy(lengths > 0)[:, None]] == 0).all()
    else:
        assert (s[pad] == 0).all()


def test_param_cache_rebuilds_when_a_parameter_changes():
    """The kernels' weight copies: kept while the parameters stay, rebuilt
    after an in-place change, a replacement or a new key, and never kept
    while autograd records through a parameter."""
    w = torch.nn.Parameter(torch.ones(3))
    cache = ParamCache()
    builds = []

    def build():
        builds.append(1)
        return w.detach() * 2

    with torch.no_grad():
        first = cache.get([w], "f32", build)
        assert cache.get([w], "f32", build) is first and len(builds) == 1
        w.add_(1.0)
        assert cache.get([w], "f32", build)[0] == 4 and len(builds) == 2
        w.data = torch.zeros(3)
        assert cache.get([w], "f32", build)[0] == 0 and len(builds) == 3
        kept = cache.get([w], "bf16", build)
        assert len(builds) == 4
    cache.get([w], "bf16", build)
    assert len(builds) == 5
    with torch.no_grad():
        assert cache.get([w], "bf16", build) is kept and len(builds) == 5


@pytest.mark.parametrize("return_score", [False, True])
@pytest.mark.parametrize("wnorm", [False, True])
def test_din_attention_ref_matches_jax(wnorm, return_score):
    rng = np.random.default_rng(7)
    scores = rng.normal(0, 2, (6, 1, 10)).astype(np.float32)
    keys = rng.normal(0, 1, (6, 10, 4)).astype(np.float32)
    lengths = _lengths(rng, 6, 10)
    masks = np.arange(10)[None, None, :] < lengths[:, None, None]
    want = jref.din_attention_ref(jnp.asarray(scores), jnp.asarray(keys),
                                  jnp.asarray(masks), wnorm, return_score)
    got = pref.din_attention_ref(torch.from_numpy(scores),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(masks), wnorm,
                                 return_score)
    assert got.shape == (6, 1, 10 if return_score else 4)
    assert_agree(got, want, "float32")
