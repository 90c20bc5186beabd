"""The CIN backward's hand-written kernels (``csrc/cin_mix_bwd.cu``,
``ops.cin.bwd_launch``) on the card, against a float64 evaluation from the
same bfloat16 inputs and beside the einsums they replace
(``ops.cin.cin_mix_bwd``); repeat and CUDA-graph replay bit-equal; and the
route a CIN layer's backward takes in each ``set_cin_dtype`` mode, read
from the two counters.  Every test needs an NVIDIA GPU and skips here; on
the card they run without the repository's conftest, which imports JAX::

    python -m pytest tests/test_torch_cin_bwd_card.py -m card --noconftest

Acceptance, for each of dh, dx and dwt, output by output: the kernels'
error against float64 is at most twice the einsums' largest error plus one
bf16 ulp of the float64 value (the kernels round as the einsums do, so
their errors are alike; a lost row chunk or field, or an operand in a
narrower type, exceeds that).  The kernels' tiling (``bwd_plan``, from the
library) is ``BWD_PLANS`` at every shape the CPU tests route by it."""

import numpy as np
import pytest
import torch

from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.ops import cin
from deepctr_tpu_torch.ops._build import LAUNCHES

BF16 = torch.bfloat16
# (B, D, H, F, O, hidden's row stride or None): the benchmark's three
# xDeepFM layers (two of one shape), DeepCTR's 256-128 split_half (the
# second layer's hidden a strided view), H = 26 padded to 32, rows no
# multiple of the tile, O no multiple of 8
SHAPES = [(4096, 10, 26, 26, 200, None), (4096, 10, 200, 26, 200, None),
          (4096, 4, 26, 26, 256, None), (4096, 4, 128, 26, 128, 256),
          (77, 10, 26, 26, 61, None), (77, 10, 200, 26, 100, None),
          (37, 3, 5, 3, 7, None)]
# cin_mix_bwd_plan's tiling at (H, F, O), None where it does not fit:
# the benchmark's layers, DeepCTR's 256-128, ragged shapes, hidden rows
# wider than K6 takes, and cotangent rows too wide
BWD_PLANS = {
    (26, 26, 200): dict(NT=32, nch=1, FG=4, XF=27, stages=9, NO=208,
                        hb_log2=5, FB=4, w_stages=5),
    (200, 26, 200): dict(NT=104, nch=2, FG=2, XF=27, stages=5, NO=208,
                         hb_log2=5, FB=4, w_stages=5),
    (26, 26, 256): dict(NT=32, nch=1, FG=4, XF=27, stages=9, NO=256,
                        hb_log2=5, FB=4, w_stages=5),
    (128, 26, 128): dict(NT=64, nch=2, FG=2, XF=27, stages=10, NO=128,
                         hb_log2=6, FB=2, w_stages=7),
    (5, 3, 7): dict(NT=32, nch=1, FG=4, XF=3, stages=12, NO=64, hb_log2=5,
                    FB=4, w_stages=12),
    (26, 26, 61): dict(NT=32, nch=1, FG=4, XF=27, stages=12, NO=64,
                       hb_log2=5, FB=4, w_stages=12),
    (200, 26, 100): dict(NT=104, nch=2, FG=2, XF=27, stages=6, NO=128,
                         hb_log2=5, FB=4, w_stages=9),
    (400, 26, 72): dict(NT=104, nch=4, FG=2, XF=27, stages=6, NO=128,
                        hb_log2=6, FB=2, w_stages=7),
    (1000, 26, 256): dict(NT=64, nch=16, FG=2, XF=27, stages=8, NO=256,
                          hb_log2=6, FB=2, w_stages=4),
    (200, 26, 1024): None,
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE, pt_config.cin_dtype()
    yield
    pt_config._COMPUTE_DTYPE = saved[0]
    pt_config.set_cin_dtype(saved[1])


def inputs(shape, seed, device):
    """hidden_t (a view at row stride ``ld`` where given), x0_t, wt and g in
    bfloat16 at the scales of a trained layer."""
    B, D, H, F, O, ld = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*size, std=1.0):
        return (torch.randn(*size, generator=gen, device=device) * std).to(BF16)
    hidden = draw(B, D, ld or H)[..., :H]
    x0 = draw(B, D, F)
    wt = draw(F * H, O, std=(H * F) ** -0.5)
    g = draw(B, D, O, std=0.1)
    return hidden, x0, wt, g


def float64_backward(hidden, x0, wt, g):
    """(dh, dx, dwt) in float64 from the bfloat16 inputs, with no rounding
    between: the values both paths approximate."""
    B, D, H = hidden.shape
    F, O, M = x0.shape[2], g.shape[2], B * D
    h = hidden.reshape(M, H).double()
    x = x0.reshape(M, F).double()
    gg = g.reshape(M, O).double()
    dz = torch.matmul(gg, wt.double().t()).reshape(M, F, H)
    dh = torch.einsum("mfh,mf->mh", dz, x)
    dx = torch.einsum("mfh,mh->mf", dz, h)
    del dz
    z = (x[:, :, None] * h[:, None, :]).reshape(M, F * H)
    dwt = torch.matmul(z.t(), gg)
    return dh.reshape(B, D, H), dx.reshape(B, D, F), dwt


@pytest.mark.card
@pytest.mark.parametrize("shape", list(BWD_PLANS), ids=lambda s: "x".join(
    map(str, s)))
def test_the_library_plans_as_the_table(card, shape):
    assert cin.bwd_plan(*shape) == BWD_PLANS[shape]


def ulp(v):
    """One bf16 ulp of |v| (float64)."""
    return torch.exp2(torch.floor(torch.log2(
        v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    str(v) for v in s if v is not None))
def test_kernels_against_float64_and_the_einsums(card, shape):
    B, D, H, F, O, _ = shape
    assert cin.bwd_route(BF16, BF16, H, F, O) == "mma"
    hidden, x0, wt, g = inputs(shape, 11 + H + O, card)
    before = LAUNCHES["cin_mix_bwd"]
    got = cin.bwd_launch(hidden, x0, wt, g)
    assert LAUNCHES["cin_mix_bwd"] - before == 7
    einsum = cin.cin_mix_bwd(hidden, x0, wt, g)
    want = float64_backward(hidden, x0, wt, g)
    torch.cuda.synchronize()
    report = []
    for name, k, e, w in zip(("dh", "dx", "dwt"), got, einsum, want):
        assert k.dtype == BF16 and k.shape == e.shape
        err_k = (k.double() - w).abs()
        err_e = (e.double() - w).abs().max().item()
        excess = (err_k - ulp(w)).max().item()
        report.append("%s kernel %.3g einsum %.3g" % (
            name, err_k.max().item(), err_e))
        assert excess <= 2 * err_e, (name, excess, err_e)
    print(shape, "; ".join(report))


@pytest.mark.card
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3], SHAPES[5]],
                         ids=["cell", "split_half", "ragged"])
def test_repeat_and_graph_replay_are_bit_equal(card, shape):
    hidden, x0, wt, g = inputs(shape, 5, card)
    first = cin.bwd_launch(hidden, x0, wt, g)
    second = cin.bwd_launch(hidden, x0, wt, g)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        cin.bwd_launch(hidden, x0, wt, g)          # warm the caching pool
        with torch.cuda.graph(graph, stream=stream):
            captured = cin.bwd_launch(hidden, x0, wt, g)
    torch.cuda.current_stream().wait_stream(stream)
    before = LAUNCHES["cin_mix_bwd"]
    graph.replay()
    torch.cuda.synchronize()
    assert LAUNCHES["cin_mix_bwd"] == before       # a replay calls no host
    for a, b, c in zip(first, second, captured):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))


@pytest.mark.card
@pytest.mark.parametrize("mode,kernels", [("bf16", True), ("carry", False),
                                          ("f32", False)])
def test_cin_modes_take_their_route(card, mode, kernels):
    """A CIN of three layers trained at bf16 compute: in the "bf16" mode
    every layer's backward launches its seven kernels and none takes the
    einsums; the carry mode's float32 cotangent and the f32 mode take the
    einsums."""
    from deepctr_tpu_torch.layers.interaction import CIN
    pt_config.set_compute_dtype("bfloat16")
    pt_config.set_cin_dtype(mode)
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    layer = CIN(26, (200, 200, 200), activation="linear", split_half=False,
                device=card, generator=gen)
    x = (torch.randn(256, 26, 10, device=card, generator=gen) * 0.05
         ).requires_grad_()
    launches = LAUNCHES["cin_mix_bwd"]
    einsums = LAUNCHES["cin_mix_bwd_einsum"]
    layer(x, training=True).float().sum().backward()
    torch.cuda.synchronize()
    launches = LAUNCHES["cin_mix_bwd"] - launches
    einsums = LAUNCHES["cin_mix_bwd_einsum"] - einsums
    assert (launches, einsums) == ((21, 0) if kernels else (0, 3))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in layer.parameters())
    assert np.isfinite(x.grad.float().cpu().numpy()).all()
