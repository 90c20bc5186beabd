"""Where the tensor-core attention kernel spends its time, on one card.

    python -m deepctr_tpu_torch.tools.attention_parts [--seed S]

Builds ``csrc/din_attention.cu`` as it is and with one part taken out,
and times each build at DIN's bench shape (bfloat16 keys, relu, B=1024,
T=100, E=64, attention 64-16, weights at std 0.3), with the softmax and
without it, at every history length 0, at every length 100 and at lengths
uniform over [0, 100], in device ms with a cold L2, median of 20.  The
parts:

- ``fold``: forming a sample's B_s = W_k + diag(q) W_qk;
- ``c0``: a sample's q W_q;
- ``tiles``: every 16-row tile of valid steps (the MLP, the softmax and
  the weighted keys);
- ``weighted keys``: a tile's sum of its rows' keys by their weights;
- ``later layers``: the hidden layers after the first;
- ``key staging``: copying a window's key rows to shared memory.

A build without a part computes wrong values: only its time is read.  The
parts are cut out by editing the source's text, so an edit of the kernel
that moves those lines stops this tool with the line it missed.  Prints
one JSON line a build and case, ``{"without", "softmax", "lengths",
"ms"}``.  Without a CUDA device it raises.
"""

import argparse
import ctypes
import json

import torch

from ..ops import attention
from .gru_parts import build_variants, device_ms

B, T, E, HIDDEN = 1024, 100, 64, (64, 16)
STD = 0.3

# what is taken out -> ("din_attention", [(text, replacement)]), as
# gru_parts.build_variants takes them; "" takes out nothing
_CUTS = {
    "": [],
    "fold": [("for (int i = tid; i < (ep / 16) * nt0 * 32; "
              "i += kMmaThreads) {",
              "for (int i = tid; i < 0; i += kMmaThreads) {")],
    "c0": [("for (int o0 = 0; o0 < np0; o0 += kMmaThreads / parts) {",
            "for (int o0 = 0; o0 < 0; o0 += kMmaThreads / parts) {")],
    "tiles": [("for (int ti = warp; ti < tiles; ti += kMmaWarps) {",
               "for (int ti = warp; ti < 0; ti += kMmaWarps) {")],
    "weighted keys": [
        ("#pragma unroll 4\n        for (int r = 0; r < rows; ++r) {",
         "#pragma unroll 4\n        for (int r = 0; r < 0; ++r) {")],
    "later layers": [("        for (int l = 1; l < hidden; ++l) {",
                      "        for (int l = 1; l < 0; ++l) {")],
    "key staging": [("      stage_row(stage + r * kstride, "
                     "kb + static_cast<long long>(t) * k_st, E,\n"
                     "                ep, vec);", "")],
}
VARIANTS = {without: ("din_attention", edits)
            for without, edits in _CUTS.items()}


def make_inputs(seed):
    """The readout's inputs at the bench shape, on the card, from
    ``seed``: the query, bf16 keys, the masks of each case, the packed
    weights and the widths."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    query = STD * torch.randn(B, E, generator=gen, device="cuda")
    keys = (STD * torch.randn(B, T, E, generator=gen, device="cuda")).to(
        torch.bfloat16)
    widths = (4 * E,) + HIDDEN + (1,)
    layers = [(STD * torch.randn(i, o, generator=gen, device="cuda"),
               STD * torch.randn(o, generator=gen, device="cuda"))
              for i, o in zip(widths[:-1], widths[1:])]
    lengths = torch.randint(0, T + 1, (B,), generator=gen, device="cuda")
    masks = {
        "0": torch.zeros(B, T, dtype=torch.bool, device="cuda"),
        str(T): torch.ones(B, T, dtype=torch.bool, device="cuda"),
        "uniform": torch.arange(T, device="cuda")[None, :] < lengths[:, None],
    }
    return query, keys, masks, attention.pack_params(layers), widths


def readout_call(lib, inputs, mask, softmax):
    query, keys, _, packed, widths = inputs
    fn = attention._kernel(lib)
    out = torch.empty(B, E, dtype=keys.dtype, device="cuda")
    c_widths = (ctypes.c_int * len(widths))(*widths)

    def call():
        rc = fn(1, attention.ACTIVATIONS["relu"], int(softmax),
                query.data_ptr(), 0, keys.data_ptr(), keys.stride(0),
                keys.stride(1), mask.data_ptr(), packed.data_ptr(),
                len(widths) - 1,
                ctypes.addressof(c_widths), B, T, E, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError("din_attention launch failed with %d" % rc)
    return call


def run(seed=0):
    """The records, one a build and case."""
    if not torch.cuda.is_available():
        raise RuntimeError("attention_parts times kernels on a CUDA device")
    libs = build_variants(VARIANTS)
    inputs = make_inputs(seed)
    records = []
    for without, lib in libs.items():
        for softmax in (True, False):
            for lengths, mask in inputs[2].items():
                call = readout_call(lib, inputs, mask, softmax)
                records.append({"without": without, "softmax": softmax,
                                "lengths": lengths, "ms": device_ms(call)})
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    for rec in run(args.seed):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
