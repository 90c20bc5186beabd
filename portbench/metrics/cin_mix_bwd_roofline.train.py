"""The CIN backward's kernels' (``CinMix``'s backward on its "mma" route:
cin_bwd_tile_kernel four times, cin_bwd_data_wgmma_kernel,
cin_bwd_weight_wgmma_kernel and cin_bwd_weight_reduce_kernel) share of
their roofline in the traced training window, in percent: the larger of
their bytes at the HBM rate (3.35 TB/s) and their products at the bf16
tensor rate (989 TFLOP/s; float32 FMAs at 67 TFLOP/s where the compute
dtype is float32), H100 SXM, over their device time; seven launches a CIN
layer a step.  The parent of these kernels ran the backward as einsums and
launches none of them: the metric then reads nothing.

A layer's least work, counted from the batch's B and the configuration's
shapes: 4 * B * E * H * F * O operations at the unpadded H and O (the two
products, dz = g wt^T and dwt = z^T g; the outer product z and the
reductions of dz into dh and dx are not counted); the cotangent g [B, E,
O], the hidden maps [B, E, H], the fields [B, E, F] and the weight [F * H,
O] read once, dh, dx and dwt written once, in the compute dtype."""

import importlib.util
from pathlib import Path

from portbench.metrics import _roofline

KERNELS = ("cin_bwd_tile_kernel", "cin_bwd_data_wgmma_kernel",
           "cin_bwd_weight_wgmma_kernel", "cin_bwd_weight_reduce_kernel")


def _forward_reader():
    """The K6 reader beside this file, for its ``cin_layers``."""
    path = Path(__file__).with_name("cin_mix_roofline.train.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_cin_mix_roofline_train_layers", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cin_mix_bwd_counts(config, B):
    """``[(bytes, operations)]`` of a step's CIN backward, a layer each, at
    batch B."""
    F = sum(c["kind"] == "sparse" for c in config["columns"])
    E = config["embedding_dim"]
    size = 2 if config["compute_dtype"] == "bfloat16" else 4
    out = []
    for H, O in _forward_reader().cin_layers(config):
        moved = B * E * O + 2 * (B * E * H + B * E * F + F * H * O)
        out.append((size * moved, 4 * B * E * H * F * O))
    return out


def read(view):
    if not view.config.get("cin_layer_size"):
        return None
    rate = (_roofline.BF16_FLOP_PER_S
            if view.config["compute_dtype"] == "bfloat16"
            else _roofline.F32_FLOP_PER_S)

    def least(batch):
        B = next(iter(batch.values())).shape[0]
        return sum(_roofline.least_seconds(n_bytes, flops, rate)
                   for n_bytes, flops in cin_mix_bwd_counts(view.config, B))
    return _roofline.roofline_share(view, KERNELS, least)
