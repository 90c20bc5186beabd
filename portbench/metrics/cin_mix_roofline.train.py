"""cin_mix's (K6, a CIN layer's mix) share of its roofline in the traced
training window, in percent: the larger of its bytes at the HBM rate (3.35
TB/s) and its products at the bf16 tensor rate (989 TFLOP/s; float32 FMAs
at 67 TFLOP/s where the compute dtype is float32), H100 SXM, over its
device time; one launch a CIN layer a step (the backward runs no K6).

A layer's least work, counted from the batch's B and the configuration's
shapes: the hidden maps [B, E, H], the fields [B, E, F], the weight [O, H *
F] and the output [B, E, O] each moved once in the compute dtype, and
2 * B * E * H * F * O operations at the unpadded H and O (the outer
product's multiplies are not counted)."""


from portbench.metrics import _roofline

KERNELS = ("cin_mix_wgmma_kernel", "cin_mix_kernel")


def cin_layers(config):
    """``[(H, O)]`` of the CIN's layers: each layer's hidden maps in and
    maps out; H of the first is the field count."""
    F = sum(c["kind"] == "sparse" for c in config["columns"])
    sizes = config["cin_layer_size"]
    out, H = [], F
    for k, O in enumerate(sizes):
        out.append((H, O))
        H = O // 2 if config["cin_split_half"] and k < len(sizes) - 1 else O
    return out


def cin_mix_counts(config, B):
    """``[(bytes, operations)]`` of a forward's K6 launches at batch B."""
    F = sum(c["kind"] == "sparse" for c in config["columns"])
    E = config["embedding_dim"]
    size = 2 if config["compute_dtype"] == "bfloat16" else 4
    return [(size * (B * E * H + B * E * F + O * H * F + B * E * O),
             2 * B * E * H * F * O) for H, O in cin_layers(config)]


def read(view):
    if not view.config.get("cin_layer_size"):
        return None
    rate = (_roofline.BF16_FLOP_PER_S
            if view.config["compute_dtype"] == "bfloat16"
            else _roofline.F32_FLOP_PER_S)

    def least(batch):
        B = next(iter(batch.values())).shape[0]
        return sum(_roofline.least_seconds(n_bytes, flops, rate)
                   for n_bytes, flops in cin_mix_counts(view.config, B))
    return _roofline.roofline_share(view, KERNELS, least)
