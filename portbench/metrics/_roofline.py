"""The yardstick of the per-layer metrics: the H100's peaks and the
operations and bytes each hand-written kernel of the port must move for a
launch, counted from the inputs the benchmark drew.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its full power
limit of 700 W (a card set lower runs slower under load; the result line
names the card).  The counts follow the least-work rule: each input
byte read once, each output byte written once, the work these inputs need
(a history's padded steps need no arithmetic).  They are copies of
``chip_smoke.py``'s ``bound``, ``gather_bytes``, ``gru_bound``,
``gru_bwd_bound`` and ``k2_bounds`` (and its ``scatter_add_rows`` bytes),
rewritten over the benchmark's own batches.
"""

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12
# the GRU kernels at H <= 64 run each float32 multiply-add as three TF32
# tensor-core products (3xTF32): their operations bound is at a third of
# the TF32 rate
GRU_FLOP_PER_S = TF32_FLOP_PER_S / 3

# the optimizer's state tensors a table row carries
OPT_STATE = {"sgd": 0, "adagrad": 1, "rmsprop": 1, "adam": 2}


def least_seconds(n_bytes, flops, flop_rate):
    """The least time of a launch: the larger of its bytes at the HBM
    rate and its operations at ``flop_rate``."""
    return max(n_bytes / HBM_BYTES_PER_S,
               0.0 if flop_rate is None else flops / flop_rate)


def table_width(config, table):
    """A table's row width as the port stores it: E, and one more column
    for the linear weight where every sparse column is also a linear
    column (the fused wide column)."""
    for c in config["columns"]:
        if c.get("table", c["name"]) == table and c["kind"] != "dense":
            return c["dim"] + (1 if config["linear_columns"] == "all"
                               else 0)
    raise KeyError(table)


def lookup_fields(config, training):
    """``[(column, table, fields)]`` of a forward's one gather launch:
    every sparse column (1 field) and history (``maxlen`` fields); the
    columns ``train_only_columns`` names only in training."""
    skip = set() if training else set(config.get("train_only_columns", []))
    out = []
    for c in config["columns"]:
        if c["kind"] in ("sparse", "varlen") and c["name"] not in skip:
            out.append((c["name"], c.get("table", c["name"]),
                        c.get("maxlen", 1)))
    return out


def _distinct(batch, fields):
    """``{table: distinct ids}`` over the fields of a batch."""
    ids = {}
    for col, table, _ in fields:
        ids.setdefault(table, []).append(batch[col].reshape(-1))
    return {t: int(torch.unique(torch.cat(v)).numel())
            for t, v in ids.items()}


def gather_bytes(config, batch, training):
    """gather_rows: the id of every (row, field) (float32 in the flat
    input), every distinct table row once, the [B, F, W] output."""
    fields = lookup_fields(config, training)
    B = next(iter(batch.values())).shape[0]
    n_bytes = 0
    for table, n in _distinct(batch, fields).items():
        n_bytes += 4 * table_width(config, table) * n
    for col, table, f in fields:
        n_bytes += 4 * B * f * (1 + table_width(config, table))
    return n_bytes


def scatter_add_bytes(config, batch):
    """scatter_add_rows (the gather's backward): the cotangent and the
    ids (int64) once, each distinct target row read and written once."""
    fields = lookup_fields(config, True)
    B = next(iter(batch.values())).shape[0]
    n_bytes = 0
    for col, table, f in fields:
        n_bytes += B * f * (4 * table_width(config, table) + 8)
    for table, n in _distinct(batch, fields).items():
        n_bytes += 2 * 4 * table_width(config, table) * n
    return n_bytes


def row_update_bytes(config, batch, sparse_tables):
    """row_update (K2) of a step: each touched row (the batch's ids and
    row 0) of a sparse table, its table row and state rows read and
    written once and its gradient read once, and each slot of the table's
    fixed row list (``min(1 + B * fields, V)``) read once as an int64."""
    B = next(iter(batch.values())).shape[0]
    n_state = OPT_STATE[config["optimizer"]]
    n_bytes = 0
    for table, cols in sparse_tables.items():
        name = table.rsplit(".", 1)[-1]
        vocab = next(c["vocab"] for c in config["columns"]
                     if c.get("table", c["name"]) == name
                     and c["kind"] != "dense")
        width = table_width(config, name)
        ids = torch.cat([batch[c].reshape(-1) for c in cols]
                        + [torch.zeros(1, dtype=torch.int64,
                                       device=batch[cols[0]].device)])
        n = int(torch.unique(ids).numel())
        fields = sum(batch[c][0].numel() for c in cols)
        cap = min(1 + B * fields, vocab)
        n_bytes += n * width * 4 * (2 * (1 + n_state) + 1) + cap * 8
    return n_bytes


def gru_counts(valid, T, B, H, training, att, size=2):
    """gru_scan over one batch: ``(bytes, operations)``.  Operations: the
    h @ W_hh product of each step inside a history (2 * H * 3H a step).
    Bytes: those steps' gates read once, the [T, B, H] outputs, h_last,
    the mask and the float32 W_hh and b_hh; the attention scores [B, T]
    where given; in training the carries [T, B, H] written too."""
    n_bytes = (valid * 3 * H * size + T * B * H * size + B * H * size
               + T * B + 4 * (H * 3 * H + 3 * H))
    if att:
        n_bytes += B * T * size
    if training:
        n_bytes += T * B * H * size
    return n_bytes, 2 * valid * H * 3 * H


def gru_bwd_counts(valid, T, B, H, att, size=2):
    """gru_scan_bwd over one batch: ``(bytes, operations)``.  Operations:
    a step inside a history does three products of H x 3H multiply-adds a
    row (the gates recomputed, dh, dW_hh).  Bytes: those steps' gates,
    carries and output cotangents, h_last's cotangent, the mask and the
    weights read once; dgi (every step), dW_hh and db_hh written once;
    the scores read and their cotangent written where given."""
    n_bytes = (valid * 5 * H * size + B * H * size + T * B
               + T * B * 3 * H * size + 2 * 4 * (H * 3 * H + 3 * H))
    if att:
        n_bytes += 2 * B * T * size
    return n_bytes, 6 * valid * H * 3 * H


def gru_launches(config):
    """``[(length column, has attention scores)]``: the GRU scans of one
    forward, as the configuration's ``gru_launches`` lists them (none
    where it lists none)."""
    return [(g["length"], bool(g["attention"]))
            for g in config.get("gru_launches", [])]


def roofline_share(view, kernel_names, least_per_unit):
    """100 x (the least time of every launch of ``kernel_names`` in the
    traced window) / (their device time), or None where none launched.
    ``least_per_unit(batch)`` is the least seconds of the launches one
    unit of work (a train step, a graph replay) makes on a sample batch;
    the samples' weights average it, ``view.units`` counts the units."""
    n, seconds = view.records.kernel(kernel_names)
    if n == 0 or seconds <= 0:
        return None
    per_unit = sum(w * least_per_unit(b) for w, b in view.samples)
    return 100.0 * per_unit * view.units / seconds


def mfu(view, training):
    """100 x the model's matrix-product operations (x3 in training: the
    forward and two backward products) a second over the bf16 peak."""
    if view.window_s <= 0:
        return None
    flops = view.flops_per_example * (3 if training else 1)
    return 100.0 * flops * view.examples / view.window_s / BF16_FLOP_PER_S
