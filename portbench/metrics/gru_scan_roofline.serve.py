"""gru_scan's (K3, the GRU forward) share of its roofline in the traced
serving window, in percent: the larger of its bytes at the HBM rate (3.35
TB/s) and its products at a third of the TF32 tensor rate (495 TFLOP/s,
H100 SXM; three products a float32 multiply-add), over its device time;
two launches a graph replay (the interest extractor and the evolution)."""


from portbench.metrics import _roofline

KERNELS = ("gru_scan_kernel", "gru_scan_rows_kernel")


def read(view):
    launches = _roofline.gru_launches(view.config)
    if not launches:
        return None
    H = view.config["hidden_size"]

    def least(batch):
        total = 0.0
        for length, att in launches:
            lengths = batch[length]
            B, T = lengths.shape[0], view.config["maxlen"]
            valid = int(lengths.clamp(0, T).sum())
            n_bytes, flops = _roofline.gru_counts(valid, T, B, H, False, att)
            total += _roofline.least_seconds(n_bytes, flops,
                                             _roofline.GRU_FLOP_PER_S)
        return total
    return _roofline.roofline_share(view, KERNELS, least)
