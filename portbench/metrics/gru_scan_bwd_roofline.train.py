"""gru_scan_bwd's (K5, the GRU backward: the reverse scan and the dW_hh
product) share of its roofline in the traced training window, in percent:
the larger of its bytes at the HBM rate (3.35 TB/s) and its products at a
third of the TF32 tensor rate (495 TFLOP/s, H100 SXM; three products a
float32 multiply-add), over the device time of its kernels; two launches a
step."""


from portbench.metrics import _roofline

KERNELS = ("gru_scan_bwd_kernel", "gru_scan_bwd_rows_kernel",
           "dw_partial_kernel", "dw_rows_partial_kernel", "dw_reduce_kernel")


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
            n_bytes, flops = _roofline.gru_bwd_counts(valid, T, B, H, att)
            total += _roofline.least_seconds(n_bytes, flops,
                                             _roofline.GRU_FLOP_PER_S)
        return total
    return _roofline.roofline_share(view, KERNELS, least)
