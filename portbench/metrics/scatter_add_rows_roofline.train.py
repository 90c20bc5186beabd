"""scatter_add_rows' (K1, the gather's backward: its sort and sums) share
of its roofline in the traced training window, in percent: its bytes at the
HBM rate (3.35 TB/s, H100 SXM) over the device time of its kernels; one
launch a step."""


from portbench.metrics import _roofline

KERNELS = ("keys_hist_kernel", "place_kernel", "chunk_sum_kernel",
           "run_sum_kernel")


def read(view):
    def least(batch):
        return _roofline.least_seconds(
            _roofline.scatter_add_bytes(view.config, batch), 0, None)
    return _roofline.roofline_share(view, KERNELS, least)
