"""gather_rows' share of its roofline in the traced serving window, in
percent: its bytes at the HBM rate (3.35 TB/s, H100 SXM) over its device
time; one launch a graph replay."""


from portbench.metrics import _roofline

KERNELS = ("gather_rows_kernel",)


def read(view):
    def least(batch):
        return _roofline.least_seconds(
            _roofline.gather_bytes(view.config, batch, False), 0, None)
    return _roofline.roofline_share(view, KERNELS, least)
