"""row_update's (K2, the touched rows' L2 and optimizer step) share of its
roofline in the traced training window, in percent: its bytes at the HBM
rate (3.35 TB/s, H100 SXM) over its device time; one launch a step."""


from portbench.metrics import _roofline

KERNELS = ("row_update_kernel",)


def read(view):
    if not view.sparse_tables:
        return None

    def least(batch):
        return _roofline.least_seconds(_roofline.row_update_bytes(
            view.config, batch, view.sparse_tables), 0, None)
    return _roofline.roofline_share(view, KERNELS, least)
