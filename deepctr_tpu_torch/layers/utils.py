"""Small shared helpers (counterpart of ``deepctr_tpu/layers/utils.py``)."""

import numpy as np
import torch


def concat_fun(inputs, axis=-1):
    if len(inputs) == 1:
        return inputs[0]
    return torch.cat(inputs, dim=axis)


def slice_arrays(arrays, start=None, stop=None):
    """Slice one array or a list of arrays along axis 0, for
    ``fit(validation_split=...)``.

    ``start`` is an integer (``[start:stop]``) or a sequence of row
    indices (``stop`` must then be None).  ``None`` entries pass through,
    and a length-1 list sliced by range collapses to the bare array.
    """
    if arrays is None:
        return [None]
    single = not isinstance(arrays, list)
    items = [arrays] if single else arrays

    fancy = hasattr(start, "__len__")
    if fancy:
        if stop is not None:
            raise ValueError(
                "stop must be None when start is an index sequence")
        idx = np.asarray(start)
        sliced = [None if a is None else np.asarray(a)[idx] for a in items]
    else:
        sliced = [None if a is None else a[start:stop] for a in items]

    if single or (not fancy and len(sliced) == 1):
        return sliced[0]
    return sliced
