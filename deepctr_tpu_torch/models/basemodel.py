"""Model base: device, seeded init, batch assembly, predict, weights.

Counterpart of ``deepctr_tpu/models/basemodel.py`` (``__init__`` :144-210,
``_assemble_x`` :1413-1444, ``predict`` :2020-2053, ``get_weights`` /
``set_weights`` :2125-2134).  The model is the ``nn.Module`` itself; its
``state_dict`` is its weights.  Training comes with a later slice.
"""

import numpy as np
import torch

from ..features import SparseFeat, VarLenSparseFeat
from .base_module import BaseModule


def resolve_device(device):
    """``None`` means ``"cuda"``; a CUDA device on a host without CUDA
    raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the model on the CPU")
    return device


class BaseModel(BaseModule):
    """Feature plumbing, seeded init and inference around a model's layers.

    Every parameter is drawn at construction from one ``torch.Generator``
    on the model's device, seeded with ``seed``; subclasses draw their own
    layers from ``self._init_generator`` after this ``__init__``.
    """

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, init_std=1e-4,
                 seed=1024, task="binary", device=None, gpus=None):
        device = resolve_device(device)
        hashed = [f.name for f in list(linear_feature_columns)
                  + list(dnn_feature_columns)
                  if isinstance(f, (SparseFeat, VarLenSparseFeat))
                  and f.use_hash]
        if hashed:
            raise NotImplementedError(
                "use_hash features %s are not ported yet (they need the "
                "native batcher)" % hashed)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        super().__init__(linear_feature_columns, dnn_feature_columns, task,
                         init_std, device=device, generator=generator)
        self._init_generator = generator
        self.input_dim = (max(e for _, e in self.feature_index.values())
                          if self.feature_index else 0)
        self.seed = seed
        self.task = task
        self.gpus = gpus
        # recorded for the training slice's regularization
        self.l2_reg_linear = l2_reg_linear
        self.l2_reg_embedding = l2_reg_embedding

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------
    def _assemble_x(self, x):
        """dict/list of arrays -> one [N, input_dim] float32 matrix."""
        if isinstance(x, dict):
            x = [x[feature] for feature in self.feature_index]
        if isinstance(x, np.ndarray):
            x = [x]
        arrays = []
        for a in x:
            a = np.asarray(a)
            if a.ndim == 1:
                a = a[:, None]
            arrays.append(np.asarray(a, dtype=np.float32))
        lens = {a.shape[0] for a in arrays}
        if len(lens) > 1:
            detail = ", ".join(
                "%s: %d" % (n, a.shape[0])
                for n, a in zip(self.feature_index, arrays))
            raise ValueError(
                "input features have inconsistent sample counts (%s)"
                % detail)
        X = np.concatenate(arrays, axis=1)
        if X.shape[1] != self.input_dim:
            raise ValueError("input width %d != expected %d"
                             % (X.shape[1], self.input_dim))
        return X

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def predict(self, x, batch_size=256):
        """Batched inference -> float64 ndarray [N, out_dim].

        ``x`` is a dict/list of host arrays, or a flat [N, input_dim]
        float32 tensor (which may already be on the model's device).
        """
        device = next(self.parameters()).device
        if isinstance(x, torch.Tensor):
            X = x
            if X.dim() != 2 or X.shape[1] != self.input_dim:
                raise ValueError("tensor input must be [N, %d], got %r"
                                 % (self.input_dim, tuple(X.shape)))
        else:
            X = torch.from_numpy(self._assemble_x(x))
        outs = []
        with torch.no_grad():
            for start in range(0, X.shape[0], batch_size):
                xb = X[start:start + batch_size].to(device, torch.float32)
                outs.append(self(xb).float())
        out = torch.cat(outs).cpu().numpy().astype("float64")
        if out.ndim == 1:
            out = out[:, None]
        return out

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def get_weights(self):
        """``{state_dict key: numpy array}``."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.state_dict().items()}

    def set_weights(self, weights):
        """Load ``{state_dict key: array}``; every key must match, shape
        included.  Copies into the existing parameters."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in weights.items()}, strict=True)
