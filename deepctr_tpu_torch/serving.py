"""Serving: a model's inference function exported as one self-contained
artifact.

The port's counterpart of ``deepctr_tpu/serving.py``, which exports the
jitted inference function through ``jax.export``.  Here
``torch.export.export`` traces ``model(X, training=False)`` over a flat
``[B, input_dim]`` float32 batch (the layout ``fit`` and ``predict`` use,
columns in ``get_feature_names`` order) into an ``ExportedProgram`` that
holds a copy of the weights, taken at export; ``torch.export.save`` writes
it to one file.

What a serving process needs: ``torch``, and the port's operator
registrations (``deepctr_tpu_torch.ops.library``, which
:func:`load_exported` imports), because the artifact calls the
hand-written kernels as the custom operators ``deepctr_tpu_torch::
gather_rows``, ``din_attention_fused``, ``gru_scan`` and ``cin_mix``.  It
needs no model class and no feature columns.

Two shape modes, as in the JAX package: a fixed ``batch_size`` (the caller
pads the last partial batch, as ``predict`` does), or ``batch_size=None``,
which makes the batch dimension a ``torch.export.Dim``, so that one
artifact serves any batch size.

The artifact runs on the device its model was on.  One from a CUDA model
launches the kernels (each operator's CUDA implementation, which counts
its launches); one from a ``device="cpu"`` model runs their plain versions
through the operators' CPU implementations.  Like the JAX artifact it does
not check ids: an id outside its table gives a NaN row, and so NaN
predictions.

A model on a mesh (``parallel/``) exports the same one-device, unsharded
function, as ``jax.export`` of a model on a mesh gives an artifact of one
device: every rank calls :func:`export_predict`, which gathers the
row-sharded tables over the ``model`` axis, and :func:`save_exported`
writes the artifact from rank 0 only.
"""

import torch
import torch.distributed as dist
from torch import nn

from .ops import library  # noqa: F401  (registers the operators)

__all__ = ["Exported", "export_predict", "save_exported", "load_exported"]

# the example batch that traces a symbolic batch dimension (sizes 0 and 1
# would be specialised)
_TRACE_BATCH = 8


class _Predict(nn.Module):
    """``model(X, training=False)`` as ``predict`` computes it: float32,
    [B, outputs]."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, X):
        out = self.model(X, training=False).float()
        return out[:, None] if out.dim() == 1 else out


class Exported:
    """An exported inference function: ``program`` is the
    ``torch.export.ExportedProgram``; :meth:`call` runs it.  ``writes``
    is whether :func:`save_exported` writes it from this process (on a
    mesh only rank 0 does)."""

    def __init__(self, program, writes=True):
        self.program = program
        self.writes = writes
        self._module = program.module()
        tensors = list(program.state_dict.values()) + list(
            program.constants.values())
        self.device = next(t.device for t in tensors
                           if isinstance(t, torch.Tensor))

    def call(self, X):
        """Predictions [B, outputs] float32 on the artifact's device for
        ``X`` [B, input_dim] (an array or tensor, moved there)."""
        X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            return self._module(X)


def export_predict(model, batch_size=None):
    """Export ``model``'s inference function as an :class:`Exported`.

    The weights are copied into the artifact at export: training the model
    afterwards does not change it.  ``batch_size=None`` exports a symbolic
    batch dimension (any batch size at call time); an int fixes the shape.
    Raises ``ValueError`` for a model with no input features.

    On a mesh every rank calls it.  Each gathers the whole weights
    (``full_state_dict``, over the ``model`` axis) into a copy of the
    model without a mesh, built again from its constructor arguments as
    ``load_model`` builds one, and exports that copy: the artifact holds
    every table whole and runs on one device."""
    if model.input_dim == 0:
        raise ValueError("model has no input features")
    writes = True
    if getattr(model, "mesh", None) is not None:
        writes = dist.get_rank() == 0
        state = model.full_state_dict()
        model = type(model)(**dict(model._init_kwargs,
                                   device=model._device))
        model.load_state_dict(state)
    example = torch.zeros(batch_size or _TRACE_BATCH, model.input_dim,
                          device=model._device)
    dynamic = (None if batch_size is not None
               else {"X": {0: torch.export.Dim("batch")}})
    with torch.no_grad():
        program = torch.export.export(_Predict(model), (example,),
                                      dynamic_shapes=dynamic, strict=False)
        state = program.state_dict
        for name, t in list(state.items()):
            copy = t.detach().clone()
            state[name] = (nn.Parameter(copy, requires_grad=t.requires_grad)
                           if isinstance(t, nn.Parameter) else copy)
    return Exported(program, writes)


def save_exported(exported, path):
    """Write an :class:`Exported` to ``path`` (``torch.export.save``).  Of
    an artifact exported on a mesh, every rank calls it and rank 0
    writes."""
    if exported.writes:
        torch.export.save(exported.program, path)
    return path


def load_exported(path):
    """Read an artifact written by :func:`save_exported`; returns an
    :class:`Exported` (run it with ``.call(X)``)."""
    return Exported(torch.export.load(path))
