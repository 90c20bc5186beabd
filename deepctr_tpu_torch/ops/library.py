"""The inference kernels as ``torch.library`` custom operators.

Four operators in the namespace ``deepctr_tpu_torch``, each with three
implementations:

- CUDA: the wrapper module's ``launch``, which checks what the kernel
  takes, launches the hand-written kernel through ``ctypes`` and counts
  the launch (``ops._build.LAUNCHES``, at run time);
- CPU: the kernel's plain PyTorch version;
- fake: the output's shape and dtype from the inputs alone, with the
  batch dimension left symbolic, so that ``torch.export`` traces a model
  through them (``serving.py``).

Every pointer read and argument cache lives inside the CUDA
implementation, which the tracer never runs.  The model path, the CUDA
graphs of ``models/graphs.py`` and exported artifacts all call these
operators: one forward a kernel.  The wrappers ``ops.gather.gather_rows``,
``ops.attention.din_attention_fused``, ``ops.gru.gru_scan`` and
``ops.cin.cin_mix`` check their arguments and call them; the
``torch.autograd.Function``s ``GatherRows``, ``GruScan`` and ``CinMix``
call them for their forward and keep their backward kernels.

A process that loads an artifact imports this module to register them
(``serving.load_exported`` does).
"""

from typing import List, Optional

import torch

from . import attention, cin, gather, gru

_NS = "deepctr_tpu_torch::"


# gather_rows: X [B, D] f32, tables F x [V_f, W] f32, cols [F], row bases
# [F] or None (the shard-local mode) -> [B, F, W]

@torch.library.custom_op(_NS + "gather_rows", mutates_args=(),
                         device_types="cuda")
def gather_rows(X: torch.Tensor, tables: List[torch.Tensor],
                cols: List[int],
                bases: Optional[List[int]] = None) -> torch.Tensor:
    return gather.launch(X, tables, cols, bases)


@gather_rows.register_kernel("cpu")
def _(X, tables, cols, bases=None):
    return gather.gather_rows_ref(X, tables, cols, bases)


@gather_rows.register_fake
def _(X, tables, cols, bases=None):
    return X.new_empty(X.shape[0], len(tables), tables[0].shape[1])


# din_attention_fused: query [B, 1, E], keys [B, T, E], mask [B, T], the
# layers' (W, b) flattened -> [B, 1, E] in the keys' dtype

def _layers(params):
    return list(zip(params[0::2], params[1::2]))


@torch.library.custom_op(_NS + "din_attention_fused", mutates_args=(),
                         device_types="cuda")
def din_attention_fused(query: torch.Tensor, keys: torch.Tensor,
                        mask: torch.Tensor, params: List[torch.Tensor],
                        activation: str, weight_normalization: bool,
                        packed: Optional[torch.Tensor]) -> torch.Tensor:
    return attention.launch(query, keys, mask, _layers(params), activation,
                            weight_normalization, packed)


@din_attention_fused.register_kernel("cpu")
def _(query, keys, mask, params, activation, weight_normalization, packed):
    layers = _layers(params)
    if packed is not None:
        attention._check_packed(packed, keys, layers)
    return attention.din_attention_fused_ref(query, keys, mask, layers,
                                             activation, weight_normalization)


@din_attention_fused.register_fake
def _(query, keys, mask, params, activation, weight_normalization, packed):
    return keys.new_empty(keys.shape[0], 1, keys.shape[2])


# gru_scan: gi [T, B, 3H] -> (outs [B, T, H], h_last [B, H], carry [T, B, H]
# with save_carry, else [0]), in gi's dtype

@torch.library.custom_op(_NS + "gru_scan", mutates_args=(),
                         device_types="cuda")
def gru_scan(gi: torch.Tensor, whh_t: torch.Tensor, bhh: torch.Tensor,
             mask: torch.Tensor, att: Optional[torch.Tensor], mode: str,
             save_carry: bool) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    return gru.launch(gi, whh_t, bhh, mask, att, mode, save_carry)


@gru_scan.register_kernel("cpu")
def _(gi, whh_t, bhh, mask, att, mode, save_carry):
    return gru.plain(gi, whh_t, bhh, mask, att, mode, save_carry)


@gru_scan.register_fake
def _(gi, whh_t, bhh, mask, att, mode, save_carry):
    T, B, H3 = gi.shape
    H = H3 // 3
    carry = gi.new_empty(T, B, H) if save_carry else gi.new_empty(0)
    return gi.new_empty(B, T, H), gi.new_empty(B, H), carry


# cin_mix: hidden_t [B, D, H], x0_t [B, D, F], w3 [O, H, F] (the plain
# version's weight) and the kernel's wt [F*H, O] and wm (tensor-core route)
# -> [B, D, O] in out_dtype, or hidden_t's dtype

@torch.library.custom_op(_NS + "cin_mix", mutates_args=(),
                         device_types="cuda")
def cin_mix(hidden_t: torch.Tensor, x0_t: torch.Tensor, w3: torch.Tensor,
            wt: Optional[torch.Tensor], wm: Optional[torch.Tensor],
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if wt is None:
        wt = cin.kernel_weight(w3, hidden_t.dtype)
    return cin.launch(hidden_t, x0_t, wt, wm, out_dtype)


@cin_mix.register_kernel("cpu")
def _(hidden_t, x0_t, w3, wt, wm, out_dtype):
    return cin.cin_mix_ref(hidden_t, x0_t, w3, out_dtype)


@cin_mix.register_fake
def _(hidden_t, x0_t, w3, wt, wm, out_dtype):
    B, D, _ = hidden_t.shape
    return hidden_t.new_empty(B, D, w3.shape[0],
                              dtype=out_dtype or hidden_t.dtype)
