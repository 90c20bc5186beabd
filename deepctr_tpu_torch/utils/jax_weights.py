"""Carry weights from a ``deepctr_tpu`` model into its port.

``load_jax_weights(model, weights)`` takes the numpy parameter tree that
the JAX package's ``BaseModel.get_weights()`` returns and loads it into the
port's model.  Leaf paths map to ``state_dict`` keys as:

=====================================  =====================================
JAX leaf                               port key
=====================================  =====================================
``embedding_dict/<name>``              ``embedding_dict.tables.<name>``
``linear_model/embedding_dict/<name>`` ``linear_model.embedding_dict.tables.<name>``
``linear_model/weight``                ``linear_model.weight``
``dnn/dense_<i>/kernel`` ``[in,out]``  ``dnn.dense_<i>.weight`` ``[out,in]``
``dnn/dense_<i>/bias``                 ``dnn.dense_<i>.bias``
``dnn_linear/kernel``                  ``dnn_linear.weight`` (transposed)
``out/bias``                           ``out.bias``
``.../Dice_<i>/alpha``                 ``....Dice_<i>.alpha``
``.../bn_<i>/{scale,bias}``            ``....bn_<i>.{scale,bias}``
``.../gru/weight_ih`` (and ``_hh``)    ``....gru.weight_ih`` (not transposed)
``cin/conv_w_<i>`` ``[size, in_ch]``   ``cin.conv_w_<i>`` (not transposed)
``cin/conv_b_<i>``                     ``cin.conv_b_<i>``
``cin_linear/kernel``                  ``cin_linear.weight`` (transposed)
``crossnet/{kernels,bias}``            ``crossnet.{kernels,bias}``
``crossnet/{U,V,C}_list``, ``gating``  ``crossnet.{U,V,C}_list``, ``.gating``
``int_layer_<i>/W_{Query,key,...}``    ``int_layer_<i>.W_{Query,key,...}``
``fm/attention_{W,b}``                 ``fm.attention_{W,b}``
``fm/projection_{h,p}``                ``fm.projection_{h,p}``
``SE/{reduce,expand}/kernel``          ``SE.{reduce,expand}.weight`` (transposed)
``Bilinear/kernel`` ``[P|F, E, E]``    ``Bilinear.kernel`` (not transposed)
``outterproduct/kernel``               ``outterproduct.kernel`` (not transposed)
=====================================  =====================================

A leaf whose path with dots for slashes is a port key keeps its layout
(the stacked and square parameters of the interaction layers, the CIN's,
the GRUs'); any other ``kernel`` is a ``Dense`` layer's, transposed.

``batch_stats`` leaves map the same way onto buffers: Dice's running
``.../Dice_<i>/bn/{mean,var}`` onto ``....Dice_<i>.bn.{mean,var}``, a DNN
batch norm's ``.../bn_<i>/{mean,var}`` onto ``....bn_<i>.{mean,var}``;
``jax_batch_stats`` reads the port's buffers back as that tree.

Tables that the JAX package stores packed (``[ceil(V/pack), 128]`` with
``pack = 128 // W``, see ``deepctr_tpu/inputs.py:78-83``) are unpacked to
the port's logical ``[V, W]``.  A leaf with no counterpart, a shape that
matches neither layout, or a port weight that no leaf fills raises.
``port_key`` and ``jax_path`` apply the table in either direction; the
engine matches its regularization rules against ``jax_path`` of each
parameter, so that patterns written for the JAX package work unchanged.
Uses numpy only.
"""

import numpy as np


def unpack_table(stored, vocab, width):
    """A JAX table as stored -> logical ``[vocab, width]``.

    ``stored`` is either already ``[vocab, width]`` or packed
    ``[ceil(vocab/pack), 128]`` with ``pack = 128 // width``."""
    stored = np.asarray(stored)
    if stored.shape == (vocab, width):
        return stored
    pack = 128 // width if 0 < width <= 128 else 0
    if pack and stored.shape == (-(-vocab // pack), 128):
        return stored[:, :pack * width].reshape(-1, width)[:vocab]
    raise ValueError("table of shape %s is neither [%d, %d] nor its packed "
                     "layout" % (stored.shape, vocab, width))


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = prefix + key
        if isinstance(value, dict):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def port_key(path):
    """JAX leaf path (``a/b/c``) -> the port's ``state_dict`` key, a
    ``kernel`` taken as a ``Dense`` layer's (``jax_to_state_dict`` first
    looks for the path as it is)."""
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] == "embedding_dict":
        return ".".join(parts[:-1] + ["tables", parts[-1]])
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"])
    return ".".join(parts)


def jax_path(key):
    """The port's ``state_dict`` key -> the JAX leaf path (``port_key``'s
    inverse).  A ``weight`` is a ``Dense`` layer's, whose JAX leaf is its
    transpose ``kernel``, except the linear part's dense-feature weight."""
    parts = key.split(".")
    if len(parts) >= 3 and parts[-3:-1] == ["embedding_dict", "tables"]:
        return "/".join(parts[:-2] + [parts[-1]])
    if parts[-1] == "weight" and parts[0] != "linear_model":
        return "/".join(parts[:-1] + ["kernel"])
    return "/".join(parts)


def jax_to_state_dict(weights, target_shapes):
    """Map a JAX parameter tree to ``{port key: numpy array}``.

    ``weights`` is ``get_weights()``'s ``{"params": ..., "batch_stats":
    ...}`` or the ``params`` tree alone; ``target_shapes`` is ``{port
    key: shape}`` of the port model's ``state_dict`` (buffers
    included)."""
    leaves = []
    if "params" in weights:
        leaves = list(_flatten(weights.get("batch_stats", {})))
        weights = weights["params"]
    out = {}
    for path, value in list(_flatten(weights)) + leaves:
        value = np.asarray(value)
        key = path.replace("/", ".")
        if key not in target_shapes:
            key = port_key(path)
            if path.split("/")[-1] == "kernel":
                value = value.T
        if key not in target_shapes:
            raise KeyError("JAX leaf %r has no counterpart in the port "
                           "(looked for %r)" % (path, key))
        shape = tuple(target_shapes[key])
        if ".tables." in key:
            try:
                value = unpack_table(value, *shape)
            except ValueError as err:
                raise ValueError("JAX leaf %r: %s" % (path, err)) from None
        if value.shape != shape:
            raise ValueError("JAX leaf %r has shape %s, port %r wants %s"
                             % (path, value.shape, key, shape))
        out[key] = np.ascontiguousarray(value, dtype=np.float32)
    missing = sorted(set(target_shapes) - set(out))
    if missing:
        raise KeyError("no JAX leaf fills port weights %s" % missing)
    return out


def load_jax_weights(model, weights):
    """Load the JAX package's parameter tree into the port's ``model``;
    returns the ``{port key: numpy array}`` it loaded."""
    state = jax_to_state_dict(
        weights, {k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.set_weights(state)
    return state


def jax_batch_stats(model):
    """The running statistics of ``model`` (Dice's and the DNN batch
    norms' ``mean``/``var`` buffers) as the JAX package's nested
    ``batch_stats`` tree of numpy arrays, as ``get_weights()["batch_stats"]``
    gives it."""
    tree = {}
    persistent = model.state_dict()
    for key, buf in model.named_buffers():
        if key not in persistent:
            continue
        node = tree
        parts = jax_path(key).split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = buf.detach().cpu().numpy()
    return tree
