"""Declarative feature-column spec.

Mirrors the semantics of the reference spec (reference: deepctr_torch/
inputs.py:20-123): a model is configured by a list of ``SparseFeat`` /
``DenseFeat`` / ``VarLenSparseFeat`` descriptors which compile into an
ordered ``{name: (start, end)}`` span map over one flat float input matrix.

The host assembles one ``[B, total_width]`` float32 array per batch, so
there is exactly one host->device copy per batch, and the embedding gather
kernel reads every field's ids straight out of that matrix.

A copy of ``deepctr_tpu/features.py``, kept here so the PyTorch package
imports nothing of the JAX one.
"""

from collections import OrderedDict, namedtuple

DEFAULT_GROUP_NAME = "default_group"


class SparseFeat(namedtuple("SparseFeat",
                            ["name", "vocabulary_size", "embedding_dim",
                             "use_hash", "dtype", "embedding_name",
                             "group_name"])):
    """Categorical (id) feature descriptor.

    ``embedding_name`` defaults to ``name``; two features declaring the same
    ``embedding_name`` share one embedding table (used by e.g. DIN where
    ``item_id`` and ``hist_item_id`` share a table).
    ``embedding_dim="auto"`` resolves to ``6 * vocab**0.25``.
    ``use_hash=True`` hashes raw values (strings or ints) onto
    ``[0, vocabulary_size)`` on the host at batch-assembly time (native
    FNV-1a, deepctr_tpu_torch/native) — the reference declares this flag but
    does not support it (deepctr_torch/inputs.py:31-33).
    (reference parity: deepctr_torch/inputs.py:20-38)
    """
    __slots__ = ()

    def __new__(cls, name, vocabulary_size, embedding_dim=4, use_hash=False,
                dtype="int32", embedding_name=None,
                group_name=DEFAULT_GROUP_NAME):
        if embedding_name is None:
            embedding_name = name
        if embedding_dim == "auto":
            embedding_dim = 6 * int(pow(vocabulary_size, 0.25))
        return super(SparseFeat, cls).__new__(
            cls, name, vocabulary_size, embedding_dim, use_hash, dtype,
            embedding_name, group_name)

    def __hash__(self):
        return self.name.__hash__()


class VarLenSparseFeat(namedtuple("VarLenSparseFeat",
                                  ["sparsefeat", "maxlen", "combiner",
                                   "length_name"])):
    """Variable-length (multi-valued / behavior-sequence) sparse feature.

    Padded to ``maxlen`` in the flat matrix.  If ``length_name`` is None the
    valid mask is ``ids != 0`` (0 = padding id); otherwise an explicit length
    column is appended to the input layout.
    (reference parity: deepctr_torch/inputs.py:41-77)
    """
    __slots__ = ()

    def __new__(cls, sparsefeat, maxlen, combiner="mean", length_name=None):
        return super(VarLenSparseFeat, cls).__new__(
            cls, sparsefeat, maxlen, combiner, length_name)

    @property
    def name(self):
        return self.sparsefeat.name

    @property
    def vocabulary_size(self):
        return self.sparsefeat.vocabulary_size

    @property
    def embedding_dim(self):
        return self.sparsefeat.embedding_dim

    @property
    def use_hash(self):
        return self.sparsefeat.use_hash

    @property
    def dtype(self):
        return self.sparsefeat.dtype

    @property
    def embedding_name(self):
        return self.sparsefeat.embedding_name

    @property
    def group_name(self):
        return self.sparsefeat.group_name

    def __hash__(self):
        return self.name.__hash__()


class DenseFeat(namedtuple("DenseFeat", ["name", "dimension", "dtype"])):
    """Dense numeric feature of a given dimension.
    (reference parity: deepctr_torch/inputs.py:80-87)
    """
    __slots__ = ()

    def __new__(cls, name, dimension=1, dtype="float32"):
        return super(DenseFeat, cls).__new__(cls, name, dimension, dtype)

    def __hash__(self):
        return self.name.__hash__()


def build_input_features(feature_columns):
    """Compile an ordered column list into ``OrderedDict{name: (start, end)}``.

    Dedups by name; a VarLenSparseFeat occupies ``maxlen`` columns and, when
    it declares ``length_name``, appends a 1-wide length column.
    (reference parity: deepctr_torch/inputs.py:99-123)
    """
    features = OrderedDict()
    start = 0
    for feat in feature_columns:
        feat_name = feat.name
        if feat_name in features:
            continue
        if isinstance(feat, SparseFeat):
            features[feat_name] = (start, start + 1)
            start += 1
        elif isinstance(feat, DenseFeat):
            features[feat_name] = (start, start + feat.dimension)
            start += feat.dimension
        elif isinstance(feat, VarLenSparseFeat):
            features[feat_name] = (start, start + feat.maxlen)
            start += feat.maxlen
            if feat.length_name is not None and feat.length_name not in features:
                features[feat.length_name] = (start, start + 1)
                start += 1
        else:
            raise TypeError("Invalid feature column type, got %s" % type(feat))
    return features


def get_feature_names(feature_columns):
    """Ordered feature names = the order user arrays are concatenated in."""
    return list(build_input_features(feature_columns).keys())


def input_width(feature_columns):
    """Total flat-matrix width implied by a feature-column list."""
    features = build_input_features(feature_columns)
    if not features:
        return 0
    return max(end for _, end in features.values())


def split_columns(feature_columns, kinds="sparse,dense,varlen"):
    """Partition a mixed column list by kind; returns the requested lists."""
    sparse = [f for f in feature_columns if isinstance(f, SparseFeat)]
    dense = [f for f in feature_columns if isinstance(f, DenseFeat)]
    varlen = [f for f in feature_columns if isinstance(f, VarLenSparseFeat)]
    out = {"sparse": sparse, "dense": dense, "varlen": varlen}
    parts = [out[k] for k in kinds.split(",")]
    return parts[0] if len(parts) == 1 else tuple(parts)
