"""Shared helpers for vectorizer stages: matrix assembly + metadata (the
port's copy of ``transmogrifai_tpu/ops/vector_utils.py``; ``stable_hash``
is the JAX package's md5 bucket hash, so hash columns land in the same
buckets)."""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from ..features.columns import FeatureColumn
from ..utils.vector_meta import (NULL_INDICATOR, OTHER_INDICATOR,
                                 VectorColumnMetadata, VectorMetadata)

__all__ = ["vector_output", "stable_hash", "NULL_INDICATOR",
           "OTHER_INDICATOR", "VectorColumnMetadata", "VectorMetadata"]


def vector_output(name: str, blocks: Sequence[np.ndarray],
                  columns: Sequence[VectorColumnMetadata],
                  n_rows: int = 0) -> FeatureColumn:
    """Assemble per-feature column blocks into one OPVector column.
    ``n_rows`` sizes the zero-width matrix when ``blocks`` is empty —
    a map vectorizer fitted with ZERO keys (all-empty training maps)
    must still emit one (n, 0) row per input row, not a (0, 0) column
    that breaks the dataset's row-count invariant."""
    if blocks:
        mat = np.concatenate([np.atleast_2d(b.T).T if b.ndim == 1
                              else b for b in blocks], axis=1)
    else:
        mat = np.zeros((n_rows, 0), dtype=np.float64)
    meta = VectorMetadata(name=name, columns=tuple(columns))
    return FeatureColumn.vector(mat, meta)


def stable_hash(token: str, n_buckets: int) -> int:
    """Deterministic string hash (reference uses MurmurHash3 via Spark
    HashingTF, core/.../feature/OPCollectionHashingVectorizer.scala; any
    stable uniform hash preserves the semantics)."""
    h = hashlib.md5(token.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "little") % n_buckets
