"""Text vectorization: tokenizer, hashing trick, smart pivot-or-hash.

Counterpart of ``transmogrifai_tpu/ops/text.py``, the reference text
pipeline
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
{SmartTextVectorizer.scala:60, OPCollectionHashingVectorizer.scala,
TextTokenizer.scala}). The reference tokenizes with Lucene analyzers and
hashes with Spark's MurmurHash3 HashingTF; here tokenization is a unicode
regex analyzer and hashing a stable md5-derived bucket hash, both on the
host — same semantics, no JVM. No stage here has a device lowering (as
in the JAX package), so the prepare and scoring plans run them on the
host. ``TextTokenizer`` turns text into a TextList of these tokens, which
``TextListHashVectorizer`` hashes into the same buckets as the JAX
package's.

SmartTextVectorizer's per-feature decision rule is preserved: if the
training cardinality of a text feature is at most ``max_cardinality`` it
is pivoted like a categorical (one-hot over top-K), otherwise its tokens
are hashed into ``num_hashes`` buckets (term frequencies).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from ..features.columns import FeatureColumn
from ..stages.base import SequenceEstimator, SequenceModel
from ..types import OPVector, Text, TextList
from .categorical import _pivot_block, _pivot_metas, _top_categories
from .vector_utils import (NULL_INDICATOR, VectorColumnMetadata, stable_hash,
                           vector_output)

__all__ = ["tokenize", "TextTokenizer", "SmartTextVectorizer",
           "SmartTextVectorizerModel", "TextHashVectorizer",
           "TextListHashVectorizer", "TextListNullTransformer"]

_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)

#: CJK codepoint ranges (Han, Hiragana, Katakana, Hangul) — runs of
#: these emit overlapping character BIGRAMS, Lucene CJKBigramFilter's
#: behavior (the reference's analyzer chain ships CJKAnalyzer/Kuromoji,
#: core/build.gradle:18-21; bigrams are the classic statistical
#: segmentation for unsegmented scripts)
_CJK_RE = re.compile(
    "([㐀-䶿一-鿿぀-ゟ゠-ヿ"
    "가-힯]+)")


def _cjk_bigrams(run: str) -> List[str]:
    if len(run) == 1:
        return [run]
    return [run[i:i + 2] for i in range(len(run) - 1)]


def tokenize(text: Optional[str], min_token_length: int = 1,
             to_lowercase: bool = True) -> List[str]:
    """Unicode word tokenizer with CJK bigram fallback (replaces the
    Lucene analyzer chain of reference TextTokenizer.scala; host-side
    preprocessing). Non-CJK scripts split on word boundaries; CJK runs
    — which carry no spaces to split on — become overlapping character
    bigrams. min_token_length applies to word tokens only (bigrams are
    already minimal units)."""
    if text is None:
        return []
    if to_lowercase:
        text = text.lower()
    out: List[str] = []
    for part in _CJK_RE.split(text):
        if not part:
            continue
        if _CJK_RE.fullmatch(part):
            out.extend(_cjk_bigrams(part))
        else:
            out.extend(t for t in _TOKEN_RE.findall(part)
                       if len(t) >= min_token_length)
    return out


class TextTokenizer(SequenceModel):
    """Text -> TextList of tokens (reference TextTokenizer.scala). A
    stateless transformer, modeled as a 1-sequence for uniformity."""

    input_types = (Text,)
    output_type = TextList

    def __init__(self, min_token_length: int = 1, to_lowercase: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="tokenize", uid=uid)
        self.min_token_length = min_token_length
        self.to_lowercase = to_lowercase

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        col = cols[0]
        out = [tuple(tokenize(v, self.min_token_length, self.to_lowercase))
               for v in col.data]
        return FeatureColumn.from_values(TextList, out)


def _hash_block(texts, n_buckets: int, track_nulls: bool,
                binary_freq: bool = False) -> np.ndarray:
    n = len(texts)
    width = n_buckets + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float64)
    for i, v in enumerate(texts):
        toks = tokenize(v)
        if v is None:
            if track_nulls:
                block[i, n_buckets] = 1.0
            continue
        for t in toks:
            j = stable_hash(t, n_buckets)
            if binary_freq:
                block[i, j] = 1.0
            else:
                block[i, j] += 1.0
    return block


def _hash_metas(feature, n_buckets: int, track_nulls: bool
                ) -> List[VectorColumnMetadata]:
    metas = [VectorColumnMetadata(
        parent_feature_name=feature.name,
        parent_feature_type=feature.ftype.__name__,
        grouping=feature.name, descriptor_value=f"hash_{j}")
        for j in range(n_buckets)]
    if track_nulls:
        metas.append(VectorColumnMetadata(
            parent_feature_name=feature.name,
            parent_feature_type=feature.ftype.__name__,
            grouping=feature.name, indicator_value=NULL_INDICATOR))
    return metas


class SmartTextVectorizerModel(SequenceModel):
    input_types = (Text,)
    output_type = OPVector

    def __init__(self, strategies: List[Tuple[str, object]],
                 num_hashes: int = 512, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtVec", uid=uid)
        #: per input feature: ("pivot", [categories]) or ("hash", None)
        self.strategies = [tuple(s) for s in strategies]
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def _vector_metas(self) -> List[VectorColumnMetadata]:
        # built once per fitted model, not per batch: a hashing slot
        # emits num_hashes (+null) metadata records whose content is
        # fully determined at fit time
        metas = getattr(self, "_metas_cache", None)
        if metas is None:
            metas = []
            for f, (kind, cats) in zip(self.input_features,
                                       self.strategies):
                if kind == "pivot":
                    metas.extend(_pivot_metas(f, list(cats),
                                              self.track_nulls))
                else:
                    metas.extend(_hash_metas(f, self.num_hashes,
                                             self.track_nulls))
            self._metas_cache = metas
        return metas

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks = []
        for col, (kind, cats) in zip(cols, self.strategies):
            if kind == "pivot":
                rows = [None if v is None else (v,) for v in col.data]
                blocks.append(_pivot_block(rows, list(cats),
                                           self.track_nulls))
            else:
                blocks.append(_hash_block(col.data, self.num_hashes,
                                          self.track_nulls))
        return vector_output(self.get_output().name, blocks,
                             self._vector_metas())


class SmartTextVectorizer(SequenceEstimator):
    """Pivot-or-hash decision per text feature
    (reference SmartTextVectorizer.scala:60, fitFn:79-98)."""

    input_types = (Text,)
    output_type = OPVector

    def __init__(self, max_cardinality: int = 30, top_k: int = 20,
                 min_support: int = 10, num_hashes: int = 512,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtVec", uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> SmartTextVectorizerModel:
        strategies: List[Tuple[str, object]] = []
        for col in cols:
            counts: dict = {}
            for v in col.data:
                if v is not None:
                    counts[v] = counts.get(v, 0) + 1
            if len(counts) <= self.max_cardinality:
                strategies.append(
                    ("pivot",
                     _top_categories(counts, self.top_k, self.min_support)))
            else:
                strategies.append(("hash", None))
        return SmartTextVectorizerModel(strategies=strategies,
                                        num_hashes=self.num_hashes,
                                        track_nulls=self.track_nulls)


class TextHashVectorizer(SequenceModel):
    """Pure hashing-trick vectorizer (reference
    OPCollectionHashingVectorizer.scala); stateless."""

    input_types = (Text,)
    output_type = OPVector

    def __init__(self, num_hashes: int = 512, binary_freq: bool = False,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="hashText", uid=uid)
        self.num_hashes = num_hashes
        self.binary_freq = binary_freq
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col in zip(self.input_features, cols):
            blocks.append(_hash_block(col.data, self.num_hashes,
                                      self.track_nulls, self.binary_freq))
            metas.extend(_hash_metas(f, self.num_hashes, self.track_nulls))
        return vector_output(self.get_output().name, blocks, metas)


class TextListHashVectorizer(SequenceModel):
    """Hashing-trick vectorizer over pre-tokenized text lists
    (reference OPCollectionHashingVectorizer.scala list path); an empty
    list is a null."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, num_hashes: int = 512, binary_freq: bool = False,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="hashTextList", uid=uid)
        self.num_hashes = num_hashes
        self.binary_freq = binary_freq
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col in zip(self.input_features, cols):
            n = col.n_rows
            width = self.num_hashes + (1 if self.track_nulls else 0)
            block = np.zeros((n, width), dtype=np.float64)
            for i, toks in enumerate(col.data):
                if not toks:
                    if self.track_nulls:
                        block[i, self.num_hashes] = 1.0
                    continue
                for t in toks:
                    j = stable_hash(str(t), self.num_hashes)
                    if self.binary_freq:
                        block[i, j] = 1.0
                    else:
                        block[i, j] += 1.0
            blocks.append(block)
            metas.extend(_hash_metas(f, self.num_hashes, self.track_nulls))
        return vector_output(self.get_output().name, blocks, metas)


class TextListNullTransformer(SequenceModel):
    """Text lists -> per-feature null/empty indicator column
    (reference TextListNullTransformer.scala)."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="textListNull", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col in zip(self.input_features, cols):
            blocks.append(np.array(
                [0.0 if toks else 1.0 for toks in col.data]))
            metas.append(VectorColumnMetadata(
                parent_feature_name=f.name,
                parent_feature_type=f.ftype.__name__, grouping=f.name,
                indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas)
