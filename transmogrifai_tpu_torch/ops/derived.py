"""Derived-value transformers: parsing, validation, similarity, surgery.

The port's copy of ``transmogrifai_tpu/ops/derived.py``, the reference's
derived-value family (core/src/main/scala/com/salesforce/op/stages/impl/
feature/{PhoneNumberParser.scala, EmailParser via RichTextFeature,
MimeTypeDetector.scala, LangDetector.scala, NGramSimilarity.scala,
TextLenTransformer.scala, ToOccurTransformer.scala,
DropIndicesByTransformer.scala, OPCollectionTransformer.scala}). The
JVM-library backends (libphonenumber, Tika, Optimaize, Lucene) are small
pure-Python equivalents. Every stage here is a host pass, as in the JAX
package: the prepare and scoring plans run them before the device
program.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional

import numpy as np

from ..features.columns import FeatureColumn
from ..stages.base import BinaryTransformer, UnaryTransformer
from ..types import (Base64, Binary, Email, Integral, OPSet, OPVector,
                     Phone, PickList, Real, RealNN, Text, TextList)
from ..utils.vector_meta import VectorMetadata

__all__ = ["PhoneNumberParser", "EmailToPickList", "UrlToPickList",
           "MimeTypeDetector", "LangDetector", "TextLenTransformer",
           "NGramSimilarity", "JaccardSimilarity", "ToOccurTransformer",
           "DropIndicesByTransformer", "CollectionTransformer"]


class PhoneNumberParser(UnaryTransformer):
    """Phone validity check (reference PhoneNumberParser.scala; the
    libphonenumber backend becomes a structural digit check)."""

    input_types = (Phone,)
    output_type = Binary

    def __init__(self, region: str = "US", uid: Optional[str] = None):
        super().__init__(operation_name="phoneValid", uid=uid)
        self.region = region

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        out = np.empty(cols[0].n_rows, dtype=object)
        for i, v in enumerate(cols[0].data):
            if v is None:
                out[i] = None
                continue
            digits = re.sub(r"\D", "", str(v))
            n = len(digits)
            out[i] = (7 <= n <= 15) and not digits.startswith("0") \
                if self.region == "US" else 7 <= n <= 15
        return FeatureColumn.from_values(Binary, list(out))


class EmailToPickList(UnaryTransformer):
    """Email -> domain (or prefix) categorical
    (reference RichTextFeature email pivot via EmailParser)."""

    input_types = (Email,)
    output_type = PickList

    def __init__(self, part: str = "domain", uid: Optional[str] = None):
        super().__init__(operation_name="emailPart", uid=uid)
        if part not in ("domain", "prefix"):
            raise ValueError("part must be 'domain' or 'prefix'")
        self.part = part

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = []
        for v in cols[0].data:
            boxed = Email(v)
            vals.append(boxed.domain if self.part == "domain"
                        else boxed.prefix)
        return FeatureColumn.from_values(PickList, vals)


class UrlToPickList(UnaryTransformer):
    """URL -> protocol/domain categorical (reference RichTextFeature
    urlVectorize)."""

    input_types = (Text,)
    output_type = PickList

    def __init__(self, part: str = "domain", uid: Optional[str] = None):
        super().__init__(operation_name="urlPart", uid=uid)
        if part not in ("domain", "protocol"):
            raise ValueError("part must be 'domain' or 'protocol'")
        self.part = part

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        from ..types import URL
        vals = []
        for v in cols[0].data:
            boxed = URL(v)
            vals.append(boxed.domain if self.part == "domain"
                        else boxed.protocol)
        return FeatureColumn.from_values(PickList, vals)


_MAGIC = [
    (b"%PDF", "application/pdf"),
    (b"\x89PNG", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF8", "image/gif"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"<?xml", "application/xml"),
    (b"{", "application/json"),
]


class MimeTypeDetector(UnaryTransformer):
    """Base64 -> MIME type via magic bytes (reference
    MimeTypeDetector.scala; Tika becomes a signature table)."""

    input_types = (Base64,)
    output_type = PickList

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="mimeType", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = []
        for v in cols[0].data:
            data = Base64(v).as_bytes() if v is not None else None
            if not data:
                vals.append(None)
                continue
            mime = next((m for sig, m in _MAGIC
                         if data.startswith(sig)), None)
            if mime is None:
                try:
                    data.decode("utf-8")
                    mime = "text/plain"
                except UnicodeDecodeError:
                    mime = "application/octet-stream"
            vals.append(mime)
        return FeatureColumn.from_values(PickList, vals)


class LangDetector(UnaryTransformer):
    """Language detection via Unicode-script routing and Cavnar-Trenkle
    character n-gram profiles (utils/text_lang.py), the model family of
    the reference's Optimaize detector (LangDetector.scala,
    core/build.gradle); non-Latin scripts (CJK, Cyrillic, Arabic, ...)
    included."""

    input_types = (Text,)
    output_type = PickList

    def __init__(self, default_lang: str = "unknown",
                 min_confidence: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(operation_name="langDetect", uid=uid)
        self.default_lang = default_lang
        self.min_confidence = min_confidence

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        from ..utils.text_lang import detect_language
        vals = []
        for v in cols[0].data:
            if not v:
                vals.append(None)
                continue
            lang, conf = detect_language(str(v), default=self.default_lang)
            vals.append(lang if conf >= self.min_confidence
                        else self.default_lang)
        return FeatureColumn.from_values(PickList, vals)


class TextLenTransformer(UnaryTransformer):
    """Text length (reference TextLenTransformer.scala); None -> 0."""

    input_types = (Text,)
    output_type = Integral

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="textLen", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = [len(v) if v is not None else 0 for v in cols[0].data]
        return FeatureColumn.from_values(Integral, vals)


def _ngrams(s: str, n: int) -> set:
    s = re.sub(r"\s+", " ", s.strip().lower())
    if len(s) < n:
        return {s} if s else set()
    return {s[i:i + n] for i in range(len(s) - n + 1)}


class NGramSimilarity(BinaryTransformer):
    """Character n-gram Jaccard similarity of two texts
    (reference NGramSimilarity.scala via Lucene; empty inputs -> 0)."""

    input_types = (Text, Text)
    output_type = RealNN

    def __init__(self, n: int = 3, uid: Optional[str] = None):
        super().__init__(operation_name="ngramSim", uid=uid)
        self.n = n

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        out = np.zeros(cols[0].n_rows, dtype=np.float64)
        for i, (a, b) in enumerate(zip(cols[0].data, cols[1].data)):
            if not a or not b:
                continue
            ga, gb = _ngrams(a, self.n), _ngrams(b, self.n)
            union = len(ga | gb)
            out[i] = len(ga & gb) / union if union else 0.0
        return FeatureColumn(ftype=RealNN, data=out)


class JaccardSimilarity(BinaryTransformer):
    """Jaccard similarity of two set features (reference
    JaccardSimilarity.scala; both-empty -> 1.0 as in the reference)."""

    input_types = (OPSet, OPSet)
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="jaccardSim", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        out = np.zeros(cols[0].n_rows, dtype=np.float64)
        for i, (a, b) in enumerate(zip(cols[0].data, cols[1].data)):
            sa = set(a) if a else set()
            sb = set(b) if b else set()
            if not sa and not sb:
                out[i] = 1.0
                continue
            union = len(sa | sb)
            out[i] = len(sa & sb) / union if union else 0.0
        return FeatureColumn(ftype=RealNN, data=out)


class ToOccurTransformer(UnaryTransformer):
    """Any feature -> 1.0 if present/truthy else 0.0
    (reference ToOccurTransformer.scala)."""

    input_types = (None,)
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="toOccur", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        col = cols[0]
        missing = col.is_missing()
        return FeatureColumn(ftype=RealNN,
                             data=(~missing).astype(np.float64))


class DropIndicesByTransformer(UnaryTransformer):
    """Drop vector columns whose metadata matches a predicate
    (reference DropIndicesByTransformer.scala). The predicate takes a
    VectorColumnMetadata; only importable functions survive save/load."""

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, match_fn: Callable = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="dropIndicesBy", uid=uid)
        if match_fn is None:
            raise ValueError("DropIndicesByTransformer requires match_fn")
        self.match_fn = match_fn

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vec = cols[0]
        meta = vec.metadata
        if meta is None or meta.size != vec.data.shape[1]:
            raise ValueError(
                "DropIndicesByTransformer requires vector metadata")
        keep = [c.index for c in meta.columns if not self.match_fn(c)]
        return FeatureColumn.vector(
            np.asarray(vec.data, dtype=np.float64)[:, keep],
            meta.select(keep, name=self.get_output().name))


class CollectionTransformer(UnaryTransformer):
    """Lift a scalar unary transformer over a collection feature
    (reference OPCollectionTransformer.scala: OPMap/OPList/OPSet
    variants wrapping any Text/Numeric transformer): map VALUES / list /
    set ELEMENTS are boxed into the inner stage's input type, pushed
    through its ``transform_value``, and unboxed back into the same
    collection shape."""

    from ..types import OPCollection as _OPC, OPMap as _OPM
    input_types = (object,)   # concrete collection type set at set_input
    output_type = None

    def __init__(self, inner, output_type=None, uid: Optional[str] = None):
        super().__init__(
            operation_name=f"collection_{inner.operation_name}"
            if hasattr(inner, "operation_name") else "collection",
            uid=uid)
        self.inner = inner
        self._out_override = output_type

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = self._out_override or features[0].ftype
        if not getattr(self.inner, "input_features", ()):
            # wire the inner stage to a synthetic element-typed feature
            # so its row path has an input to describe
            from ..features.builder import FeatureBuilder
            dummy = FeatureBuilder.of(
                f"{features[0].name}_element",
                self.inner.input_types[0]).extract(
                lambda r: None).as_predictor()
            self.inner.set_input(dummy)
        return out

    def _apply_scalar(self, v):
        inner_in = self.inner.input_types[0]
        boxed = self.inner.transform_value(inner_in(v))
        return boxed.value if hasattr(boxed, "value") else boxed

    def transform_value(self, value):
        from ..types import OPMap, OPList, OPSet
        raw = value.value if hasattr(value, "value") else value
        ftype = self.output_type
        if raw is None:
            return ftype(None)
        if issubclass(ftype, OPMap):
            return ftype({k: self._apply_scalar(v)
                          for k, v in raw.items()})
        if issubclass(ftype, OPSet):
            return ftype({self._apply_scalar(v) for v in raw})
        return ftype(tuple(self._apply_scalar(v) for v in raw))

    def transform_columns(self, cols):
        from ..features.columns import FeatureColumn
        return FeatureColumn.from_values(
            self.output_type,
            [self.transform_value(v) for v in cols[0].data])
