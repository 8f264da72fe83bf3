"""NameEntityRecognizer: Text -> MultiPickListMap of entity tags.

The port's copy of ``transmogrifai_tpu/ops/ner.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/feature/
NameEntityRecognizer.scala:57-90): split the text into sentences, tag each
sentence and merge the {token -> set(entity types)} maps. The statistical
OpenNLP tagger is the deterministic heuristic tagger of
``utils/text_ner.py``. A host pass, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..features.columns import FeatureColumn
from ..stages.base import UnaryTransformer
from ..types import MultiPickListMap, Text
from ..utils.text_ner import (HeuristicNameEntityTagger, NameEntityType,
                              split_sentences)

__all__ = ["NameEntityRecognizer", "NameEntityType"]


class NameEntityRecognizer(UnaryTransformer):
    """(reference NameEntityRecognizer.scala:57)"""

    input_types = (Text,)
    output_type = MultiPickListMap

    def __init__(self, tagger: Optional[HeuristicNameEntityTagger] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="nameEntityRec", uid=uid)
        self.tagger = tagger or HeuristicNameEntityTagger()

    def transform_value(self, value) -> MultiPickListMap:
        text = value.value if hasattr(value, "value") else value
        merged: Dict[str, Set[str]] = {}
        for sentence in split_sentences(text or ""):
            for tok, ents in self.tagger.tag(sentence).items():
                merged.setdefault(tok, set()).update(ents)
        return MultiPickListMap({k: set(v) for k, v in merged.items()})

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        values = [self.transform_value(v) for v in cols[0].data]
        return FeatureColumn.from_values(MultiPickListMap, values)
