"""Default model pool of the binary selector (the ported part).

Counterpart of ``transmogrifai_tpu/models/registry.py``. The reference's
default binary pool is LogisticRegression, RandomForestClassifier,
GBTClassifier and LinearSVC; so far the port has the two tree families,
in the reference's order and with its identical 18-point grids: RF at 50
trees over max_depth 3/6/12 x min_instances_per_node 10/100 x
min_info_gain 0.001/0.01/0.1, GBT at 20 rounds over max_depth 3/6/12 x
min_child_weight 1/10 x gamma 0.001/0.01/0.1. The order matters: the
first candidate wins a tie.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .base import Predictor

__all__ = ["default_binary_models", "UNPORTED_BINARY_FAMILIES"]

#: DefaultSelectorParams.MaxDepth
_DEPTH = (3, 6, 12)
#: DefaultSelectorParams.MinInstancesPerNode
_MIN_INST = (10, 100)
#: DefaultSelectorParams.MinInfoGain, swept as the booster's gamma
_MIN_GAIN = (0.001, 0.01, 0.1)
#: DefaultSelectorParams.{MaxTrees, MaxIterTree}
_NUM_TREES, _GBT_ROUNDS = 50, 20
#: families of the reference's default binary pool not ported yet
UNPORTED_BINARY_FAMILIES = ("LogisticRegression", "LinearSVC")


def default_binary_models(device="cuda"
                          ) -> List[Tuple[Predictor, List[Dict]]]:
    """The ported families of the default binary pool, on ``device``."""
    from .trees import GBTClassifier, RandomForestClassifier
    return [
        (RandomForestClassifier(num_trees=_NUM_TREES, device=device),
         [{"max_depth": d, "min_instances_per_node": m, "min_info_gain": g}
          for d in _DEPTH for m in _MIN_INST for g in _MIN_GAIN]),
        (GBTClassifier(num_rounds=_GBT_ROUNDS, device=device),
         [{"max_depth": d, "min_child_weight": float(m), "gamma": g}
          for d in _DEPTH for m in (1, 10) for g in _MIN_GAIN]),
    ]
