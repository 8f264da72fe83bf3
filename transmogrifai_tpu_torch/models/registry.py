"""Default model pool of the binary selector.

Counterpart of ``transmogrifai_tpu/models/registry.py``
(``default_binary_models``): the reference's default binary pool,
LogisticRegression, RandomForestClassifier, GBTClassifier and LinearSVC,
in its order and with its grids (DefaultSelectorParams): LR at
max_iter 50 over reg_param 0.001/0.01/0.1/0.2 x elastic_net_param
0.1/0.5 (8 points); RF at 50 trees over max_depth 3/6/12 x
min_instances_per_node 10/100 x min_info_gain 0.001/0.01/0.1 (18); GBT
at 20 rounds over max_depth 3/6/12 x min_child_weight 1/10 x gamma
0.001/0.01/0.1 (18); LinearSVC at max_iter 50 over the four reg_param
values (4). The order matters: the first candidate wins a tie.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .base import Predictor

__all__ = ["default_binary_models"]

#: DefaultSelectorParams.Regularization
_REG = (0.001, 0.01, 0.1, 0.2)
#: DefaultSelectorParams.ElasticNet
_ELASTIC = (0.1, 0.5)
#: DefaultSelectorParams.MaxDepth
_DEPTH = (3, 6, 12)
#: DefaultSelectorParams.MinInstancesPerNode
_MIN_INST = (10, 100)
#: DefaultSelectorParams.MinInfoGain, swept as the booster's gamma
_MIN_GAIN = (0.001, 0.01, 0.1)
#: DefaultSelectorParams.{MaxTrees, MaxIterTree, MaxIterLin}
_NUM_TREES, _GBT_ROUNDS, _MAX_ITER_LIN = 50, 20, 50


def default_binary_models(device="cuda"
                          ) -> List[Tuple[Predictor, List[Dict]]]:
    """The default binary pool (48 grid points), on ``device``."""
    from .linear import LinearSVC, LogisticRegression
    from .trees import GBTClassifier, RandomForestClassifier
    return [
        (LogisticRegression(max_iter=_MAX_ITER_LIN, device=device),
         [{"reg_param": r, "elastic_net_param": e}
          for r in _REG for e in _ELASTIC]),
        (RandomForestClassifier(num_trees=_NUM_TREES, device=device),
         [{"max_depth": d, "min_instances_per_node": m, "min_info_gain": g}
          for d in _DEPTH for m in _MIN_INST for g in _MIN_GAIN]),
        (GBTClassifier(num_rounds=_GBT_ROUNDS, device=device),
         [{"max_depth": d, "min_child_weight": float(m), "gamma": g}
          for d in _DEPTH for m in (1, 10) for g in _MIN_GAIN]),
        (LinearSVC(max_iter=_MAX_ITER_LIN, device=device),
         [{"reg_param": r} for r in _REG]),
    ]
