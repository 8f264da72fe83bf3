"""Default model pools of the selector factories.

Counterpart of ``transmogrifai_tpu/models/registry.py``: the default and
opt-in pools of the three problem types, each family on the caller's
``device``. The default binary pool is
LogisticRegression, RandomForestClassifier, GBTClassifier and LinearSVC,
in its order and with its grids (DefaultSelectorParams): LR at
max_iter 50 over reg_param 0.001/0.01/0.1/0.2 x elastic_net_param
0.1/0.5 (8 points); RF at 50 trees over max_depth 3/6/12 x
min_instances_per_node 10/100 x min_info_gain 0.001/0.01/0.1 (18); GBT
at 20 rounds over max_depth 3/6/12 x min_child_weight 1/10 x gamma
0.001/0.01/0.1 (18); LinearSVC at max_iter 50 over the four reg_param
values (4). The multiclass pool is LR, RF, NaiveBayes and DT; the
regression pool LinearRegression, RandomForestRegressor, GBTRegressor and
GLM (gaussian and poisson at reg_param 0.001/0.01/0.1). The opt-in pools
(``model_types_to_use`` picks from default + opt-in) hold NaiveBayes, DT
and XGBoost (binary), the softmax XGBoost (multiclass) and DT and XGBoost
(regression) and the MLP at hidden layers (10,) and (32, 16)
(multiclass). The order matters: the first candidate wins a tie.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .base import Predictor

__all__ = ["default_binary_models", "default_binary_extra_models",
           "default_multiclass_models", "default_multiclass_extra_models",
           "default_regression_models", "default_regression_extra_models"]

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
#: DefaultSelectorParams.MinChildWeight (xgboost)
_MIN_CHILD = (1.0, 5.0, 10.0)
#: DefaultSelectorParams.{MaxTrees, MaxIterTree, MaxIterLin}
_NUM_TREES, _GBT_ROUNDS, _MAX_ITER_LIN = 50, 20, 50


def default_binary_models(device="cuda"
                          ) -> List[Tuple[Predictor, List[Dict]]]:
    """The default binary pool (48 grid points), on ``device``."""
    from .linear import LinearSVC
    from .trees import GBTClassifier, RandomForestClassifier
    return [
        _lr(device),
        (RandomForestClassifier(num_trees=_NUM_TREES, device=device),
         _forest_grid()),
        (GBTClassifier(num_rounds=_GBT_ROUNDS, device=device), _gbt_grid()),
        (LinearSVC(max_iter=_MAX_ITER_LIN, device=device),
         [{"reg_param": r} for r in _REG]),
    ]


def _lr(device):
    from .linear import LogisticRegression
    return (LogisticRegression(max_iter=_MAX_ITER_LIN, device=device),
            [{"reg_param": r, "elastic_net_param": e}
             for r in _REG for e in _ELASTIC])


def _forest_grid():
    return [{"max_depth": d, "min_instances_per_node": m, "min_info_gain": g}
            for d in _DEPTH for m in _MIN_INST for g in _MIN_GAIN]


def _gbt_grid():
    return [{"max_depth": d, "min_child_weight": float(m), "gamma": g}
            for d in _DEPTH for m in (1, 10) for g in _MIN_GAIN]


def _xgb_grid():
    return [{"max_depth": d, "eta": e, "min_child_weight": m}
            for d in _DEPTH for e in (0.1, 0.3) for m in _MIN_CHILD]


def default_binary_extra_models(device="cuda"
                                ) -> List[Tuple[Predictor, List[Dict]]]:
    """The binary opt-in families: NaiveBayes, DT and XGBoost."""
    from .bayes import NaiveBayes
    from .trees import DecisionTreeClassifier, XGBoostClassifier
    return [
        (NaiveBayes(device=device), [{"smoothing": 1.0}]),
        (DecisionTreeClassifier(device=device), _forest_grid()),
        (XGBoostClassifier(device=device), _xgb_grid()),
    ]


def default_multiclass_models(device="cuda"
                              ) -> List[Tuple[Predictor, List[Dict]]]:
    """The default multiclass pool: LR 8, RF 18, NaiveBayes 1, DT 18."""
    from .bayes import NaiveBayes
    from .trees import DecisionTreeClassifier, RandomForestClassifier
    return [
        _lr(device),
        (RandomForestClassifier(num_trees=_NUM_TREES, device=device),
         _forest_grid()),
        (NaiveBayes(device=device), [{"smoothing": 1.0}]),
        (DecisionTreeClassifier(device=device), _forest_grid()),
    ]


def default_multiclass_extra_models(device="cuda"
                                    ) -> List[Tuple[Predictor, List[Dict]]]:
    """The multiclass opt-in families: the softmax XGBoost (9 points) and
    the MLP (2)."""
    from .mlp import MultilayerPerceptronClassifier
    from .trees import XGBoostClassifier
    return [
        (XGBoostClassifier(num_round=_GBT_ROUNDS, device=device),
         [{"max_depth": d, "min_child_weight": m}
          for d in _DEPTH for m in _MIN_CHILD]),
        (MultilayerPerceptronClassifier(device=device),
         [{"hidden_layers": h} for h in ((10,), (32, 16))]),
    ]


def default_regression_models(device="cuda"
                              ) -> List[Tuple[Predictor, List[Dict]]]:
    """The default regression pool: LinearRegression 8, RF 18, GBT 18,
    GLM 6."""
    from .glm import GeneralizedLinearRegression
    from .linear import LinearRegression
    from .trees import GBTRegressor, RandomForestRegressor
    return [
        (LinearRegression(max_iter=_MAX_ITER_LIN, device=device),
         [{"reg_param": r, "elastic_net_param": e}
          for r in _REG for e in _ELASTIC]),
        (RandomForestRegressor(num_trees=_NUM_TREES, device=device),
         _forest_grid()),
        (GBTRegressor(num_rounds=_GBT_ROUNDS, device=device), _gbt_grid()),
        (GeneralizedLinearRegression(device=device),
         [{"family": f, "reg_param": r}
          for f in ("gaussian", "poisson") for r in (0.001, 0.01, 0.1)]),
    ]


def default_regression_extra_models(device="cuda"
                                    ) -> List[Tuple[Predictor, List[Dict]]]:
    """The regression opt-in families: DT and XGBoost."""
    from .trees import DecisionTreeRegressor, XGBoostRegressor
    return [
        (DecisionTreeRegressor(device=device), _forest_grid()),
        (XGBoostRegressor(device=device), _xgb_grid()),
    ]
