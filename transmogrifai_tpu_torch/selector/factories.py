"""Problem-typed selector factories with the default model grids.

Counterpart of ``transmogrifai_tpu/selector/factories.py``: one factory
per problem type (``BinaryClassificationModelSelector``,
``MultiClassificationModelSelector``, ``RegressionModelSelector``) on the
shared ``_SelectorFactory`` base, each with its default evaluator (AuPR,
F1, RMSE), its default splitter (``DataBalancer``, ``DataCutter``,
``DataSplitter``) and its default and opt-in pools
(``models/registry.py``); ``with_cross_validation`` (exact or racing) and
``with_train_validation_split``. ``model_types_to_use`` picks among the
default and opt-in families of the problem type, as in the JAX package:
a name outside them (the MLP in a binary selector) is dropped, and a
filter that leaves no family raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type

from ..evaluators import (BinaryClassificationEvaluator, Evaluator,
                          MultiClassificationEvaluator, RegressionEvaluator)
from ..models import registry
from ..models.base import Predictor
from ..utils.device import resolve_device
from .selector import ModelSelector
from .splitters import DataBalancer, DataCutter, DataSplitter, Splitter
from .validator import CrossValidation, TrainValidationSplit

__all__ = ["BinaryClassificationModelSelector",
           "MultiClassificationModelSelector", "RegressionModelSelector"]


def _names(model_types_to_use) -> set:
    return {t.__name__ if isinstance(t, type) else str(t)
            for t in model_types_to_use}


def _filter_models(models, opt_in_models, model_types_to_use):
    """No filter: ``models``; with ``model_types_to_use``, the families of
    ``models`` + ``opt_in_models`` it names, in pool order."""
    if model_types_to_use is None:
        return list(models)
    allowed = _names(model_types_to_use)
    pool = list(models) + list(opt_in_models)
    kept = [(est, grid) for est, grid in pool
            if type(est).__name__ in allowed]
    if not kept:
        raise ValueError(f"No candidate models left after filtering to "
                         f"{sorted(allowed)}")
    return kept


class _SelectorFactory:
    problem_type = ""
    default_evaluator: Type[Evaluator] = Evaluator
    default_splitter: Type[Splitter] = Splitter

    @classmethod
    def _default_models(cls, device) -> List[Tuple[Predictor, List[Dict]]]:
        raise NotImplementedError

    @classmethod
    def _opt_in_models(cls, device) -> List[Tuple[Predictor, List[Dict]]]:
        return []

    @classmethod
    def _pool(cls, models, model_types_to_use, device):
        if models is not None:
            return _filter_models(list(models), [], model_types_to_use)
        opt_in = (cls._opt_in_models(device)
                  if model_types_to_use is not None else [])
        return _filter_models(cls._default_models(device), opt_in,
                              model_types_to_use)

    @classmethod
    def with_cross_validation(cls, num_folds: int = 3, seed: int = 42,
                              evaluator: Optional[Evaluator] = None,
                              splitter: Optional[Splitter] = None,
                              models: Optional[Sequence] = None,
                              model_types_to_use: Optional[Sequence] = None,
                              stratify: bool = False,
                              validation: str = "exact",
                              eta: Optional[int] = None,
                              min_fidelity: Optional[float] = None,
                              device="cuda") -> ModelSelector:
        """Selector over ``models`` (or the default pool, or the default
        and opt-in families ``model_types_to_use`` names) under
        ``num_folds``-fold CV, ranking by the evaluator's metric (the
        problem type's default when None), on ``device``.
        ``validation="racing"`` races the pool under successive halving
        (``selector/racing.py``): each rung keeps the top ``1/eta``, the
        first rung spends ``min_fidelity`` of full CV (default
        ``1/eta**2``), and the final rung is exact full CV for the
        survivors."""
        dev = resolve_device(device)
        return ModelSelector(
            models=cls._pool(models, model_types_to_use, dev),
            validator=CrossValidation(
                evaluator or cls.default_evaluator(),
                num_folds=num_folds, seed=seed, stratify=stratify),
            splitter=(splitter if splitter is not None
                      else cls.default_splitter(seed=seed)),
            problem_type=cls.problem_type, device=dev,
            validation=validation, eta=eta, min_fidelity=min_fidelity)

    @classmethod
    def with_train_validation_split(
            cls, train_ratio: float = 0.75, seed: int = 42,
            evaluator: Optional[Evaluator] = None,
            splitter: Optional[Splitter] = None,
            models: Optional[Sequence] = None,
            model_types_to_use: Optional[Sequence] = None,
            stratify: bool = False, device="cuda") -> ModelSelector:
        """Selector validating every candidate on one seeded
        ``train_ratio`` split (reference OpTrainValidationSplit), on
        ``device``."""
        dev = resolve_device(device)
        return ModelSelector(
            models=cls._pool(models, model_types_to_use, dev),
            validator=TrainValidationSplit(
                evaluator or cls.default_evaluator(),
                train_ratio=train_ratio, seed=seed, stratify=stratify),
            splitter=(splitter if splitter is not None
                      else cls.default_splitter(seed=seed)),
            problem_type=cls.problem_type, device=dev)


class BinaryClassificationModelSelector(_SelectorFactory):
    problem_type = "BinaryClassification"
    default_evaluator = BinaryClassificationEvaluator
    default_splitter = DataBalancer

    @classmethod
    def _default_models(cls, device):
        return registry.default_binary_models(device)

    @classmethod
    def _opt_in_models(cls, device):
        return registry.default_binary_extra_models(device)


class MultiClassificationModelSelector(_SelectorFactory):
    problem_type = "MultiClassification"
    default_evaluator = MultiClassificationEvaluator
    default_splitter = DataCutter

    @classmethod
    def _default_models(cls, device):
        return registry.default_multiclass_models(device)

    @classmethod
    def _opt_in_models(cls, device):
        return registry.default_multiclass_extra_models(device)


class RegressionModelSelector(_SelectorFactory):
    problem_type = "Regression"
    default_evaluator = RegressionEvaluator
    default_splitter = DataSplitter

    @classmethod
    def _default_models(cls, device):
        return registry.default_regression_models(device)

    @classmethod
    def _opt_in_models(cls, device):
        return registry.default_regression_extra_models(device)
