"""Problem-typed selector factory with the default model grids.

Counterpart of ``transmogrifai_tpu/selector/factories.py``
(``BinaryClassificationModelSelector.with_cross_validation``, exact or
racing, and ``with_train_validation_split``). Only the binary problem type
is ported, with its whole default pool
(LogisticRegression, RandomForestClassifier, GBTClassifier, LinearSVC);
asking for a family outside it (NaiveBayes, DecisionTreeClassifier,
XGBoostClassifier, ...) raises an error that names the family instead of
dropping it silently.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..evaluators import BinaryClassificationEvaluator, Evaluator
from ..models import registry
from ..models.base import Predictor
from ..utils.device import resolve_device
from .selector import ModelSelector
from .splitters import DataBalancer, Splitter
from .validator import CrossValidation, TrainValidationSplit

__all__ = ["BinaryClassificationModelSelector"]


def _filter_models(models, model_types_to_use):
    """``models`` narrowed to ``model_types_to_use`` (all of them for
    None)."""
    if model_types_to_use is None:
        return list(models)
    allowed = {t.__name__ if isinstance(t, type) else str(t)
               for t in model_types_to_use}
    kept = [(est, grid) for est, grid in models
            if type(est).__name__ in allowed]
    if not kept:
        raise ValueError(f"No candidate models left after filtering to "
                         f"{sorted(allowed)}")
    return kept


def _binary_pool(model_types_to_use, device
                 ) -> List[Tuple[Predictor, List[Dict]]]:
    """The default binary pool narrowed to ``model_types_to_use``; raises
    if that asks for a family outside the pool, which the port does not
    have yet."""
    pool = registry.default_binary_models(device)
    if model_types_to_use is not None:
        names = {t.__name__ if isinstance(t, type) else str(t)
                 for t in model_types_to_use}
        missing = sorted(names - {type(est).__name__ for est, _ in pool})
        if missing:
            raise NotImplementedError(
                f"model families not ported to PyTorch yet: {missing}; "
                f"the port has the default pool's LogisticRegression, "
                f"RandomForestClassifier, GBTClassifier and LinearSVC")
    return _filter_models(pool, model_types_to_use)


class BinaryClassificationModelSelector:
    problem_type = "BinaryClassification"

    @classmethod
    def _pool(cls, models, model_types_to_use, device):
        return (_filter_models(list(models), model_types_to_use)
                if models is not None
                else _binary_pool(model_types_to_use, device))

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
        """Selector over ``models`` (or the default pool narrowed to
        ``model_types_to_use``) under ``num_folds``-fold CV, ranking by
        the evaluator's metric (AuPR by default), on ``device``.
        ``validation="racing"`` races the pool under successive halving
        (``selector/racing.py``): each rung keeps the top ``1/eta``, the
        first rung spends ``min_fidelity`` of full CV (default
        ``1/eta**2``), and the final rung is exact full CV for the
        survivors."""
        dev = resolve_device(device)
        return ModelSelector(
            models=cls._pool(models, model_types_to_use, dev),
            validator=CrossValidation(
                evaluator or BinaryClassificationEvaluator(),
                num_folds=num_folds, seed=seed, stratify=stratify),
            splitter=(splitter if splitter is not None
                      else DataBalancer(seed=seed)),
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
                evaluator or BinaryClassificationEvaluator(),
                train_ratio=train_ratio, seed=seed, stratify=stratify),
            splitter=(splitter if splitter is not None
                      else DataBalancer(seed=seed)),
            problem_type=cls.problem_type, device=dev)
