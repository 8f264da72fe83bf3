"""Carry fitted models across from the JAX package.

The JAX package's fitted ``GBTClassifierModel`` holds numpy arrays
(``feats``, ``thrs``, ``leaves``, ``depth``, ``base``, ``n_features``), and
its ``TreeEnsembleClassifierModel`` (random forests, decision trees) the
same without ``base``; its binary ``LogisticRegressionModel`` and
``LinearSVCModel`` hold ``coefficients`` (d,) and ``intercept``. The
multiclass and regression families add the multinomial
``LogisticRegressionModel`` ((K, d) coefficients, (K,) intercepts),
``NaiveBayesModel`` (``pi`` (K,), ``theta`` (K, d)),
``LinearRegressionModel`` and ``GeneralizedLinearRegressionModel``
(coefficients, intercept, link), the regressor forests
(``TreeEnsembleRegressorModel``: leaves (T, 2^depth)), ``GBTRegressorModel``
and the softmax booster's ``GBTMulticlassClassifierModel`` (feats, thrs
(R, K, H), leaves (R, K, L), base (K,)). The port's models built from them
predict the same probabilities, labels and values. The fitted text stages
carry across too: ``Word2VecModel`` (vocabulary, vectors), ``LDAModel``
(vocabulary, topic_word, alpha), ``CountVectorizerModel`` (vocabularies,
binary), ``TfIdfVectorizerModel`` (vocabularies, idf) and
``StringIndexerModel`` (labels, handle_invalid), as numpy arrays and
lists with the JAX stage's uid; the caller wires their inputs.
:func:`from_jax_model` takes any of them by its class name.
"""
from __future__ import annotations

import numpy as np

from .bayes import NaiveBayesModel
from .glm import GeneralizedLinearRegressionModel
from .linear import (LinearRegressionModel, LinearSVCModel,
                     LogisticRegressionModel)
from .trees import (GBTClassifierModel, GBTMulticlassClassifierModel,
                    GBTRegressorModel, TreeEnsembleClassifierModel,
                    TreeEnsembleRegressorModel)

__all__ = ["forest_from_numpy", "from_jax_model", "gbt_from_numpy",
           "logistic_from_numpy", "svc_from_numpy"]


def gbt_from_numpy(feats: np.ndarray, thrs: np.ndarray, leaves: np.ndarray,
                   depth: int, base: float, n_features: int,
                   device="cuda") -> GBTClassifierModel:
    """Port-side ``GBTClassifierModel`` from the reference model's arrays:
    ``feats`` (R, 2^depth - 1) split features, ``thrs`` the same shape
    split thresholds, ``leaves`` (R, 2^depth) leaf margins."""
    return GBTClassifierModel(np.asarray(feats, dtype=np.int32),
                              np.asarray(thrs, dtype=np.float64),
                              np.asarray(leaves, dtype=np.float64),
                              depth=int(depth), base=float(base),
                              n_features=int(n_features), device=device)


def forest_from_numpy(feats: np.ndarray, thrs: np.ndarray,
                      leaves: np.ndarray, depth: int, n_features: int,
                      device="cuda") -> TreeEnsembleClassifierModel:
    """Port-side ``TreeEnsembleClassifierModel`` from the reference
    model's arrays: ``feats`` and ``thrs`` (T, 2^depth - 1), ``leaves``
    (T, 2^depth, K) leaf class distributions."""
    return TreeEnsembleClassifierModel(np.asarray(feats, dtype=np.int32),
                                       np.asarray(thrs, dtype=np.float64),
                                       np.asarray(leaves, dtype=np.float64),
                                       depth=int(depth),
                                       n_features=int(n_features),
                                       device=device)


def logistic_from_numpy(coefficients: np.ndarray, intercept,
                        device="cuda") -> LogisticRegressionModel:
    """Port-side ``LogisticRegressionModel`` from the reference model's
    ``coefficients`` (d,) and ``intercept`` (binary) or (K, d) and (K,)
    (multinomial)."""
    return LogisticRegressionModel(coefficients, intercept, device=device)


def svc_from_numpy(coefficients: np.ndarray, intercept,
                   device="cuda") -> LinearSVCModel:
    """Port-side ``LinearSVCModel`` from the reference model's
    ``coefficients`` (d,) and ``intercept``."""
    return LinearSVCModel(coefficients, intercept, device=device)


#: the port's model class of each JAX package model class, and the numpy
#: attributes its constructor takes
_MODELS = {
    "LogisticRegressionModel": (LogisticRegressionModel,
                                ("coefficients", "intercept")),
    "LinearSVCModel": (LinearSVCModel, ("coefficients", "intercept")),
    "LinearRegressionModel": (LinearRegressionModel,
                              ("coefficients", "intercept")),
    "GeneralizedLinearRegressionModel": (
        GeneralizedLinearRegressionModel, ("coefficients", "intercept",
                                           "link")),
    "NaiveBayesModel": (NaiveBayesModel, ("pi", "theta", "model_type")),
    "TreeEnsembleClassifierModel": (
        TreeEnsembleClassifierModel,
        ("feats", "thrs", "leaves", "depth", "n_features")),
    "TreeEnsembleRegressorModel": (
        TreeEnsembleRegressorModel,
        ("feats", "thrs", "leaves", "depth", "n_features")),
    "GBTClassifierModel": (
        GBTClassifierModel,
        ("feats", "thrs", "leaves", "depth", "base", "n_features")),
    "GBTRegressorModel": (
        GBTRegressorModel,
        ("feats", "thrs", "leaves", "depth", "base", "n_features")),
    "GBTMulticlassClassifierModel": (
        GBTMulticlassClassifierModel,
        ("feats", "thrs", "leaves", "depth", "base", "n_features")),
}


def _text_stages():
    """class name -> (port class, attributes, whether it takes a device)
    of the fitted text stages."""
    from ..ops.index import StringIndexerModel
    from ..ops.text_advanced import (CountVectorizerModel, LDAModel,
                                     TfIdfVectorizerModel, Word2VecModel)
    return {
        "Word2VecModel": (Word2VecModel, ("vocabulary", "vectors"), False),
        "LDAModel": (LDAModel, ("vocabulary", "topic_word", "alpha"), True),
        "CountVectorizerModel": (CountVectorizerModel,
                                 ("vocabulary", "binary"), False),
        "TfIdfVectorizerModel": (TfIdfVectorizerModel,
                                 ("vocabulary", "idf"), False),
        "StringIndexerModel": (StringIndexerModel,
                               ("labels", "handle_invalid"), False),
    }


def from_jax_model(model, device="cuda"):
    """The port's counterpart of a fitted JAX package model or text stage,
    by its class name, built from its numpy attributes (copies) on
    ``device``."""
    name = type(model).__name__
    stages = _text_stages()
    if name in stages:
        cls, attrs, takes_device = stages[name]
        kwargs = {a: (np.array(getattr(model, a))
                      if isinstance(getattr(model, a), np.ndarray)
                      else getattr(model, a)) for a in attrs}
        if takes_device:
            kwargs["device"] = device
        return cls(**kwargs, uid=model.uid)
    if name not in _MODELS:
        raise ValueError(f"no port counterpart for {name}")
    cls, attrs = _MODELS[name]
    kwargs = {}
    for a in attrs:
        v = getattr(model, a)
        kwargs[a] = np.array(v) if isinstance(v, np.ndarray) else v
    return cls(**kwargs, device=device)
