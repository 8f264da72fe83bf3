"""RandomParamBuilder: random-search hyperparameter grids.

The port's copy of ``transmogrifai_tpu/selector/random_params.py``
(reference core/src/main/scala/com/salesforce/op/stages/impl/selector/
RandomParamBuilder.scala): declare a sampling distribution per parameter
(uniform float or int, log-uniform "exponential", or a choice from a set)
and draw N independent param dicts to feed a ModelSelector's grid. The
draws come from numpy's ``default_rng(seed)`` in the JAX package's order,
so one seed gives both packages the same grids.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["RandomParamBuilder"]


class RandomParamBuilder:
    """(reference RandomParamBuilder.scala:51)"""

    def __init__(self, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._params: List[Tuple[str, str, Any]] = []

    def uniform(self, name: str, low: float, high: float,
                integer: bool = False) -> "RandomParamBuilder":
        """Uniformly distributed values in [low, high]
        (reference uniform for Double/Float/Int/Long params)."""
        if not low < high:
            raise ValueError("low must be less than high")
        self._params.append((name, "uniform", (low, high, integer)))
        return self

    def exponential(self, name: str, low: float, high: float
                    ) -> "RandomParamBuilder":
        """Log-uniformly distributed values in [low, high], the prior for
        regularization strengths (reference exponential)."""
        if not 0 < low < high:
            raise ValueError("exponential requires 0 < low < high")
        self._params.append((name, "exponential", (low, high)))
        return self

    def subset(self, name: str, choices: Sequence[Any]
               ) -> "RandomParamBuilder":
        """Uniform choice from a finite set (reference subset)."""
        if not choices:
            raise ValueError("subset requires at least one choice")
        self._params.append((name, "subset", list(choices)))
        return self

    def build(self, n: int) -> List[Dict[str, Any]]:
        """Draw ``n`` independent param dicts
        (reference build(numberOfParams))."""
        if not self._params:
            raise ValueError("no parameters registered")
        out: List[Dict[str, Any]] = []
        for _ in range(n):
            d: Dict[str, Any] = {}
            for name, kind, spec in self._params:
                if kind == "uniform":
                    low, high, integer = spec
                    if integer:
                        d[name] = int(self._rng.integers(int(low),
                                                         int(high) + 1))
                    else:
                        d[name] = float(self._rng.uniform(low, high))
                elif kind == "exponential":
                    low, high = spec
                    d[name] = float(np.exp(self._rng.uniform(
                        np.log(low), np.log(high))))
                else:
                    d[name] = spec[int(self._rng.integers(len(spec)))]
            out.append(d)
        return out
