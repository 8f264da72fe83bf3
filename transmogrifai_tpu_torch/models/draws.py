"""Random draws of the tree families, passed in as inputs.

Counterpart of the ``jax.random`` calls of ``transmogrifai_tpu/models/
trees.py``. Threefry cannot be reproduced in torch, so the port takes its
draws from an object with one method per draw, and a test can hand it an
object that replays the JAX package's own key chain. In the JAX package
every candidate of a static group, and every fold, shares
``PRNGKey(seed)``, so each draw depends only on the seed, the tree (or
boosting round) and the draw's own arguments:

- ``pool(t, sizes)``: the per-tree stratified feature pool, one sample
  without replacement per pool class (``_tree_pool``, ``jax.random.
  choice(..., replace=False)``); ``sizes`` is ((population, picks), ...)
  and the result one array of picked positions per class;
- ``poisson(t, rate, n)``: the bootstrap row weights of tree ``t``
  (``jax.random.poisson(wkey, rate, (n,))``);
- ``node_uniform(t, level, shape)``: the uniforms that pick the per-node
  feature subsets of tree ``t`` at ``level`` (the per-level
  ``split(key)`` and ``uniform`` of ``_grow_tree``);
- ``bernoulli(r, rate, n)``: the 0/1 row subsample of boosting round
  ``r`` (``jax.random.bernoulli(rkey, rate, (n,))``).

A provider is made by a factory ``factory(seed, count)``, where ``count``
is the number of trees or rounds (the JAX package splits its key into
that many). Methods return CPU tensors or numpy arrays; the caller moves
them to its device, so a card and the CPU fed by one provider see
identical draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["TorchDraws"]

_MASK64 = (1 << 64) - 1
#: one stream per kind of draw
_POOL, _POISSON, _NODE, _BERNOULLI = 1, 2, 3, 4


def _mix(*words: int) -> int:
    """A 63-bit generator seed from integers (splitmix64 over each)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


def _poisson_cdf(rate: float) -> torch.Tensor:
    """Cumulative Poisson(rate) probabilities of 0, 1, ..., K, with K
    twelve deviations and more above the mean (the tail beyond lies far
    below float64 resolution); the last entry is 1."""
    k = torch.arange(int(rate + 12 * np.sqrt(rate) + 20) + 1,
                     dtype=torch.float64)
    log_pmf = k * np.log(rate) - rate - torch.lgamma(k + 1)
    cdf = torch.cumsum(torch.exp(log_pmf), 0)
    cdf[-1] = 1.0
    return cdf


class TorchDraws:
    """The port's own draws: a CPU ``torch.Generator`` per (seed, kind of
    draw, tree or round[, level]), so every draw is reproducible alone and
    equal whatever device consumes it. Poisson counts come from one
    uniform each through the inverse CDF. ``count`` (trees or rounds) is
    taken for the factory signature; these streams do not need it."""

    def __init__(self, seed: int, count: int = 0):
        self.seed = int(seed)

    def _gen(self, *words: int) -> torch.Generator:
        return torch.Generator().manual_seed(_mix(self.seed, *words))

    def pool(self, t: int, sizes: Sequence[Tuple[int, int]]):
        out = []
        for c, (population, picks) in enumerate(sizes):
            gen = self._gen(_POOL, t, c)
            out.append(torch.randperm(int(population), generator=gen)
                       [:int(picks)])
        return out

    def poisson(self, t: int, rate: float, n: int) -> torch.Tensor:
        if rate <= 0:
            return torch.zeros(int(n), dtype=torch.float64)
        u = torch.rand(int(n), generator=self._gen(_POISSON, t),
                       dtype=torch.float64)
        return torch.searchsorted(_poisson_cdf(float(rate)), u,
                                  right=True).to(torch.float64)

    def node_uniform(self, t: int, level: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(_NODE, t, level),
                          dtype=torch.float64)

    def bernoulli(self, r: int, rate: float, n: int) -> torch.Tensor:
        u = torch.rand(int(n), generator=self._gen(_BERNOULLI, r),
                       dtype=torch.float64)
        return (u < float(rate)).to(torch.float64)
