"""Seeded random typed-data generators.

The port's copy of ``transmogrifai_tpu/testkit/random_data.py``, the
reference testkit
(testkit/src/main/scala/com/salesforce/op/testkit/{RandomData.scala:51,
RandomReal.scala:45, RandomText.scala:49, RandomIntegral.scala,
RandomBinary.scala, RandomList.scala, RandomMap.scala, RandomSet.scala,
RandomVector.scala, ProbabilityOfEmpty.scala}): every FeatureType gets a
deterministic generator stream with optional probability-of-empty. Both
packages draw from numpy generators in the same order, so the same seeds
give the same records value for value; ``chip_smoke.py`` takes the JAX
tests' data from here.
"""
from __future__ import annotations

import string
from typing import Dict, List, Optional, Sequence, Type

import numpy as np

from ..features.columns import FeatureColumn
from ..types import (Binary, City, ComboBox, Country, Currency, Date,
                     DateTime, Email, FeatureType, Geolocation, ID, Integral,
                     MultiPickList, OPVector, Percent, PickList, PostalCode,
                     Real, RealNN, State, Street, Text, TextArea, TextList,
                     URL)

__all__ = ["RandomReal", "RandomIntegral", "RandomBinary", "RandomText",
           "RandomList", "RandomSet", "RandomMap", "RandomVector",
           "RandomData"]


class _RandomBase:
    """Seeded infinite stream of boxed feature values."""

    ftype: Type[FeatureType] = Real

    def __init__(self, seed: int = 42, probability_of_empty: float = 0.0):
        self.seed = seed
        self.probability_of_empty = probability_of_empty
        self.reset(seed)

    def reset(self, seed: Optional[int] = None) -> "_RandomBase":
        """(reference RandomData.reset)"""
        self._rng = np.random.default_rng(
            self.seed if seed is None else seed)
        return self

    def with_probability_of_empty(self, p: float) -> "_RandomBase":
        """(reference ProbabilityOfEmpty.withProbabilityOfEmpty)"""
        self.probability_of_empty = p
        return self

    def _value(self):
        raise NotImplementedError

    def take(self, n: int) -> List[FeatureType]:
        out = []
        for _ in range(n):
            if (self.probability_of_empty > 0
                    and self._rng.uniform() < self.probability_of_empty):
                out.append(self.ftype.empty())
            else:
                out.append(self.ftype(self._value()))
        return out

    def column(self, n: int) -> FeatureColumn:
        return FeatureColumn.from_values(self.ftype, self.take(n))


class RandomReal(_RandomBase):
    """(reference RandomReal.scala:45,75 — uniform/normal/poisson/
    exponential/gamma/logNormal/weibull distributions)"""

    def __init__(self, distribution: str = "uniform", a: float = 0.0,
                 b: float = 1.0, ftype: Type[FeatureType] = Real,
                 seed: int = 42, probability_of_empty: float = 0.0):
        self.distribution = distribution
        self.a, self.b = a, b
        self.ftype = ftype
        super().__init__(seed, probability_of_empty)

    @classmethod
    def uniform(cls, low: float = 0.0, high: float = 1.0,
                ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("uniform", low, high, ftype, seed)

    @classmethod
    def normal(cls, mean: float = 0.0, sigma: float = 1.0,
               ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("normal", mean, sigma, ftype, seed)

    @classmethod
    def poisson(cls, mean: float = 1.0, ftype: Type[FeatureType] = Real,
                seed: int = 42):
        return cls("poisson", mean, 0.0, ftype, seed)

    @classmethod
    def exponential(cls, scale: float = 1.0,
                    ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("exponential", scale, 0.0, ftype, seed)

    @classmethod
    def gamma(cls, shape: float = 2.0, scale: float = 1.0,
              ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("gamma", shape, scale, ftype, seed)

    @classmethod
    def lognormal(cls, mean: float = 0.0, sigma: float = 1.0,
                  ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("lognormal", mean, sigma, ftype, seed)

    @classmethod
    def weibull(cls, shape: float = 1.5, scale: float = 1.0,
                ftype: Type[FeatureType] = Real, seed: int = 42):
        return cls("weibull", shape, scale, ftype, seed)

    def _value(self) -> float:
        r, a, b = self._rng, self.a, self.b
        if self.distribution == "uniform":
            return float(r.uniform(a, b))
        if self.distribution == "normal":
            return float(r.normal(a, b))
        if self.distribution == "poisson":
            return float(r.poisson(a))
        if self.distribution == "exponential":
            return float(r.exponential(a))
        if self.distribution == "gamma":
            return float(r.gamma(a, b))
        if self.distribution == "lognormal":
            return float(r.lognormal(a, b))
        if self.distribution == "weibull":
            return float(b * r.weibull(a))
        raise ValueError(f"Unknown distribution {self.distribution!r}")


class RandomIntegral(_RandomBase):
    """(reference RandomIntegral.scala)"""

    ftype = Integral

    def __init__(self, low: int = 0, high: int = 100,
                 ftype: Type[FeatureType] = Integral, seed: int = 42,
                 probability_of_empty: float = 0.0):
        self.low, self.high = low, high
        self.ftype = ftype
        super().__init__(seed, probability_of_empty)

    @classmethod
    def integers(cls, low: int = 0, high: int = 100, seed: int = 42):
        return cls(low, high, Integral, seed)

    @classmethod
    def dates(cls, start_ms: int = 1_500_000_000_000,
              step_ms: int = 86_400_000, seed: int = 42):
        return cls(start_ms, start_ms + 1000 * step_ms, Date, seed)

    @classmethod
    def datetimes(cls, start_ms: int = 1_500_000_000_000,
                  step_ms: int = 3_600_000, seed: int = 42):
        return cls(start_ms, start_ms + 1000 * step_ms, DateTime, seed)

    def _value(self) -> int:
        return int(self._rng.integers(self.low, self.high))


class RandomBinary(_RandomBase):
    """(reference RandomBinary.scala)"""

    ftype = Binary

    def __init__(self, probability_of_true: float = 0.5, seed: int = 42,
                 probability_of_empty: float = 0.0):
        self.probability_of_true = probability_of_true
        super().__init__(seed, probability_of_empty)

    def _value(self) -> bool:
        return bool(self._rng.uniform() < self.probability_of_true)


_COUNTRIES = ["USA", "Canada", "Mexico", "France", "Germany", "Japan",
              "Brazil", "India", "Kenya", "Australia"]
_STATES = ["CA", "NY", "TX", "WA", "OR", "IL", "GA", "MA", "CO", "FL"]
_CITIES = ["San Francisco", "New York", "Austin", "Seattle", "Portland",
           "Chicago", "Atlanta", "Boston", "Denver", "Miami"]
_DOMAINS = ["example.com", "mail.org", "corp.net", "web.io"]


class RandomText(_RandomBase):
    """(reference RandomText.scala:49 — strings/emails/urls/phones/
    countries/states/cities/postal codes/ids/picklists)"""

    ftype = Text

    def __init__(self, kind: str = "strings",
                 domain: Optional[Sequence[str]] = None, min_len: int = 3,
                 max_len: int = 10, ftype: Type[FeatureType] = Text,
                 seed: int = 42, probability_of_empty: float = 0.0):
        self.kind = kind
        self.domain = list(domain) if domain is not None else None
        self.min_len, self.max_len = min_len, max_len
        self.ftype = ftype
        super().__init__(seed, probability_of_empty)

    @classmethod
    def strings(cls, min_len: int = 3, max_len: int = 10, seed: int = 42):
        return cls("strings", None, min_len, max_len, Text, seed)

    @classmethod
    def textareas(cls, min_len: int = 20, max_len: int = 60, seed: int = 42):
        return cls("strings", None, min_len, max_len, TextArea, seed)

    @classmethod
    def emails(cls, domain: Optional[str] = None, seed: int = 42):
        return cls("emails", [domain] if domain else _DOMAINS, 3, 10,
                   Email, seed)

    @classmethod
    def urls(cls, seed: int = 42):
        return cls("urls", _DOMAINS, 3, 10, URL, seed)

    @classmethod
    def phones(cls, seed: int = 42):
        return cls("phones", None, 10, 10, Text, seed)

    @classmethod
    def ids(cls, seed: int = 42):
        return cls("ids", None, 8, 12, ID, seed)

    @classmethod
    def countries(cls, seed: int = 42):
        return cls("pick", _COUNTRIES, 0, 0, Country, seed)

    @classmethod
    def states(cls, seed: int = 42):
        return cls("pick", _STATES, 0, 0, State, seed)

    @classmethod
    def cities(cls, seed: int = 42):
        return cls("pick", _CITIES, 0, 0, City, seed)

    @classmethod
    def streets(cls, seed: int = 42):
        return cls("streets", None, 0, 0, Street, seed)

    @classmethod
    def postal_codes(cls, seed: int = 42):
        return cls("postal", None, 5, 5, PostalCode, seed)

    @classmethod
    def picklists(cls, domain: Sequence[str], seed: int = 42):
        return cls("pick", domain, 0, 0, PickList, seed)

    @classmethod
    def comboboxes(cls, domain: Sequence[str], seed: int = 42):
        return cls("pick", domain, 0, 0, ComboBox, seed)

    def _rand_word(self) -> str:
        n = int(self._rng.integers(self.min_len, self.max_len + 1))
        letters = self._rng.choice(list(string.ascii_lowercase), n)
        return "".join(letters)

    def _value(self) -> str:
        r = self._rng
        if self.kind == "strings":
            return self._rand_word()
        if self.kind == "pick":
            return str(r.choice(self.domain))
        if self.kind == "emails":
            return f"{self._rand_word()}@{r.choice(self.domain)}"
        if self.kind == "urls":
            return f"https://{self._rand_word()}.{r.choice(self.domain)}"
        if self.kind == "phones":
            return "".join(str(d) for d in r.integers(0, 10, 10))
        if self.kind == "ids":
            return "".join(
                str(c) for c in r.choice(list(string.hexdigits[:16]), 10))
        if self.kind == "postal":
            return "".join(str(d) for d in r.integers(0, 10, 5))
        if self.kind == "streets":
            return f"{int(r.integers(1, 9999))} {self._rand_word()} St"
        raise ValueError(f"Unknown text kind {self.kind!r}")


class RandomList(_RandomBase):
    """(reference RandomList.scala)"""

    ftype = TextList

    def __init__(self, element_gen: _RandomBase, min_size: int = 0,
                 max_size: int = 5, ftype: Type[FeatureType] = TextList,
                 seed: int = 42, probability_of_empty: float = 0.0):
        self.element_gen = element_gen
        self.min_size, self.max_size = min_size, max_size
        self.ftype = ftype
        super().__init__(seed, probability_of_empty)

    def _value(self):
        n = int(self._rng.integers(self.min_size, self.max_size + 1))
        return [v.value for v in self.element_gen.take(n)]


class RandomSet(_RandomBase):
    """(reference RandomSet.scala — MultiPickList)"""

    ftype = MultiPickList

    def __init__(self, domain: Sequence[str], min_size: int = 0,
                 max_size: int = 3, seed: int = 42,
                 probability_of_empty: float = 0.0):
        self.domain = list(domain)
        self.min_size, self.max_size = min_size, max_size
        super().__init__(seed, probability_of_empty)

    def _value(self):
        n = int(self._rng.integers(self.min_size,
                                   min(self.max_size, len(self.domain)) + 1))
        return set(self._rng.choice(self.domain, n, replace=False).tolist())


class RandomMap(_RandomBase):
    """(reference RandomMap.scala) — values from an element generator under
    keys ``key_prefix{0..}``."""

    def __init__(self, element_gen: _RandomBase, ftype: Type[FeatureType],
                 key_prefix: str = "k", min_size: int = 1, max_size: int = 4,
                 seed: int = 42, probability_of_empty: float = 0.0):
        self.element_gen = element_gen
        self.ftype = ftype
        self.key_prefix = key_prefix
        self.min_size, self.max_size = min_size, max_size
        super().__init__(seed, probability_of_empty)

    def _value(self):
        n = int(self._rng.integers(self.min_size, self.max_size + 1))
        vals = self.element_gen.take(n)
        return {f"{self.key_prefix}{i}": v.value
                for i, v in enumerate(vals) if v.value is not None}


class RandomVector(_RandomBase):
    """(reference RandomVector.scala)"""

    ftype = OPVector

    def __init__(self, size: int, distribution: str = "normal",
                 seed: int = 42, probability_of_empty: float = 0.0):
        self.size = size
        self.distribution = distribution
        super().__init__(seed, probability_of_empty)

    def _value(self):
        if self.distribution == "normal":
            return self._rng.normal(size=self.size)
        return self._rng.uniform(size=self.size)


class RandomData:
    """Convenience: build a dict of named columns from generators
    (reference RandomData.scala:51)."""

    def __init__(self, seed: int = 42):
        self.seed = seed
        self._gens: Dict[str, _RandomBase] = {}

    def with_column(self, name: str, gen: _RandomBase) -> "RandomData":
        self._gens[name] = gen
        return self

    def columns(self, n: int) -> Dict[str, FeatureColumn]:
        return {name: gen.column(n) for name, gen in self._gens.items()}

    def records(self, n: int) -> List[Dict]:
        cols = {name: gen.take(n) for name, gen in self._gens.items()}
        return [{name: vals[i].value for name, vals in cols.items()}
                for i in range(n)]
