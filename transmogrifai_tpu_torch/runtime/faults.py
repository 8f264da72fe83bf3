"""Deterministic fault injection: the test harness of the runtime.

The port's copy of ``transmogrifai_tpu/runtime/faults.py``. Named
**injection sites** sit along the training and serving paths (family
dispatch, host fits, rung boundaries, the model save, plan compile and
dispatch, the lifecycle's retrain, canary and post-swap watch) and fire
*planned* faults at exact occurrence counts, so every recovery path
(retry, quarantine, journal resume, atomic save, rollback) can be driven
in a test on the CPU and reproduced on the card.

A plan is a comma-separated list of rules::

    TX_FAULT_PLAN="family:GBTClassifier:dispatch:2=oom"

with the grammar ``scope:name:site:n=fault``:

- ``scope``: ``family`` (name = model family class), ``rung`` (name =
  rung index), ``workflow`` (the save path), ``prepare`` (the training
  prepare plan; name = stage class, or ``device`` for a device
  transform), ``plan`` (the serving ScoringPlan; name = stage class, or
  ``device`` for the bucket dispatch), ``serving`` (the guardrails),
  ``lifecycle`` (the self-healing loop; name = the registered model);
  the JAX package's ``state``, ``admission`` and ``fleet`` scopes parse
  alike, and their sites wait for the port of those modules.
- ``name``: exact match or ``*``.
- ``site``: ``dispatch`` (a family's device search, once per retry
  attempt, or a plan's device dispatch), ``fit`` (a host-path candidate
  fit), ``metric`` (after a family's metric matrix lands), ``boundary``
  (between racing rungs), ``save``, ``compile``, ``guard``
  (``serving:output:guard``: a ``nan`` fault poisons one scored row),
  and the lifecycle's ``retrain``, ``canary`` and ``postswap``.
- ``n``: fire at the Nth matching probe (1-based), or ``*`` for every
  one.
- ``fault``: ``oom`` (a ``torch.cuda.OutOfMemoryError``, what the card's
  caching allocator raises: transient, then quarantined when it
  persists), ``preempt`` (an UNAVAILABLE preemption: transient),
  ``bug`` (a non-transient :class:`InjectedFamilyBug`), ``kill``
  (:class:`KillPoint`: simulated process death, a BaseException the
  quarantine layer does not absorb), ``nan`` (the caller poisons its
  metrics or a scored row), ``hang:<seconds>`` (sleep: the deadline
  drills), and, parsed for the modules that fire them later, ``torn``
  and ``burst[:<rows>]`` (returned to the caller, like ``nan``).

Activate with the context manager (tests) or ``TX_FAULT_PLAN`` (the
smoke, or reproducing a field failure)::

    with FaultInjector.plan("family:LinearSVC:dispatch:*=oom"):
        selector.fit_arrays(X, y)

A probe costs one global ``None`` check when no plan is active, so the
production paths keep their probes.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

_log = logging.getLogger(__name__)

__all__ = ["FaultInjector", "maybe_inject", "injector_active",
           "KillPoint", "InjectedFault", "InjectedOom",
           "InjectedPreemption", "InjectedFamilyBug"]


class InjectedFault(Exception):
    """Base of the injector's exceptions. Their types and messages are
    shaped so the classifier (``runtime/errors.py``) sorts them exactly
    like the real errors they stand for."""


class InjectedOom(InjectedFault, torch.cuda.OutOfMemoryError):
    """A ``torch.cuda.OutOfMemoryError``, as the caching allocator raises
    it: ``except torch.cuda.OutOfMemoryError`` catches it, and the
    classifier calls it transient."""

    def __init__(self, site: str = ""):
        super().__init__(
            f"CUDA out of memory. Tried to allocate a device buffer "
            f"(injected at {site})")


class InjectedPreemption(InjectedFault):
    def __init__(self, site: str = ""):
        super().__init__(
            f"UNAVAILABLE: device worker preempted, replica restarting "
            f"(injected at {site})")


class InjectedFamilyBug(InjectedFault):
    def __init__(self, site: str = ""):
        super().__init__(f"injected family fault at {site} "
                         f"(non-transient)")


class KillPoint(BaseException):
    """Simulated process death (a preempted VM mid-search, the OOM
    killer, ctrl-C). A ``BaseException`` on purpose: the quarantine
    layer's ``except Exception`` must not absorb it, so the run dies as a
    real kill would and only the journal survives."""

    def __init__(self, site: str = ""):
        super().__init__(f"injected kill point at {site}")


@dataclass(frozen=True)
class _Rule:
    scope: str
    name: str        # exact or "*"
    site: str
    nth: Optional[int]   # None = every occurrence
    fault: str   # "oom"|"preempt"|"bug"|"kill"|"nan"|"torn"
    #             |"hang:<s>"|"burst[:<rows>]"


def _parse_plan(text: str) -> List[_Rule]:
    rules: List[_Rule] = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        try:
            spec, fault = part.split("=", 1)
            scope, name, site, n = spec.split(":")
        except ValueError:
            raise ValueError(
                f"bad fault rule {part!r}: expected "
                f"'scope:name:site:n=fault' "
                f"(e.g. 'family:GBTClassifier:dispatch:2=oom')")
        nth = None if n == "*" else int(n)
        if nth is not None and nth < 1:
            raise ValueError(f"bad fault rule {part!r}: n is 1-based")
        rules.append(_Rule(scope, name, site, nth, fault))
    return rules


class FaultInjector:
    """A parsed plan with per-(scope, name, site) occurrence counters.
    Install with the :meth:`plan` context manager, or let
    :func:`maybe_inject` pick ``TX_FAULT_PLAN`` up from the
    environment."""

    def __init__(self, plan_text: str):
        self.plan_text = plan_text
        self.rules = _parse_plan(plan_text)
        self._counts: Dict[Tuple[str, str, str], int] = {}
        self._lock = threading.Lock()
        #: fired (rule, occurrence) log, for assertions in tests
        self.fired: List[Tuple[_Rule, int]] = []

    # -- installation ------------------------------------------------------
    @classmethod
    def plan(cls, plan_text: str) -> "FaultInjector":
        return cls(plan_text)

    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None

    # -- the probe ---------------------------------------------------------
    def check(self, scope: str, name: str, site: str) -> Optional[str]:
        """Count this probe occurrence and fire the first matching rule.
        Raising faults raise; ``nan``, ``torn`` and ``burst`` return
        their text for the caller to act on; ``hang`` sleeps, then
        returns None."""
        with self._lock:
            key = (scope, name, site)
            self._counts[key] = n = self._counts.get(key, 0) + 1
            rule = next(
                (r for r in self.rules
                 if r.scope == scope and r.site == site
                 and r.name in ("*", name)
                 and (r.nth is None or r.nth == n)), None)
            if rule is None:
                return None
            self.fired.append((rule, n))
        where = f"{scope}:{name}:{site}#{n}"
        _log.warning("fault injector firing %s at %s", rule.fault, where)
        if rule.fault == "oom":
            raise InjectedOom(where)
        if rule.fault == "preempt":
            raise InjectedPreemption(where)
        if rule.fault == "bug":
            raise InjectedFamilyBug(where)
        if rule.fault == "kill":
            raise KillPoint(where)
        if rule.fault in ("nan", "torn"):
            return rule.fault
        if rule.fault.startswith("hang"):
            _, _, secs = rule.fault.partition(":")
            time.sleep(float(secs or "60"))
            return None
        if rule.fault.startswith("burst"):
            return rule.fault
        raise ValueError(f"unknown fault {rule.fault!r} in plan "
                         f"{self.plan_text!r}")


_ACTIVE: Optional[FaultInjector] = None
_ENV_CACHE: Tuple[str, Optional[FaultInjector]] = ("", None)


def _active() -> Optional[FaultInjector]:
    if _ACTIVE is not None:
        return _ACTIVE
    global _ENV_CACHE
    text = os.environ.get("TX_FAULT_PLAN", "")
    if not text:
        return None
    if _ENV_CACHE[0] != text:
        _ENV_CACHE = (text, FaultInjector(text))
    return _ENV_CACHE[1]


def injector_active() -> bool:
    """True when a fault plan is installed (context manager or
    ``TX_FAULT_PLAN``)."""
    return _active() is not None


def maybe_inject(scope: str, name: str, site: str) -> Optional[str]:
    """The injection-site probe: None unless an injector is active and a
    rule matches this occurrence."""
    inj = _active()
    if inj is None:
        return None
    return inj.check(scope, name, site)
