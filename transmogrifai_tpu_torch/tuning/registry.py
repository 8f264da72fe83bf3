"""The knobs' registry: the single home of the defaults the scoring plan,
the serving loop and the racing search read.

The port's copy of the ``serving.*`` and ``search.*`` entries of
``transmogrifai_tpu/tuning/registry.py`` (its ``Knob`` table and
``STATIC_DEFAULTS``) that the plan, the server and
``selector/racing.py`` read. The admission
knobs come with ``serving/admission.py``; the coalescing policy is
``ServeConfig.coalesce_policy``. Consumers import a default from
:data:`STATIC_DEFAULTS` instead of restating the number. The JAX package's
``TuningPolicy`` moves these from recorded costs; the port has no policy
yet, so every decision is the static default, which is what the JAX
policy decides with an empty profile store or ``TX_TUNE=off``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

__all__ = ["Knob", "KNOBS", "STATIC_DEFAULTS"]


@dataclass(frozen=True)
class Knob:
    """One registered tunable: its identity, static default and the
    layer that consumes the decision."""
    name: str
    default: Any
    consumer: str
    kind: str          # int | float | str | int_tuple
    description: str


#: the registry, in the JAX package's display order
KNOBS: Tuple[Knob, ...] = (
    Knob(name="serving.target_batch", default=64,
         consumer="serving/server.py ServingServer._target_batch",
         kind="int",
         description="coalescer target batch when the plan has no local "
                     "bucket profile yet (deadline-or-full's 'full')"),
    Knob(name="serving.min_bucket", default=8,
         consumer="plans/common.py bucket_for / serving ScoringPlan",
         kind="int",
         description="smallest padded power-of-two batch: single-record "
                     "requests share one captured graph"),
    Knob(name="serving.max_bucket", default=8192,
         consumer="plans/common.py bucket_for / serving ScoringPlan",
         kind="int",
         description="largest padded batch: bigger inputs chunk, so the "
                     "graphs stay bounded at log2(max/min)+1 per plan"),
    Knob(name="serving.prewarm", default=(),
         consumer="serving/server.py ServingServer.prewarm",
         kind="int_tuple",
         description="bucket sizes captured before traffic; empty means "
                     "no prewarm unless the caller names buckets"),
    Knob(name="search.eta", default=3,
         consumer="selector/racing.py RacingCrossValidation",
         kind="int",
         description="racing promotion ratio: each rung keeps the top "
                     "1/eta"),
    Knob(name="search.min_fidelity", default=None,
         consumer="selector/racing.py RacingCrossValidation",
         kind="float",
         description="budget fraction of the first racing rung (None "
                     "derives the classic 1/eta**2 three-rung ladder); the "
                     "final rung is always exact full CV"),
)

#: knob name -> static default; the values consumers import
STATIC_DEFAULTS: Dict[str, Any] = {k.name: k.default for k in KNOBS}

