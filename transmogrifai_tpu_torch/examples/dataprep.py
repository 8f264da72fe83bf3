"""Data prep with aggregate, conditional and joined readers on the PyTorch
port, and a seeded e-mail event log that trains a workflow.

Counterpart of ``examples/dataprep.py`` (reference helloworld/src/main/
scala/com/salesforce/hw/dataprep/JoinsAndAggregates.scala and
ConditionalAggregation.scala), over records given as arguments:

1. ``joins_and_aggregates(sends, clicks, cutoff_ms)``: per-user clicks
   yesterday, sends last week and clicks tomorrow aggregated around a
   cutoff, CTR derived in the DAG, sends left-outer-joined with clicks
   at the prepared-dataset level (a user absent from the clicks gets
   null, one present but filtered out gets the monoid zero);
2. ``conditional_aggregation(visits)``: each user's cutoff is their first
   visit to a target landing page; predictors aggregate the week before
   it, responses the day after.

``synthetic_event_log(users, seed)`` draws a log of e-mail sends and
clicks with numpy (each user's click propensity, campaigns, devices,
topics, subjects and click locations); ``write_event_log`` writes it as
Avro files; ``event_features`` and ``event_reader`` declare a workflow
over it: aggregates of both tables joined by user, the response whether
the user clicks in the day after the cutoff. ``run`` trains that
workflow at one cutoff and scores it at another.

Run:  python -m transmogrifai_tpu_torch.examples.dataprep [--users N]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..evaluators import BinaryClassificationEvaluator
from ..evaluators.base import EvaluationMetrics
from ..features.aggregators import (ConcatText, CutOffTime,
                                    GeolocationMidpoint, LastAggregator,
                                    LogicalOr, MaxNumeric, MeanNumeric,
                                    SumNumeric, UnionSet)
from ..features.builder import FeatureBuilder
from ..features.columns import Dataset
from ..features.feature import Feature
from ..ops import transmogrify
from ..readers import (AggregateDataReader,
                       ConditionalDataReader, DataReader,
                       JoinedAggregateReaders)
from ..selector import BinaryClassificationModelSelector
from ..types import (Binary, Geolocation, MultiPickList, PickList, Real,
                     RealNN, Text)
from ..workflow import Workflow, WorkflowModel

__all__ = ["DAY_MS", "START_MS", "joins_and_aggregates",
           "conditional_aggregation", "synthetic_event_log",
           "write_event_log", "SEND_SCHEMA", "CLICK_SCHEMA",
           "event_features", "event_reader", "default_selector", "run",
           "EventLogRun"]

DAY_MS = 24 * 3600 * 1000
#: 2017-09-01T00:00:00Z, the first day of the synthetic log
START_MS = 1_504_224_000_000


# ---------------------------------------------------------------------------
# the reference's two data-prep pipelines
# ---------------------------------------------------------------------------

def joins_and_aggregates(sends: Sequence[dict], clicks: Sequence[dict],
                         cutoff_ms: int, device="cuda"
                         ) -> Dict[str, Dict[str, Optional[float]]]:
    """The reference JoinsAndAggregates pipeline over ``sends`` and
    ``clicks`` (records with ``userId`` and ``timeStamp`` in ms): a
    workflow of aggregates and one derived feature trained and scored on
    ``device``; returns each user's values."""
    num_clicks_yday = (FeatureBuilder.real("numClicksYday")
                       .extract(lambda c: 1.0).aggregate(SumNumeric())
                       .window(DAY_MS).from_source("clicks")
                       .as_predictor())
    num_sends_last_week = (FeatureBuilder.real("numSendsLastWeek")
                           .extract(lambda s: 1.0).aggregate(SumNumeric())
                           .window(7 * DAY_MS).from_source("sends")
                           .as_predictor())
    num_clicks_tomorrow = (FeatureBuilder.real("numClicksTomorrow")
                           .extract(lambda c: 1.0).aggregate(SumNumeric())
                           .window(DAY_MS).from_source("clicks")
                           .as_response())
    ctr = (num_clicks_yday / (num_sends_last_week + 1.0)).alias("ctr")
    cutoff = CutOffTime.unix_ms(cutoff_ms)
    reader = JoinedAggregateReaders(
        left=AggregateDataReader(
            sends, key_fn=lambda r: r["userId"],
            timestamp_fn=lambda r: r["timeStamp"], cutoff_time=cutoff),
        right=AggregateDataReader(
            clicks, key_fn=lambda r: r["userId"],
            timestamp_fn=lambda r: r["timeStamp"], cutoff_time=cutoff,
            response_window_ms=DAY_MS),
        left_name="sends", right_name="clicks")
    names = ("numClicksYday", "numClicksTomorrow", "numSendsLastWeek",
             "ctr")
    model = (Workflow(device=device)
             .set_result_features(num_clicks_yday, num_clicks_tomorrow,
                                  num_sends_last_week, ctr)
             .set_reader(reader).train())
    ds = model.score(reader)
    keys = reader.generate_dataset([]).keys
    return {k: {name: ds[name].boxed(i).value for name in names}
            for i, k in enumerate(keys)}


def conditional_aggregation(visits: Sequence[dict],
                            target_url: str = "http://www.amazon.com/SaveBig"
                            ) -> Dict[str, Dict[str, float]]:
    """The reference ConditionalAggregation pipeline over ``visits``
    (records with ``userId``, ``url``, ``productId`` and ``timestamp`` in
    ms): visits in the week before each user's first visit to
    ``target_url``, purchases in the day after; returns each user's
    values."""
    num_visits_week_prior = (
        FeatureBuilder.real_nn("numVisitsWeekPrior")
        .extract(lambda v: 1.0).aggregate(SumNumeric())
        .window(7 * DAY_MS).as_predictor())
    num_purchases_next_day = (
        FeatureBuilder.real_nn("numPurchasesNextDay")
        .extract(lambda v: 1.0 if v["productId"] else None)
        .aggregate(SumNumeric()).window(DAY_MS).as_response())
    reader = ConditionalDataReader(
        visits, key_fn=lambda v: v["userId"],
        timestamp_fn=lambda v: v["timestamp"],
        target_condition=lambda v: v["url"] == target_url,
        response_window_ms=DAY_MS, predictor_window_ms=7 * DAY_MS,
        drop_if_no_target=True)
    ds = reader.generate_dataset([num_visits_week_prior,
                                  num_purchases_next_day])
    return {k: {f.name: ds[f.name].boxed(i).value
                for f in (num_visits_week_prior, num_purchases_next_day)}
            for i, k in enumerate(ds.keys)}


# ---------------------------------------------------------------------------
# a seeded e-mail event log
# ---------------------------------------------------------------------------

CAMPAIGNS = ("welcome", "weekly", "promo", "reminder", "survey",
             "launch", "digest", "winback")
TOPICS = ("sports", "travel", "tech", "food", "music", "finance")
WORDS = ("new", "deal", "your", "week", "save", "today", "inside", "top",
         "picks", "last", "chance", "free", "update", "guide", "more")
#: city centres the click locations scatter around (lat, lon)
CITIES = ((37.77, -122.42), (40.71, -74.01), (51.51, -0.13),
          (48.86, 2.35), (35.68, 139.69))

SEND_SCHEMA = {"type": "record", "name": "Send", "fields": [
    {"name": "sendId", "type": "long"},
    {"name": "userId", "type": "string"},
    {"name": "emailId", "type": "long"},
    {"name": "timeStamp", "type": "long"},
    {"name": "campaign", "type": ["null", "string"]},
    {"name": "subject", "type": ["null", "string"]}]}
CLICK_SCHEMA = {"type": "record", "name": "Click", "fields": [
    {"name": "clickId", "type": "long"},
    {"name": "userId", "type": "string"},
    {"name": "emailId", "type": "long"},
    {"name": "timeStamp", "type": "long"},
    {"name": "dwellSeconds", "type": ["null", "double"]},
    {"name": "mobile", "type": ["null", "boolean"]},
    {"name": "topics", "type": {"type": "array", "items": "string"}},
    {"name": "lat", "type": ["null", "double"]},
    {"name": "lon", "type": ["null", "double"]}]}


def synthetic_event_log(users: int, seed: int = 0, days: int = 28,
                        sends_per_user: float = 7.0
                        ) -> Tuple[List[dict], List[dict]]:
    """(sends, clicks) of ``users`` users over ``days`` days from
    START_MS, drawn column by column with numpy from ``seed``: about
    ``sends_per_user`` sends a user, each clicked with the user's own
    propensity (a beta draw, higher for mobile users and for the
    "promo" and "launch" campaigns), a click within a day of its send.
    Both lists are in time order."""
    rng = np.random.default_rng(seed)
    propensity = rng.beta(0.8, 1.2, users)
    mobile_user = rng.uniform(size=users) < 0.4
    city = rng.integers(len(CITIES), size=users)
    n_sends = rng.poisson(sends_per_user, users)
    user = np.repeat(np.arange(users), n_sends)
    n = len(user)
    send_t = START_MS + rng.integers(0, days * DAY_MS, n)
    campaign = rng.integers(len(CAMPAIGNS), size=n)
    email = rng.integers(0, 200, n)
    boost = np.where(np.isin(campaign, (2, 5)), 1.5, 1.0) \
        * np.where(mobile_user[user], 1.3, 1.0)
    clicked = rng.uniform(size=n) < np.minimum(propensity[user] * boost,
                                               0.95)
    n_words = rng.integers(2, 6, n)
    words = rng.integers(len(WORDS), size=(n, 5))
    order = np.argsort(send_t, kind="stable")
    sends = [{"sendId": int(i), "userId": f"u{user[i]:06d}",
              "emailId": int(email[i]), "timeStamp": int(send_t[i]),
              "campaign": CAMPAIGNS[campaign[i]],
              "subject": " ".join(WORDS[w] for w in words[i, :n_words[i]])}
             for i in order]
    c = np.flatnonzero(clicked)
    m = len(c)
    click_t = send_t[c] + rng.integers(60_000, DAY_MS, m)
    dwell = np.round(rng.gamma(2.0, 20.0, m), 3)
    dwell_missing = rng.uniform(size=m) < 0.05
    mobile = mobile_user[user[c]] ^ (rng.uniform(size=m) < 0.1)
    n_topics = rng.integers(0, 3, m)
    topics = rng.integers(len(TOPICS), size=(m, 2))
    centre = np.asarray(CITIES)[city[user[c]]]
    loc = centre + rng.normal(0.0, 0.05, (m, 2))
    loc_missing = rng.uniform(size=m) < 0.1
    order = np.argsort(click_t, kind="stable")
    clicks = [{"clickId": int(j), "userId": f"u{user[c[j]]:06d}",
               "emailId": int(email[c[j]]), "timeStamp": int(click_t[j]),
               "dwellSeconds": None if dwell_missing[j]
               else float(dwell[j]),
               "mobile": bool(mobile[j]),
               "topics": sorted({TOPICS[t] for t in topics[j, :n_topics[j]]}),
               "lat": None if loc_missing[j] else float(loc[j, 0]),
               "lon": None if loc_missing[j] else float(loc[j, 1])}
              for j in order]
    return sends, clicks


def write_event_log(sends: Sequence[dict], clicks: Sequence[dict],
                    directory: str, files: int = 4,
                    codec: str = "deflate") -> Tuple[str, str]:
    """Write the log as ``files`` Avro files a table under
    ``directory``; returns the two tables' globs."""
    from ..utils.avro_io import write_avro
    os.makedirs(directory, exist_ok=True)
    globs = []
    for name, recs, schema in (("sends", sends, SEND_SCHEMA),
                               ("clicks", clicks, CLICK_SCHEMA)):
        bounds = np.linspace(0, len(recs), files + 1).astype(int)
        for i in range(files):
            write_avro(os.path.join(directory, f"{name}-{i:03d}.avro"),
                       list(recs[bounds[i]:bounds[i + 1]]), schema=schema,
                       codec=codec)
        globs.append(os.path.join(directory, f"{name}-*.avro"))
    return globs[0], globs[1]


def _location(c: dict):
    return None if c["lat"] is None else [c["lat"], c["lon"], 1.0]


def event_features() -> Tuple[Feature, List[Feature]]:
    """(label, predictors) of the event-log workflow. Sends: sends in the
    last day and week, the last campaign, the week's subjects. Clicks:
    clicks in the last day and week, mean dwell, whether any click was on
    mobile, the topics clicked, the clicks' midpoint. Label: 1 if the
    user clicks in the day after the cutoff, else 0."""
    def agg(name, ftype, fn, aggregator, source, window=None):
        b = FeatureBuilder.of(name, ftype).extract(fn).aggregate(aggregator)
        if window is not None:
            b = b.window(window)
        return b.from_source(source)

    week = 7 * DAY_MS
    predictors = [
        agg("sendsLastDay", Real, lambda s: 1.0, SumNumeric(), "sends",
            DAY_MS),
        agg("sendsLastWeek", Real, lambda s: 1.0, SumNumeric(), "sends",
            week),
        agg("lastCampaign", PickList, lambda s: s["campaign"],
            LastAggregator(), "sends"),
        agg("subjects", Text, lambda s: s["subject"], ConcatText(),
            "sends", week),
        agg("clicksLastDay", Real, lambda c: 1.0, SumNumeric(), "clicks",
            DAY_MS),
        agg("clicksLastWeek", Real, lambda c: 1.0, SumNumeric(), "clicks",
            week),
        agg("meanDwell", Real, lambda c: c["dwellSeconds"], MeanNumeric(),
            "clicks"),
        agg("anyMobile", Binary, lambda c: c["mobile"], LogicalOr(),
            "clicks"),
        agg("topics", MultiPickList, lambda c: c["topics"], UnionSet(),
            "clicks"),
        agg("clickLocation", Geolocation, _location, GeolocationMidpoint(),
            "clicks"),
    ]
    predictors = [b.as_predictor() for b in predictors]
    label = agg("clickedNextDay", RealNN, lambda c: 1.0, MaxNumeric(),
                "clicks", DAY_MS).as_response()
    return label, predictors


def event_reader(sends, clicks, cutoff_ms: int) -> JoinedAggregateReaders:
    """Both tables aggregated by user around ``cutoff_ms`` and joined
    left outer on the sends' users. ``sends`` and ``clicks`` are records
    or readers (an ``AvroProductReader`` of a glob)."""
    cutoff = CutOffTime.unix_ms(cutoff_ms)

    def side(data):
        src = data if isinstance(data, DataReader) else None
        return AggregateDataReader(
            None if src is not None else data, source=src,
            key_fn=lambda r: r["userId"],
            timestamp_fn=lambda r: r["timeStamp"], cutoff_time=cutoff)
    return JoinedAggregateReaders(side(sends), side(clicks),
                                  left_name="sends", right_name="clicks")


def default_selector(device="cuda", models=None, num_folds: int = 3,
                     seed: int = 42):
    """The event-log workflow's selector: ``models`` (default: the whole
    default binary pool) under stratified ``num_folds``-fold CV."""
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, seed=seed, stratify=True, device=device,
        models=models)


class EventLogRun(NamedTuple):
    model: WorkflowModel
    label: Feature
    vector: Feature
    prediction: Feature
    #: the later cutoff's scored dataset (with responses) and its metrics
    scored: Dataset
    metrics: EvaluationMetrics
    #: wall seconds of the train and of the later cutoff's score
    train_seconds: float
    score_seconds: float


def run(sends, clicks, train_cutoff_ms: int, score_cutoff_ms: int,
        device="cuda", models=None) -> EventLogRun:
    """Train the event-log workflow on ``device`` at ``train_cutoff_ms``,
    then score and evaluate it at ``score_cutoff_ms`` through a second
    reader over the same data."""
    label, predictors = event_features()
    vector = transmogrify(predictors)
    prediction = default_selector(device, models).set_input(
        label, vector).get_output()
    t0 = time.perf_counter()
    model = (Workflow(device=device)
             .set_result_features(label, prediction)
             .set_reader(event_reader(sends, clicks, train_cutoff_ms))
             .train())
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluator = BinaryClassificationEvaluator(
        label_col=label.name, prediction_col=prediction.name)
    scored, metrics = model.score_and_evaluate(
        event_reader(sends, clicks, score_cutoff_ms), evaluator)
    return EventLogRun(model, label, vector, prediction, scored, metrics,
                       train_s, time.perf_counter() - t0)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sends, clicks = synthetic_event_log(args.users, args.seed)
    cutoff = START_MS + 14 * DAY_MS
    result = run(sends, clicks, cutoff, cutoff + 7 * DAY_MS,
                 device=args.device)
    print(f"{len(sends)} sends, {len(clicks)} clicks; trained in "
          f"{result.train_seconds:.2f} s; a week later AuPR "
          f"{result.metrics.AuPR:.4f}, AuROC {result.metrics.AuROC:.4f}")


if __name__ == "__main__":
    main()
