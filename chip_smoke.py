#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``transmogrifai_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py [--rows N]
[--workflow-rows N] [--cv-rows N] [--families-rows N] [--text-rows N]
[--out FILE] [--k1-only |
--workflow-only [--agree-witness-rows N] | --validate-only |
--problems-only | --families-only | --text-only | --readers-only |
--models-only [--per-candidate] | --runtime-only]

Phases (any failure exits non-zero; ``--k1-only`` stops after phase 3,
``--workflow-only`` runs phases 1, 2, 8, 8a-8c, 9 and 9b-9d, or with
``--agree-witness-rows N`` phases 1, 2 and 9 alone at N records with the
linear families' float64 witness on the card (the float32 gap reported,
the float64 one checked), ``--validate-only`` phases 1, 2 and 9b-9d, 9b
with its own exact search, ``--problems-only`` phases 1, 2 and 9e-9h,
``--families-only`` phases 1, 2, 9i and 9j, ``--text-only`` phases 1, 2,
9k and 9l, ``--readers-only`` phases 1, 2 and 9m-9o, ``--models-only``
phases 1, 2 and 9p-9r, ``--runtime-only`` phases 1, 2 and 11a-11c; in
the whole smoke the card-against-CPU phases 6, 9, 9d, 9h, 9j, 9l and 9r
and the runtime's 11a and 11c run after phase 11b, the last timed phase,
in a worker process each (9h as three), so that no path is timed beside
them):
  1. device: card name and count, torch and CUDA versions, power limit;
  2. build: compile K1 from ``transmogrifai_tpu_torch/csrc/level_hist.cu``;
  3. K1 (level histogram) against its plain PyTorch version at the GBT
     path's shapes (1M x 100 design, compact uint8 ids, S = 2, C = 1, 4,
     32, 128, 256, with sentinel-slot and zero-stats cases, the latter at
     C = 32 and through the bucketed rows at C = 256), on a wide
     design and on a design with uint16 ids, and at the forest path's
     shape (one tree's 40-feature pool of the same design, TB = 320,
     one-hot labels times Poisson weights times a fold mask, C = 1, 32,
     256: exact, and equal in two runs); kernel, plain and ``index_add_``
     times, the memory bound of the rows each input makes add (for the
     compact ids and for int32 packed ids), whether two runs agree bit
     for bit, and K1's time alone at every slot count the searches
     launch, at both shapes;
     The forest shape also runs real levels' slots: level 8 (C = 256)
     of the RF search's depth-12 trees, recorded as the search grows
     them (the tree with the fewest and the one with the most occupied
     slots);
  4. the main path: the binary model-selection search over the whole
     default pool (3 folds x (8 LogisticRegression points + 18 RF points
     at 50 trees + 18 GBT points + 4 LinearSVC points) = 144 candidates,
     then the winner's refit) on 1M x 100 rows after a stratified 90/10
     holdout split; per family its seconds, models x folds/s and K1's
     launches by slot count (the tree families), with their time
     estimated from phase 3;
  5. the linear search's two products (X @ V and X^T @ R) at its shapes
     (the search's own ~900K training rows), timed against their bounds;
     a LinearSVC fit (L-BFGS) on the 1M rows;
  6. the same four families with the linear ones' full grids and 4-point
     tree grids (RF at 5 trees: the card-against-CPU pool of phases 6, 9,
     9d and 9j) at 20,000 x 100 rows on the card
     (float32) and on the CPU (float64), draws from the same CPU
     generators: metric matrices within 2e-3, and the L-BFGS LinearSVC
     fit on both (the same iteration count, coefficients within 1e-5);
  7. single-record scoring equals batch scoring, through the winner, the
     LinearSVC, and the GBT and the 50-tree forest fitted in phase 10;
  8. the second main path, the Titanic workflow: 100,000 synthetic
     Titanic-shaped records (``--workflow-rows``) through
     ``Workflow.train`` (typed features, transmogrify to a ~590-column
     matrix born on the card, the whole default pool under 3-fold
     stratified CV) and ``score_and_evaluate`` of the 25 % holdout:
     seconds of raw extraction, vectorizer fits, device and host-stage
     transforms, the search by family, K1 launches by family and slot
     count, the winner and holdout AuPR / AuROC, peak memory, and that
     ``fit_columns`` received the matrix as a tensor on the card; a
     ``WorkflowListener`` rides along: its top stages, the models x
     folds (144) and the validator's family profile (the four families)
     beside the smoke's own family seconds;
 8a. [workflow-copies] the workflow on 12,000 records with the
     card-against-CPU pool (its 9,000-row matrix binned on the card,
     as phase 8's), the search under torch.profiler: the bytes
     ``fit_columns`` copied each way (memcpy events), which must leave
     the matrix on the card, and the device's idle share (phase 8's own
     search under the profiler cost 184 s of trace handling);
 8b. [serve-saved] phase 8's model saved to a temporary directory,
     reloaded with ``load_score_function`` on the card, and
     ``SAMPLE_PASSENGER`` and 1,000 holdout records served one at a
     time (p50 / p99 / mean ms a record, synchronized): the served rows
     equal phase 8's ``model.score`` rows within 1e-6, the model stage's
     ``raw_arrays`` ran on CUDA tensors, a reload on the CPU serves the
     same records within 1e-5 of the card (a linear winner), and a
     re-save over the directory swaps it atomically; K1 launches none;
 8c. [serve-compiled] phase 8's model reloaded on the card and frozen into
     a ScoringPlan (``serving/plan.py``): its coverage, and the capture
     seconds of one CUDA graph per row bucket up to the server's
     ``max_batch``; the 25,000 holdout records scored through graph
     replays (``score_batch(engine="compiled")`` and
     ``model.score(engine="compiled")``, records/s, ``bucket_profile``)
     within 1e-6 of the columnar path, bitwise equal over two runs, a
     replay equal to an eager run of the same program, a CPU plan over a
     CPU reload within 1e-5, no program added by a repeat; the offline
     guarded plan's drift sentinel (the saved fingerprints) reads the
     holdout ``ok`` and the holdout shifted (age + 40, sex constant)
     ``warn`` or ``degrade``; then the in-process micro-batching server
     under a default ``ServeConfig()`` (guardrails and the drift sentinel
     on) answering 10,000 holdout records, one request each from 64
     submitter threads (requests/s, p50 / p99 / mean ms, dispatches full
     or at the deadline): no capture in steady state, no host fallback,
     breaker short-circuit or quarantined row, every answer bitwise the
     offline ``score_guarded`` row, the tenant's sentinel ``ok``; the
     same requests without, with, with and without the sentinel
     (requests/s, p50);
     last, 20,000-record workflows with a
     fixed GBT (depth 6, 20 rounds) and a fixed 50-tree forest, each
     scored through a compiled plan within 1e-6 of its columnar score.
     K1 launches none while serving;
  9. the same workflow on 5,000 records on the card and on the CPU
     (the card-against-CPU pool): equal metadata, bitwise equal
     indicator, one-hot, hash and integer columns, float columns within
     1e-5, metric matrices within 2e-3 (1e-2 at the GBT points of
     min_child_weight 1, where float32 breaks gain ties among the sparse
     hash columns otherwise than float64) and the same winner; those GBT
     points searched again on the CPU run's matrix in float64 on the card
     through the plain histogram (the tree float64 witness,
     ``tree_dtype``) must agree with the CPU within 2e-3;
 9b. [validate] the validated DAG (transmogrify, ``.sanity_check``, the
     default pool raced at eta 3 from 1/9) on phase 8's records behind
     the raw feature filter: the filter's seconds and exclusions, the
     checker's fit (seconds, kept and dropped columns, the bytes a warm
     profiled re-fit copies each way: under 1 MB to the host), the race
     by rung and family, K1 launches by family and C, K1 at rung 0's
     sliced shape against its plain version (exact), the winner and
     holdout AuPR within 0.005 of phase 8's exact search, 50 of 144 fold
     fits; then a save, compiled against columnar scoring of the holdout
     (bitwise), 1,001 served records (within 1e-6), no host fallback;
 9c. [workflow-cv] the same DAG under workflow-level CV and exact CV on
     25,000 records (``--cv-rows``): pre-pass, per-fold refit seconds and
     widths, the fold searches, K1 launches, winner and holdout AuPR;
 9d. [validate-agree] both DAGs on 5,000 records on the card and on the
     CPU with phase 9's pool: equal filter results and checker columns,
     checker statistics within 1e-6, the same rung decisions (a flip only
     at a reported near tie), metrics as in phase 9, the same winner;
 9e. [k1-problems] K1 against its plain version at the new problem types'
     shapes: the Iris matrix's forest (S = 3 one-hot statistics, C = 1,
     32, 256, exact), a K = 7 forest block (S = 7, launched as blocks of
     4 + 3 statistics, exact), the Boston regression forest's
     [w, wy, wyy] (S = 3) and the GBT regressor's [g, h] (S = 2) at
     C = 256, within float32 rounding; kernel, plain and ``index_add_``
     times beside the bound;
 9f. [iris] the Iris example (``examples/iris.py``) on 300,000 synthetic
     records (2,000 times the UCI data): transmogrify, the example's pool
     (LR 8, RF 18 at 50 trees, NaiveBayes 1, DT 18, softmax XGBoost 9 =
     54 points x 3 folds) with a DataCutter holding out 20 %: seconds by
     stage and family, K1 launches by family and C (counted from zero
     just before the train; every tree family must launch it), the
     winner, holdout F1 and Error, peak memory; then save, reload, 1,001
     holdout records served one at a time (within 1e-6 of the batch
     score) and the holdout scored through the compiled plan (within
     1e-6 of columnar), no host fallback, no K1 launch;
 9g. [boston] the same for the Boston example on 200,000 records (about
     400 times the UCI data): the default regression pool (LinReg 8, RF
     18, GBT 18, GLM 6 = 50 points x 3 folds) with a DataSplitter, holdout
     RMSE and R2; then a depth-12 DecisionTreeRegressor on the prepared
     matrix on the card (float32 [w, wy, wyy] statistics) against the
     CPU's float64 fit: split nodes that differ;
 9h. [problems-agree] both examples on 3,000 records on the card and on
     the CPU (forests at 5 trees, the same CPU draws) and a K = 7 multiclass array search (3,000 x 20, the default
     multiclass pool): metric matrices within 2e-3 (relative for RMSE),
     the same winner unless the CPU's top two lie within that; the K = 7
     forests launch K1 in statistic blocks; Boston's GBT points of depth
     6 and 12 searched again in float64 on the card through the plain
     histogram must agree with the CPU within 2e-3 (relative);
 9i. [families] the every-family workflow (``examples/families.py``: the
     JAX package's family DAG of dates, date lists, maps of every kind,
     text, sets, numerics, with a geolocation, tokens and both
     bucketizers, ~1,095 columns) on 100,000 testkit records
     (``--families-rows``) with the whole default pool under 3-fold CV:
     seconds by stage and of the ported stages (fit, device or host
     transform), K1 launches by family and C (every tree family and the
     auto-bucketizer's one-feature tree must launch it), winner, holdout
     AuPR / AuROC, peak memory; [k1-families]: K1 against its plain
     version at the bucketizer's d = 1 design (C = 1, 2) and on the
     family matrix (forest statistics at C = 1, 32, 256, exact; the GBT's
     [g, h] at C = 256), with ``index_add_`` times and the bound; then
     save (with the drift fingerprints), reload, the holdout scored
     through the compiled plan (bitwise the columnar path) and through its
     default guardrails (the drift sentinel reads it ``ok``) and 1,001
     records served one at a time (within 1e-6), no host fallback, no K1
     launch (the Iris and Boston paths serve the same way);
 9j. [families-agree] the same DAG on 5,000 records on the card and on
     the CPU with the card-against-CPU pool (GBT at 5 rounds): metadata
     equal but for the auto-bucketizer's labels (they carry its split
     points, float32 on the card), indicator, one-hot, hash and integer
     columns bitwise, float columns within 1e-5, the split points and
     rows in another bucket reported, metric matrices within 2e-3 (named
     exceptions: GBT at min_child_weight < 10; LR at reg_param 0.001
     and LinearSVC on this wide noisy matrix, whose gap must be
     float32's: the same linear search in float64 on the card within
     2e-3 of the CPU's, the CPU's own float32 gap reported), the same
     winner;
 9k. [text] the text workflow (``examples/text.py``: TF-IDF, Word2Vec and
     LDA over the body's tokens, language, length, name entities, n-gram
     similarity, e-mail and URL domains, phone validity and a string
     index, ~2,300 columns) on 10,000 records (``--text-rows``) with the
     whole default pool: seconds by stage, Word2Vec's and LDA's fit
     seconds (on the card), the search by family, K1 launches by family
     and C, winner, holdout AuPR / AuROC / log loss / Brier score, peak
     memory; [k1-text]: K1 against its plain version on the text matrix
     (forest statistics at C = 1, 32, 256, exact; the GBT's [g, h] at
     C = 256) with ``index_add_`` times and the bound; then save, reload,
     the holdout through the compiled plan (bitwise the columnar path)
     and its default guardrails (drift ``ok``), 1,001 records served one
     at a time (within 1e-6) and 2,000 holdout requests through a
     default ``ServeConfig()`` server (within 1e-6 of the guarded plan,
     its sentinel ``ok``);
 9l. [text-agree] the text DAG on 2,000 records on the card and on the
     CPU with the linear families only: every host stage's output
     bitwise equal, Word2Vec's vectors and document means (float32 SGD
     on the card) within 1e-6, LDA's topic-word matrix and mixtures
     (float64 on both) within 1e-10; then the linear families on a
     10,000-record text design (7,500 rows, ~2,300 columns) on the card:
     their float32 metric matrix within 2e-3 of the CPU's float64 search
     on the same matrix (3e-2 at LogisticRegression's reg_param 0.001),
     the float64 search on the card within 2e-3 (the CPU's own float32
     gap reported beside it);
 9m. [quickstart] the README's Quick start with the port's imports:
     100,000 seeded Titanic-shaped records (``QUICKSTART_ROWS``), 75 %
     written as a CSV and trained through ``DataReaders.Simple.csv_auto``
     (typed age, sex and survived, transmogrify, ``sanity_check``, the
     card-against-CPU pool under 3-fold CV): seconds, the search by
     family, K1 launches by family and C; ``summary_pretty()`` and
     ``model_insights().pretty()`` printed; save, ``load_score_function``
     and one record served; the 25 % holdout streamed in batches of 1,000
     through ``score(engine="compiled")`` within 1e-6 of one whole
     compiled score, and its AuPR; [k1-quickstart]: K1 against its plain
     version on its matrix (forest statistics at C = 1, 32, 256, exact;
     the GBT's [g, h] at C = 256);
 9n. [readers] the seeded e-mail event log of ``examples/dataprep.py``
     (20,000 users, ~205,000 sends and clicks, ``READERS_USERS``)
     written as deflate Avro files and read by two AggregateDataReaders
     over AvroProductReader sources, joined left outer by
     JoinedAggregateReaders: the workflow (sums over 1 and 7 days, a mean,
     a logical or, the last campaign, a union of topics, the subjects'
     text, the clicks' midpoint; the label a click in the day after the
     cutoff) with the card-against-CPU pool, trained at one cutoff and
     scored 7 days later through a second reader on the same files with
     its responses (AuPR) and through a third that refuses the response
     (compiled engine; the label all NaN, the predictions within 1e-6):
     seconds of Avro reading, aggregation, join, raw
     extraction, fits and the search by family, K1 launches by family
     and C; [k1-readers]: K1 against its plain version on the event-log
     matrix, as [k1-quickstart];
 9o. [insights] for both workflows, over their first 5,000 scored rows:
     RecordInsightsLOCO on the card against a CPU reload of the saved
     model (every diff within 1e-5, the same top-3 groups wherever no tie
     straddles K), RecordInsightsCorr on the card against the CPU (within
     1e-5, NaN alike); ``feature_importances`` of phase 8c's fixed GBT and
     50-tree forest against their CPU reloads (exact, summing to 1; under
     ``--readers-only`` fixed trees on the event log); seconds of each, no
     K1 launch. 9m-9o's seconds together are logged beside their 60 s
     budget, which is reported, not enforced;
 9p. [host-metric] the Titanic DAG on 20,000 records selected under
     LogLossEvaluator (no device metric) over the card-against-CPU pool:
     every family's batched fold x grid fits (every tree family launching
     K1 through them), each fold's tree models in one
     ``batch_predict_raw`` group a shape, the log loss on the host;
     seconds and K1 launches by family and C, the groups, the winner and
     the holdout log loss and AuPR. The same pool on its prepared matrix
     by the device path and by the host path (an AuPR evaluator that
     overrides ``metric_from``): within AGREE_TOL (GBT_SMALL_LEAF_TOL at
     GBT min_child_weight 1), the same winner; then under
     ``TX_TREE_EDGES=fold``, with K1 at one fold's design against its
     plain version (exact); ``--per-candidate`` also times the host path
     candidate by candidate, the loop its batched fits replace;
 9q. [mlp] the Iris example on 300,000 records with the opt-in MLP grid:
     the batched fold fits' seconds, the L-BFGS refit's seconds and
     iterations, the holdout F1 and Error; save, reload, 1,001 records
     served one at a time and the holdout through the compiled plan
     (``_serve_problem``); an IsotonicRegressionCalibrator on the
     winner's scores and a ``wrap_estimator`` family (a host stage), each
     served once, their coverage logged;
 9r. [models-agree] the MLP's batched fits and F1 matrix on 3,000 Iris
     records and the log-loss search of the small pool on 3,000 Titanic
     records, card against CPU, within AGREE_TOL (GBT_SMALL_LEAF_TOL at
     GBT min_child_weight 1);
 10. torch.profiler windows over the LogisticRegression search (at 250
     and at 200 FISTA iterations, whose difference is FISTA's own cost),
     one GBT fit, one 50-tree, depth-6 RF fit and the RF search's
     depth-12 group cut to 5 trees, the searches on their own training
     rows: device busy and idle share, top device ops (read from the
     windows' raw events; the first also through ``prof.events()``,
     which must agree), host syncs of the fits' tree loops;
 11a. [resume] the Titanic DAG at full width (RESUME_ROWS records, the
     default pool with its forests at PATH_TREES, 3-fold CV, a journal
     under a temporary ``checkpoint_dir``): run A uninterrupted, run B
     killed by ``family:GBTClassifier:dispatch:1=kill`` and resumed with
     ``train(resume_from=...)``, then the same raced and killed at
     ``rung:1:boundary``; seconds, journal lines, bytes and fsync
     seconds, K1 launches by family and C, journal hits; fails unless the
     resume dispatches no journaled entry (no K1 launch for a journaled
     family), replays the journal bit for bit, picks run A's winner and
     stays within AGREE_TOL of run A (RESUME_GBT_TOL for a recomputed
     GBT point);
 11b. [heal] a 5,000-record Titanic model served with the lifecycle and
     the drift sentinel: a shifted stream for tenant ``a`` degrades its
     sentinel, the retrain runs on the card (K1 counted), the canary
     passes and the entry swaps, then ``lifecycle:titanic:postswap:1=
     preempt`` rolls it back; requests dropped (0), ``plan_compiles()``
     at and after the swap (flat), the retrain's seconds, served p50 /
     p99 before, during and after the retrain; tenant ``b`` keeps its
     entry object and answers;
 11c. [quarantine] in its own process: the Titanic search with the
     allocator limited around it (``set_per_process_memory_fraction``,
     from each family's measured peak) so that RF meets a real CUDA
     out-of-memory: ``train()`` completes with the survivors, RF is named
     (transient, its retry spent), K1 then matches its plain version,
     and an OOM at every family raises one AllFamiliesFailedError naming
     all four. Their seconds together are logged against
     RUNTIME_PHASES_BUDGET_S, reported, not enforced.
Every phase but [quarantine] runs under ``forbid_quarantines``: a family
quarantined there (an OOM, a CUDA error the runtime classed transient or
family-scoped) fails the run at the end of its phase.
The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from transmogrifai_tpu_torch import _build  # noqa: E402
from transmogrifai_tpu_torch.models.hist_kernel import (  # noqa: E402
    HistPlan, _packed, compact_ids, hist_bytes, index_add_rows, level_hist,
    level_hist_plain)
from transmogrifai_tpu_torch.models import linear, trees  # noqa: E402
from transmogrifai_tpu_torch.models.draws import TorchDraws  # noqa: E402
from transmogrifai_tpu_torch.models.linear import (  # noqa: E402
    LinearSVC, LogisticRegression)
from transmogrifai_tpu_torch.models.registry import (  # noqa: E402
    default_binary_models)
from transmogrifai_tpu_torch.models.trees import (  # noqa: E402
    GBTClassifier, RandomForestClassifier, _ForestPool, _PackedDesign, _on,
    _pool_plan, _resolve_max_features, clear_design_cache)
from transmogrifai_tpu_torch.evaluators import (  # noqa: E402
    BinaryClassificationEvaluator)
from transmogrifai_tpu_torch.selector import (  # noqa: E402
    BinaryClassificationModelSelector, CrossValidation, DataBalancer)
from transmogrifai_tpu_torch.examples import titanic  # noqa: E402
from transmogrifai_tpu_torch.local import load_score_function  # noqa: E402
from transmogrifai_tpu_torch.selector import validator  # noqa: E402
from transmogrifai_tpu_torch.serving.sentinel import (  # noqa: E402
    DRIFT_FINGERPRINTS_FILE, DriftSentinel)
from transmogrifai_tpu_torch.selector.selector import (  # noqa: E402
    models_x_folds)
from transmogrifai_tpu_torch.utils.device import (  # noqa: E402
    resolve_device, working_dtype)
from transmogrifai_tpu_torch.utils.listener import (  # noqa: E402
    WorkflowListener)
from transmogrifai_tpu_torch.models import (  # noqa: E402
    IsotonicRegressionCalibrator, wrap_estimator)
from transmogrifai_tpu_torch.serving import ScoringPlan  # noqa: E402

#: H100 SXM published peaks: HBM bytes/s and
#: float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
K1_SOURCE = "transmogrifai_tpu_torch/csrc/level_hist.cu"
K1_REPLACES = "transmogrifai_tpu/models/pallas_hist.py:124"
#: features of BASELINE config 4 (20 numeric, 80 binary); never cut
COLS = 100
#: slot counts the search launches K1 at (depths 3, 6, 12; cap 256)
SEARCH_SLOTS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: families of the main path, in the default pool's order
FAMILIES = ("LogisticRegression", "RandomForestClassifier", "GBTClassifier",
            "LinearSVC")
#: the families that launch K1
TREE_FAMILIES = ("RandomForestClassifier", "GBTClassifier")
#: the 4-point grids of the card-against-CPU phase
SMALL_GRID = [{"max_depth": d, "min_child_weight": m, "gamma": 0.01}
              for d in (3, 6) for m in (1.0, 10.0)]
RF_SMALL_GRID = [{"max_depth": d, "min_instances_per_node": m,
                  "min_info_gain": 0.01} for d in (3, 6) for m in (10, 100)]
AGREE_TOL = 2e-3
#: boosting rounds of the GBT points in [families-agree] (phase 9j), whose
#: CPU half sums plain float64 histograms over ~1,095 columns: at the
#: pool's 20 rounds it took 99.67 s of CPU on 5,000 records, at 5 rounds
#: 35.36 s (the host of one H100). Phases 6, 9, 9d and 9h keep 20
AGREE_ROUNDS = 5
#: rows of the card-against-CPU array search (phase 6) and records of the
#: card-against-CPU workflows (phases 9 and 9d): the sizes the tolerances
#: were measured at (at 8,000 rows and 3,000 records an H100 came within
#: 1.81e-3 of AGREE_TOL and past it, 1.27e-2, on LinearSVC and LR points)
CARD_VS_CPU_ROWS = 20_000
AGREE_RECORDS = 5_000
#: holdout records a served problem path scores through its plan's
#: default guardrails (the drift sentinel's sample)
GUARDED_RECORDS = 5_000
#: smallest sample on which an unshifted holdout must read drift "ok":
#: below it the JS of a hashed high-cardinality text feature is noise
#: (a Titanic holdout of 64 to 300 records reads "warn" in the CPU
#: rehearsals; 1,000 read "ok" in tests/test_torch_sentinel.py, 25,000 a
#: largest JS of 0.105 against warn at 0.25 on an H100 host)
DRIFT_MIN_RECORDS = 1_000
#: records of the profiled workflow (8a): its matrix (9,000 x ~550) is
#: above _DEVICE_BIN_MIN_ELEMS, so it is binned on the card as phase 8's;
#: phase 8's own search under the profiler (26,460 K1 launches) made a
#: 4 GB trace whose stop, export and scan took 184 s of the run
COPIES_RECORDS = 12_000
#: card (float32) against CPU (float64) L-BFGS coefficients at 20K rows:
#: measured 2.8e-8 on an H100, this leaves float32 rounding a 300x margin
#: and still fails a line search that fell back to its safe step
LBFGS_COEF_TOL = 1e-5
#: card (float32) against CPU (float64) prepared Titanic matrix: the
#: float columns (means, sums, z-scores) within this much of the column's
#: largest magnitude; every other column bitwise equal
PREPARED_REL_TOL = 1e-5
#: card against CPU metric of a GBT grid point of min_child_weight < 10
#: on the Titanic matrix, whose 513 sparse hash columns and leaves of a few
#: rows leave many splits tied in gain: float32 and float64 pick different
#: ones among them. Measured on an H100 at 3,750 / 15,000 training rows:
#: 8.6e-3 / 4.6e-3 at min_child_weight 1, <= 2.3e-4 at 10, <= 7.6e-5 for
#: every other family; every other point keeps AGREE_TOL
GBT_SMALL_LEAF_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def make_data(rows: int, cols: int, seed: int = 0):
    """The 1M-row synthetic tabular recipe of BASELINE config 4: a fifth
    of the columns normal, the rest Bernoulli(0.15), a logistic label."""
    rng = np.random.default_rng(seed)
    n_num = max(cols // 5, 1)
    X_num = rng.normal(size=(rows, n_num))
    X_bin = (rng.uniform(size=(rows, cols - n_num)) < 0.15).astype(float)
    X = np.concatenate([X_num, X_bin], axis=1)
    logits = X_num[:, 0] + X_bin[:, :3].sum(axis=1) - 0.5
    y = (logits + rng.logistic(size=rows) * 0.5 > 0).astype(float)
    return X, y


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "smi": nvidia_smi()}
    log(f"[device] {info['kind']} x{info['count']} torch {info['torch']} "
        f"cuda {info['cuda']}")
    log(info["smi"])
    return info


def phase_build() -> None:
    built = _build.build("level_hist")
    _build.load("level_hist")
    if built is None:
        log("[build] level_hist: built already")
        return
    seconds, out = built
    log(f"[build] level_hist: nvcc {seconds:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    # which atomic instructions the shared and global adds compiled to
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build._target(
                _build.CSRC / "level_hist.cu"))],
            capture_output=True, text=True, timeout=120).stdout
        ops: dict = {}
        for line in sass.splitlines():
            for tok in line.replace(";", " ").split():
                if tok.startswith(("ATOMS", "ATOMG", "RED", "ATOM.")):
                    ops[tok] = ops.get(tok, 0) + 1
        log(f"[build]   SASS atomics: {json.dumps(ops, sort_keys=True)}")


def k1_case(label: str, ids, offsets, slot, st, C: int, TB: int,
            plan, exact: bool = False) -> dict:
    """K1 against its plain version on one input: agreement (fails the
    run outside the tolerance; with ``exact``, unless equal bit for bit
    and equal in two runs), kernel, plain and ``index_add_`` times, and
    the memory bounds for the compact ids and for int32 packed ids."""
    n = ids.shape[0]
    d = offsets.shape[0]
    S = st.shape[1]
    got = level_hist(ids, offsets, slot, st, C, TB, plan)
    again = level_hist(ids, offsets, slot, st, C, TB, plan)
    ref = level_hist_plain(ids, offsets, slot, st, C, TB)
    mag = level_hist_plain(ids, offsets, slot, st.abs(), C, TB)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    # float32 sums in two orders: allow 1e-5 of the summed magnitudes
    if not bool(torch.all(err <= 1e-5 * mag + 1e-5)):
        raise AssertionError(f"K1 disagrees with its plain version "
                             f"({label}): max abs err {float(err.max())}")
    max_abs = float(err.max())
    max_rel = float((err / mag.clamp(min=1e-6)).max())
    bitwise = bool(torch.equal(got, again))
    equal = bool(torch.equal(got, ref))
    if exact and not (equal and bitwise):
        raise AssertionError(f"K1 is not exact on integer stats ({label}): "
                             f"equal to plain {equal}, repeats {bitwise}")
    del got, again, ref, mag, err
    ms = cuda_ms(lambda: level_hist(ids, offsets, slot, st, C, TB, plan), 20)
    plain_ms = cuda_ms(lambda: level_hist_plain(ids, offsets, slot, st, C,
                                                TB), 3, warmup=1)
    seg = torch.where((slot >= 0)[:, None] & (slot < C)[:, None],
                      slot.long()[:, None] * TB + _packed(ids, offsets),
                      C * TB).reshape(-1)
    vals = st[:, None, :].expand(n, d, S).reshape(n * d, S).contiguous()
    acc = torch.zeros((C * TB + 1, S), device=ids.device)
    library_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 3, warmup=1)
    del seg, vals, acc
    # this input's work: stats only of rows slotted in [0, C), bin ids and
    # additions only of those rows whose stats are not all zero
    slotted = (slot >= 0) & (slot < C)
    n_slotted = int(slotted.sum())
    n_live = int((slotted & (st != 0).any(dim=1)).sum())
    ops_ms = n_live * d * S / PEAK_F32_OPS_PER_S * 1e3
    bound_ms = max(hist_bytes(n, d, S, C, TB, n_slotted, n_live,
                              id_bytes=ids.element_size())
                   / PEAK_BYTES_PER_S * 1e3, ops_ms)
    bound_int32 = max(hist_bytes(n, d, S, C, TB, n_slotted, n_live)
                      / PEAK_BYTES_PER_S * 1e3, ops_ms)
    c_tile, stages, copies = plan.launch(C)
    log(f"[k1] {label}: max_abs_err={max_abs:.3e} max_rel_err="
        f"{max_rel:.3e} ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.3f} bound_ms={bound_ms:.4f} "
        f"bound_ms_int32_ids={bound_int32:.4f} bitwise_repeat={bitwise} "
        f"equal_to_plain={equal} "
        f"(groups={plan.n_groups} c_tile={c_tile} copies={copies} "
        f"stages={stages} "
        f"rows={plan.rows} smem={plan.smem_bytes(C)})")
    return {"case": label, "n": n, "d": d, "TB": TB, "S": S, "C": C,
            "id_bytes": ids.element_size(), "stride": ids.shape[1],
            "rows_slotted": n_slotted, "rows_live": n_live,
            "groups": plan.n_groups, "c_tile": c_tile, "copies": copies,
            "stages": stages,
            "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_ms_int32_ids": bound_int32,
            "bitwise_repeat": bitwise, "equal_to_plain": equal}


def synthetic_ids(gen, n: int, widths, device):
    """(ids, offsets) of ``n`` rows with uniform local bins."""
    w = torch.as_tensor(widths, device=device, dtype=torch.int64)
    local = (torch.rand((n, len(widths)), generator=gen, device=device)
             * w).long()
    local = torch.minimum(local, w - 1).to(torch.int32)
    return compact_ids(local, widths)


def phase_k1(device: torch.device, X: np.ndarray) -> dict:
    """K1 against its plain version on the main path's design, then on a
    wide design and on one with uint16 ids; then K1 alone at every slot
    count the search launches."""
    design = _PackedDesign(X, 32, device)
    ids, offsets, TB = design.ids, design.offsets, design.total_bins
    n, d = design.n, design.d
    S = 2
    plan = design.hist_plan(S)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    stats = torch.randn((n, S), generator=gen, device=device)
    log(f"[k1] design n={n} d={d} TB={TB} ids {ids.dtype} stride "
        f"{ids.shape[1]} groups={plan.n_groups} w_max={plan.w_max}")
    cases = []
    for label, C, kind in (("C=1", 1, ""), ("C=4", 4, ""), ("C=32", 32, ""),
                           ("C=128", 128, ""), ("C=256", 256, ""),
                           ("C=256 sentinel", 256, "sentinel"),
                           ("C=32 zero-stats", 32, "zero"),
                           ("C=256 zero-stats", 256, "zero")):
        slot = torch.randint(0, C, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        st = stats.clone()
        if kind == "sentinel":
            slot[::4] = C                      # parked rows add nothing
        if kind == "zero":
            st[::3] = 0.0                      # masked rows add nothing
        cases.append(k1_case(label, ids, offsets, slot, st, C, TB, plan))
    ms_by_c = {}
    for C in SEARCH_SLOTS:
        slot = torch.randint(0, C, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        ms_by_c[C] = cuda_ms(lambda: level_hist(ids, offsets, slot, stats, C,
                                                TB, plan), 20)
    log("[k1] K1 ms by slot count: " + " ".join(
        f"C={c}:{ms:.4f}" for c, ms in ms_by_c.items()))
    del design, ids, stats
    clear_design_cache()
    extra = []
    # 500 features x 32 bins = 16,000 bins; and a uint16 design: one
    # 1000-bin feature beside 999 of 32 bins (two feature groups)
    for label, n_x, widths, C in (("wide 500x32 C=8", 100_000, [32] * 500, 8),
                                  ("uint16 1000 feats C=4", 50_000,
                                   [1000] + [32] * 999, 4)):
        ids_x, off_x = synthetic_ids(gen, n_x, widths, device)
        plan_x = HistPlan(widths, S, device)
        slot_x = torch.randint(0, C, (n_x,), generator=gen, device=device,
                               dtype=torch.int32)
        st_x = torch.randn((n_x, S), generator=gen, device=device)
        extra.append(k1_case(label, ids_x, off_x, slot_x, st_x, C,
                             sum(widths), plan_x))
        del ids_x, off_x, slot_x, st_x
    return {"cases": cases, "extra": extra, "ms_by_c": ms_by_c}


def forest_k1_inputs(device, X: np.ndarray, y: np.ndarray, seed: int = 42):
    """Tree 0's pooled design of the main path's forests (the default
    pool's RF: sqrt feature subsets, so a 40-feature pool of the 100 at
    1M x 100) and its statistics: one-hot labels times Poisson(1) weights
    times a fold mask that drops a third of the rows. Returns (pooled
    design, stats (n, 2) in the working dtype)."""
    design = _PackedDesign(X, 32, resolve_device(device))
    mf = _resolve_max_features("auto", design.d, True)
    classes, cfg, _ = _pool_plan(design.widths, mf)
    if cfg is None:
        raise AssertionError("the forest path's design is not pooled")
    draws = TorchDraws(seed, 1)
    tree = _ForestPool(design, classes, cfg).tree(0, draws)
    w = draws.poisson(0, 1.0, design.n) * (torch.arange(design.n) % 3 != 0)
    onehot = np.eye(2)[np.asarray(y).astype(np.int64)]
    stats = _on(onehot * w[:, None].numpy(), design.dtype, design.device)
    return tree, stats.contiguous()


def real_level_inputs(device, X: np.ndarray, y: np.ndarray,
                      level: int = 8, num_trees: int = 3) -> list:
    """K1's inputs at ``level`` of every tree the RF search grows at depth
    12 for the default pool's first depth-12 point over 3 folds, cut to
    ``num_trees`` trees, as the search launches them: a list of (pooled
    design, slot, stats, C), one per (tree, fold)."""
    seen = []
    calls = []
    real = trees._level_histograms

    def record(design, slot, stats, num_slots):
        if len(calls) % 12 == level:
            seen.append((design, slot.clone(), stats.clone(), num_slots))
        calls.append(num_slots)
        return real(design, slot, stats, num_slots)
    trees._level_histograms = record
    try:
        search_slice(device, X, y, num_trees=num_trees, depth=12,
                     points=1)()
    finally:
        trees._level_histograms = real
    return seen


def phase_k1_forest(device: torch.device, X: np.ndarray,
                    y: np.ndarray) -> dict:
    """K1 at the forest path's shape against its plain version (integer
    statistics: exact, and equal in two runs), on random slots and on a
    real level's, then K1 alone at every slot count the forest search
    launches."""
    tree, stats = forest_k1_inputs(device, X, y)
    plan = tree.hist_plan(2)
    n, TB = tree.n, tree.total_bins
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    log(f"[k1-forest] pooled design n={n} d={tree.d} TB={TB} ids "
        f"{tree.ids.dtype} stride {tree.ids.shape[1]} groups="
        f"{plan.n_groups} w_max={plan.w_max}; rows with stats "
        f"{int((stats != 0).any(dim=1).sum())}")
    cases = []
    for C in (1, 32, 256):
        slot = torch.randint(0, C, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        cases.append(k1_case(f"forest C={C}", tree.ids, tree.offsets, slot,
                             stats, C, TB, plan, exact=True))
    # level 8 of the search's trees: the unsplit one (a tree whose pool
    # misses the informative features keeps every row in one node) and
    # the one with the most occupied slots
    levels = real_level_inputs(device, X, y)
    occupied = [int(torch.unique(slot[slot < C]).numel())
                for _, slot, _, C in levels]
    log(f"[k1-forest] real level 8 of the RF search, occupied slots by "
        f"(tree, fold): {occupied}")
    for label, i in (("unsplit", int(np.argmin(occupied))),
                     ("fullest", int(np.argmax(occupied)))):
        real, slot, real_stats, C = levels[i]
        crowd = int(torch.bincount(slot[slot < C].long()).max())
        log(f"[k1-forest] real level 8 {label}: C={C}, {occupied[i]} "
            f"occupied slots, the largest holds {crowd} rows")
        cases.append(k1_case(f"forest real level 8 {label} C={C}", real.ids,
                             real.offsets, slot, real_stats, C,
                             real.total_bins, real.hist_plan(2), exact=True))
    del levels, real, slot, real_stats
    ms_by_c = {}
    for C in SEARCH_SLOTS:
        slot = torch.randint(0, C, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        ms_by_c[C] = cuda_ms(lambda: level_hist(tree.ids, tree.offsets, slot,
                                                stats, C, TB, plan), 20)
    log("[k1-forest] K1 ms by slot count: " + " ".join(
        f"C={c}:{ms:.4f}" for c, ms in ms_by_c.items()))
    del tree, stats
    clear_design_cache()
    return {"cases": cases, "ms_by_c": ms_by_c}


def metric_matrix(selected) -> np.ndarray:
    """(folds, candidates) validation metrics of a fitted selector, the
    families in pool order and each family's grid in order."""
    return np.array([r.metric_values
                     for r in selected.summary.validation_results]).T


def small_models(device, num_rounds: int = 20, num_trees: int = 5,
                 families=FAMILIES):
    """The card-against-CPU pool: the linear families with their default
    grids (8 and 4 points), the tree families with 4-point grids."""
    dev = resolve_device(device)
    pool = {type(est).__name__: (est, grid)
            for est, grid in default_binary_models(dev)
            if type(est).__name__ not in TREE_FAMILIES}
    pool["RandomForestClassifier"] = (
        RandomForestClassifier(num_trees=num_trees, device=dev),
        RF_SMALL_GRID)
    pool["GBTClassifier"] = (GBTClassifier(num_rounds=num_rounds,
                                           device=dev), SMALL_GRID)
    return [pool[f] for f in families]


def time_family(est, record: dict, fit: bool = False) -> None:
    """Wrap ``est``'s search (``eval_fold_grid_arrays``, or with ``fit``
    the host path's ``fit_fold_grid_arrays``) so that its calls add up
    their seconds, their candidates and the K1 launches by slot count they
    made (each call ends in the read-back of its metric matrix or of its
    models; a racing search calls a family once a rung)."""
    name = "fit_fold_grid_arrays" if fit else "eval_fold_grid_arrays"
    search = getattr(est, name)

    def timed(*args, **kwargs):
        before = collections.Counter(level_hist.launches_by_c)
        t0 = time.perf_counter()
        out = search(*args, **kwargs)
        if fit and torch.cuda.is_available():
            torch.cuda.synchronize()     # models may stay on the card
        seconds = time.perf_counter() - t0
        by_c = collections.Counter(level_hist.launches_by_c) - before
        rec = record.setdefault(type(est).__name__, {
            "seconds": 0.0, "candidates": 0, "calls": 0,
            "k1_launches_by_c": {}})
        rec["seconds"] += seconds
        rec["candidates"] += (sum(len(row) for row in out) if fit
                              else int(out.size))
        rec["calls"] += 1
        rec["models_x_folds_per_s"] = rec["candidates"] / rec["seconds"]
        merged = collections.Counter(rec["k1_launches_by_c"]) + by_c
        rec["k1_launches_by_c"] = dict(sorted(merged.items()))
        rec["k1_launches"] = sum(merged.values())
        return out
    setattr(est, name, timed)


def phase_main(device, X: np.ndarray, y: np.ndarray, models=None,
               tag: str = "main") -> dict:
    """The binary search over ``models`` (default: the default pool),
    per family timed."""
    dev = resolve_device(device)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True,
        splitter=DataBalancer(reserve_test_fraction=0.1, seed=42),
        models=models, device=dev)
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families)
    clear_design_cache()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    with iterations_of("fista_minimize") as fista:
        t0 = time.perf_counter()
        selected = sel.fit_arrays(X, y)
        wall = time.perf_counter() - t0
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    s = selected.summary
    mm = metric_matrix(selected)
    G = len(s.validation_results)
    if mm.shape != (3, G) or not np.all(np.isfinite(mm)):
        raise AssertionError(f"[{tag}] bad metric matrix {mm}")
    if dev.type == "cuda":
        idle = [f for f, rec in families.items()
                if f in TREE_FAMILIES and rec["k1_launches"] == 0]
        if launches == 0 or idle:
            raise AssertionError(
                f"[{tag}] K1 never launched by {idle or 'the search'}")
    hold = s.holdout_evaluation
    if hold is None or not 0.5 < hold.AuROC <= 1.0:
        raise AssertionError(f"[{tag}] holdout evaluation is off: {hold}")
    winner_index = int(np.argmax(mm.mean(axis=0)))
    out = {"rows": int(X.shape[0]), "cols": int(X.shape[1]),
           "candidates": int(mm.size), "wall_s": wall,
           "models_x_folds_per_s": mm.size / wall,
           "timings_s": dict(s.timings),
           "search_models_x_folds_per_s": mm.size / s.timings["validate"],
           "families": families,
           "k1_launches": launches, "k1_launches_by_c": by_c,
           "k1_launches_refit": launches - sum(
               f["k1_launches"] for f in families.values()),
           "winner": s.best_model_name,
           "winner_params": s.best_model_params,
           "winner_index": winner_index,
           "best_metric": s.best_validation_metric,
           "holdout_AuPR": hold.AuPR, "holdout_AuROC": hold.AuROC,
           "fista_iterations": [int(i.max()) for i in fista],
           "metric_matrix": mm.tolist(), "selected": selected}
    if s.validation_results[winner_index].model_name != s.best_model_name:
        raise AssertionError(f"[{tag}] the selector's winner is not the "
                             f"best mean of its matrix")
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {X.shape[0]}x{X.shape[1]} on {dev}: {mm.size} "
        f"models x folds in {wall:.2f} s ({out['models_x_folds_per_s']:.3f}"
        f"/s), stages {json.dumps(out['timings_s'])}")
    for name, rec in families.items():
        log(f"[{tag}] {name}: {rec['candidates']} models x folds in "
            f"{rec['seconds']:.2f} s ({rec['models_x_folds_per_s']:.3f}/s); "
            f"K1 launches {rec['k1_launches']}: " + " ".join(
                f"C={c}:{k}" for c, k in rec["k1_launches_by_c"].items()))
    log(f"[{tag}] winner {s.best_model_name} {s.best_model_params} "
        f"mean AuPR {s.best_validation_metric:.6f}; holdout AuPR "
        f"{hold.AuPR:.6f} AuROC {hold.AuROC:.6f}; K1 launches {launches} "
        f"(refit {out['k1_launches_refit']})"
        + (f"; max_memory_allocated {out['max_memory_allocated']}"
           if "max_memory_allocated" in out else "")
        + f"; FISTA iterations by call {out['fista_iterations']}")
    log(f"[{tag}] metric matrix (folds x candidates):")
    for row in mm:
        log(f"[{tag}]   " + " ".join(f"{v:.6f}" for v in row))
    return out


def phase_card_vs_cpu(device, rows: int, cols: int, num_rounds: int = 20,
                      num_trees: int = 5, families=FAMILIES) -> dict:
    """The same small search on ``device`` (float32 on a card) and on the
    CPU (float64), the forests' draws from the same CPU generators:
    metric matrices within AGREE_TOL, same winner unless the CPU's top
    two means lie within AGREE_TOL. Then a LinearSVC L-BFGS fit on both:
    the same iteration count, coefficients within LBFGS_COEF_TOL and AuPR
    on the rows within AGREE_TOL."""
    X, y = make_data(rows, cols, seed=1)
    card = phase_main(device, X, y, models=small_models(
        device, num_rounds, num_trees, families), tag="agree-card")
    cpu = phase_main("cpu", X, y, models=small_models(
        "cpu", num_rounds, num_trees, families), tag="agree-cpu")
    a, b = np.asarray(card["metric_matrix"]), np.asarray(cpu["metric_matrix"])
    diff = float(np.abs(a - b).max())
    means = np.sort(b.mean(axis=0))[::-1]
    close = len(means) > 1 and means[0] - means[1] < AGREE_TOL
    same = card["winner_index"] == cpu["winner_index"]
    log(f"[agree] max |card - cpu| = {diff:.3e} (tol {AGREE_TOL}); "
        f"winner card {card['winner_index']} cpu {cpu['winner_index']}"
        f"{' (top two within tol)' if close else ''}")
    if diff > AGREE_TOL or not (same or close):
        raise AssertionError("card and CPU searches disagree")
    by_family = {}
    for name in card["families"]:
        cols_f = [i for i, r in enumerate(
            card["selected"].summary.validation_results)
            if r.model_name == name]
        by_family[name] = float(np.abs(a[:, cols_f] - b[:, cols_f]).max())
    log(f"[agree] max |card - cpu| by family: {json.dumps(by_family)}; "
        f"seconds card {card['wall_s']:.2f} cpu {cpu['wall_s']:.2f}")
    (m_card, s_card, it_card), (m_cpu, s_cpu, it_cpu) = (
        lbfgs_fit(where, X, y) for where in (device, "cpu"))
    evaluator = BinaryClassificationEvaluator()
    aupr = [evaluator.evaluate_arrays(y, m.predict_arrays(X)).AuPR
            for m in (m_card, m_cpu)]
    coef_diff = float(np.abs(m_card.coefficients.cpu().numpy()
                             - m_cpu.coefficients.cpu().numpy()).max())
    log(f"[agree] LinearSVC L-BFGS fit at {rows} rows: card {s_card:.3f} s "
        f"{it_card} iterations, cpu {s_cpu:.3f} s {it_cpu} iterations; "
        f"max |coef diff| {coef_diff:.3e}; AuPR card {aupr[0]:.6f} cpu "
        f"{aupr[1]:.6f}")
    if (it_card != it_cpu or coef_diff > LBFGS_COEF_TOL
            or abs(aupr[0] - aupr[1]) > AGREE_TOL):
        raise AssertionError(
            f"card and CPU L-BFGS fits disagree: iterations {it_card} vs "
            f"{it_cpu} (must be equal), max |coef diff| {coef_diff:.3e} "
            f"(tol {LBFGS_COEF_TOL}), AuPR {aupr[0]} vs {aupr[1]}")
    return {"max_abs_diff": diff, "same_winner": same,
            "max_abs_diff_by_family": by_family,
            "card_s": card["wall_s"], "cpu_s": cpu["wall_s"],
            "lbfgs": {"card_s": s_card, "cpu_s": s_cpu,
                      "card_iterations": it_card,
                      "cpu_iterations": it_cpu, "max_coef_diff": coef_diff,
                      "aupr_card": aupr[0], "aupr_cpu": aupr[1]}}


@contextlib.contextmanager
def iterations_of(solver: str):
    """Record the iteration counts (the second result) of every call the
    linear models make to ``solver`` ("fista_minimize": a tensor per call,
    read only after the run; "lbfgs_minimize": an int)."""
    seen = []
    real = getattr(linear, solver)

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1])
        return out
    setattr(linear, solver, recorded)
    try:
        yield seen
    finally:
        setattr(linear, solver, real)


def lbfgs_fit(device, X: np.ndarray, y: np.ndarray, reg: float = 0.01):
    """A LinearSVC(reg_param=reg) fit, which runs L-BFGS: (model, seconds
    to the read-back of its coefficients, L-BFGS iterations)."""
    with iterations_of("lbfgs_minimize") as counts:
        t0 = time.perf_counter()
        model = LinearSVC(reg_param=reg, max_iter=50,
                          device=resolve_device(device)).fit_arrays(X, y)
        seconds = time.perf_counter() - t0
    return model, seconds, counts[0]


def phase_lbfgs(device, X: np.ndarray, y: np.ndarray) -> tuple:
    """The LinearSVC L-BFGS fit on the main path's rows: seconds,
    iterations, and a sane AuPR on the rows. Returns (record, model)."""
    model, seconds, iters = lbfgs_fit(device, X, y)
    coef = model.coefficients.cpu().numpy()
    aupr = BinaryClassificationEvaluator().evaluate_arrays(
        y, model.predict_arrays(X)).AuPR
    if not (np.all(np.isfinite(coef)) and 0.5 < aupr <= 1.0):
        raise AssertionError(f"[lbfgs] bad LinearSVC fit: AuPR {aupr}")
    log(f"[lbfgs] LinearSVC(reg_param=0.01) fit on {X.shape[0]}x"
        f"{X.shape[1]}: {seconds:.3f} s, {iters} L-BFGS iterations "
        f"({seconds / iters * 1e3:.2f} ms each); AuPR on the rows "
        f"{aupr:.6f}")
    return {"seconds": seconds, "iterations": iters, "aupr": aupr}, model


def phase_linear_ops(device, X: np.ndarray, y: np.ndarray) -> dict:
    """The linear search's two products per solver iteration, X @ V (n,
    C) and X^T @ R (d, C), at its shapes (C = 3 folds x the family's
    grid), and one whole closed-form gradient, each against its bound:
    every input read once and the output written once at the card's
    memory rate, or 2 n d C float32 operations at its peak."""
    masks, _, _, _ = fold_arrays(X, y)
    design = linear._prep(X, masks, True, resolve_device(device))
    Xc = design.Xc
    n, d = Xc.shape
    y_t = torch.as_tensor(y, dtype=Xc.dtype, device=Xc.device)
    gen = torch.Generator(device=Xc.device)
    gen.manual_seed(2)
    out = {}
    for family, G in (("LogisticRegression", 8), ("LinearSVC", 4)):
        C = 3 * G
        V = torch.randn((d, C), generator=gen, device=Xc.device)
        R = torch.randn((n, C), generator=gen, device=Xc.device)
        Z = torch.randn((C, d + 1), generator=gen, device=Xc.device) * 0.1
        kind = "logistic" if family == "LogisticRegression" else "svc"
        _, grad = linear._objective(kind, design, y_t,
                                    torch.full((C,), 0.01,
                                               device=Xc.device), True)
        rec = {"C": C, "n": n, "d": d}
        for op, fn, nbytes in (
                ("X@V", lambda: Xc @ V, 4 * (n * d + d * C + n * C)),
                ("X^T@R", lambda: Xc.T @ R, 4 * (n * d + n * C + d * C)),
                ("gradient", lambda: grad(Z),
                 4 * (n * d + 4 * n + 2 * C * (d + 1)))):
            ms = cuda_ms(fn, 20)
            flops = 2 * n * d * C * (2 if op == "gradient" else 1)
            bound = max(nbytes / PEAK_BYTES_PER_S,
                        flops / PEAK_F32_OPS_PER_S) * 1e3
            rec[op] = {"ms": ms, "bound_ms": bound,
                       "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                                    >= flops / PEAK_F32_OPS_PER_S
                                    else "operations")}
            log(f"[linear] {family} C={C} n={n} d={d} {op}: ms={ms:.4f} "
                f"bound_ms={bound:.4f} ({rec[op]['bound_by']})")
        out[family] = rec
    del design, Xc
    return out


def phase_serve(selected, X: np.ndarray, count: int = 8,
                tag: str = "serve") -> float:
    """Score ``count`` records one at a time through a fitted model; they
    must equal the batch scores (probabilities within 1e-6: the card may
    sum the trees, or a product, in another order at another batch
    width; a model without probabilities, LinearSVC, by its raw margins
    within 1e-5)."""
    batch = selected.predict_arrays(X[:count])
    scores = "probability" if batch.probability.shape[1] else "raw_prediction"
    tol = 1e-6 if scores == "probability" else 1e-5
    worst = 0.0
    for i in range(count):
        one = selected.predict_arrays(X[i:i + 1])
        if one.data[0] != batch.data[i]:
            raise AssertionError(f"record {i}: label {one.data[0]} vs "
                                 f"batch {batch.data[i]}")
        worst = max(worst, float(np.abs(getattr(one, scores)[0]
                                        - getattr(batch, scores)[i]).max()))
    if worst > tol:
        raise AssertionError(f"single-record scores differ from batch "
                             f"scores by {worst}")
    log(f"[{tag}] {count} single records equal the batch "
        f"(max {scores} diff {worst:.2e})")
    return worst


def count_syncs(loop) -> int:
    """Host synchronizations that ``loop()`` asks of the card, as CUDA's
    sync debug mode reports them; the tree loops are written to need
    none."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def tree_loop(est, X: np.ndarray, y: np.ndarray):
    """The fit's tree loop alone, on a binned design: every boosting round
    of a GBT, every tree of a forest (binning and the model's read-back
    excluded)."""
    from transmogrifai_tpu_torch.models.trees import (
        _design_args, _forest_setup, _forest_trees, _gbt_body)
    if isinstance(est, GBTClassifier):
        design = _design_args(X, est.max_bins, est.device)
        y_t = torch.as_tensor(y, dtype=design.dtype, device=est.device)
        return lambda: _gbt_body(design, y_t, torch.ones_like(y_t),
                                 **est._fit_kwargs())
    design, onehot, pool, mf, draws = _forest_setup(est, X, y, est.device)
    lane = (torch.ones(design.n, dtype=design.dtype, device=est.device),
            float(est.min_instances_per_node), float(est.min_info_gain),
            float(est.subsampling_rate))
    return lambda: list(_forest_trees(
        design, onehot, [lane], draws, kind=est.kind, depth=est.max_depth,
        num_trees=est.num_trees, impurity=est.impurity,
        bootstrap=est.bootstrap, max_features=mf, pool=pool))


def fold_arrays(X: np.ndarray, y: np.ndarray):
    """(masks, spec, X_val, y_val) of the main path's 3 stratified folds
    over the whole matrix."""
    return CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                           seed=42, stratify=True)._build_fold_arrays(X, y)


def search_rows(X: np.ndarray, y: np.ndarray):
    """(X, y) of the rows the main path's search runs on: the training
    part of its stratified 90/10 holdout split, as the selector prepares
    it."""
    splitter = DataBalancer(reserve_test_fraction=0.1, seed=42)
    train_idx, _ = splitter.split(y)
    idx = splitter.prepare(y[train_idx])
    return X[train_idx][idx], y[train_idx][idx]


def search_slice(device, X: np.ndarray, y: np.ndarray, num_trees: int = 5,
                 depth: int = 12, points=None):
    """One static group of the main path's RF search (its ``depth`` grid
    points, or the first ``points`` of them, 3 stratified folds of the
    whole matrix), cut to ``num_trees`` trees: a callable that runs it
    and returns its metric matrix."""
    masks, spec, X_val, y_val = fold_arrays(X, y)
    rf, grid = next((e, g) for e, g in default_binary_models(device)
                    if isinstance(e, RandomForestClassifier))
    est = rf.with_params(num_trees=num_trees)
    grid = [p for p in grid if p["max_depth"] == depth][:points]
    return lambda: est.eval_fold_grid_arrays(X, y, masks, grid, X_val,
                                             y_val, spec)


def linear_search(device, X: np.ndarray, y: np.ndarray,
                  family: str = "LogisticRegression", max_iter=None):
    """The main path's search of one linear family (its default grid, 3
    stratified folds of the whole matrix; 5 * ``max_iter`` FISTA
    iterations, the pool's when None): a callable that runs it and
    returns its metric matrix."""
    masks, spec, X_val, y_val = fold_arrays(X, y)
    est, grid = next((e, g) for e, g in default_binary_models(device)
                     if type(e).__name__ == family)
    if max_iter is not None:
        est = est.with_params(max_iter=max_iter)
    return lambda: est.eval_fold_grid_arrays(X, y, masks, grid, X_val,
                                             y_val, spec)


def profiled_estimators(device, num_rounds: int = 20, num_trees: int = 50):
    """The single fits the profile windows time and whose models then
    score single records: a depth-6 GBT and a depth-6 forest."""
    return (GBTClassifier(num_rounds=num_rounds, max_depth=6, device=device),
            RandomForestClassifier(num_trees=num_trees, max_depth=6,
                                   device=device))


def phase_fista_profile(device, X: np.ndarray, y: np.ndarray,
                        max_iter: int = 50, fewer: int = 40) -> dict:
    """The LogisticRegression search under the profiler at the pool's
    5 * ``max_iter`` FISTA iterations and at 5 * ``fewer``: the
    differences over the 5 * (max_iter - fewer) iterations between them
    are FISTA's own device ops and device time an iteration, without the
    search's fixed work (upload, statistics, power iteration, metrics)."""
    full, _ = phase_profile(
        f"LogisticRegression search (8 points x 3 folds, {5 * max_iter} "
        f"FISTA iterations)", linear_search(device, X, y, max_iter=max_iter),
        cross_check=True)
    short, _ = phase_profile(
        f"LogisticRegression search at {5 * fewer} FISTA iterations",
        linear_search(device, X, y, max_iter=fewer))
    iters = 5 * (max_iter - fewer)
    full["device_ops_per_fista_iteration"] = (
        full["kernel_launches"] - short["kernel_launches"]) / iters
    full["device_ms_per_fista_iteration"] = (
        full["device_busy_ms"] - short["device_busy_ms"]) / iters
    full["wall_ms_per_fista_iteration"] = (
        full["wall_ms"] - short["wall_ms"]) / iters
    full["at_fewer_iterations"] = short
    log(f"[profile]   per FISTA iteration (the difference of the two "
        f"windows over {iters} iterations): "
        f"{full['device_ops_per_fista_iteration']:.2f} device ops, device "
        f"busy {full['device_ms_per_fista_iteration']:.4f} ms, wall "
        f"{full['wall_ms_per_fista_iteration']:.4f} ms")
    return full


def device_events(prof) -> list:
    """(name, microseconds) of every device event (kernels, copies, sets)
    of a finished torch.profiler window, read from its raw results:
    ``prof.events()`` builds a FunctionEvent tree of every host and device
    event first, about 60 us an event on a host CPU, and a search's window
    holds hundreds of thousands."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def phase_profile(label: str, run, loop=None, cross_check: bool = False
                  ) -> tuple:
    """``run()`` under torch.profiler after one warm-up run: kernel time
    over wall and the top device ops (``device_events``; with
    ``cross_check``, also through ``prof.events()``, which must give the
    same count and time); with ``loop`` (a function of no arguments, made
    after the warm-up), the host syncs it asks for. Returns the
    measurements and the profiled run's result."""
    from torch.profiler import ProfilerActivity, profile
    run()                                      # bins and warms
    torch.cuda.synchronize()
    syncs = count_syncs(loop()) if loop is not None else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device time = the kernels (and copies) the CUDA activity recorded;
    # the CPU op rows of key_averages() repeat their kernels' time
    t_read = time.perf_counter()
    stop_s = t_read - t0 - wall_us / 1e6
    kernels = device_events(prof)
    busy_us = sum(us for _, us in kernels)
    read_s = time.perf_counter() - t_read
    parse_s = None
    if cross_check:
        from torch.autograd import DeviceType
        t_parse = time.perf_counter()
        parsed = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        parse_s = time.perf_counter() - t_parse
        busy_parsed = sum(e.time_range.elapsed_us() for e in parsed)
        if len(parsed) != len(kernels) or \
                abs(busy_parsed - busy_us) > 1e-6 * max(busy_us, 1.0):
            raise AssertionError(
                f"[profile] raw device events ({len(kernels)}, {busy_us} "
                f"us) differ from prof.events() ({len(parsed)}, "
                f"{busy_parsed} us)")
    by_name: dict = {}
    for name, us in kernels:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"run": label, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "idle_share": (1.0 - busy_us / wall_us) if busy_us else None,
           "kernel_launches": len(kernels), "host_syncs_in_loop": syncs,
           "profiler_stop_s": stop_s, "events_read_s": read_s,
           "events_parse_s": parse_s,
           "top": [(name[:60], t / 1e3, c) for name, (t, c) in top]}
    log(f"[profile] {label}: wall {out['wall_ms']:.1f} "
        f"ms, device busy {out['device_busy_ms']:.1f} ms, idle share "
        f"{out['idle_share'] if busy_us else 'not measured'}; "
        f"{len(kernels)} device ops"
        + ("" if syncs is None else f"; host syncs inside the tree loop: "
           f"{syncs}") + f"; profiler stop {stop_s:.2f} s, events read "
        f"{read_s:.2f} s" + ("" if parse_s is None else
                             f" (prof.events() {parse_s:.2f} s)"))
    for key, ms, count in out["top"]:
        log(f"[profile]   {ms:9.2f} ms  x{count:<6d} {key}")
    return out, result


_NUMBER = re.compile(rb"[0-9.]+")


def memcpy_window(trace) -> dict:
    """Copies and device time of a torch.profiler window over the card,
    read from its exported Chrome trace (bytes or an mmap; the profiler
    gives a copy's bytes only there): bytes copied device to host and host
    to device, their counts, and the summed time of every device event
    (kernels, copies, sets). Scans with ``find`` rather than a regex: a
    search's trace holds millions of events."""
    out = {"dtoh_bytes": 0, "htod_bytes": 0, "dtoh_copies": 0,
           "htod_copies": 0, "device_busy_ms": 0.0}
    for cat in (b'"cat": "kernel"', b'"cat": "gpu_memcpy"',
                b'"cat": "gpu_memset"'):
        i = trace.find(cat)
        while i >= 0:
            j = trace.find(b'"dur": ', i) + len(b'"dur": ')
            out["device_busy_ms"] += float(_NUMBER.match(trace, j).group())
            i = trace.find(cat, j)
    out["device_busy_ms"] /= 1e3
    name = b'"name": "Memcpy '
    i = trace.find(name)
    while i >= 0:
        kind = bytes(trace[i + len(name):i + len(name) + 4]).decode().lower()
        nxt = trace.find(name, i + 1)
        at = trace.find(b'"bytes": ', i)
        if kind in ("dtoh", "htod"):
            if at < 0 or trace.find(b'"ph"', i, at) >= 0:
                raise AssertionError("a copy in the profiler's trace has "
                                     "no bytes")
            out[f"{kind}_bytes"] += int(
                _NUMBER.match(trace, at + len(b'"bytes": ')).group())
            out[f"{kind}_copies"] += 1
        i = nxt
    return out


def profiled(run, seen: dict):
    """``run()`` under torch.profiler (CUDA activity): records its wall
    time, the copies and device time of the window (``memcpy_window``)
    and the seconds the profiler's stop and the trace read took. Returns
    what ``run`` returns."""
    import mmap
    import tempfile
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
        seen["wall_ms"] = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        seen["trace_bytes"] = os.path.getsize(path)
        with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0,
                                               access=mmap.ACCESS_READ) as mm:
            seen.update(memcpy_window(mm))
    seen["profiler_stop_s"] = t1 - t0 - seen["wall_ms"] / 1e3
    seen["trace_read_s"] = time.perf_counter() - t1
    seen["idle_share"] = 1.0 - seen["device_busy_ms"] / seen["wall_ms"]
    return result


def spy_fit_columns(selector, seen: dict, profile: bool) -> None:
    """Wrap ``selector.fit_columns`` (the workflow's call into the search)
    to record the feature matrix it receives and, with ``profile`` on a
    card, the copies and device time of the call under torch.profiler
    (``profiled``)."""
    real = selector.fit_columns

    def spied(cols):
        X = cols[1].data
        seen["is_tensor"] = isinstance(X, torch.Tensor)
        seen["device"] = str(X.device) if seen["is_tensor"] else "host"
        seen["matrix_bytes"] = X.element_size() * X.numel() \
            if seen["is_tensor"] else X.nbytes
        if not (profile and seen["is_tensor"] and X.device.type == "cuda"):
            return real(cols)
        return profiled(lambda: real(cols), seen)
    selector.fit_columns = spied


def phase_workflow(device, rows: int, models=None, tag: str = "workflow",
                   profile: bool = True, seed: int = 42) -> dict:
    """The Titanic workflow (``transmogrifai_tpu_torch/examples/
    titanic.py``: typed features, transmogrify, the selector over
    ``models``, default: the whole default pool, under 3-fold stratified
    CV) on ``rows`` synthetic Titanic-shaped records: stratified 75/25
    split, ``Workflow.train`` on ``device``, ``score_and_evaluate`` of the
    holdout. Fails unless the selector received the prepared matrix as a
    tensor on ``device`` and, profiled on a card, the bytes ``fit_columns``
    copied to the host stay below the matrix's own size; on a card the
    tree families must launch K1."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    records = titanic.synthetic_titanic(rows, seed=seed)
    gen_s = time.perf_counter() - t0
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, models=models, device=dev)
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families)
    seen: dict = {}
    spy_fit_columns(sel, seen, profile)
    clear_design_cache()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    listener = WorkflowListener()
    validator.reset_family_profile()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    run = titanic.run(records, device=dev, model_stage=sel,
                      listener=listener)
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    family_prof = validator.family_profile()
    mxf = models_x_folds(run.model)
    wf, plan = run.workflow, run.workflow.last_prepare_plan
    X = run.model.train_dataset[run.vector.name].data
    selected = next(s for s in run.model.stages()
                    if type(s).__name__ == "SelectedModel")
    s = selected.summary
    mm = metric_matrix(selected)
    search_label = next(k for k in plan.fit_seconds
                        if k.startswith("ModelSelector("))
    fits = {k: v for k, v in plan.fit_seconds.items() if k != search_label}
    out = {"rows": rows, "generate_s": gen_s,
           "train_rows": int(X.shape[0]), "matrix_shape": list(X.shape),
           "matrix_dtype": str(X.dtype), "matrix_device": str(X.device),
           "raw_extraction_s": wf.last_train_seconds["raw_extraction"],
           "vectorizer_fits_s": sum(fits.values()),
           "device_transforms_s": plan.device_transform_seconds,
           "host_stage_transforms_s": plan.host_transform_seconds,
           "bytes_to_device": plan.bytes_to_device,
           "search_s": plan.fit_seconds[search_label],
           "train_s": sum(wf.last_train_seconds.values()),
           "train_score_evaluate_s": run.seconds,
           "selector_timings_s": dict(s.timings), "families": families,
           "k1_launches": launches, "k1_launches_by_c": by_c,
           "winner": s.best_model_name, "winner_params": s.best_model_params,
           "winner_index": int(np.argmax(mm.mean(axis=0))),
           "best_metric": s.best_validation_metric,
           "holdout_AuPR": run.metrics.AuPR,
           "holdout_AuROC": run.metrics.AuROC,
           "metric_matrix": mm.tolist(), "fit_columns": seen,
           "host_stages": [list(f) for f in plan.coverage.fallback],
           "device_stages": len(plan.coverage.lowered),
           "fit_placements": [list(p) for p in plan.fit_placements],
           "models_x_folds": mxf, "family_profile": family_prof,
           "stage_profile": [m.to_json() for m in sorted(
               listener.metrics.stage_metrics, key=lambda m: -m.seconds)[:3]],
           "holdout_records": titanic.stratified_split(records)[1],
           "run": run}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {rows} records generated in {gen_s:.2f} s; train "
        f"{out['train_rows']}, holdout {run.scored.n_rows}; prepared matrix "
        f"{tuple(X.shape)} {X.dtype} on {X.device}")
    log(f"[{tag}] seconds: raw extraction {out['raw_extraction_s']:.3f}, "
        f"vectorizer fits {out['vectorizer_fits_s']:.3f}, device transforms "
        f"{out['device_transforms_s']:.3f}, host-stage transforms "
        f"{out['host_stage_transforms_s']:.3f}, search (selector fit) "
        f"{out['search_s']:.3f}; train {out['train_s']:.3f}, train + score "
        f"+ evaluate {run.seconds:.3f}; {plan.bytes_to_device} bytes of host "
        f"columns copied up")
    for label, why in plan.coverage.fallback:
        log(f"[{tag}] host stage {label.split('(')[0]}: {why}")
    log(f"[{tag}] {len(plan.coverage.lowered)} stages on {dev}; selector "
        f"stages {json.dumps({k: round(v, 3) for k, v in s.timings.items()})}")
    for name, rec in families.items():
        log(f"[{tag}] {name}: {rec['candidates']} models x folds in "
            f"{rec['seconds']:.2f} s; K1 launches {rec['k1_launches']}: "
            + " ".join(f"C={c}:{k}"
                       for c, k in rec["k1_launches_by_c"].items()))
    log(f"[{tag}] winner {s.best_model_name} {s.best_model_params} mean AuPR "
        f"{s.best_validation_metric:.6f}; holdout AuPR {run.metrics.AuPR:.6f}"
        f" AuROC {run.metrics.AuROC:.6f}; K1 launches {launches}"
        + (f"; max_memory_allocated {out['max_memory_allocated']}"
           if "max_memory_allocated" in out else ""))
    log(f"[{tag}] fit_columns received "
        + json.dumps({k: v for k, v in seen.items()}))
    log(f"[{tag}] listener, top 3 stages:\n"
        + listener.metrics.profile_pretty(top=3))
    log(f"[{tag}] models x folds {mxf}; family profile (validator) vs the "
        f"smoke's own seconds: " + "; ".join(
            f"{r['family']} {r['seconds']:.2f} s / {r['calls']} calls vs "
            f"{families.get(r['family'], {}).get('seconds', float('nan')):.2f}"
            f" s" for r in family_prof))
    G = len(s.validation_results)
    if mxf != 3 * G:
        raise AssertionError(f"[{tag}] models x folds {mxf}, expected "
                             f"{3 * G}")
    if models is None and mxf != 144:
        raise AssertionError(f"[{tag}] the default pool gave {mxf} models "
                             f"x folds, not 144")
    if sorted(r["family"] for r in family_prof) != sorted(families) or \
            any(r["calls"] < 1 for r in family_prof):
        raise AssertionError(f"[{tag}] family profile {family_prof} does "
                             f"not list every family of {sorted(families)}")
    if not listener.metrics.stage_metrics or \
            listener.metrics.end_time is None:
        raise AssertionError(f"[{tag}] the listener saw no stages")
    if mm.shape != (3, G) or not np.all(np.isfinite(mm)):
        raise AssertionError(f"[{tag}] bad metric matrix {mm}")
    if not (seen.get("is_tensor") and seen["device"] == str(X.device)
            and X.device.type == dev.type):
        raise AssertionError(f"[{tag}] the selector did not receive the "
                             f"prepared matrix as a tensor on {dev}: {seen}")
    if "dtoh_bytes" in seen and seen["dtoh_bytes"] >= seen["matrix_bytes"]:
        raise AssertionError(f"[{tag}] fit_columns copied {seen['dtoh_bytes']}"
                             f" bytes to the host, not below the matrix's "
                             f"{seen['matrix_bytes']}")
    if dev.type == "cuda":
        idle = [f for f, rec in families.items()
                if f in TREE_FAMILIES and rec["k1_launches"] == 0]
        if launches == 0 or idle:
            raise AssertionError(
                f"[{tag}] K1 never launched by {idle or 'the workflow'}")
    if not 0.5 < run.metrics.AuROC <= 1.0:
        raise AssertionError(f"[{tag}] holdout evaluation is off: "
                             f"{run.metrics}")
    return out


#: served rows on the card against ``model.score`` on the card
SERVE_SCORE_TOL = 1e-6
#: the same saved linear model served on the card (float32) and on the CPU
#: (float64 copies of the saved float32 arrays)
SERVE_CPU_TOL = 1e-5


def _serve_all(score_fn, records, name: str, dev: torch.device):
    """Serve ``records`` one at a time; returns (rows, ms per record), each
    call on a card synchronized so its time includes the card's work."""
    rows, ms = [], []
    for rec in records:
        t0 = time.perf_counter()
        row = score_fn(dict(rec))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(row[name])
    return rows, np.asarray(ms)


def _max_gap(rows_a, rows_b) -> float:
    """Largest absolute difference over every key of two lists of served
    prediction dicts (which must have the same keys)."""
    worst = 0.0
    for a, b in zip(rows_a, rows_b):
        if set(a) != set(b):
            raise AssertionError(f"served keys differ: {sorted(a)} vs "
                                 f"{sorted(b)}")
        worst = max(worst, max(abs(a[k] - b[k]) for k in a))
    return worst


def phase_serve_saved(run, holdout_records) -> dict:
    """[serve-saved]: phase 8's fitted workflow model saved to a temporary
    directory, reloaded through ``load_score_function`` on the workflow's
    device (the card), and
    ``SAMPLE_PASSENGER`` and ``holdout_records`` served one at a time.
    Fails unless the served holdout rows equal the model's batch
    ``score`` rows within SERVE_SCORE_TOL, the model stage's
    ``raw_arrays`` ran on CUDA tensors for every record, a CPU reload
    serves the same records within SERVE_CPU_TOL of the card (a linear
    winner; a tree winner may route a row near a threshold otherwise in
    float32, and must agree on 99 % of the records), a re-save over the
    directory leaves one intact model, and K1 never launches."""
    import shutil
    import tempfile
    model = run.model
    dev = run.workflow.device
    name = run.prediction.name
    records = [titanic.SAMPLE_PASSENGER] + list(holdout_records)
    level_hist.launches = 0
    out = {"records": len(records)}
    tmp = tempfile.mkdtemp(prefix="serve_saved_")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        out["save_s"] = time.perf_counter() - t0
        out["op_model_json_bytes"] = os.path.getsize(
            os.path.join(path, "op-model.json"))
        out["arrays_npz_bytes"] = os.path.getsize(
            os.path.join(path, "arrays.npz"))
        t0 = time.perf_counter()
        card_fn = load_score_function(path, device=dev)
        out["load_s"] = time.perf_counter() - t0
        selected = next(st for st in card_fn.model.stages()
                        if type(st).__name__ == "SelectedModel")
        inner = selected.inner
        out["winner"] = type(inner).__name__
        seen = collections.Counter()
        real_raw = inner.raw_arrays

        def spy(X):
            seen[X.device.type] += 1
            return real_raw(X)
        inner.raw_arrays = spy
        card_rows, ms = _serve_all(card_fn, records, name, dev)
        inner.raw_arrays = real_raw
        out.update(ms_p50=float(np.percentile(ms, 50)),
                   ms_p99=float(np.percentile(ms, 99)),
                   ms_mean=float(ms.mean()), ms_first=float(ms[0]),
                   ms_max=float(ms.max()), raw_arrays_devices=dict(seen))
        scored = model.score(holdout_records)[name]
        batch = [dict(scored.boxed(i).value)
                 for i in range(len(holdout_records))]
        out["max_abs_diff_vs_score"] = _max_gap(card_rows[1:], batch)
        t0 = time.perf_counter()
        cpu_fn = load_score_function(path, device="cpu")
        out["load_cpu_s"] = time.perf_counter() - t0
        cpu_rows, cpu_ms = _serve_all(cpu_fn, records, name,
                                      torch.device("cpu"))
        out["cpu_ms_mean"] = float(cpu_ms.mean())
        gaps = np.array([abs(a["probability_1"] - b["probability_1"])
                         for a, b in zip(card_rows, cpu_rows)])
        out["max_abs_prob_diff_cpu"] = float(gaps.max())
        out["share_within_cpu_tol"] = float(np.mean(gaps <= SERVE_CPU_TOL))
        t0 = time.perf_counter()
        card_fn.model.save(path)
        out["resave_s"] = time.perf_counter() - t0
        leftovers = sorted(p for p in os.listdir(tmp) if p != "model")
        again = load_score_function(path, device=dev)(
            dict(titanic.SAMPLE_PASSENGER))[name]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["k1_launches"] = level_hist.launches
    log(f"[serve-saved] saved in {out['save_s']:.3f} s "
        f"(op-model.json {out['op_model_json_bytes']} bytes, arrays.npz "
        f"{out['arrays_npz_bytes']} bytes); loaded on {dev} in "
        f"{out['load_s']:.3f} s, on cpu in {out['load_cpu_s']:.3f} s; "
        f"winner {out['winner']}")
    log(f"[serve-saved] {len(records)} records one at a time on {dev}: p50 "
        f"{out['ms_p50']:.3f} ms, p99 {out['ms_p99']:.3f} ms, mean "
        f"{out['ms_mean']:.3f} ms a record, first {out['ms_first']:.3f} ms, "
        f"max {out['ms_max']:.3f} ms (cpu reload: mean "
        f"{out['cpu_ms_mean']:.3f} ms); P(survived) of SAMPLE_PASSENGER "
        f"{card_rows[0]['probability_1']:.6f}")
    log(f"[serve-saved] max |served - model.score| {out['max_abs_diff_vs_score']:.3e}"
        f" (tol {SERVE_SCORE_TOL}); max |card - cpu reload| P(survived) "
        f"{out['max_abs_prob_diff_cpu']:.3e} (tol {SERVE_CPU_TOL}, "
        f"{100 * out['share_within_cpu_tol']:.1f} % within); raw_arrays "
        f"calls by device {json.dumps(out['raw_arrays_devices'])}; re-saved "
        f"in {out['resave_s']:.3f} s, leftovers {leftovers}; K1 launches "
        f"{out['k1_launches']}")
    if out["max_abs_diff_vs_score"] > SERVE_SCORE_TOL:
        raise AssertionError("[serve-saved] served rows differ from "
                             "model.score")
    if seen.get(dev.type, 0) != len(records) or set(seen) != {dev.type}:
        raise AssertionError(f"[serve-saved] raw_arrays ran on {dict(seen)}"
                             f", not once a record on {dev.type}")
    linear = out["winner"] in ("LogisticRegressionModel", "LinearSVCModel")
    if (linear and out["max_abs_prob_diff_cpu"] > SERVE_CPU_TOL) or \
            out["share_within_cpu_tol"] < 0.99:
        raise AssertionError("[serve-saved] the CPU reload serves other "
                             "probabilities than the card")
    if leftovers or _max_gap([again], card_rows[:1]) > 0.0:
        raise AssertionError(f"[serve-saved] re-save left {leftovers} or "
                             f"served another row")
    if out["k1_launches"]:
        raise AssertionError("[serve-saved] the serve path launched K1")
    return out


#: compiled plan on the card against the columnar path on the card
COMPILED_SCORE_TOL = 1e-6
#: a CPU plan over a CPU reload against the card's plan (a linear winner)
COMPILED_CPU_TOL = 1e-5
#: float32 ulps a bucket's graph replay may differ from an eager run of
#: the same composed program on the card
GRAPH_EAGER_MAX_ULP = 0
#: requests of the traced drive that splits a request's time by span
TRACED_REQUESTS = 2000


def _prob(scored, name: str) -> np.ndarray:
    return np.asarray(scored[name].probability, dtype=np.float64)


def _f32_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps between two arrays of float32
    values (held as float64)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _margin_order_ulps(X, model, sizes=(8, 64, 256, 2048, 8192)) -> dict:
    """Worst float32 ulps between the margins of 8 rows of ``X`` scored
    alone and the same rows placed at other offsets of batches of other
    sizes, and each row scored as a batch of one (a served record): for
    ``X @ w`` (the card's BLAS picks its kernel by shape) and for the
    linear ``model``'s ``raw_arrays`` (its products added in feature
    order)."""
    forms = {"matmul": lambda A: A @ model.coefficients + model.intercept,
             "raw_arrays": lambda A: model.raw_arrays(A)[:, 1]}
    rows = X[:8]
    out = {}
    for name, f in forms.items():
        base = f(rows).double().cpu().numpy()
        alone = np.concatenate([f(rows[i:i + 1]).double().cpu().numpy()
                                for i in range(8)])
        worst = _f32_ulps(alone, base)
        for n in sizes:
            n = min(n, X.shape[0])
            for off in sorted(o for o in {0, 1, 3, n - 8} if o + 8 <= n):
                A = X[:n].clone()
                A[off:off + 8] = rows
                got = f(A)[off:off + 8].double().cpu().numpy()
                worst = max(worst, _f32_ulps(got, base))
        out[name] = worst
    return out


def _drive_server(client, records, threads: int):
    """``records`` submitted by ``threads`` concurrent submitter threads,
    one blocking request each; returns (answers in record order, ms a
    request, wall seconds)."""
    import threading
    answers = [None] * len(records)
    ms = np.zeros(len(records))
    order = iter(range(len(records)))
    lock = threading.Lock()
    errors = []

    def submitter():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                answers[i] = client.score(dict(records[i]), timeout=120.0)
            except Exception as e:          # surfaced after the join
                errors.append(e)
                return
            ms[i] = (time.perf_counter() - t0) * 1e3

    workers = [threading.Thread(target=submitter, name=f"submit-{k}")
               for k in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(w.is_alive() for w in workers):
        raise AssertionError(f"[serve-compiled] submitters failed: "
                             f"{errors[:3]}")
    return answers, ms, wall


def _tree_stage(device, est, records, tag: str) -> dict:
    """A Titanic workflow on ``records`` with the fixed model stage
    ``est``, its holdout scored through a compiled plan on ``device`` and
    on the columnar path."""
    t0 = time.perf_counter()
    run = titanic.run(records, device=device, model_stage=est)
    train_s = time.perf_counter() - t0
    name = run.prediction.name
    holdout = titanic.stratified_split(records)[1]
    plan = run.model.scoring_plan()
    t0 = time.perf_counter()
    compiled = run.model.score(holdout, engine="compiled")
    compiled_s = time.perf_counter() - t0
    columnar = run.model.score(holdout)
    gap = float(np.abs(_prob(compiled, name) - _prob(columnar, name)).max())
    flips = int((compiled[name].data != columnar[name].data).sum())
    out = {"stage": type(est).__name__, "train_s": train_s,
           "holdout": len(holdout), "compiled_s": compiled_s,
           "captured_buckets": sorted(plan.capture_seconds),
           "capture_s": dict(plan.capture_seconds),
           "max_abs_diff_vs_columnar": gap, "prediction_flips": flips,
           "lowered": len(plan.coverage.lowered), "_model": run.model}
    log(f"[serve-compiled] {tag}: {out['stage']} trained on "
        f"{len(records) - len(holdout)} rows in {train_s:.2f} s; "
        f"{len(holdout)} holdout records compiled in {compiled_s:.3f} s "
        f"(graphs at buckets {out['captured_buckets']}, capture s "
        f"{json.dumps({k: round(v, 3) for k, v in plan.capture_seconds.items()})}"
        f"); max |compiled - columnar| P {gap:.3e} (tol "
        f"{COMPILED_SCORE_TOL}), prediction flips {flips}")
    if gap > COMPILED_SCORE_TOL or flips:
        raise AssertionError(f"[serve-compiled] {tag}: the compiled plan "
                             f"differs from the columnar path")
    return out


def phase_serve_compiled(run, holdout_records, server_records: int = 10_000,
                         threads: int = 64, tree_rows: int = 20_000,
                         tree_models=None) -> dict:
    """[serve-compiled]: phase 8's model saved, reloaded on the workflow's
    device (the card) and frozen into a ScoringPlan: coverage, the
    capture seconds of every bucket up to the server's ``max_batch``; the
    holdout scored with ``score_batch(engine="compiled")`` and
    ``model.score(engine="compiled")`` (records/s, ``bucket_profile``):
    within COMPILED_SCORE_TOL of the columnar path, bitwise equal over
    two runs, one bucket's graph replay equal to an eager run of the same
    program (GRAPH_EAGER_MAX_ULP), a CPU plan over a CPU reload within
    COMPILED_CPU_TOL, and a repeat adding no program. Then the
    in-process server under a default ``ServeConfig()`` (guardrails and
    each tenant's drift sentinel on) answers ``server_records`` holdout
    records, one request each from ``threads`` concurrent submitters:
    requests/s, per-request p50/p99/mean ms, dispatches by kind; no
    program captured in steady state, no host-fallback batch, breaker
    short-circuit or quarantined row, every answer bitwise the offline
    ``score_guarded`` row, and the tenant's sentinel reading ``ok``; the
    same drive without, with, with and without the sentinel for their
    requests/s and p50 (``sentinel_ab``); the
    offline plan's ``drift_report()`` reads ``ok`` on the whole holdout
    (both ``ok`` checks over at least DRIFT_MIN_RECORDS records) and
    ``warn`` or ``degrade`` on it shifted (every ``age`` + 40, ``sex``
    constant). Last, a Titanic workflow on ``tree_rows``
    records with a fixed GBT (depth 6, 20 rounds) and one with a fixed
    50-tree forest, each scored through a compiled plan within
    COMPILED_SCORE_TOL of its columnar score. K1 never launches while
    serving."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.observability import trace
    from transmogrifai_tpu_torch.runtime import telemetry
    from transmogrifai_tpu_torch.serving import (ScoringPlan, ServeConfig,
                                                 plan_compiles,
                                                 serve_in_process)
    from transmogrifai_tpu_torch.workflow.persistence import load_model
    from transmogrifai_tpu_torch.workflow.workflow import _generate_raw_data
    t_phase = time.perf_counter()
    dev = run.workflow.device
    name = run.prediction.name
    records = list(holdout_records)
    level_hist.launches = 0
    out: dict = {"records": len(records)}
    # the saved directory stays until the phase ends: the reloaded
    # model's drift sentinels read their fingerprints there
    tmp = tempfile.mkdtemp(prefix="serve_compiled_")
    try:
        path = os.path.join(tmp, "model")
        run.model.save(path)
        fn = load_score_function(path, device=dev)
        model = fn.model
        cpu_model = load_model(path, device="cpu")

        # -- compile: coverage ------------------------------------------------
        t0 = time.perf_counter()
        plan = model.scoring_plan()
        out["compile_s"] = time.perf_counter() - t0
        desc = plan.describe()
        out["coverage"] = desc["coverage"]
        log(f"[serve-compiled] plan on {plan.device} compiled in "
            f"{out['compile_s']:.3f} s: {desc['device_stages']} device "
            f"stages, "
            f"{desc['fallback_stages']} host stages; host inputs "
            f"{len(desc['host_inputs'])}, buckets {desc['buckets']}")
        for label in desc["coverage"]["lowered"]:
            log(f"[serve-compiled] device stage {label.split('(')[0]}")
        for label, why in desc["coverage"]["fallback"]:
            log(f"[serve-compiled] host stage {label.split('(')[0]}: {why}")

        # -- batch ------------------------------------------------------------
        c0 = plan_compiles()
        t0 = time.perf_counter()
        rows_batch = fn.score_batch(records, engine="compiled")
        out["score_batch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = model.score(records, engine="compiled")
        out["score_compiled_s"] = time.perf_counter() - t0
        c1 = plan_compiles()
        t0 = time.perf_counter()
        again = model.score(records, engine="compiled")
        out["score_compiled_again_s"] = time.perf_counter() - t0
        out["repeat_compiles"] = plan_compiles() - c1
        out["batch_compiles"] = c1 - c0
        t0 = time.perf_counter()
        columnar = model.score(records)
        out["score_columnar_s"] = time.perf_counter() - t0
        p_first, p_again = _prob(first, name), _prob(again, name)
        out["bitwise_repeat"] = bool(
            np.array_equal(p_first, p_again)
            and np.array_equal(first[name].raw_prediction,
                               again[name].raw_prediction))
        out["max_abs_diff_vs_columnar"] = float(
            np.abs(p_first - _prob(columnar, name)).max())
        out["score_batch_gap"] = float(max(
            abs(r[name]["probability_1"] - p) for r, p in
            zip(rows_batch, p_first[:, 1])))
        out["records_per_s"] = len(records) / out["score_compiled_again_s"]
        out["records_per_s_first"] = len(records) / out["score_compiled_s"]
        out["records_per_s_score_batch"] = len(records) / out["score_batch_s"]
        out["records_per_s_columnar"] = len(records) / out["score_columnar_s"]
        out["bucket_profile"] = plan.bucket_profile()
        out["capture_s_batch"] = dict(plan.capture_seconds)
        # one bucket's graph replay against an eager run of the same program
        raw = _generate_raw_data(model.raw_features(), records[:1000],
                                 require_responses=False)
        bucket, inputs, mask, _rows = plan.encode_raw_dataset(raw).chunks[0]
        replayed = plan._run_bucket(bucket, inputs, mask)
        eager = plan.run_eager(inputs, mask)
        out["graph_vs_eager_ulps"] = max(_f32_ulps(a, b)
                                         for a, b in zip(replayed, eager))
        out["graph_vs_eager_bucket"] = bucket
        # a linear winner's margins must not depend on the batch they sit in
        inner = getattr(next((st for st in run.model.stages()
                              if type(st).__name__ == "SelectedModel"), None),
                        "inner", None)
        if hasattr(inner, "coefficients"):
            out["margin_ulps"] = _margin_order_ulps(
                run.model.train_dataset[run.vector.name].data, inner)
            log(f"[serve-compiled] a row's margin across batch sizes and "
                f"offsets, worst float32 ulps: X @ w "
                f"{out['margin_ulps']['matmul']}, raw_arrays (feature order) "
                f"{out['margin_ulps']['raw_arrays']}")
            if out["margin_ulps"]["raw_arrays"]:
                raise AssertionError("[serve-compiled] a linear margin "
                                     "depends on its batch")
        # a CPU plan over a CPU reload
        t0 = time.perf_counter()
        cpu_scored = cpu_model.score(records, engine="compiled")
        out["cpu_compiled_s"] = time.perf_counter() - t0
        out["max_abs_diff_cpu"] = float(
            np.abs(_prob(cpu_scored, name) - p_first).max())
        log(f"[serve-compiled] batch of {len(records)} records: score_batch "
            f"{out['score_batch_s']:.3f} s, model.score(engine='compiled') "
            f"{out['score_compiled_s']:.3f} s then "
            f"{out['score_compiled_again_s']:.3f}"
            f" s ({out['records_per_s']:.0f} records/s warm, "
            f"{out['records_per_s_first']:.0f} first), columnar "
            f"{out['score_columnar_s']:.3f} s "
            f"({out['records_per_s_columnar']:.0f}"
            f" records/s); CPU plan {out['cpu_compiled_s']:.3f} s")
        log(f"[serve-compiled] bucket_profile "
            + json.dumps({b: {k: (round(v, 5) if isinstance(v, float) else v)
                              for k, v in r.items()}
                          for b, r in sorted(out["bucket_profile"].items())}))
        log(f"[serve-compiled] max |compiled - columnar| P "
            f"{out['max_abs_diff_vs_columnar']:.3e} (tol "
            f"{COMPILED_SCORE_TOL}); score_batch vs score "
            f"{out['score_batch_gap']:.3e}; repeat bitwise "
            f"{out['bitwise_repeat']}; bucket {bucket} graph vs eager "
            f"{out['graph_vs_eager_ulps']} ulps (max {GRAPH_EAGER_MAX_ULP}); "
            f"CPU plan vs card {out['max_abs_diff_cpu']:.3e} (tol "
            f"{COMPILED_CPU_TOL}); programs: batch {out['batch_compiles']}, "
            f"repeat {out['repeat_compiles']}")
        if out["max_abs_diff_vs_columnar"] > COMPILED_SCORE_TOL \
                or out["score_batch_gap"] > 0.0:
            raise AssertionError("[serve-compiled] the compiled batch differs "
                                 "from the columnar path")
        if not out["bitwise_repeat"] or out["repeat_compiles"]:
            raise AssertionError("[serve-compiled] a repeated batch "
                                 "changed or added a program")
        if out["graph_vs_eager_ulps"] > GRAPH_EAGER_MAX_ULP:
            raise AssertionError("[serve-compiled] graph replay differs from "
                                 "the eager program")
        if out["max_abs_diff_cpu"] > COMPILED_CPU_TOL:
            raise AssertionError("[serve-compiled] the CPU plan differs from "
                                 "the card's")
        if dev.type == "cuda" and not plan.capture_seconds:
            raise AssertionError("[serve-compiled] no graph was captured")

        # -- server -----------------------------------------------------------
        served = records[:server_records]
        offline_plan = ScoringPlan(model).compile().with_guardrails()
        offline = offline_plan.score_guarded(served).scored[name]
        # the offline plan's default sentinel: the holdout, then a fresh
        # sentinel over the holdout shifted
        offline_plan.score_guarded(records[server_records:])
        out["drift_holdout"] = _drift_summary(offline_plan.drift_report())
        offline_plan.with_guardrails(sentinel=DriftSentinel.for_model(model))
        offline_plan.score_guarded([dict(r, age=(r["age"] or 30.0) + 40.0,
                                         sex="male") for r in served])
        out["drift_shifted"] = _drift_summary(offline_plan.drift_report())
        log(f"[serve-compiled] drift_report() on {len(records)} holdout "
            f"records: {json.dumps(out['drift_holdout'])}; shifted (age + 40, "
            f"sex "
            f"constant): {json.dumps(out['drift_shifted'])}")
        if _drift_misread(out["drift_holdout"]) \
                or out["drift_shifted"]["status"] not in ("warn", "degrade"):
            raise AssertionError("[serve-compiled] the drift sentinel misread "
                                 "the holdout or the shift")
        config = ServeConfig()
        server, client = serve_in_process({"titanic": model}, config,
                                          device=dev)
        try:
            buckets = [b for b in plan.buckets() if b <= config.max_batch]
            t0 = time.perf_counter()
            warmed = server.prewarm(buckets=buckets)["titanic"]
            out["prewarm_s"] = time.perf_counter() - t0
            out["capture_s"] = warmed
            log(f"[serve-compiled] prewarm captured buckets "
                + ", ".join(f"{b}: {s:.3f} s"
                            for b, s in sorted(warmed.items()))
                + f" ({out['prewarm_s']:.2f} s); plan_compiles() "
                f"{plan_compiles()}")
            client.score_many(served[:256])            # warm the loop path
            before = telemetry.counters()
            stats0 = dict(server.stats)
            c0 = plan_compiles()
            answers, ms, wall = _drive_server(client, served, threads)
            after = telemetry.counters()
            desc = server.describe()
            metrics = server.metrics_snapshot()
            lane_drift = metrics["sentinels"]["titanic/default"]
            # where a request's time goes: a shorter traced drive, its spans
            # averaged by name (the server's request segments and the plan's
            # encode and dispatch)
            trace.configure(True)
            trace.reset()
            try:
                _drive_server(client, served[:TRACED_REQUESTS], threads)
                spans = trace.spans()
            finally:
                trace.configure(False)
                trace.reset()
        finally:
            server.stop()
        by_name = collections.defaultdict(list)
        for sp in spans:
            by_name[sp["name"]].append(sp["dur"] * 1e3)
        traced = {k: {"count": len(v), "mean_ms": float(np.mean(v))}
                  for k, v in sorted(by_name.items())}
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in (
            "serving_host_fallback_batches", "serving_breaker_short_circuits",
            "serving_rows_quarantined", "serving_device_failures")}
        batches = desc["batches"] - int(stats0["batches"])
        rows = desc["rows"] - int(stats0["rows"])
        out["server"] = {
            "requests": len(served), "threads": threads, "wall_s": wall,
            "requests_per_s": len(served) / wall,
            "ms_p50": float(np.percentile(ms, 50)),
            "ms_p99": float(np.percentile(ms, 99)),
            "ms_mean": float(ms.mean()), "ms_max": float(ms.max()),
            "batches": batches,
            "mean_rows_per_dispatch": rows / max(batches, 1),
            "full_dispatches": desc["full_dispatches"]
            - int(stats0["full_dispatches"]),
            "deadline_dispatches": desc["deadline_dispatches"]
            - int(stats0["deadline_dispatches"]),
            "orphaned_dispatches": desc["orphaned_dispatches"],
            "dispatch_saturation": desc["dispatch_saturation"],
            "steady_compiles": plan_compiles() - c0, "counters": delta,
            "latency_ms_server": metrics["latency_ms"], "traced": traced}
        mismatched = [i for i, a in enumerate(answers)
                      if "_guard" in a
                      or a[name] != dict(offline.boxed(i).value)]
        out["server"]["mismatched_answers"] = len(mismatched)
        out["server"]["drift"] = {k: lane_drift[k] for k in (
            "status", "rowsSeen", "warnThreshold", "degradeThreshold")}
        # what the sentinel costs: the same drive without and with it, in
        # the order without, with, with, without
        drives = [(on, _server_drive(model, served, threads,
                                     ServeConfig(sentinel=on), dev, buckets))
                  for on in (False, True, True, False)]
        out["sentinel_ab"] = {
            key: [d for on, d in drives if on == want]
            for key, want in (("with", True), ("without", False))}
        out["server_no_sentinel"] = out["sentinel_ab"]["without"][0]
        s = out["server"]
        log(f"[serve-compiled] server: {s['requests']} requests from "
            f"{threads} threads in {wall:.3f} s "
            f"({s['requests_per_s']:.0f} requests/s); "
            f"ms a request p50 {s['ms_p50']:.3f}, p99 {s['ms_p99']:.3f}, mean "
            f"{s['ms_mean']:.3f}, max {s['ms_max']:.3f}; {batches} "
            f"dispatches, "
            f"{s['mean_rows_per_dispatch']:.2f} rows each, full "
            f"{s['full_dispatches']} / deadline {s['deadline_dispatches']}, "
            f"orphaned {s['orphaned_dispatches']}, saturation "
            f"{s['dispatch_saturation']:.3f}; steady-state programs "
            f"{s['steady_compiles']}; counters {json.dumps(delta)}; answers "
            f"not bitwise the offline score_guarded rows: {len(mismatched)}; "
            f"the tenant's sentinel {json.dumps(s['drift'])}")
        ab = out["sentinel_ab"]
        log(f"[serve-compiled] the same {len(served)} requests without, "
            f"with, with and without the sentinel: requests/s with "
            f"{[round(d['requests_per_s']) for d in ab['with']]} without "
            f"{[round(d['requests_per_s']) for d in ab['without']]}; p50 ms "
            f"with {[round(d['ms_p50'], 3) for d in ab['with']]} without "
            f"{[round(d['ms_p50'], 3) for d in ab['without']]}")
        log(f"[serve-compiled] traced {TRACED_REQUESTS} requests, mean ms by "
            f"span: " + ", ".join(f"{k} {v['mean_ms']:.3f} (x{v['count']})"
                                  for k, v in traced.items()))
        if s["steady_compiles"]:
            raise AssertionError("[serve-compiled] the server captured in "
                                 "steady state")
        if any(delta.values()):
            raise AssertionError(f"[serve-compiled] fallback, short-circuit "
                                 f"or quarantine while serving: {delta}")
        if mismatched:
            i = mismatched[0]
            raise AssertionError(
                f"[serve-compiled] {len(mismatched)} answers differ from the "
                f"offline score_guarded rows, e.g. row {i}: {answers[i]} vs "
                f"{dict(offline.boxed(i).value)}")
        if _drift_misread(s["drift"]) \
                or s["drift"]["rowsSeen"] < len(served):
            raise AssertionError(f"[serve-compiled] the server's sentinel "
                                 f"misread the holdout: {s['drift']}")
        out["k1_launches"] = level_hist.launches

        # -- tree stages ------------------------------------------------------
        tree_records = titanic.synthetic_titanic(tree_rows, seed=7)
        gbt, rf = tree_models or (
            GBTClassifier(max_depth=6, num_rounds=20, device=dev),
            RandomForestClassifier(num_trees=50, device=dev))
        out["trees"] = [_tree_stage(dev, gbt, tree_records, "gbt"),
                        _tree_stage(dev, rf, tree_records, "rf")]
        out["seconds"] = time.perf_counter() - t_phase
        log(f"[serve-compiled] K1 launches while serving "
            f"{out['k1_launches']}; phase {out['seconds']:.1f} s")
        if out["k1_launches"]:
            raise AssertionError("[serve-compiled] the serve path launched K1")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



def _server_drive(model, records, threads: int, config, dev,
                  buckets) -> dict:
    """``records`` through an in-process server under ``config``, after
    the same prewarm and warm-up as [serve-compiled]'s: requests/s and
    ms a request."""
    from transmogrifai_tpu_torch.serving import serve_in_process
    server, client = serve_in_process({"titanic": model}, config,
                                      device=dev)
    try:
        server.prewarm(buckets=buckets)
        client.score_many(records[:256])
        _, ms, wall = _drive_server(client, records, threads)
    finally:
        server.stop()
    return {"requests": len(records), "requests_per_s": len(records) / wall,
            "ms_p50": float(np.percentile(ms, 50)),
            "ms_p99": float(np.percentile(ms, 99)),
            "ms_mean": float(ms.mean()), "wall_s": wall}


def phase_serving(wf_run: dict) -> tuple:
    """Phases 8b and 8c on phase 8's model: ``wf_run`` loses its model run
    and holdout records, which its JSON does not hold."""
    run, holdout = wf_run.pop("run"), wf_run.pop("holdout_records")
    serve_saved = phase_serve_saved(run, holdout[:1000])
    return serve_saved, phase_serve_compiled(run, holdout)

def _norm_uid(name):
    return None if name is None else re.sub(r"[0-9a-f]{12}", "UID", name)


def phase_workflow_copies(device, rows: int = COPIES_RECORDS) -> dict:
    """[workflow-copies]: the Titanic workflow on ``rows`` records with the
    card-against-CPU pool, its search under torch.profiler: the bytes
    ``fit_columns`` copies each way (which must stay below the matrix's:
    the matrix stays on the card) and the device's idle share."""
    out = phase_workflow(device, rows, tag="workflow-copies", profile=True,
                         models=small_models(device))
    out.pop("run")
    out.pop("holdout_records")
    return out


def phase_workflow_agree(device, rows: int = AGREE_RECORDS,
                         num_rounds: int = 20,
                         num_trees: int = 5, witness: bool = False) -> dict:
    """The Titanic workflow on ``rows`` records on ``device`` (float32 on a
    card) and on the CPU (float64), with the card-against-CPU pool (the
    linear families' full grids, 4-point tree grids): equal metadata,
    bitwise equal indicator, one-hot, hash and integer columns, float
    columns within PREPARED_REL_TOL of their largest magnitude, metric
    matrices within AGREE_TOL (GBT points of min_child_weight < 10 within
    GBT_SMALL_LEAF_TOL) and the same winner unless the CPU's top two
    means lie within AGREE_TOL. With ``witness`` the float32 metric gap
    is reported, not checked, and the linear families' search runs again
    on the CPU run's matrix in float64 on ``device``, which must agree
    with the CPU within AGREE_TOL (``linear_precision_witness``)."""
    card = phase_workflow(device, rows, tag="wf-agree-card", profile=False,
                          models=small_models(device, num_rounds, num_trees))
    cpu = phase_workflow("cpu", rows, tag="wf-agree-cpu", profile=False,
                         models=small_models("cpu", num_rounds, num_trees))
    cols = [r.model.train_dataset[r.vector.name]
            for r in (card["run"], cpu["run"])]
    metas = [[(_norm_uid(c.parent_feature_name), c.parent_feature_type,
               _norm_uid(c.grouping), c.indicator_value, c.descriptor_value)
              for c in col.metadata.columns] for col in cols]
    if metas[0] != metas[1]:
        raise AssertionError("card and CPU prepared matrices' metadata "
                             "differ")
    a = cols[0].data.double().cpu().numpy()
    b = cols[1].data.numpy()
    floats = np.array([m[1] in ("Real", "RealNN") and m[3] is None
                       for m in metas[1]])
    exact = bool(np.array_equal(a[:, ~floats], b[:, ~floats]))
    scale = np.maximum(np.abs(b[:, floats]).max(axis=0), 1e-30)
    float_rel = float((np.abs(a[:, floats] - b[:, floats]) / scale).max())
    mc, mp = (np.asarray(r["metric_matrix"]) for r in (card, cpu))
    diff = float(np.abs(mc - mp).max())
    results = next(s for s in cpu["run"].model.stages()
                   if type(s).__name__ == "SelectedModel"
                   ).summary.validation_results
    tol = np.array([GBT_SMALL_LEAF_TOL if r.model_name == "GBTClassifier"
                    and r.params.get("min_child_weight", 1.0) < 10
                    else AGREE_TOL for r in results])
    within = bool(np.all(np.abs(mc - mp) <= tol))
    names = [r.model_name for r in results]
    by_family = {f: np.abs(mc - mp)[:, [i for i, n in enumerate(names)
                                         if n == f]].max(axis=0).tolist()
                 for f in dict.fromkeys(names)}
    log(f"[wf-agree] max |card - cpu| by family and grid point: "
        f"{json.dumps(by_family)}")
    means = np.sort(mp.mean(axis=0))[::-1]
    close = len(means) > 1 and means[0] - means[1] < AGREE_TOL
    same = card["winner_index"] == cpu["winner_index"]
    log(f"[wf-agree] prepared {a.shape}: metadata equal; {int(floats.sum())} "
        f"float columns max rel diff {float_rel:.3e} (tol "
        f"{PREPARED_REL_TOL}); the other {int((~floats).sum())} bitwise "
        f"equal: {exact}; max |card - cpu| metric {diff:.3e} (tol "
        f"{AGREE_TOL}, {GBT_SMALL_LEAF_TOL} for GBT at min_child_weight "
        f"< 10): within {within}; winner card {card['winner_index']} cpu "
        f"{cpu['winner_index']}{' (top two within tol)' if close else ''}; "
        f"seconds card {card['train_score_evaluate_s']:.2f} cpu "
        f"{cpu['train_score_evaluate_s']:.2f}")
    if not exact or float_rel > PREPARED_REL_TOL:
        raise AssertionError("card and CPU prepared matrices disagree")
    out = {}
    small = [i for i, r in enumerate(results)
             if r.model_name == "GBTClassifier"
             and r.params.get("min_child_weight", 1.0) < 10]
    if small:
        dev = resolve_device(device)
        out["tree_precision_witness"] = tree_precision_witness(
            device, lambda d, models:
            BinaryClassificationModelSelector.with_cross_validation(
                num_folds=3, seed=42, stratify=True, models=models,
                device=d),
            GBTClassifier(num_rounds=num_rounds, device=dev),
            [results[i].params for i in small], cols[1].data,
            np.asarray(cpu["run"].model.train_dataset["survived"].data,
                       dtype=np.float64), mp[:, small], mc[:, small],
            "wf-agree")
    if witness:
        run = cpu["run"]
        out["linear_precision_witness"] = linear_precision_witness(
            device, cols[1].data, np.asarray(
                run.model.train_dataset["survived"].data, dtype=np.float64),
            mp[:, [i for i, n in enumerate(names) if n in LINEAR_FAMILIES]],
            tag="wf-agree")
    elif not within or not (same or close):
        raise AssertionError("card and CPU workflow searches disagree")
    return {**out, "records": rows,
            "shape": list(a.shape), "float_columns": int(floats.sum()),
            "float_max_rel_diff": float_rel, "others_bitwise": exact,
            "metric_max_abs_diff": diff, "metrics_within_tol": within,
            "same_winner": same, "metric_diff_by_family": by_family,
            "card_s": card["train_score_evaluate_s"],
            "cpu_s": cpu["train_score_evaluate_s"]}


# ---------------------------------------------------------------------------
# the feature-validation slice: [validate], [workflow-cv], [validate-agree]
# ---------------------------------------------------------------------------

#: racing's fold-fit equivalents against the exact search's under the
#: static ladder (eta 3 from 1/9) over the 48-point default pool:
#: 48 x 1/3 + 16 x 1 + 6 x 3 = 50 of 48 x 3 = 144
RACING_BUDGET_SHARE = 50 / 144
#: racing's holdout AuPR against the exact search's on the same records
#: and split: the JAX package's own acceptance for racing (bench.py)
RACING_AUPR_TOL = 0.005
#: card (statistics in float64 over the float32 matrix) against CPU
#: (float64) SanityChecker statistics, relative to max(1, |CPU value|)
CHECKER_STATS_TOL = 1e-6
#: bytes a SanityChecker fit on the card may copy to the host: its
#: statistic vectors and contingency tables, never the matrix
CHECKER_DTOH_MAX = 1 << 20
#: slot count of the K1 launch recorded at a racing rung's shape: the RF
#: search's level 5 (its depth-6 and depth-12 trees reach it)
RUNG_K1_SLOTS = 32


def validated_workflow(device, records, models=None, validation="racing",
                       workflow_cv=False, rff=True) -> dict:
    """The validated Titanic DAG, as ``cli/gen.py`` builds it: the
    example's features, ``transmogrify``, ``.sanity_check(survived)`` and
    the selector over ``models`` (default: the whole default pool) under
    3-fold stratified CV, ``validation`` exact or racing at the static
    ladder, on the example's 75/25 split of ``records``; with the raw
    feature filter against the holdout records when ``rff`` and
    workflow-level CV when ``workflow_cv``. Returns the workflow, its
    selector, the prediction feature, the families' search records
    (``time_family``) and the holdout records."""
    from transmogrifai_tpu_torch.checkers import RawFeatureFilter
    from transmogrifai_tpu_torch.workflow import Workflow
    dev = resolve_device(device)
    train, test = titanic.stratified_split(records)
    survived, features = titanic.build_features()
    checked = features.sanity_check(survived)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, models=models, device=dev,
        validation=validation)
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families)
    pred = sel.set_input(survived, checked).get_output()
    wf = (Workflow(device=dev).set_result_features(survived, pred)
          .set_input_records(train))
    if rff:
        wf = wf.with_raw_feature_filter(RawFeatureFilter(), score_data=test)
    if workflow_cv:
        wf = wf.with_workflow_cv()
    return {"workflow": wf, "selector": sel, "prediction": pred,
            "families": families, "holdout": test}


def spy_checker_fits(fits: list, keep_inputs: bool):
    """Patch ``SanityChecker.fit_columns`` (the class's: a raw feature
    filter that rewires the DAG fits a clone) to record every fit: its
    rows and columns, kept and dropped columns and its seconds
    (synchronized on a card); with ``keep_inputs``, a function that fits
    again on the same inputs. Returns the function that restores it."""
    from transmogrifai_tpu_torch.checkers import SanityChecker
    real = SanityChecker.fit_columns

    def spied(self, cols):
        X = cols[1].data
        seen = {"rows": int(X.shape[0]), "cols": int(X.shape[1])}
        t0 = time.perf_counter()
        model = real(self, cols)
        if isinstance(X, torch.Tensor) and X.device.type == "cuda":
            torch.cuda.synchronize()
        seen["seconds"] = time.perf_counter() - t0
        seen["kept"] = len(model.kept_indices)
        seen["dropped"] = seen["cols"] - seen["kept"]
        if keep_inputs:
            seen["refit"] = lambda: real(self, cols)
        fits.append(seen)
        return model
    SanityChecker.fit_columns = spied
    return lambda: setattr(SanityChecker, "fit_columns", real)


def spy_level(seen: dict, num_slots: int):
    """Patch ``trees._level_histograms`` to keep a copy of the inputs of
    the first K1 launch at ``num_slots`` slots (in a racing search: the
    RF family's, at rung 0 on its sliced rows). Returns the function that
    restores it."""
    real = trees._level_histograms

    def record(design, slot, stats, C):
        if C == num_slots and "design" not in seen:
            seen.update(design=design, slot=slot.clone(),
                        stats=stats.clone(), C=C)
        return real(design, slot, stats, C)
    trees._level_histograms = record
    return lambda: setattr(trees, "_level_histograms", real)


def _train_validated(v: dict, tag: str, profile: bool) -> dict:
    """Train ``validated_workflow``'s workflow with K1's counts zeroed just
    before and read just after, the checker's fits recorded, and the
    holdout scored and evaluated. Returns the run's record (the model
    under "model")."""
    wf = v["workflow"]
    dev = wf.device
    fits: list = []
    profile = profile and dev.type == "cuda"
    restore = spy_checker_fits(fits, profile)
    clear_design_cache()
    validator.reset_family_profile()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    t0 = time.perf_counter()
    try:
        model = wf.train()
    finally:
        restore()
    train_s = time.perf_counter() - t0
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    if profile:
        # the last fit again, warm, under the profiler: its copies each
        # way (the fit in the train is the process's first, and pays the
        # one-time imports and library set-up)
        window: dict = {}
        profiled(fits[-1]["refit"], window)
        fits[-1].update(
            warm_seconds=window["wall_ms"] / 1e3,
            **{k: window[k] for k in ("dtoh_bytes", "htod_bytes",
                                      "dtoh_copies", "htod_copies",
                                      "device_busy_ms")})
    for fit in fits:
        fit.pop("refit", None)
    evaluator = BinaryClassificationEvaluator(
        label_col="survived", prediction_col=v["prediction"].name)
    t0 = time.perf_counter()
    _, metrics = model.score_and_evaluate(v["holdout"], evaluator)
    score_s = time.perf_counter() - t0
    selected = next(s for s in model.stages()
                    if type(s).__name__ == "SelectedModel")
    checker = next(s for s in model.stages()
                   if type(s).__name__ == "SanityCheckerModel")
    s = selected.summary
    plan = wf.last_prepare_plan
    search_label = next(k for k in plan.fit_seconds
                        if k.startswith("ModelSelector("))
    rff = wf.raw_feature_filter_results
    out = {"train_s": train_s, "score_evaluate_s": score_s,
           "train_seconds": dict(wf.last_train_seconds),
           "search_s": plan.fit_seconds[search_label],
           "checker_fits": fits, "kept_indices": checker.kept_indices,
           "width_before_checker": fits[-1]["cols"],
           "width_after_checker": len(checker.kept_indices),
           "families": v["families"], "k1_launches": launches,
           "k1_launches_by_c": by_c,
           "winner": s.best_model_name, "winner_params": s.best_model_params,
           "best_metric": s.best_validation_metric,
           "holdout_AuPR": metrics.AuPR, "holdout_AuROC": metrics.AuROC,
           "racing": dict(s.racing),
           "trajectories": [(r.model_name, r.grid_index, r.rung,
                             r.pruned_at, list(r.metric_values))
                            for r in s.validation_results],
           "rff_exclusions": [e.to_json() for e in rff.exclusions]
           if rff is not None else None,
           "rff_results": rff.to_json() if rff is not None else None,
           "rff_seconds": wf.last_train_seconds.get("raw_feature_filter"),
           "workflow_cv": dict(wf.last_workflow_cv),
           "checker_lowered": any(
               label.startswith("SanityCheckerModel(")
               for label in plan.coverage.lowered),
           "model": model, "summary": s}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def _log_search(tag: str, run: dict) -> None:
    for name, rec in run["families"].items():
        log(f"[{tag}] {name}: {rec['calls']} calls, {rec['candidates']} "
            f"models x folds in {rec['seconds']:.2f} s; K1 launches "
            f"{rec['k1_launches']}: " + " ".join(
                f"C={c}:{k}" for c, k in rec["k1_launches_by_c"].items()))
    log(f"[{tag}] winner {run['winner']} {run['winner_params']} mean AuPR "
        f"{run['best_metric']:.6f}; holdout AuPR {run['holdout_AuPR']:.6f} "
        f"AuROC {run['holdout_AuROC']:.6f}; K1 launches "
        f"{run['k1_launches']}: " + " ".join(
            f"C={c}:{k}" for c, k in run["k1_launches_by_c"].items()))


def phase_validate(device, rows: int, exact=None, models=None,
                   tag: str = "validate", seed: int = 42,
                   profile: bool = True) -> dict:
    """[validate]: ``rows`` synthetic Titanic records through the
    validated DAG (``validated_workflow``) under racing at the static
    ladder, behind the raw feature filter against the holdout records;
    then ``score_and_evaluate`` of the holdout, a save, a reload on the
    card scoring the holdout through the compiled plan and the columnar
    path, and SAMPLE_PASSENGER and 1,000 holdout records served one at a
    time through ``load_score_function``. Prints the filter's seconds and
    exclusions, the checker's fit (seconds, columns kept and dropped,
    bytes copied to the host, profiled on a card), the search by family
    and rung, candidates and pruned counts per rung, the budget spent,
    K1 launches by family and C, the winner and holdout AuPR / AuROC
    beside the exact search's (``exact``: phase 8's record on the same
    records and split, else an exact run here). K1 at the racing rung's
    sliced shape is held against its plain version. Fails unless the
    compiled scores equal the columnar ones bit for bit, every served
    record is within SERVE_SCORE_TOL of the batch score, no scoring batch
    fell back to the host, the checker's gather ran in the prepare plan
    on the device, its fit copied under CHECKER_DTOH_MAX bytes to the
    host (profiled on a card), and, over the default pool, racing spent
    at most RACING_BUDGET_SHARE of full CV and its holdout AuPR is within
    RACING_AUPR_TOL of the exact search's; on a card every tree family
    must launch K1."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.runtime import telemetry
    from transmogrifai_tpu_torch.workflow.persistence import load_model
    dev = resolve_device(device)
    t_phase = time.perf_counter()
    records = titanic.synthetic_titanic(rows, seed=seed)
    v = validated_workflow(dev, records, models=models)
    pred = v["prediction"].name
    rung_k1: dict = {}
    restore = spy_level(rung_k1, RUNG_K1_SLOTS)
    try:
        run = _train_validated(v, tag, profile)
    finally:
        restore()
    out = {k: val for k, val in run.items()
           if k not in ("model", "summary", "rff_results")}
    out["rows"] = rows
    racing = run["racing"]
    out["rung_profile"] = list(v["selector"].validator.rung_profile)
    fit = run["checker_fits"][-1]
    log(f"[{tag}] {rows} records; raw feature filter {run['rff_seconds']:.3f}"
        f" s, exclusions {json.dumps(run['rff_exclusions'])}; train "
        f"{run['train_s']:.2f} s: " + json.dumps(
            {k: round(val, 3) for k, val in run["train_seconds"].items()}))
    log(f"[{tag}] SanityChecker fit on {dev} over {fit['rows']} x "
        f"{fit['cols']}: {fit['seconds']:.3f} s in the train, "
        f"{fit.get('warm_seconds', float('nan')):.3f} s again warm under the"
        f" profiler (device busy {fit.get('device_busy_ms', float('nan')):.3f}"
        f" ms); kept {fit['kept']}, dropped {fit['dropped']}; copied to the "
        f"host {fit.get('dtoh_bytes', 'not profiled')} bytes in "
        f"{fit.get('dtoh_copies', '-')} copies, up "
        f"{fit.get('htod_bytes', '-')} bytes; gather on the device in the "
        f"prepare plan: {run['checker_lowered']}")
    log(f"[{tag}] search (selector fit) {run['search_s']:.2f} s; racing: "
        f"{racing.get('candidatesTotal')} candidates, "
        f"{racing.get('candidatesPruned')} pruned, budget "
        f"{racing.get('budgetSpentFoldFits')} of "
        f"{racing.get('budgetFullCvFoldFits')} fold fits")
    for row, prof in zip(racing.get("rungs", []), out["rung_profile"]):
        log(f"[{tag}] rung {row['rung']}: budget {row['budgetFraction']}, "
            f"{row['folds']} folds x {row['rowFraction']} rows "
            f"(matrix {prof['rows']} rows), {row['candidates']} "
            f"candidates, {row['promoted']} promoted, {prof['seconds']:.2f} s:"
            + " ".join(f" {k} {s_:.2f} s"
                       for k, s_ in prof["familySeconds"].items()))
    _log_search(tag, run)
    if exact is None:
        ex = _train_validated(validated_workflow(dev, records, models=models,
                                                 validation="exact"),
                              tag + "-exact", profile=False)
        exact = {"holdout_AuPR": ex["holdout_AuPR"], "winner": ex["winner"],
                 "search_s": ex["search_s"],
                 "source": "an exact search of the validated DAG here"}
    out["exact"] = exact
    out["aupr_gap_vs_exact"] = run["holdout_AuPR"] - exact["holdout_AuPR"]
    log(f"[{tag}] exact search ({exact['source']}): holdout AuPR "
        f"{exact['holdout_AuPR']:.6f}, winner {exact['winner']}, search "
        f"{exact['search_s']:.2f} s; racing - exact AuPR "
        f"{out['aupr_gap_vs_exact']:+.6f} (tol {RACING_AUPR_TOL})")

    # K1 at a racing rung's sliced shape, against its plain version
    if dev.type == "cuda":
        design = rung_k1["design"]
        rung0_rows = out["rung_profile"][0]["rows"]
        out["rung_k1_case"] = k1_case(
            f"racing rung 0 RF level C={RUNG_K1_SLOTS} ({design.n} sliced "
            f"rows of {rung0_rows})", design.ids, design.offsets,
            rung_k1["slot"], rung_k1["stats"], rung_k1["C"],
            design.total_bins, design.hist_plan(rung_k1["stats"].shape[1]),
            exact=True)
        if design.n != rung0_rows:
            raise AssertionError(f"[{tag}] the recorded K1 launch ran on "
                                 f"{design.n} rows, not rung 0's "
                                 f"{rung0_rows}")
    rung_k1.clear()

    # save, reload, compiled against columnar, serve records one at a time
    holdout = v["holdout"]
    served_records = [titanic.SAMPLE_PASSENGER] + list(holdout[:1000])
    tmp = tempfile.mkdtemp(prefix="validate_")
    before = telemetry.counters()
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        run["model"].save(path)
        out["save_s"] = time.perf_counter() - t0
        loaded = load_model(path, device=dev)
        t0 = time.perf_counter()
        compiled = loaded.score(holdout, engine="compiled")
        out["score_compiled_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        columnar = loaded.score(holdout)
        out["score_columnar_s"] = time.perf_counter() - t0
        plan = loaded.scoring_plan()
        out["plan_checker_lowered"] = any(
            label.startswith("SanityCheckerModel(")
            for label in plan.coverage.lowered)
        fn = load_score_function(path, device=dev)
        served, ms = _serve_all(fn, served_records, pred, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    after = telemetry.counters()
    out["host_fallback_batches"] = after.get(
        "serving_host_fallback_batches", 0) - before.get(
        "serving_host_fallback_batches", 0)
    out["compiled_equals_columnar"] = bool(
        np.array_equal(_prob(compiled, pred), _prob(columnar, pred))
        and np.array_equal(compiled[pred].raw_prediction,
                           columnar[pred].raw_prediction))
    batch = [dict(columnar[pred].boxed(i).value)
             for i in range(len(served_records) - 1)]
    out["max_abs_diff_served"] = _max_gap(served[1:], batch)
    out.update(serve_ms_p50=float(np.percentile(ms, 50)),
               serve_ms_p99=float(np.percentile(ms, 99)),
               serve_ms_mean=float(ms.mean()))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] saved in {out['save_s']:.3f} s; {len(holdout)} holdout "
        f"records compiled {out['score_compiled_s']:.3f} s, columnar "
        f"{out['score_columnar_s']:.3f} s, bitwise equal "
        f"{out['compiled_equals_columnar']}; checker gather in the scoring "
        f"plan on the device: {out['plan_checker_lowered']}; "
        f"{len(served_records)} records served one at a time: p50 "
        f"{out['serve_ms_p50']:.3f} ms, p99 {out['serve_ms_p99']:.3f} ms, "
        f"max |served - batch| {out['max_abs_diff_served']:.3e} (tol "
        f"{SERVE_SCORE_TOL}); host fallback batches "
        f"{out['host_fallback_batches']}; phase {out['seconds']:.1f} s")
    if not out["compiled_equals_columnar"]:
        raise AssertionError(f"[{tag}] compiled scores differ from "
                             f"columnar")
    if out["max_abs_diff_served"] > SERVE_SCORE_TOL:
        raise AssertionError(f"[{tag}] served records differ from the "
                             f"batch score")
    if out["host_fallback_batches"]:
        raise AssertionError(f"[{tag}] scoring fell back to the host")
    if not (run["checker_lowered"] and out["plan_checker_lowered"]):
        raise AssertionError(f"[{tag}] the checker's gather did not run "
                             f"on the device")
    if fit.get("dtoh_bytes", 0) >= CHECKER_DTOH_MAX:
        raise AssertionError(f"[{tag}] the checker's fit copied "
                             f"{fit['dtoh_bytes']} bytes to the host")
    if not racing.get("raced"):
        raise AssertionError(f"[{tag}] the search did not race")
    if models is None:
        if racing["budgetSpentFoldFits"] > RACING_BUDGET_SHARE * \
                racing["budgetFullCvFoldFits"] + 1e-9:
            raise AssertionError(f"[{tag}] racing spent "
                                 f"{racing['budgetSpentFoldFits']} fold fits")
        if abs(out["aupr_gap_vs_exact"]) > RACING_AUPR_TOL:
            raise AssertionError(f"[{tag}] racing's holdout AuPR is "
                                 f"{out['aupr_gap_vs_exact']:+.6f} off the "
                                 f"exact search's")
    if dev.type == "cuda":
        idle = [f for f, rec in run["families"].items()
                if f in TREE_FAMILIES and rec["k1_launches"] == 0]
        if run["k1_launches"] == 0 or idle:
            raise AssertionError(
                f"[{tag}] K1 never launched by {idle or 'the search'}")
    if not 0.5 < run["holdout_AuROC"] <= 1.0:
        raise AssertionError(f"[{tag}] holdout evaluation is off")
    return out


def phase_workflow_cv(device, rows: int, models=None,
                      tag: str = "workflow-cv") -> dict:
    """[workflow-cv]: the validated DAG of ``[validate]`` with
    ``with_workflow_cv()`` and exact CV on ``rows`` records over
    ``models`` (default: the default pool, its forests at PATH_TREES
    trees, ``path_pool``): the
    prepare plan fits the vectorizers once, the checker is refit per fold
    on the card and each fold's matrix searched on its own. Prints the
    pre-pass seconds, each fold's refit seconds and matrix width, the
    search seconds, K1 launches, the winner and holdout AuPR. Fails
    unless the search covered every candidate on three folds and, on a
    card, every tree family launched K1."""
    dev = resolve_device(device)
    t_phase = time.perf_counter()
    records = titanic.synthetic_titanic(rows, seed=42)
    v = validated_workflow(dev, records, models=models or path_pool(dev),
                           validation="exact", workflow_cv=True)
    run = _train_validated(v, tag, profile=False)
    out = {k: val for k, val in run.items()
           if k not in ("model", "summary", "rff_results")}
    out["rows"] = rows
    cv = run["workflow_cv"]
    G = len(run["summary"].validation_results)
    mxf = sum(len(r.metric_values)
              for r in run["summary"].validation_results)
    out["models_x_folds"] = mxf
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] {rows} records; train {run['train_s']:.2f} s: "
        + json.dumps({k: round(val, 3)
                      for k, val in run["train_seconds"].items()}))
    log(f"[{tag}] pre-pass {cv['prepass_seconds']:.3f} s; per-fold checker "
        f"refit seconds " + ", ".join(f"{s_:.3f}"
                                      for s_ in cv["fold_refit_seconds"])
        + f"; fold train matrices {list(zip(cv['fold_train_rows'], cv['fold_widths']))}"
        f" (rows, width); fold search {cv['search_seconds']:.2f} s; final "
        f"checker keeps {run['width_after_checker']} of "
        f"{run['width_before_checker']}")
    _log_search(tag, run)
    log(f"[{tag}] models x folds {mxf}; phase {out['seconds']:.1f} s")
    if mxf != 3 * G or len(cv.get("fold_widths", ())) != 3:
        raise AssertionError(f"[{tag}] the fold search covered {mxf} models"
                             f" x folds over {cv.get('fold_widths')}")
    if dev.type == "cuda":
        idle = [f for f, rec in run["families"].items()
                if f in TREE_FAMILIES and rec["k1_launches"] == 0]
        if run["k1_launches"] == 0 or idle:
            raise AssertionError(
                f"[{tag}] K1 never launched by {idle or 'the search'}")
    if not 0.5 < run["holdout_AuROC"] <= 1.0:
        raise AssertionError(f"[{tag}] holdout evaluation is off")
    return out


def spy_prunes(racer, rungs: list) -> None:
    """Wrap a racing validator's ``_prune_rung`` to record, at each rung
    boundary, every contender's mean metric and the kept candidates, by
    (family, grid) index."""
    real = racer._prune_rung

    def spied(contenders, rung):
        means = {(rc.fam, rc.gi): rc.mean() for rc in contenders}
        keep = real(contenders, rung)
        rungs.append({"rung": rung, "means": means,
                      "kept": sorted((rc.fam, rc.gi) for rc in contenders
                                     if rc.alive)})
        return keep
    racer._prune_rung = spied


def _candidate_tol(result) -> float:
    return (GBT_SMALL_LEAF_TOL if result.model_name == "GBTClassifier"
            and result.params.get("min_child_weight", 1.0) < 10
            else AGREE_TOL)


def _agree_checker(card: dict, cpu: dict, tag: str) -> dict:
    """The two runs' final checkers: kept indices equal, every statistic
    within CHECKER_STATS_TOL of the CPU's relative to max(1, |CPU|)."""
    stats = [next(s for s in r["model"].stages()
                  if type(s).__name__ == "SanityCheckerModel"
                  ).summary.column_stats for r in (card, cpu)]
    worst = 0.0
    for a, b in zip(*stats):
        for key in ("variance", "mean", "min", "max", "corr_label",
                    "cramers_v", "max_rule_confidence", "support"):
            x, y = getattr(a, key), getattr(b, key)
            if x is None or y is None or (np.isnan(x) and np.isnan(y)):
                if (x is None) != (y is None):
                    raise AssertionError(f"[{tag}] {b.name} {key}: {x} "
                                         f"vs {y}")
                continue
            worst = max(worst, abs(x - y) / max(1.0, abs(y)))
    same = card["kept_indices"] == cpu["kept_indices"]
    log(f"[{tag}] checker kept {len(cpu['kept_indices'])} of "
        f"{len(stats[1])} on both: {same}; max relative statistic gap "
        f"{worst:.3e} (tol {CHECKER_STATS_TOL})")
    if not same or worst > CHECKER_STATS_TOL:
        raise AssertionError(f"[{tag}] card and CPU checkers disagree")
    return {"kept_equal": same, "stats_max_rel_gap": worst}


def _agree_matrices(card: dict, cpu: dict, tag: str) -> dict:
    """Per-candidate metrics of two runs whose candidates reached the same
    rung (all of them under exact CV): within AGREE_TOL
    (GBT_SMALL_LEAF_TOL at the GBT points of min_child_weight < 10); the
    same winner unless the CPU's top two finalist means lie within
    AGREE_TOL."""
    res = [r["summary"].validation_results for r in (card, cpu)]
    gaps, worst = {}, 0.0
    for a, b in zip(*res):
        if (a.rung, a.pruned_at, len(a.metric_values)) != \
                (b.rung, b.pruned_at, len(b.metric_values)):
            continue
        gap = float(np.max(np.abs(np.subtract(a.metric_values,
                                              b.metric_values))))
        worst = max(worst, gap)
        gaps[f"{b.model_name}[{b.grid_index}]"] = gap
        if gap > _candidate_tol(b):
            raise AssertionError(f"[{tag}] {b.model_name}[{b.grid_index}]"
                                 f" differs by {gap:.3e} card to CPU")
    finals = sorted((r.mean_metric for r in res[1]
                     if r.pruned_at is None), reverse=True)
    close = len(finals) > 1 and finals[0] - finals[1] < AGREE_TOL
    same = (card["winner"], card["winner_params"]) == \
        (cpu["winner"], cpu["winner_params"])
    log(f"[{tag}] max |card - cpu| metric {worst:.3e} over {len(gaps)} "
        f"candidates; winner card {card['winner']} {card['winner_params']}"
        f" cpu {cpu['winner']} {cpu['winner_params']}"
        + (" (top two within tol)" if close else ""))
    if not (same or close):
        raise AssertionError(f"[{tag}] card and CPU pick other winners")
    return {"metric_max_abs_diff": worst, "same_winner": same,
            "metric_diff_by_candidate": gaps}


def _agree_prunes(card_rungs: list, cpu_rungs: list, results,
                  tag: str) -> dict:
    """Racing's rung decisions on the card and on the CPU: each rung's
    contenders' means within their metric tolerance, the same candidates
    kept. A candidate kept on one side only is allowed, and reported,
    only at a near tie: its CPU mean within its tolerance of the CPU's
    cut (the last kept candidate's mean)."""
    by_index = {(fi, gi): r for fi, gi, r in results}
    flips = []
    for a, b in zip(card_rungs, cpu_rungs):
        for key in set(a["means"]) & set(b["means"]):
            x, y = a["means"][key], b["means"][key]
            if np.isfinite(y) and abs(x - y) > _candidate_tol(by_index[key]):
                raise AssertionError(f"[{tag}] rung {b['rung']} mean of "
                                     f"{key} differs: {x} vs {y}")
        if a["kept"] == b["kept"]:
            continue
        cut = min(b["means"][k] for k in b["kept"])
        for key in sorted(set(a["kept"]) ^ set(b["kept"])):
            r = by_index[key]
            gap = abs(b["means"].get(key, np.nan) - cut)
            flips.append({"rung": b["rung"],
                          "candidate": f"{r.model_name}[{r.grid_index}]",
                          "cpu_mean": b["means"].get(key),
                          "cpu_cut": cut, "gap": gap})
            if not gap <= _candidate_tol(r):
                raise AssertionError(f"[{tag}] rung {b['rung']} keeps "
                                     f"other candidates: {flips[-1]}")
    log(f"[{tag}] rung decisions: " + "; ".join(
        f"rung {b['rung']} kept {len(b['kept'])} of {len(b['means'])}"
        for b in cpu_rungs) + f"; near-tie flips {json.dumps(flips)}")
    return {"prune_flips": flips,
            "same_prunes": all(a["kept"] == b["kept"]
                               for a, b in zip(card_rungs, cpu_rungs))}


def phase_validate_agree(device, rows: int = AGREE_RECORDS,
                         num_rounds: int = 20,
                         num_trees: int = 5) -> dict:
    """[validate-agree]: the validated DAG on ``rows`` records on the card
    (float32) and on the CPU (float64) with the card-against-CPU pool,
    first racing behind the raw feature filter, then exact under
    workflow-level CV: equal filter results; the checkers' kept indices
    equal and their statistics within CHECKER_STATS_TOL; racing's rung
    decisions equal but for reported near ties (``_agree_prunes``); the
    metrics within AGREE_TOL (GBT_SMALL_LEAF_TOL at the GBT points of
    min_child_weight < 10) and the same winner (``_agree_matrices``);
    under workflow CV each fold's refit checker as wide on both."""
    out = {}
    runs = []
    t_phase = time.perf_counter()
    for where in (device, "cpu"):
        dev = resolve_device(where)
        records = titanic.synthetic_titanic(rows, seed=42)
        v = validated_workflow(dev, records, models=small_models(
            dev, num_rounds, num_trees))
        rungs: list = []
        spy_prunes(v["selector"].validator, rungs)
        run = _train_validated(v, f"validate-agree-{dev.type}", False)
        run["rungs"] = rungs
        fams = {est.uid: fi
                for fi, (est, _) in enumerate(v["selector"].models)}
        run["pool"] = [(fams[r.model_uid], r.grid_index, r)
                       for r in run["summary"].validation_results]
        t0 = time.perf_counter()
        cv = _train_validated(validated_workflow(
            dev, records, models=small_models(dev, num_rounds, num_trees),
            validation="exact", workflow_cv=True, rff=False),
            f"validate-agree-cv-{dev.type}", False)
        runs.append((run, cv))
        log(f"[validate-agree] {dev}: racing train {run['train_s']:.2f} s, "
            f"workflow-CV train {cv['train_s']:.2f} s "
            f"({time.perf_counter() - t0:.2f} s with its scoring)")
    (card, card_cv), (cpu, cpu_cv) = runs
    if card["rff_results"] != cpu["rff_results"]:
        raise AssertionError("[validate-agree] the raw feature filters' "
                             "results differ")
    out["rff_equal"] = True
    out["checker"] = _agree_checker(card, cpu, "validate-agree")
    out["prunes"] = _agree_prunes(card["rungs"], cpu["rungs"], cpu["pool"],
                                  "validate-agree")
    out["racing"] = _agree_matrices(card, cpu, "validate-agree")
    widths = [r["workflow_cv"]["fold_widths"] for r in (card_cv, cpu_cv)]
    log(f"[validate-agree] workflow-CV fold widths card {widths[0]} cpu "
        f"{widths[1]}")
    if widths[0] != widths[1]:
        raise AssertionError("[validate-agree] the per-fold checkers keep "
                             "other columns")
    out["workflow_cv_checker"] = _agree_checker(card_cv, cpu_cv,
                                                "validate-agree-cv")
    out["workflow_cv"] = _agree_matrices(card_cv, cpu_cv,
                                         "validate-agree-cv")
    out["seconds"] = time.perf_counter() - t_phase
    out["card_s"] = card["train_s"] + card_cv["train_s"]
    out["cpu_s"] = cpu["train_s"] + cpu_cv["train_s"]
    log(f"[validate-agree] phase {out['seconds']:.1f} s (trains: card "
        f"{out['card_s']:.1f} s, cpu {out['cpu_s']:.1f} s)")
    return out


def exact_of(wf_run: dict) -> dict:
    """Phase 8's exact search as [validate]'s reference: the same records
    and split (``--workflow-rows``, seed 42); its DAG has no SanityChecker
    and no raw feature filter."""
    return {"holdout_AuPR": wf_run["holdout_AuPR"],
            "winner": wf_run["winner"], "search_s": wf_run["search_s"],
            "source": "phase 8 [workflow], the same records and split, "
                      "without the checker and the filter"}


def phase_validation(device, rows: int, cv_rows: int, exact=None,
                     agree: bool = True) -> dict:
    """[validate], [workflow-cv] and, with ``agree``, [validate-agree] in
    turn."""
    out = {"validate": phase_validate(device, rows, exact=exact),
           "workflow_cv": phase_workflow_cv(device, cv_rows)}
    if agree:
        out["validate_agree"] = phase_validate_agree(device)
    return out


# ---------------------------------------------------------------------------
# the multiclass and regression problem types: [k1-problems], [iris],
# [boston], [problems-agree]
# ---------------------------------------------------------------------------

#: records of the Iris path: 2,000 times the UCI data's 150
IRIS_ROWS = 300_000
#: records of the Boston path: about 400 times the UCI data's 506
BOSTON_ROWS = 200_000
#: trees of the forests on the earlier slices' own paths ([workflow-cv],
#: [iris], [boston], [families], [text]); the main paths ([main],
#: [workflow]) and [validate], which is held to [workflow]'s exact search,
#: keep the default pool's 50. Cut from 50 (to 25, then 10) when the whole
#: smoke took 1,187.2 s and then 1,196.7 s of its 1,200 s on slow hosts:
#: those forest searches are host-bound (a tree level's ops do not shrink
#: with the rows), so fewer rows would not have shortened them
PATH_TREES = 10
#: records of each example in the card-against-CPU phase
PROBLEMS_AGREE_ROWS = 3000
#: trees of the forests in the card-against-CPU phase
AGREE_TREES = 5
#: classes and shape of the multiclass array search in that phase
WIDE_K, WIDE_ROWS, WIDE_COLS = 7, 3000, 20
#: a DecisionTreeRegressor fit on the Boston matrix, card against CPU:
#: the depth whose split heaps are compared. Measured on an H100 at
#: 200,000 x 26: no node of 4,095 differs, with the label centred on the
#: card or not, so the card keeps the JAX package's raw statistics
VARIANCE_DEPTH = 12
#: card (float32) against CPU relative RMSE of a GBTRegressor point of
#: depth 6 or more on the Boston records: its leaves hold a few rows,
#: float32 sums of residuals break near ties in gain otherwise than
#: float64, and a split that flips in one round moves every later round.
#: Measured on an H100 at 2,000 training rows: up to 6.43e-3 at depth 12
#: (min_child_weight 1), 3.21e-3 at depth 6; every other point of either
#: example <= 4.2e-4. The gap is float32's: the same points in float64 on
#: the card, which adds in the CPU's row order (``index_add_rows``, the
#: base mean on the host), are within 2.5e-16 of the CPU and repeat bit
#: for bit (the float64 witness holds them to AGREE_TOL)
GBT_REG_DEEP_TOL = 1e-2


def iris_matrix(rows: int, seed: int = 42):
    """The Iris DAG's prepared matrix as numpy, without the workflow: each
    real value and its null indicator (0: the synthetic records have no
    nulls), the label."""
    from transmogrifai_tpu_torch.examples import iris
    recs = iris.synthetic_iris(rows, seed)
    vals = np.array([[r[f] for f in iris.FEATURES] for r in recs])
    X = np.stack([vals, np.zeros_like(vals)], axis=2).reshape(rows, -1)
    return X, np.array([r["label"] for r in recs])


def boston_matrix(rows: int, seed: int = 42):
    """The Boston DAG's columns as numpy (each real value with its null
    indicator, then chas and its indicator) and medv."""
    from transmogrifai_tpu_torch.examples import boston
    recs = boston.synthetic_boston(rows, seed)
    cols = [c for c in boston.COLUMNS if c not in ("chas", "medv")]
    vals = np.array([[r[c] for c in cols + ["chas"]] for r in recs])
    X = np.stack([vals, np.zeros_like(vals)], axis=2).reshape(rows, -1)
    return X, np.array([r["medv"] for r in recs])


def wide_multiclass(rows: int, cols: int, k: int, seed: int = 3):
    """A make_data-like non-negative matrix (a fifth uniform, the rest
    Bernoulli(0.15)) with a ``k``-class label: the argmax of k noisy
    linear scores."""
    rng = np.random.default_rng(seed)
    n_num = max(cols // 5, 1)
    X = np.concatenate([rng.uniform(size=(rows, n_num)),
                        (rng.uniform(size=(rows, cols - n_num)) < 0.15
                         ).astype(float)], axis=1)
    W = rng.normal(size=(cols, k))
    y = np.argmax(X @ W + rng.gumbel(size=(rows, k)) * 0.5, axis=1)
    return X, y.astype(np.float64)


def _problem_k1_stats(design, kind: str, y: np.ndarray, seed: int = 42):
    """(n, S) statistics of a tree of each problem path: one-hot labels
    times Poisson(1) weights times a fold mask ("cls"), [w, wy, wyy] of
    the label centred as the card's search centres it ("reg"), or the
    squared booster's [g, h] times the mask ("gbt")."""
    n = design.n
    draws = TorchDraws(seed, 1)
    mask = (torch.arange(n) % 3 != 0).to(torch.float64)
    w = draws.poisson(0, 1.0, n) * mask
    if kind == "cls":
        k = int(y.max()) + 1
        st = np.eye(k)[y.astype(np.int64)] * w.numpy()[:, None]
    elif kind == "reg":
        st = np.stack([w.numpy(), w.numpy() * y, w.numpy() * y * y], 1)
    else:
        g = (y[mask.numpy() > 0].mean() - y) * mask.numpy()
        st = np.stack([g, mask.numpy()], 1)
    return _on(st, design.dtype, design.device).contiguous()


def phase_k1_problems(device: torch.device) -> dict:
    """[k1-problems]: K1 against its plain version at the new problem
    paths' shapes: the Iris matrix's forest at S = 3 (C = 1, 32, 256,
    exact), a K = 7 block (S = 7, split by ``HistPlan.stat_blocks`` into
    4 + 3 statistics, exact), the Boston regression forest's S = 3
    [w, wy, wyy] and the GBT regressor's S = 2 [g, h] (C = 256, within
    float32 rounding); kernel, plain and ``index_add_`` times beside the
    memory bound."""
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    cases = []
    X, y = iris_matrix(IRIS_ROWS)
    shapes = [("iris forest", X[:int(0.8 * IRIS_ROWS)],
               y[:int(0.8 * IRIS_ROWS)], "cls", (1, 32, 256), True)]
    Xw, yw = wide_multiclass(int(0.8 * IRIS_ROWS), WIDE_COLS, WIDE_K)
    shapes.append((f"K={WIDE_K} forest block", Xw, yw, "cls", (32, 256),
                   True))
    Xb, yb = boston_matrix(BOSTON_ROWS)
    nb = int(0.8 * BOSTON_ROWS)
    shapes.append(("boston forest [w,wy,wyy]", Xb[:nb], yb[:nb], "reg",
                   (256,), False))
    shapes.append(("boston GBT [g,h]", Xb[:nb], yb[:nb], "gbt", (256,),
                   False))
    for label, Xs, ys, kind, slots, exact in shapes:
        design = _PackedDesign(Xs, 32, device)
        st = _problem_k1_stats(design, kind, ys)
        plan = design.hist_plan(st.shape[1])
        blocks = [b - a for a, b, _ in plan.stat_blocks()]
        log(f"[k1-problems] {label}: n={design.n} d={design.d} "
            f"TB={design.total_bins} S={st.shape[1]} launch blocks "
            f"{blocks}")
        for C in slots:
            slot = torch.randint(0, C, (design.n,), generator=gen,
                                 device=device, dtype=torch.int32)
            case = k1_case(f"{label} C={C}", design.ids, design.offsets,
                           slot, st, C, design.total_bins, plan,
                           exact=exact)
            case["stat_blocks"] = blocks
            cases.append(case)
        del design, st
        clear_design_cache()
    return {"cases": cases}


def _serve_problem(run, tag: str, served: int = 1000,
                   server_records: int = 0) -> dict:
    """Save the run's model (with its drift fingerprints), reload it on its
    device, serve ``served`` holdout records one at a time (within
    SERVE_SCORE_TOL of the batch ``score``), and score the holdout through
    the compiled plan (within COMPILED_SCORE_TOL of the columnar path),
    then the holdout's first GUARDED_RECORDS records through the same plan
    with its default guardrails, whose drift sentinel must read them
    ``ok`` (over at least DRIFT_MIN_RECORDS records); with
    ``server_records``, that
    many holdout records as requests through a default ``ServeConfig()``
    server (the drift sentinel on) answering within SERVE_SCORE_TOL of
    the guarded plan, its tenant's sentinel reading ``ok``; no host
    fallback and no K1 launch."""
    import shutil
    import tempfile
    from transmogrifai_tpu_torch.runtime import telemetry
    from transmogrifai_tpu_torch.workflow.persistence import load_model
    dev = run.workflow.device
    pred = run.prediction.name
    holdout = run.holdout
    records = list(holdout[:served + 1])
    out: dict = {}
    level_hist.launches = 0
    before = telemetry.counters()
    tmp = tempfile.mkdtemp(prefix=f"{tag}_")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        run.model.save(path)
        out["save_s"] = time.perf_counter() - t0
        out["arrays_npz_bytes"] = os.path.getsize(
            os.path.join(path, "arrays.npz"))
        out["fingerprints"] = os.path.exists(
            os.path.join(path, DRIFT_FINGERPRINTS_FILE))
        t0 = time.perf_counter()
        loaded = load_model(path, device=dev)
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = loaded.score(holdout, engine="compiled")
        out["score_compiled_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        columnar = loaded.score(holdout)
        out["score_columnar_s"] = time.perf_counter() - t0
        plan = loaded.scoring_plan()
        out["plan_fallback_stages"] = plan.fallbacks()
        fn = load_score_function(path, device=dev)
        rows, ms = _serve_all(fn, records, pred, dev)
        # the same plan with the default guardrails: its drift sentinel
        # (fingerprints from the saved directory) over the holdout's first
        # GUARDED_RECORDS records
        t0 = time.perf_counter()
        guarded = plan.with_guardrails().score_guarded(
            holdout[:GUARDED_RECORDS])
        out["score_guarded_s"] = time.perf_counter() - t0
        out["guarded_quarantined"] = len(guarded.quarantined)
        out["drift"] = _drift_summary(plan.drift_report())
        if server_records:
            out["server"] = _default_server(
                loaded, holdout[:server_records], pred, guarded.scored, dev,
                tag)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    after = telemetry.counters()
    out["host_fallback_batches"] = after.get(
        "serving_host_fallback_batches", 0) - before.get(
        "serving_host_fallback_batches", 0)
    a, b = compiled[pred], columnar[pred]
    out["max_abs_diff_compiled"] = float(max(
        np.abs(a.data - b.data).max(),
        np.abs(a.probability - b.probability).max(initial=0.0),
        np.abs(a.raw_prediction - b.raw_prediction).max(initial=0.0)))
    batch = [dict(b.boxed(i).value) for i in range(len(records))]
    out["max_abs_diff_served"] = _max_gap(rows, batch)
    out.update(serve_ms_p50=float(np.percentile(ms, 50)),
               serve_ms_p99=float(np.percentile(ms, 99)),
               serve_ms_mean=float(ms.mean()), served=len(records),
               holdout=len(holdout), k1_launches=level_hist.launches,
               winner_class=type(next(
                   s for s in loaded.stages()
                   if type(s).__name__ == "SelectedModel").inner).__name__)
    log(f"[{tag}] saved in {out['save_s']:.3f} s (arrays.npz "
        f"{out['arrays_npz_bytes']} bytes), loaded on {dev} in "
        f"{out['load_s']:.3f} s; {len(holdout)} holdout records compiled "
        f"{out['score_compiled_s']:.3f} s, columnar "
        f"{out['score_columnar_s']:.3f} s, max |compiled - columnar| "
        f"{out['max_abs_diff_compiled']:.3e} (tol {COMPILED_SCORE_TOL}); "
        f"{len(records)} records served one at a time: p50 "
        f"{out['serve_ms_p50']:.3f} ms, p99 {out['serve_ms_p99']:.3f} ms, "
        f"max |served - batch| {out['max_abs_diff_served']:.3e} (tol "
        f"{SERVE_SCORE_TOL}); plan host stages "
        f"{out['plan_fallback_stages']}, host fallback batches "
        f"{out['host_fallback_batches']}; K1 launches {out['k1_launches']}")
    log(f"[{tag}] drift-fingerprints.json saved: {out['fingerprints']}; "
        f"holdout through the default guardrails in "
        f"{out['score_guarded_s']:.3f} s ({out['guarded_quarantined']} "
        f"quarantined): drift {json.dumps(out['drift'])}")
    if not out["fingerprints"] or _drift_misread(out["drift"]):
        raise AssertionError(f"[{tag}] the saved model has no drift "
                             f"fingerprints or its holdout reads drift")
    if out["max_abs_diff_compiled"] > COMPILED_SCORE_TOL:
        raise AssertionError(f"[{tag}] compiled scores differ from "
                             f"columnar")
    if out["max_abs_diff_served"] > SERVE_SCORE_TOL:
        raise AssertionError(f"[{tag}] served records differ from the "
                             f"batch score")
    if out["host_fallback_batches"] or out["k1_launches"]:
        raise AssertionError(f"[{tag}] serving fell back to the host or "
                             f"launched K1")
    return out


def _default_server(model, records, name: str, expect, dev,
                    tag: str, threads: int = 32) -> dict:
    """``records`` as requests from ``threads`` submitters through an
    in-process server under a default ``ServeConfig()``: requests/s, ms a
    request, answers within SERVE_SCORE_TOL of ``expect`` (the guarded
    plan's scored column over the whole holdout: a coalesced batch's host
    stages, e.g. LDA's batched E-step products, may round a row
    otherwise than the whole batch's), the tenant's drift state."""
    from transmogrifai_tpu_torch.serving import ServeConfig, serve_in_process
    server, client = serve_in_process({"m": model}, ServeConfig(),
                                      device=dev)
    try:
        answers, ms, wall = _drive_server(client, records, threads)
        drift = server.metrics_snapshot()["sentinels"]["m/default"]
    finally:
        server.stop()
    want = [dict(expect[name].boxed(i).value) for i in range(len(records))]
    if any("_guard" in a for a in answers):
        raise AssertionError(f"[{tag}] the default server quarantined or "
                             f"invalidated a holdout request")
    got = [a[name] for a in answers]
    mismatched = sum(1 for a, b in zip(got, want) if a != b)
    out = {"requests": len(records), "requests_per_s": len(records) / wall,
           "ms_p50": float(np.percentile(ms, 50)),
           "ms_p99": float(np.percentile(ms, 99)),
           "max_abs_diff": _max_gap(got, want),
           "not_bitwise": mismatched,
           "drift": {"status": drift["status"],
                     "rowsSeen": drift["rowsSeen"]}}
    log(f"[{tag}] default ServeConfig() server: {len(records)} requests from "
        f"{threads} threads, {out['requests_per_s']:.0f} requests/s, p50 "
        f"{out['ms_p50']:.3f} ms, p99 {out['ms_p99']:.3f} ms; max |answer - "
        f"guarded plan| {out['max_abs_diff']:.3e} (tol {SERVE_SCORE_TOL}), "
        f"{mismatched} not bitwise; the tenant's sentinel "
        f"{json.dumps(out['drift'])}")
    if out["max_abs_diff"] > SERVE_SCORE_TOL or _drift_misread(drift) \
            or drift["rowsSeen"] != len(records):
        raise AssertionError(f"[{tag}] the default server's answers or its "
                             f"drift sentinel are off")
    return out


def _drift_summary(report: dict, top: int = 3) -> dict:
    """A drift report's status, rows and its ``top`` features by JS."""
    return {"status": report["status"], "rowsSeen": report["rowsSeen"],
            "top": [(f["feature"], f["jsDivergence"], f["status"])
                    for f in report["features"][:top]]}


def _drift_misread(drift: dict) -> bool:
    """Whether an unshifted holdout's drift state reads other than ``ok``
    over a sample of at least DRIFT_MIN_RECORDS records."""
    return drift["rowsSeen"] >= DRIFT_MIN_RECORDS \
        and drift["status"] != "ok"


def phase_problem(device, example, records, tag: str, models=None,
                  serve: bool = True, expect_k1: bool = True) -> dict:
    """One problem path: ``example.run`` (``Workflow.train``: typed
    features, transmogrify, the selector's holdout cut and search, the
    winner's refit and holdout evaluation) on ``records`` on ``device``,
    timed by stage and by family, K1's launches by family and slot count
    counted from zero just before the train; then, with ``serve``, save,
    reload and serve (``_serve_problem``). Fails unless every tree family
    launched K1 on a card (and, with ``expect_k1``, the workflow did) and
    the metrics are finite."""
    dev = resolve_device(device)
    sel = example.default_selector(dev, models=models)
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families)
    clear_design_cache()
    validator.reset_family_profile()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    run = example.run(records, device=dev, models=sel.models)
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    selected = run.model.result_features[0].origin_stage
    s = selected.summary
    mm = metric_matrix(selected)
    plan = run.workflow.last_prepare_plan
    search_label = next(k for k in plan.fit_seconds
                        if k.startswith("ModelSelector("))
    X = run.model.train_dataset[run.vector.name].data
    larger = s.metric_larger_better
    means = mm.mean(axis=0)
    out = {"records": len(records), "matrix_shape": list(X.shape),
           "matrix_device": str(X.device),
           "train_s": sum(run.workflow.last_train_seconds.values()),
           "workflow_seconds": dict(run.workflow.last_train_seconds),
           "search_s": plan.fit_seconds[search_label],
           "selector_timings_s": dict(s.timings), "families": families,
           "k1_launches": launches, "k1_launches_by_c": by_c,
           "winner": s.best_model_name, "winner_params": s.best_model_params,
           "winner_index": int(np.argmax(means) if larger
                               else np.argmin(means)),
           "best_metric": s.best_validation_metric,
           "metric": s.evaluation_metric,
           "holdout": run.metrics.to_json(), "metric_matrix": mm.tolist(),
           "candidates": [(r.model_name, r.params)
                          for r in s.validation_results],
           "data_prep": s.data_prep_results, "run": run}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    hold = {k: v for k, v in out["holdout"].items()
            if isinstance(v, float)}
    log(f"[{tag}] {len(records)} records on {dev}: prepared matrix "
        f"{tuple(X.shape)} {X.dtype} on {X.device}; train "
        f"{out['train_s']:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in out["workflow_seconds"].items())
        + f"), search {out['search_s']:.3f} s; selector stages "
        f"{json.dumps({k: round(v, 3) for k, v in s.timings.items()})}")
    out["host_path_s"] = s.timings["validate"] - sum(
        rec["seconds"] for rec in families.values())
    log(f"[{tag}] families validated candidate by candidate on the host "
        f"path (the multinomial LR, a family whose device search declined):"
        f" {out['host_path_s']:.2f} s of the validate stage")
    for name, rec in families.items():
        log(f"[{tag}] {name}: {rec['candidates']} models x folds in "
            f"{rec['seconds']:.2f} s; K1 launches "
            f"{rec.get('k1_launches', 0)}: " + " ".join(
                f"C={c}:{k}" for c, k in rec["k1_launches_by_c"].items()))
    log(f"[{tag}] winner {s.best_model_name} {s.best_model_params} mean "
        f"{s.evaluation_metric} {s.best_validation_metric:.6f}; holdout "
        + " ".join(f"{k} {v:.6f}" for k, v in hold.items())
        + f"; K1 launches {launches}"
        + (f"; max_memory_allocated {out['max_memory_allocated']}"
           if "max_memory_allocated" in out else ""))
    if not np.all(np.isfinite(mm)) or not all(np.isfinite(list(
            hold.values()))):
        raise AssertionError(f"[{tag}] non-finite metrics: {mm}, {hold}")
    if dev.type == "cuda":
        idle = [f for f in families if "Forest" in f or "Tree" in f
                or "GBT" in f or "XGBoost" in f
                if families[f].get("k1_launches", 0) == 0]
        if (expect_k1 and launches == 0) or idle:
            raise AssertionError(f"[{tag}] K1 never launched by "
                                 f"{idle or 'the workflow'}")
    if serve:
        out["serve"] = _serve_problem(run, f"{tag}-serve")
    return out


def _variance_check(device, X: np.ndarray, y: np.ndarray) -> dict:
    """A DecisionTreeRegressor of depth VARIANCE_DEPTH on the Boston
    matrix on ``device`` (float32 [w, wy, wyy] statistics summed by K1 on
    a card) against the CPU's float64 fit: the split heaps' nodes whose
    feature or threshold differ (thresholds compared to 1e-5 of their
    size: the card bins in float32), and both fits' RMSE on the
    matrix."""
    cpu = trees.DecisionTreeRegressor(max_depth=VARIANCE_DEPTH,
                                      device="cpu").fit_arrays(X, y)
    card = trees.DecisionTreeRegressor(max_depth=VARIANCE_DEPTH,
                                       device=device).fit_arrays(X, y)
    f, t = card.feats.cpu().numpy(), card.thrs.double().cpu().numpy()
    cf, ct = cpu.feats.numpy(), cpu.thrs.numpy()
    with np.errstate(invalid="ignore"):
        close = (np.isinf(t) & np.isinf(ct)) | (
            np.abs(t - ct) <= 1e-5 * np.maximum(np.abs(ct), 1.0))
    out = {"nodes": int(cf.size),
           "nodes_differing": int(np.sum((f != cf) | ~close)),
           "rmse": float(np.sqrt(np.mean(
               (card.predict_arrays(X).data - y) ** 2))),
           "cpu_rmse": float(np.sqrt(np.mean(
               (cpu.predict_arrays(X).data - y) ** 2)))}
    clear_design_cache()
    log(f"[boston] variance statistics, DecisionTreeRegressor depth "
        f"{VARIANCE_DEPTH} on {X.shape}: split nodes differing from the "
        f"CPU's {out['nodes_differing']} of {out['nodes']}; RMSE on "
        f"{device} {out['rmse']:.6f}, cpu {out['cpu_rmse']:.6f}")
    return out


def phase_iris(device, rows: int = IRIS_ROWS) -> dict:
    """[iris]: the Iris example (``examples/iris.py``) on ``rows``
    synthetic records: the example's five-family pool (LR 8, RF 18 at
    PATH_TREES trees, NaiveBayes 1, DT 18, XGBoost 9 points, x 3 folds)
    and its DataCutter(reserve_test_fraction=0.2), then save, serve and
    compiled scoring."""
    from transmogrifai_tpu_torch.examples import iris
    t0 = time.perf_counter()
    records = iris.synthetic_iris(rows)
    gen_s = time.perf_counter() - t0
    out = phase_problem(device, iris, records, "iris",
                        models=_problem_models(iris, device, PATH_TREES))
    out["generate_s"] = gen_s
    if len(out["candidates"]) != 54:
        raise AssertionError(f"[iris] {len(out['candidates'])} candidates, "
                             f"not the example's 54")
    return out


def phase_boston(device, rows: int = BOSTON_ROWS) -> dict:
    """[boston]: the Boston example (``examples/boston.py``) on ``rows``
    synthetic records: the default regression pool (LinearRegression 8,
    RF 18 at PATH_TREES trees, GBT 18, GLM 6 points, x 3 folds) and its
    DataSplitter(reserve_test_fraction=0.2), then save, serve and
    compiled scoring; last, the variance statistics' card-against-CPU
    check (``_variance_check``)."""
    from transmogrifai_tpu_torch.examples import boston
    t0 = time.perf_counter()
    records = boston.synthetic_boston(rows)
    gen_s = time.perf_counter() - t0
    out = phase_problem(device, boston, records, "boston",
                        models=_problem_models(boston, device, PATH_TREES))
    out["generate_s"] = gen_s
    if len(out["candidates"]) != 50:
        raise AssertionError(f"[boston] {len(out['candidates'])} "
                             f"candidates, not the default pool's 50")
    # the prepared matrix of every record, in record order
    X = out["run"].model.train_dataset[out["run"].vector.name].data
    out["variance"] = _variance_check(
        device, X.double().cpu().numpy(),
        np.array([r["medv"] for r in records]))
    return out


def path_pool(device):
    """The default binary pool on ``device`` with its forests at
    PATH_TREES trees (grids whole)."""
    return [(est.with_params(num_trees=PATH_TREES)
             if type(est).__name__ == "RandomForestClassifier" else est, grid)
            for est, grid in default_binary_models(resolve_device(device))]


def _problem_models(example, device, num_trees: int = AGREE_TREES):
    """The example's pool on ``device`` with its forests at ``num_trees``
    trees (their grids whole)."""
    sel = example.default_selector(device)
    out = []
    for est, grid in sel.models:
        if hasattr(est, "num_trees") and type(est).__name__.startswith(
                "RandomForest"):
            est = est.with_params(num_trees=num_trees)
        out.append((est, grid))
    return out


def _agree(card: dict, cpu: dict, tag: str, relative: bool) -> dict:
    """Metric matrices within AGREE_TOL (relative to the CPU's value for
    RMSE-like metrics) and the same winner unless the CPU's top two means
    lie within it."""
    a, b = (np.asarray(r["metric_matrix"]) for r in (card, cpu))
    gap = np.abs(a - b) / (np.abs(b) if relative else 1.0)
    names = [n for n, _ in cpu["candidates"]]
    tol = np.array([GBT_REG_DEEP_TOL if n == "GBTRegressor"
                    and p.get("max_depth", 5) >= 6 else AGREE_TOL
                    for n, p in cpu["candidates"]])
    by_family = {f: gap[:, [i for i, n in enumerate(names) if n == f]]
                 .max(axis=0).tolist() for f in dict.fromkeys(names)}
    means = b.mean(axis=0)
    order = np.sort(means)[::-1] if not relative else np.sort(means)
    scale = abs(order[0]) if relative else 1.0
    close = len(order) > 1 and abs(order[0] - order[1]) < AGREE_TOL * scale
    same = card["winner_index"] == cpu["winner_index"]
    over = [(names[i], cpu["candidates"][i][1], float(gap[:, i].max()))
            for i in range(gap.shape[1]) if gap[:, i].max() > tol[i]]
    named = [(names[i], cpu["candidates"][i][1], float(gap[:, i].max()))
             for i in range(gap.shape[1])
             if AGREE_TOL < gap[:, i].max() <= tol[i]]
    log(f"[problems-agree] {tag}: max |card - cpu|"
        f"{' / |cpu|' if relative else ''} {float(gap.max()):.3e} (tol "
        f"{AGREE_TOL}) by family and grid point {json.dumps(by_family)}; "
        f"winner card {card['winner_index']} ({card['winner']}) cpu "
        f"{cpu['winner_index']} ({cpu['winner']})"
        f"{' (top two within tol)' if close else ''}; points within "
        f"GBT_REG_DEEP_TOL {GBT_REG_DEEP_TOL} only (deep GBT regression "
        f"trees, float32 gain ties): {named}; points over their tol "
        f"{over}")
    if over or not (same or close):
        raise AssertionError(f"[problems-agree] {tag}: card and CPU "
                             f"searches disagree")
    return {"max_diff": float(gap.max()), "relative": relative,
            "by_family": by_family, "same_winner": same,
            "within_deep_gbt_tol_only": named,
            "card_winner": card["winner"], "cpu_winner": cpu["winner"]}


def phase_problems_agree(device, rows: int = PROBLEMS_AGREE_ROWS,
                         parts=("iris", "boston", f"k{WIDE_K}")) -> dict:
    """[problems-agree], the searches named in ``parts``: both examples on
    ``rows`` records on the card (float32) and on the CPU (float64),
    forests at AGREE_TREES trees, the draws from the same CPU generators;
    then a K = 7 multiclass array search (WIDE_ROWS x WIDE_COLS, the
    default multiclass pool with its forests at AGREE_TREES trees), whose
    forests run K1 in split statistic blocks on the card."""
    from transmogrifai_tpu_torch.examples import boston, iris
    out = {}
    if "boston" in parts and resolve_device(device).type == "cuda":
        out["row_order"] = phase_row_order(device)
    for example, tag, relative in ((iris, "iris", False),
                                   (boston, "boston", True)):
        if tag not in parts:
            continue
        records = (example.synthetic_iris(rows, seed=7) if tag == "iris"
                   else example.synthetic_boston(rows, seed=7))
        t0 = time.perf_counter()
        card = phase_problem(device, example, records, f"agree-{tag}-card",
                             models=_problem_models(example, device),
                             serve=False)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = phase_problem("cpu", example, records, f"agree-{tag}-cpu",
                            models=_problem_models(example, "cpu"),
                            serve=False)
        cpu_s = time.perf_counter() - t0
        out[tag] = _agree(card, cpu, tag, relative)
        out[tag].update(card_s=card_s, cpu_s=cpu_s)
        deep = [i for i, (n, p) in enumerate(cpu["candidates"])
                if n == "GBTRegressor" and p.get("max_depth", 5) >= 6]
        if deep:
            run = cpu["run"]
            est = next(e for e, _ in _problem_models(example, device)
                       if type(e).__name__ == "GBTRegressor")
            out[tag]["tree_precision_witness"] = tree_precision_witness(
                device, example.default_selector, est,
                [cpu["candidates"][i][1] for i in deep],
                run.model.train_dataset[run.vector.name].data,
                np.asarray(run.model.train_dataset[next(
                    f.name for f in run.model.raw_features()
                    if f.is_response)].data, dtype=np.float64),
                np.asarray(cpu["metric_matrix"])[:, deep],
                np.asarray(card["metric_matrix"])[:, deep],
                f"problems-agree {tag}", relative=relative)
    if f"k{WIDE_K}" not in parts:
        return out
    from transmogrifai_tpu_torch.models.registry import (
        default_multiclass_models)
    from transmogrifai_tpu_torch.selector import (
        MultiClassificationModelSelector)
    X, y = wide_multiclass(WIDE_ROWS, WIDE_COLS, WIDE_K)
    runs = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        dev = resolve_device(where)
        models = [(est.with_params(num_trees=AGREE_TREES)
                   if type(est).__name__ == "RandomForestClassifier"
                   else est, grid)
                  for est, grid in default_multiclass_models(dev)]
        sel = MultiClassificationModelSelector.with_cross_validation(
            models=models, device=dev)
        families: dict = {}
        for est, _ in sel.models:
            time_family(est, families)
        level_hist.launches = 0
        level_hist.launches_by_c.clear()
        t0 = time.perf_counter()
        fitted = sel.fit_arrays(X if dev.type == "cpu" else
                                torch.as_tensor(X, dtype=torch.float32,
                                                device=dev), y)
        s = fitted.summary
        mm = metric_matrix(fitted)
        runs[side] = {
            "metric_matrix": mm.tolist(), "winner": s.best_model_name,
            "winner_index": int(np.argmax(mm.mean(axis=0))),
            "candidates": [(r.model_name, r.params)
                           for r in s.validation_results],
            "seconds": time.perf_counter() - t0, "families": families,
            "k1_launches": level_hist.launches,
            "k1_launches_by_c": dict(sorted(
                level_hist.launches_by_c.items()))}
        log(f"[problems-agree] K={WIDE_K} array search {X.shape} on {dev}: "
            f"{runs[side]['seconds']:.2f} s, winner "
            f"{s.best_model_name} {s.best_model_params}; K1 launches "
            f"{level_hist.launches}")
    out[f"k{WIDE_K}"] = _agree(runs["card"], runs["cpu"], f"K={WIDE_K}",
                               False)
    out[f"k{WIDE_K}"]["k1_launches"] = runs["card"]["k1_launches"]
    out[f"k{WIDE_K}"]["k1_launches_by_c"] = runs["card"]["k1_launches_by_c"]
    if resolve_device(device).type == "cuda" and \
            runs["card"]["k1_launches"] == 0:
        raise AssertionError(f"[problems-agree] the K={WIDE_K} search "
                             f"launched no K1")
    clear_design_cache()
    return out


def phase_problems(device, agree: bool = True) -> dict:
    """The four phases of the multiclass and regression slice (without
    [problems-agree] unless ``agree``)."""
    out = {"k1": phase_k1_problems(device)}
    out["iris"] = phase_iris(device)
    out["boston"] = phase_boston(device)
    if agree:
        out["agree"] = phase_problems_agree(device)
    return out


# ---------------------------------------------------------------------------
# every transmogrify feature family: [families] (with K1 at the
# bucketizer's one-feature shape and on the family matrix), then
# [families-agree]
# ---------------------------------------------------------------------------

#: records of the family workflow: 75,000 train rows of ~1,100 columns
FAMILIES_ROWS = 100_000
#: the family stages whose device part must run in both plans
FAMILY_DEVICE_STAGES = (
    "DateToUnitCircleVectorizer", "GeolocationVectorizerModel",
    "RealMapVectorizerModel", "TextMapPivotVectorizerModel",
    "_MultiPickListMapModel", "DateMapToUnitCircleVectorizerModel")
#: slot counts of the auto-bucketizer's depth-2 tree (levels 0 and 1)
BUCKET_SLOTS = (1, 2)
#: card against CPU metric of a LogisticRegression point of reg_param
#: below FAMILY_LINEAR_REG or of a LinearSVC point on the family matrix
#: (3,750 x 1,095: 1,024 columns hash random strings, noise to the
#: label): float32 and float64 iterates part within the fixed iteration
#: budget. Measured on an H100 at 5,000 records: 4.9e-3 and 1.28e-2 (LR
#: at reg_param 0.001), 8.5e-3 to 2.73e-2 (LinearSVC), <= 3.3e-5 at every
#: other LR point, which keeps AGREE_TOL as every tree point does (or
#: GBT_SMALL_LEAF_TOL). The wide limit holds only while
#: ``linear_precision_witness`` shows the gap is float32's
FAMILY_LINEAR_TOL = 3e-2
FAMILY_LINEAR_REG = 0.01
#: the linear families of the default binary pool
LINEAR_FAMILIES = ("LogisticRegression", "LinearSVC")


def _stage_seconds(listener, coverage) -> dict:
    """Seconds of every stage class's fits and transforms, each transform
    on the device or the host as the prepare plan ran it."""
    lowered = {label.split("(")[0] for label in coverage.lowered}
    out: dict = {}
    for m in listener.metrics.stage_metrics:
        cls = m.stage_name.rsplit("_", 1)[0]
        where = ("fit" if m.phase == "fit" else
                 "device" if cls in lowered else "host")
        rec = out.setdefault(cls, {})
        rec[where] = rec.get(where, 0.0) + m.seconds
    return out


class K1ByFit(WorkflowListener):
    """A WorkflowListener that also files K1's launches by slot count
    under the stage whose fit row follows them (no transform launches
    K1): ``k1_by_fit[class name]``. Made after the counts are zeroed."""

    def __init__(self):
        super().__init__()
        self.k1_by_fit: dict = {}
        self._seen = collections.Counter(level_hist.launches_by_c)

    def on_stage_completed(self, stage, phase, seconds, n_rows,
                           compile_seconds=0.0):
        super().on_stage_completed(stage, phase, seconds, n_rows,
                                   compile_seconds=compile_seconds)
        now = collections.Counter(level_hist.launches_by_c)
        if phase == "fit" and now != self._seen:
            rec = self.k1_by_fit.setdefault(type(stage).__name__,
                                            collections.Counter())
            rec.update(now - self._seen)
        self._seen = now


def _bucketizer_fit(plan, listener, model) -> dict:
    """The auto-bucketizer's fit seconds (the prepare plan's), K1 launches
    by slot count (the listener's) and the fitted split points."""
    name = "DecisionTreeNumericBucketizer"
    by_c = listener.k1_by_fit.get(name, {})
    fitted = next(s for s in model.stages()
                  if type(s).__name__ == name + "Model")
    return {"seconds": sum(v for k, v in plan.fit_seconds.items()
                           if k.startswith(name + "(")),
            "k1_launches_by_c": dict(sorted(by_c.items())),
            "k1_launches": sum(by_c.values()),
            "split_points": list(fitted.split_points)}


def _train_example(example, device, records, models=None,
                   tag: str = "families") -> dict:
    """``example.run`` (``examples/families.py`` or ``examples/text.py``)
    on ``records`` on ``device`` with the default selector over ``models``
    (default: the whole default pool): seconds by stage, K1 launches by
    family and slot count (counted from zero just before the train) and by
    the stage whose fit launched them (``out["listener"]``), the winner
    and holdout metrics. Fails unless the selector received the prepared
    matrix as a tensor on ``device``, every tree family launched K1 on a
    card and the holdout's AuROC lies above 0.5."""
    dev = resolve_device(device)
    sel = example.default_selector(dev, models=models)
    fams: dict = {}
    for est, _ in sel.models:
        time_family(est, fams)
    seen: dict = {}
    spy_fit_columns(sel, seen, False)
    clear_design_cache()
    validator.reset_family_profile()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    listener = K1ByFit()
    run = example.run(records, device=dev, model_stage=sel,
                      listener=listener)
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    plan, wf = run.workflow.last_prepare_plan, run.workflow
    selected = next(s for s in run.model.stages()
                    if type(s).__name__ == "SelectedModel")
    s = selected.summary
    mm = metric_matrix(selected)
    X = run.model.train_dataset[run.vector.name].data
    search_label = next(k for k in plan.fit_seconds
                        if k.startswith("ModelSelector("))
    fits = {k: v for k, v in plan.fit_seconds.items() if k != search_label}
    out = {"records": len(records), "matrix_shape": list(X.shape),
           "matrix_dtype": str(X.dtype), "matrix_device": str(X.device),
           "raw_extraction_s": wf.last_train_seconds["raw_extraction"],
           "vectorizer_fits_s": sum(fits.values()),
           "device_transforms_s": plan.device_transform_seconds,
           "host_stage_transforms_s": plan.host_transform_seconds,
           "bytes_to_device": plan.bytes_to_device,
           "search_s": plan.fit_seconds[search_label],
           "train_s": sum(wf.last_train_seconds.values()),
           "train_score_evaluate_s": run.seconds,
           "stage_seconds": _stage_seconds(listener, plan.coverage),
           "selector_timings_s": dict(s.timings), "families": fams,
           "k1_launches": launches, "k1_launches_by_c": by_c,
           "winner": s.best_model_name, "winner_params": s.best_model_params,
           "winner_index": int(np.argmax(mm.mean(axis=0))),
           "best_metric": s.best_validation_metric,
           "holdout_AuPR": run.metrics.AuPR,
           "holdout_AuROC": run.metrics.AuROC,
           "metric_matrix": mm.tolist(), "fit_columns": seen,
           "host_stages": [list(f) for f in plan.coverage.fallback],
           "device_stages": [label.split("(")[0]
                             for label in plan.coverage.lowered],
           "run": run, "listener": listener}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {len(records)} records on {dev}: prepared matrix "
        f"{tuple(X.shape)} {X.dtype} on {X.device}; seconds: raw extraction "
        f"{out['raw_extraction_s']:.3f}, vectorizer fits "
        f"{out['vectorizer_fits_s']:.3f}, device transforms "
        f"{out['device_transforms_s']:.3f}, host-stage transforms "
        f"{out['host_stage_transforms_s']:.3f}, search "
        f"{out['search_s']:.3f}; train {out['train_s']:.3f}, train + score "
        f"+ evaluate {run.seconds:.3f}; {plan.bytes_to_device} bytes of host "
        f"columns copied up")
    log(f"[{tag}] stage seconds (fit / device / host transform): "
        + json.dumps({k: {w: round(v, 4) for w, v in rec.items()}
                      for k, rec in out["stage_seconds"].items()}))
    for label, why in plan.coverage.fallback:
        log(f"[{tag}] host stage {label.split('(')[0]}: {why}")
    for name, rec in fams.items():
        log(f"[{tag}] {name}: {rec['candidates']} models x folds in "
            f"{rec['seconds']:.2f} s; K1 launches {rec['k1_launches']}: "
            + " ".join(f"C={c}:{k}"
                       for c, k in rec["k1_launches_by_c"].items()))
    log(f"[{tag}] winner {s.best_model_name} {s.best_model_params} mean AuPR "
        f"{s.best_validation_metric:.6f}; holdout AuPR {run.metrics.AuPR:.6f}"
        f" AuROC {run.metrics.AuROC:.6f}; K1 launches {launches}"
        + (f"; max_memory_allocated {out['max_memory_allocated']}"
           if "max_memory_allocated" in out else ""))
    if not (seen.get("is_tensor") and X.device.type == dev.type):
        raise AssertionError(f"[{tag}] the selector did not receive the "
                             f"prepared matrix as a tensor on {dev}")
    if mm.shape[0] != 3 or not np.all(np.isfinite(mm)):
        raise AssertionError(f"[{tag}] bad metric matrix {mm}")
    if dev.type == "cuda":
        idle = [f for f, rec in fams.items()
                if f in TREE_FAMILIES and rec["k1_launches"] == 0]
        if idle:
            raise AssertionError(f"[{tag}] K1 never launched by {idle}")
    if not 0.5 < run.metrics.AuROC <= 1.0:
        raise AssertionError(f"[{tag}] holdout evaluation is off: "
                             f"{run.metrics}")
    return out


def _train_families(device, records, models=None, tag: str = "families"
                    ) -> dict:
    """``examples/families.run`` through ``_train_example``, with the
    auto-bucketizer's fit (seconds, K1 launches, split points; on a card
    it must launch K1) and the family stages that must run on the
    device."""
    from transmogrifai_tpu_torch.examples import families
    out = _train_example(families, device, records, models=models, tag=tag)
    run, listener = out["run"], out.pop("listener")
    bucket = _bucketizer_fit(run.workflow.last_prepare_plan, listener,
                             run.model)
    out["bucketizer"] = bucket
    log(f"[{tag}] DecisionTreeNumericBucketizer fit "
        f"{bucket['seconds']:.3f} s, K1 launches {bucket['k1_launches']} "
        f"{json.dumps(bucket['k1_launches_by_c'])}, split points "
        f"{bucket['split_points']}")
    missing = [c for c in FAMILY_DEVICE_STAGES
               if c not in out["device_stages"]]
    if missing:
        raise AssertionError(f"[{tag}] ported stages off the device: "
                             f"{missing}")
    if resolve_device(device).type == "cuda" and not bucket["k1_launches"]:
        raise AssertionError(f"[{tag}] K1 never launched by the "
                             f"auto-bucketizer")
    return out


def matrix_k1_inputs(device, X, y: np.ndarray, name: str):
    """(label, design, statistics, slot counts, exact) of a workflow's
    prepared train matrix ``X`` (binned as the search bins it), one at a
    time: a forest's statistics (one-hot labels ``y`` times Poisson
    weights times a fold mask; C = 1, 32, 256, exact) and the GBT's
    [g, h] (C = 256, within float32 rounding); ``name`` heads the
    labels."""
    dev = resolve_device(device)
    for kind, slots, exact in (("cls", (1, 32, 256), True),
                               ("gbt", (256,), False)):
        design = _PackedDesign(X, 32, dev)
        st = _problem_k1_stats(design, kind, y)
        label = f"{name} forest" if kind == "cls" else f"{name} GBT [g,h]"
        yield label, design, st, slots, exact
        del design, st
        clear_design_cache()


def family_k1_inputs(device, records, X, y: np.ndarray):
    """Each K1 shape of the family path, as ``matrix_k1_inputs`` gives
    them: the auto-bucketizer's one-feature design (``real``'s present
    values of the train split and its one-hot labels, the statistics its
    tree sums; C = 1 and 2, exact), then the family matrix ``X``."""
    dev = resolve_device(device)
    train, _ = titanic.stratified_split(records, label_key="label")
    x = np.array([np.nan if r["real"] is None else r["real"]
                  for r in train])
    lab = np.array([r["label"] for r in train])
    ok = ~np.isnan(x)
    design = _PackedDesign(x[ok].reshape(-1, 1), 32, dev)
    st = _on(np.eye(2)[lab[ok].astype(np.int64)], design.dtype,
             dev).contiguous()
    yield "bucketizer d=1", design, st, BUCKET_SLOTS, True
    del design, st
    clear_design_cache()
    yield from matrix_k1_inputs(dev, X, y, "family matrix")


def phase_k1_inputs(device, inputs, tag: str, seed: int) -> dict:
    """K1 against its plain version at each shape of ``inputs`` (as
    ``matrix_k1_inputs`` yields them) on random slots from ``seed``:
    agreement, kernel, plain and ``index_add_`` times beside the
    bound."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cases = []
    for label, design, st, slots, exact in inputs:
        plan = design.hist_plan(st.shape[1])
        log(f"[{tag}] {label}: n={design.n} d={design.d} "
            f"TB={design.total_bins} S={st.shape[1]} ids {design.ids.dtype}"
            f" groups={plan.n_groups}")
        for C in slots:
            slot = torch.randint(0, C, (design.n,), generator=gen,
                                 device=device, dtype=torch.int32)
            cases.append(k1_case(f"{label} C={C}", design.ids,
                                 design.offsets, slot, st, C,
                                 design.total_bins, plan, exact=exact))
    return {"cases": cases}


def phase_families(device, rows: int = FAMILIES_ROWS, models=None,
                   k1: bool = True) -> dict:
    """[families]: the family workflow (``examples/families.py``) on
    ``rows`` testkit records with ``models`` (default: the whole default
    pool, its forests at PATH_TREES trees, ``path_pool``); with ``k1``,
    K1 at its shapes (``family_k1_inputs``, the card only); then save,
    reload, the holdout through the compiled plan
    (bitwise the columnar path) and 1,001 records served one at a time
    (``_serve_problem``)."""
    from transmogrifai_tpu_torch.examples import families
    t0 = time.perf_counter()
    records = families.synthetic_families(rows)
    gen_s = time.perf_counter() - t0
    log(f"[families] {rows} records generated in {gen_s:.2f} s")
    out = _train_families(device, records,
                          models=models or path_pool(device))
    out["generate_s"] = gen_s
    run = out.pop("run")
    if models is None and len(out["metric_matrix"][0]) != 48:
        raise AssertionError(f"[families] {len(out['metric_matrix'][0])} "
                             f"grid points, not the default pool's 48")
    if k1:
        X = run.model.train_dataset[run.vector.name].data
        train, _ = titanic.stratified_split(records, label_key="label")
        out["k1"] = phase_k1_inputs(device, family_k1_inputs(
            device, records, X, np.array([r["label"] for r in train])),
            "k1-families", 4)
        del X
    out["serve"] = _serve_problem(run, "families-serve")
    if out["serve"]["max_abs_diff_compiled"] != 0.0:
        raise AssertionError("[families] compiled scores are not bitwise "
                             "the columnar path's")
    coverage = run.model.scoring_plan().coverage.to_json()
    out["serve"]["plan_coverage"] = coverage
    lowered = {label.split("(")[0] for label in coverage["lowered"]}
    if not set(FAMILY_DEVICE_STAGES) <= lowered:
        raise AssertionError(f"[families] the compiled plan runs "
                             f"{sorted(set(FAMILY_DEVICE_STAGES) - lowered)}"
                             f" on the host")
    return out


@contextlib.contextmanager
def linear_dtype(dtype):
    """Inside the block the linear families compute in ``dtype`` on any
    device: the port's ``working_dtype`` (float32 on a card, float64 on
    the CPU) replaced in the modules of their search and scoring."""
    from transmogrifai_tpu_torch.models import base
    from transmogrifai_tpu_torch.parallel import cv
    mods = (base, linear, cv)
    real = [m.working_dtype for m in mods]
    for m in mods:
        m.working_dtype = lambda device: dtype
    try:
        yield
    finally:
        for m, r in zip(mods, real):
            m.working_dtype = r


def linear_precision_witness(device, X: torch.Tensor, y: np.ndarray,
                             cpu_metrics: np.ndarray,
                             tag: str = "families-agree") -> dict:
    """The linear families' search (the card-against-CPU pool's linear
    families under the examples' 3-fold selector) on the CPU run's
    prepared train matrix ``X`` twice more: on ``device`` in float64 and
    on the CPU in float32. Each one's largest gap by grid point to
    ``cpu_metrics``, the CPU run's float64 metrics of those points (the
    same search). The device in float64 must agree within AGREE_TOL: then
    the card's float32 gap is precision's, not a fault of the card's
    path. ``tag`` names the phase in the log."""
    from transmogrifai_tpu_torch.examples import families
    out = {}
    for key, where, dtype in (("device_float64", device, torch.float64),
                              ("cpu_float32", "cpu", torch.float32)):
        dev = resolve_device(where)
        with linear_dtype(dtype):
            sel = families.default_selector(dev, models=small_models(
                dev, families=LINEAR_FAMILIES))
            mm = metric_matrix(sel.fit_arrays(X.to(dev, dtype), y))
        out[key] = np.abs(mm - cpu_metrics).max(axis=0).tolist()
    log(f"[{tag}] linear families against the CPU in float64, "
        f"largest gap by grid point: {resolve_device(device)} in float64 "
        f"{json.dumps(out['device_float64'])}; the CPU in float32 "
        f"{json.dumps(out['cpu_float32'])}")
    if max(out["device_float64"]) > AGREE_TOL:
        raise AssertionError(f"[{tag}] the linear families differ card to "
                             f"CPU in float64 too")
    return out


@contextlib.contextmanager
def tree_dtype(dtype):
    """Inside the block the tree families compute in ``dtype`` on any
    device: the port's ``working_dtype`` replaced in the modules of their
    search and scoring (``models/trees``, ``models/base``), and the level
    histogram routed to its plain version (``level_hist_plain``; K1 sums
    float32 only). The design cache is cleared on entry and on exit, so
    that no design binned in one dtype serves the other."""
    from transmogrifai_tpu_torch.models import base
    real = (trees.working_dtype, base.working_dtype, trees.level_hist)
    trees.working_dtype = base.working_dtype = lambda device: dtype
    trees.level_hist = (
        lambda ids, offsets, slot, stats, num_slots, total_bins, plan=None:
        level_hist_plain(ids, offsets, slot, stats, num_slots, total_bins))
    clear_design_cache()
    try:
        yield
    finally:
        trees.working_dtype, base.working_dtype, trees.level_hist = real
        clear_design_cache()


def phase_row_order(device, seed: int = 13) -> dict:
    """The float64 tree witness's sums (``index_add_rows``) on the card
    against the CPU's ``index_add_``, which adds each index's rows in row
    order: random float64 rows on few indices (many rows an index, as a
    tree level's slots and bins have), 1 to 5 statistics a row and the
    plain histogram of a random design; must be equal bit for bit and
    repeat bit for bit. The atomic ``index_add_`` is logged beside it."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for n, segs, S in ((100_000, 7, 2), (50_000, 300, 3), (20_000, 1, 4),
                       (30_000, 64, 5), (4_000, 16, 1)):
        idx = torch.randint(0, segs, (n,), generator=gen)
        src = torch.randn((n, S), generator=gen, dtype=torch.float64)
        if S == 1:
            src = src[:, 0]
        shape = (segs,) + tuple(src.shape[1:])
        cpu = torch.zeros(shape, dtype=torch.float64).index_add_(0, idx, src)
        idx_d, src_d = idx.to(dev), src.to(dev)
        card = [index_add_rows(torch.zeros(shape, dtype=torch.float64,
                                           device=dev), idx_d, src_d).cpu()
                for _ in range(2)]
        atomic = torch.zeros(shape, dtype=torch.float64, device=dev
                             ).index_add_(0, idx_d, src_d).cpu()
        rec = {"equal_to_cpu": bool(torch.equal(card[0], cpu)),
               "repeats": bool(torch.equal(card[0], card[1])),
               "atomic_equal_to_cpu": bool(torch.equal(atomic, cpu)),
               "max_abs_diff": float((card[0] - cpu).abs().max()),
               "atomic_max_abs_diff": float((atomic - cpu).abs().max())}
        out[f"n={n} segments={segs} S={S}"] = rec
    X, y = make_data(3_000, 12, seed=seed)
    design_cpu = _PackedDesign(X, 32, torch.device("cpu"))
    design = _PackedDesign(X, 32, dev)
    st = torch.randn((3_000, 2), generator=gen, dtype=torch.float64)
    slot = torch.randint(0, 16, (3_000,), generator=gen, dtype=torch.int32)
    cpu = level_hist_plain(design_cpu.ids, design_cpu.offsets, slot, st, 16,
                           design_cpu.total_bins)
    card = level_hist_plain(design.ids, design.offsets, slot.to(dev),
                            st.to(dev), 16, design.total_bins).cpu()
    out["plain histogram C=16 S=2"] = {
        "equal_to_cpu": bool(torch.equal(card, cpu)), "repeats": True,
        "max_abs_diff": float((card - cpu).abs().max())}
    log(f"[row-order] float64 index_add_rows on {dev} against the CPU's "
        f"index_add_: {json.dumps(out)}")
    bad = [k for k, r in out.items()
           if not (r["equal_to_cpu"] and r["repeats"])]
    if bad:
        raise AssertionError(f"[row-order] the card's float64 sums part "
                             f"from the CPU's row order at {bad}")
    return out


def tree_precision_witness(device, selector_fn, est, grid, X, y,
                           cpu_metrics: np.ndarray, card_metrics: np.ndarray,
                           tag: str, relative: bool = False,
                           tol: float = AGREE_TOL) -> dict:
    """The tree grid points ``grid`` of ``est``'s family searched again by
    ``selector_fn(device, models=...)`` (the run's own selector: its
    holdout cut and folds) on the CPU run's prepared train matrix ``X``,
    in float64 on ``device`` through the plain histogram
    (``tree_dtype``). Its largest gap by grid point to ``cpu_metrics``
    (the CPU run's float64 metrics of those points; relative to them with
    ``relative``) must be within ``tol``; within AGREE_TOL, the card's
    float32 gap there (``card_metrics``, logged beside it) is float32's,
    not the card path's. ``tag`` names the phase in the log."""
    dev = resolve_device(device)
    runs, seconds = [], []
    with tree_dtype(torch.float64):
        # twice on a card: the float64 path adds in row order there
        # (``index_add_rows``), so its matrix must repeat bit for bit
        for _ in range(2 if dev.type == "cuda" else 1):
            sel = selector_fn(dev, models=[(est, grid)])
            t0 = time.perf_counter()
            runs.append(metric_matrix(sel.fit_arrays(
                torch.as_tensor(X).to(dev, torch.float64), y)))
            seconds.append(time.perf_counter() - t0)
    mm = runs[0]
    scale = np.abs(cpu_metrics) if relative else 1.0
    out = {"points": grid, "seconds": seconds, "relative": relative,
           "tol": tol,
           "repeats_bitwise": bool(np.array_equal(runs[0], runs[-1])),
           "device_float64": (np.abs(mm - cpu_metrics) / scale)
           .max(axis=0).tolist(),
           "device_float64_exact": bool(np.array_equal(mm, cpu_metrics)),
           "device_float32": (np.abs(card_metrics - cpu_metrics) / scale)
           .max(axis=0).tolist()}
    out["within_agree_tol"] = max(out["device_float64"]) <= AGREE_TOL
    log(f"[{tag}] tree float64 witness, {type(est).__name__} at {grid}: "
        f"largest gap{' / |cpu|' if relative else ''} to the CPU by grid "
        f"point: {dev} in float64 (plain histogram, row-order sums, "
        f"{' and '.join(f'{t:.2f}' for t in seconds)} s) "
        f"{json.dumps(out['device_float64'])} (tol {tol}; within AGREE_TOL "
        f"{AGREE_TOL}: {out['within_agree_tol']}; equal to the CPU's: "
        f"{out['device_float64_exact']}; the second run repeats the first "
        f"bit for bit: {out['repeats_bitwise']}); the card in float32 "
        f"{json.dumps(out['device_float32'])}")
    if max(out["device_float64"]) > tol or not out["repeats_bitwise"]:
        raise AssertionError(f"[{tag}] the tree points differ card to CPU "
                             f"in float64 too, or between two runs")
    return out


def _family_tol(result) -> float:
    """[families-agree]'s metric limit of a grid point: GBT_SMALL_LEAF_TOL
    at the GBT points of min_child_weight < 10, FAMILY_LINEAR_TOL at the
    LogisticRegression points of reg_param < FAMILY_LINEAR_REG and every
    LinearSVC point, AGREE_TOL elsewhere."""
    name, params = result.model_name, result.params
    if name == "GBTClassifier" and params.get("min_child_weight", 1.0) < 10:
        return GBT_SMALL_LEAF_TOL
    if name == "LinearSVC" or (name == "LogisticRegression" and
                               params["reg_param"] < FAMILY_LINEAR_REG):
        return FAMILY_LINEAR_TOL
    return AGREE_TOL


def _family_columns(metas) -> tuple:
    """Masks over the family matrix's columns: the auto-bucketizer's
    (grouping ``real``: their labels carry its split points) and the float
    value columns (no indicator, not a hash count)."""
    bucket = np.array([m[0] == "real" and m[2] == "real" for m in metas])
    floats = np.array([m[3] is None and not (m[4] or "").startswith("hash_")
                       for m in metas]) & ~bucket
    return bucket, floats


def phase_families_agree(device, rows: int = AGREE_RECORDS,
                         num_rounds: int = AGREE_ROUNDS,
                         num_trees: int = AGREE_TREES) -> dict:
    """[families-agree]: the family workflow on ``rows`` records on
    ``device`` (float32 on a card) and on the CPU (float64) with the
    card-against-CPU pool (its GBT at ``num_rounds`` rounds): equal
    metadata (but for the auto-bucketizer's labels), bitwise equal
    indicator, one-hot, hash and integer columns, float columns within
    PREPARED_REL_TOL of their largest magnitude, metric matrices within
    ``_family_tol``, the linear families' float64 search on ``device``
    within AGREE_TOL of the CPU's (``linear_precision_witness``), the
    same winner unless the CPU's top two lie within AGREE_TOL. The
    auto-bucketizer's split points (its tree bins and sums in float32 on
    the card) and the rows whose bucket differs are reported."""
    from transmogrifai_tpu_torch.examples import families
    records = families.synthetic_families(rows, seed0=7)
    card = _train_families(device, records, tag="families-agree-card",
                           models=small_models(device, num_rounds,
                                               num_trees))
    cpu = _train_families("cpu", records, tag="families-agree-cpu",
                          models=small_models("cpu", num_rounds, num_trees))
    cols = [r["run"].model.train_dataset[r["run"].vector.name]
            for r in (card, cpu)]
    metas = [[(_norm_uid(c.parent_feature_name), c.parent_feature_type,
               _norm_uid(c.grouping), c.indicator_value, c.descriptor_value)
              for c in col.metadata.columns] for col in cols]
    # the auto-bucketizer's columns aside on each side: their count and
    # labels follow its split points
    (bucket_a, _), (bucket, floats) = (_family_columns(ms) for ms in metas)
    strip = [[m for m, b in zip(ms, mask) if not b]
             for ms, mask in zip(metas, (bucket_a, bucket))]
    if strip[0] != strip[1]:
        raise AssertionError("card and CPU family matrices' metadata differ")
    a = cols[0].data.double().cpu().numpy()
    b = cols[1].data.numpy()
    buckets = a[:, bucket_a], b[:, bucket]
    a, b, floats = a[:, ~bucket_a], b[:, ~bucket], floats[~bucket]
    exact = bool(np.array_equal(a[:, ~floats], b[:, ~floats]))
    scale = np.maximum(np.abs(b[:, floats]).max(axis=0), 1e-30)
    float_rel = float((np.abs(a[:, floats] - b[:, floats]) / scale).max())
    sp_card = card["bucketizer"]["split_points"]
    sp_cpu = cpu["bucketizer"]["split_points"]
    sp_diff = (sum(x != y for x, y in zip(sp_card, sp_cpu))
               + abs(len(sp_card) - len(sp_cpu)))
    sp_gap = (float(np.max(np.abs(np.subtract(sp_card[1:-1],
                                              sp_cpu[1:-1]))))
              if len(sp_card) == len(sp_cpu) > 2 else None)
    rows_moved = (int(np.any(buckets[0] != buckets[1], axis=1).sum())
                  if buckets[0].shape == buckets[1].shape else len(b))
    mc, mp = (np.asarray(r["metric_matrix"]) for r in (card, cpu))
    results = next(s for s in cpu["run"].model.stages()
                   if type(s).__name__ == "SelectedModel"
                   ).summary.validation_results
    tol = np.array([_family_tol(r) for r in results])
    gap = np.abs(mc - mp)
    within = bool(np.all(gap <= tol))
    names = [r.model_name for r in results]
    by_family = {f: gap[:, [i for i, n in enumerate(names) if n == f]]
                 .max(axis=0).tolist() for f in dict.fromkeys(names)}
    means = np.sort(mp.mean(axis=0))[::-1]
    close = len(means) > 1 and means[0] - means[1] < AGREE_TOL
    same = card["winner_index"] == cpu["winner_index"]
    log(f"[families-agree] max |card - cpu| by family and grid point: "
        f"{json.dumps(by_family)}")
    train, _ = titanic.stratified_split(records, label_key="label")
    witness = linear_precision_witness(
        device, cols[1].data, np.array([r["label"] for r in train]),
        mp[:, [i for i, n in enumerate(names) if n in LINEAR_FAMILIES]])
    log(f"[families-agree] prepared {cols[0].data.shape}: metadata equal "
        f"but for the auto-bucketizer's {int(bucket_a.sum())} / "
        f"{int(bucket.sum())} columns (card / cpu); {int(floats.sum())} "
        f"float columns max rel diff {float_rel:.3e} (tol "
        f"{PREPARED_REL_TOL}); the other {int((~floats).sum())} bitwise "
        f"equal: {exact}; auto-bucketizer split points card {sp_card} cpu "
        f"{sp_cpu}: {sp_diff} differ (max |diff| {sp_gap}), {rows_moved} "
        f"of {len(b)} rows in another bucket; max |card - cpu| metric "
        f"{float(gap.max()):.3e} (tol {AGREE_TOL}, {GBT_SMALL_LEAF_TOL} for "
        f"GBT at min_child_weight < 10, {FAMILY_LINEAR_TOL} for LR at "
        f"reg_param < {FAMILY_LINEAR_REG} and LinearSVC): within {within}; "
        f"winner card "
        f"{card['winner_index']} cpu {cpu['winner_index']}"
        f"{' (top two within tol)' if close else ''}; seconds card "
        f"{card['train_score_evaluate_s']:.2f} cpu "
        f"{cpu['train_score_evaluate_s']:.2f}")
    if not exact or float_rel > PREPARED_REL_TOL:
        raise AssertionError("card and CPU family matrices disagree")
    if not within or not (same or close):
        raise AssertionError("card and CPU family searches disagree")
    return {"shape": list(cols[0].data.shape),
            "float_columns": int(floats.sum()),
            "float_max_rel_diff": float_rel, "others_bitwise": exact,
            "bucket_columns": [int(bucket_a.sum()), int(bucket.sum())],
            "split_points_card": sp_card, "split_points_cpu": sp_cpu,
            "split_points_differing": sp_diff,
            "split_points_max_abs_diff": sp_gap,
            "rows_in_another_bucket": rows_moved,
            "metric_max_abs_diff": float(gap.max()),
            "metrics_within_tol": within, "same_winner": same,
            "metric_diff_by_family": by_family,
            "linear_precision_witness": witness,
            "card_s": card["train_score_evaluate_s"],
            "cpu_s": cpu["train_score_evaluate_s"]}


def phase_families_all(device, rows: int = FAMILIES_ROWS,
                       agree: bool = True) -> dict:
    """[families] (K1's family shapes inside) and, with ``agree``,
    [families-agree] in turn."""
    out = {"families": phase_families(device, rows)}
    if agree:
        out["agree"] = phase_families_agree(device)
    return out


# ---------------------------------------------------------------------------
# the text slice: [text], [k1-text], [text-serve], [text-agree]
# ---------------------------------------------------------------------------

#: records of the text workflow (``--text-rows``): 10,000, the lowest the
#: first cut may go, since the whole smoke took 1,211.9 s of its 1,200 s
#: limit with 20,000 (on an H100 host; [text] 135.0 s of it)
TEXT_ROWS = 10_000
#: records of the text workflow's card-against-CPU phase
TEXT_AGREE_ROWS = 2_000
#: records of [text-agree]'s linear check: 7,500 train rows, over three
#: times the text design's ~2,300 columns (at 1,500 rows the float32 fits
#: part from float64 by up to 0.28 of AuPR on the CPU too; at 7,500 by
#: 1.5e-2 at LR's reg_param 0.001, 5.4e-4 at 0.01, 3.5e-3 for LinearSVC)
TEXT_LINEAR_ROWS = 10_000
#: [text-agree]'s linear limit at LogisticRegression's reg_param below
#: FAMILY_LINEAR_REG, the card's float32 against the CPU's float64 on the
#: TEXT_LINEAR_ROWS design; every other linear point is held to
#: AGREE_TOL. Measured on an H100: 1.16e-2 (reg_param 0.001), 8.8e-4 at
#: 0.01, at most 4.1e-6 at 0.1 and 0.2 and for LinearSVC
TEXT_LINEAR_TOL = FAMILY_LINEAR_TOL
#: holdout records the text model's default ServeConfig() server answers
TEXT_SERVER_RECORDS = 2_000
#: card (float32 SGD) against CPU (float64) Word2Vec vectors and document
#: means, on the same draws: the float32 steps part by rounding alone.
#: Measured on an H100 at 2,000 records: 5.3e-8 (vectors), 1.8e-8 (means)
W2V_AGREE_TOL = 1e-6
#: card against CPU LDA topic-word matrix and document mixtures, both in
#: float64: cuBLAS and the CPU sum the products in other orders. Measured
#: on an H100 at 2,000 records: 6.0e-15 (topic-word), 1.1e-12 (mixtures)
LDA_AGREE_TOL = 1e-10
#: the text DAG's host stages whose outputs must be bitwise equal card to
#: CPU (the TF-IDF matrix, the index and the derived values)
TEXT_HOST_STAGES = (
    "TextTokenizer", "TfIdfVectorizerModel", "StringIndexerModel",
    "LangDetector", "TextLenTransformer", "NameEntityRecognizer",
    "NGramSimilarity", "EmailToPickList", "UrlToPickList",
    "PhoneNumberParser")


def _stage_of(model, name: str):
    return next(s for s in model.stages() if type(s).__name__ == name)


def _train_text(device, records, models=None, tag: str = "text") -> dict:
    """``examples/text.run`` through ``_train_example``: Word2Vec's and
    LDA's fit seconds, which must have run on ``device`` (LDA's model
    keeps it), and the holdout's log loss and Brier score."""
    from transmogrifai_tpu_torch.examples import text
    out = _train_example(text, device, records, models=models, tag=tag)
    out.pop("listener")
    run = out["run"]
    fits = run.workflow.last_prepare_plan.fit_seconds
    out["word2vec_fit_s"] = sum(v for k, v in fits.items()
                                if k.startswith("Word2Vec("))
    out["lda_fit_s"] = sum(v for k, v in fits.items()
                           if k.startswith("LDA("))
    out["holdout_LogLoss"] = run.log_loss.LogLoss
    out["holdout_BrierScore"] = run.bin_score.BrierScore
    lda = _stage_of(run.model, "LDAModel")
    out["lda_device"] = str(lda.device)
    log(f"[{tag}] Word2Vec fit {out['word2vec_fit_s']:.3f} s, LDA fit "
        f"{out['lda_fit_s']:.3f} s (LDA on {lda.device}); holdout LogLoss "
        f"{out['holdout_LogLoss']:.6f}, Brier {out['holdout_BrierScore']:.6f}")
    if lda.device.type != resolve_device(device).type:
        raise AssertionError(f"[{tag}] LDA did not fit on {device}")
    return out


def phase_text(device, rows: int = TEXT_ROWS, models=None,
               k1: bool = True,
               server_records: int = TEXT_SERVER_RECORDS) -> dict:
    """[text]: the text workflow (``examples/text.py``) on ``rows``
    records with ``models`` (default: the whole default pool, its forests
    at PATH_TREES trees, ``path_pool``); with
    ``k1``, K1 on the text matrix (``matrix_k1_inputs``, the card only);
    then save (with the drift fingerprints), reload, the holdout through
    the compiled plan (bitwise the columnar path) and its default
    guardrails (the drift sentinel must read ``ok``), 1,001 records served
    one at a time (within 1e-6) and ``server_records`` holdout requests
    through a default ``ServeConfig()`` server (``_serve_problem``)."""
    from transmogrifai_tpu_torch.examples import text
    t0 = time.perf_counter()
    records = text.synthetic_text(rows)
    gen_s = time.perf_counter() - t0
    log(f"[text] {rows} records generated in {gen_s:.2f} s")
    out = _train_text(device, records, models=models or path_pool(device))
    out["generate_s"] = gen_s
    run = out.pop("run")
    if models is None and len(out["metric_matrix"][0]) != 48:
        raise AssertionError(f"[text] {len(out['metric_matrix'][0])} grid "
                             f"points, not the default pool's 48")
    if k1:
        X = run.model.train_dataset[run.vector.name].data
        y = np.asarray(run.model.train_dataset["label"].data,
                       dtype=np.float64)
        out["k1"] = phase_k1_inputs(
            device, matrix_k1_inputs(device, X, y, "text matrix"),
            "k1-text", 5)
        del X
    out["serve"] = _serve_problem(run, "text-serve",
                                  server_records=server_records)
    if out["serve"]["max_abs_diff_compiled"] != 0.0:
        raise AssertionError("[text] compiled scores are not bitwise the "
                             "columnar path's")
    out["serve"]["plan_coverage"] = run.model.scoring_plan(
        ).coverage.to_json()
    return out


def _column_values(col) -> list:
    """A column's values as a list, NaN (an empty numeric value) as
    None so that equal columns compare equal."""
    data = col.data
    if isinstance(data, torch.Tensor):
        data = data.cpu().numpy()
    values = data.tolist() if isinstance(data, np.ndarray) else list(data)
    return [None if isinstance(v, float) and v != v else v for v in values]


def _text_linear_tol(result) -> float:
    """TEXT_LINEAR_TOL at the LogisticRegression points of reg_param <
    FAMILY_LINEAR_REG, AGREE_TOL elsewhere."""
    if (result.model_name == "LogisticRegression"
            and result.params["reg_param"] < FAMILY_LINEAR_REG):
        return TEXT_LINEAR_TOL
    return AGREE_TOL


def text_linear_agree(device, rows: int = TEXT_LINEAR_ROWS) -> dict:
    """[text-agree]'s linear check: the text workflow on ``rows`` records
    on ``device`` with the linear families; the same search on its train
    matrix in float64 on the CPU is the reference. The card's float32
    metric matrix must lie within ``_text_linear_tol`` of it, and the
    float64 search on ``device`` within AGREE_TOL
    (``linear_precision_witness``, which also gives the CPU's float32
    gap)."""
    from transmogrifai_tpu_torch.examples import families, text
    records = text.synthetic_text(rows, seed=text.SEED + 2)
    card = _train_text(device, records, tag="text-agree-linear",
                       models=small_models(device,
                                           families=LINEAR_FAMILIES))
    run = card["run"]
    X = run.model.train_dataset[run.vector.name].data.to(torch.float64)
    y = np.asarray(run.model.train_dataset["label"].data,
                   dtype=np.float64)
    sel = families.default_selector("cpu", models=small_models(
        "cpu", families=LINEAR_FAMILIES))
    fitted = sel.fit_arrays(X.cpu(), y)
    mp, mc = metric_matrix(fitted), np.asarray(card["metric_matrix"])
    results = fitted.summary.validation_results
    tol = np.array([_text_linear_tol(r) for r in results])
    gap = np.abs(mc - mp).max(axis=0)
    out = {"records": rows, "shape": list(X.shape),
           "card_float32": gap.tolist(), "tol": tol.tolist(),
           "within": bool(np.all(gap <= tol))}
    out["linear_precision_witness"] = linear_precision_witness(
        device, X, y, mp, tag="text-agree")
    log(f"[text-agree] linear families on the {tuple(X.shape)} text "
        f"design, the card's float32 metrics against the CPU's float64 "
        f"by grid point: {json.dumps(out['card_float32'])} (tol "
        f"{AGREE_TOL}, {TEXT_LINEAR_TOL} for LR at reg_param < "
        f"{FAMILY_LINEAR_REG}): within {out['within']}")
    if not out["within"]:
        raise AssertionError("[text-agree] the card's float32 linear "
                             "metrics differ from the CPU's")
    return out


def phase_text_agree(device, rows: int = TEXT_AGREE_ROWS,
                     linear_rows: int = TEXT_LINEAR_ROWS) -> dict:
    """[text-agree]: the text workflow on ``rows`` records on ``device``
    and on the CPU, with the linear families only (the tree search's CPU
    half is [families-agree]'s ground): every host stage's output
    (``TEXT_HOST_STAGES``) bitwise equal; Word2Vec's vectors and document
    means (float32 SGD on a card) within W2V_AGREE_TOL, LDA's topic-word
    matrix and document mixtures (float64 on both) within LDA_AGREE_TOL;
    then the linear families' metric matrix on a text design of
    ``linear_rows`` records (``text_linear_agree``)."""
    from transmogrifai_tpu_torch.examples import text
    records = text.synthetic_text(rows, seed=text.SEED + 1)
    card, cpu = (_train_text(dev, records, tag=f"text-agree-{tag}",
                             models=small_models(dev,
                                                 families=LINEAR_FAMILIES))
                 for dev, tag in ((device, "card"), ("cpu", "cpu")))
    runs = [r["run"] for r in (card, cpu)]
    out: dict = {"records": rows}
    differ = []
    for name in TEXT_HOST_STAGES:
        a, b = (_column_values(r.model.train_dataset[
            _stage_of(r.model, name).get_output().name]) for r in runs)
        if a != b:
            differ.append(name)
    out["host_stages_bitwise"] = not differ
    w2v = [_stage_of(r.model, "Word2VecModel") for r in runs]
    lda = [_stage_of(r.model, "LDAModel") for r in runs]

    def gap(stages, attr):
        return float(np.abs(getattr(stages[0], attr)
                            - getattr(stages[1], attr)).max())

    def col_gap(stages):
        a, b = (np.asarray(r.model.train_dataset[s.get_output().name].data,
                           dtype=np.float64) for r, s in zip(runs, stages))
        return float(np.abs(a - b).max())

    out.update(w2v_vectors_max_abs_diff=gap(w2v, "vectors"),
               w2v_means_max_abs_diff=col_gap(w2v),
               lda_topic_word_max_abs_diff=gap(lda, "topic_word"),
               lda_mixtures_max_abs_diff=col_gap(lda),
               w2v_vocabulary_equal=w2v[0].vocabulary == w2v[1].vocabulary,
               lda_vocabulary_equal=lda[0].vocabulary == lda[1].vocabulary)
    out["card_s"] = card["train_score_evaluate_s"]
    out["cpu_s"] = cpu["train_score_evaluate_s"]
    out["card_fit_s"] = {"Word2Vec": card["word2vec_fit_s"],
                         "LDA": card["lda_fit_s"]}
    out["cpu_fit_s"] = {"Word2Vec": cpu["word2vec_fit_s"],
                        "LDA": cpu["lda_fit_s"]}
    log(f"[text-agree] {rows} records: host stages bitwise "
        f"{out['host_stages_bitwise']} (differ: {differ}); Word2Vec vectors "
        f"max |card - cpu| {out['w2v_vectors_max_abs_diff']:.3e}, document "
        f"means {out['w2v_means_max_abs_diff']:.3e} (tol {W2V_AGREE_TOL}); "
        f"LDA topic-word {out['lda_topic_word_max_abs_diff']:.3e}, "
        f"mixtures {out['lda_mixtures_max_abs_diff']:.3e} (tol "
        f"{LDA_AGREE_TOL}); fits card {json.dumps(out['card_fit_s'])} cpu "
        f"{json.dumps(out['cpu_fit_s'])}; seconds card "
        f"{out['card_s']:.2f} cpu {out['cpu_s']:.2f}")
    if differ or not (out["w2v_vocabulary_equal"]
                      and out["lda_vocabulary_equal"]):
        raise AssertionError(f"[text-agree] host stages differ card to CPU:"
                             f" {differ}")
    if max(out["w2v_vectors_max_abs_diff"],
           out["w2v_means_max_abs_diff"]) > W2V_AGREE_TOL:
        raise AssertionError("[text-agree] Word2Vec differs card to CPU")
    if max(out["lda_topic_word_max_abs_diff"],
           out["lda_mixtures_max_abs_diff"]) > LDA_AGREE_TOL:
        raise AssertionError("[text-agree] LDA differs card to CPU")
    out["linear"] = text_linear_agree(device, linear_rows)
    return out


def phase_text_all(device, rows: int = TEXT_ROWS,
                   agree: bool = True) -> dict:
    """[text] (K1's text shapes and the serving inside) and, with
    ``agree``, [text-agree] in turn."""
    out = {"text": phase_text(device, rows)}
    if agree:
        out["agree"] = phase_text_agree(device)
    return out


# ---------------------------------------------------------------------------
# ingestion and explainability: [quickstart], [readers], [insights]
# ---------------------------------------------------------------------------

#: records of the README's Quick start CSV (75 % trained, 25 % held out)
QUICKSTART_ROWS = 100_000
#: users of the [readers] event log (~10.3 events a user: ~205,000); cut
#: from 40,000 to keep the three phases within NEW_PHASES_BUDGET_S once
#: the label-free score reads the log a third time
READERS_USERS = 20_000
#: scored rows each model's insights run over
INSIGHT_ROWS = 5_000
#: card (float32) against a CPU reload (float64): LOCO's diffs, the Corr
#: insight's correlations, normalizers and importances
INSIGHT_TOL = 1e-5
#: LOCO's top K in [insights]
INSIGHT_TOP_K = 3
#: the streamed holdout's batches
STREAM_BATCH = 1_000
#: the three new phases together, seconds on the card: logged beside
#: their time, not enforced (the host's speed varies between machines)
NEW_PHASES_BUDGET_S = 60.0
#: the Quick start CSV's columns (the Titanic example's records)
QUICKSTART_COLUMNS = ("id", "survived", "pClass", "name", "sex", "age",
                      "sibSp", "parCh", "ticket", "fare", "cabin",
                      "embarked")


def write_csv(path: str, records, columns) -> None:
    """``records`` as a header CSV, None as an empty cell."""
    import csv
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(columns)
        for r in records:
            w.writerow(["" if r[c] is None else r[c] for c in columns])


def quickstart_workflow(csv_path: str, device, models=None,
                        families: dict = None):
    """The README's Quick start with the port's imports: typed age, sex
    and survived, transmogrify, ``sanity_check``, the binary selector
    under 3-fold CV over ``models`` (default: the card-against-CPU pool,
    ``small_models``; each family's search timed into ``families`` when it
    is given), trained through ``DataReaders.Simple.csv_auto``. Returns
    (workflow, model, prediction feature)."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.types import PickList, Real, RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    dev = resolve_device(device)
    age = FeatureBuilder.of("age", Real).extract(
        lambda r: r.get("age")).as_predictor()
    sex = FeatureBuilder.of("sex", PickList).extract(
        lambda r: r.get("sex")).as_predictor()
    y = FeatureBuilder.of("survived", RealNN).extract(
        lambda r: r.get("survived")).as_response()
    checked = transmogrify([age, sex]).sanity_check(y)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models=models if models is not None
        else small_models(dev), device=dev)
    if families is not None:
        for est, _ in sel.models:
            time_family(est, families)
    pred = sel.set_input(y, checked).get_output()
    wf = (Workflow(device=dev).set_result_features(pred)
          .set_reader(DataReaders.Simple.csv_auto(csv_path)))
    return wf, wf.train(), pred


def _scores(scored, name: str) -> np.ndarray:
    """A scored prediction column's scores: its probabilities, else (a
    LinearSVC) its raw margins."""
    col = scored[name]
    for arr in (col.probability, col.raw_prediction):
        if arr.shape[1]:
            return np.asarray(arr, dtype=np.float64)
    return np.asarray(col.data, dtype=np.float64).reshape(-1, 1)


def _searched(families: dict) -> dict:
    """The family records of a search and K1's launches by C since the
    counts were zeroed."""
    return {"families": families, "k1_launches": level_hist.launches,
            "k1_launches_by_c": dict(sorted(
                level_hist.launches_by_c.items()))}


def _log_families(tag: str, families: dict) -> None:
    for name, rec in families.items():
        log(f"[{tag}] {name}: {rec['candidates']} models x folds in "
            f"{rec['seconds']:.2f} s; K1 launches "
            f"{rec.get('k1_launches', 0)}: " + " ".join(
                f"C={c}:{k}" for c, k in rec["k1_launches_by_c"].items()))


def _check_k1(tag: str, dev, searched: dict) -> None:
    if dev.type != "cuda":
        return
    idle = [f for f in TREE_FAMILIES if f in searched["families"]
            and searched["families"][f].get("k1_launches", 0) == 0]
    if searched["k1_launches"] == 0 or idle:
        raise AssertionError(f"[{tag}] K1 never launched by "
                             f"{idle or 'the search'}")


def phase_quickstart(device, workdir: str, rows: int = QUICKSTART_ROWS,
                     models=None) -> dict:
    """[quickstart]: the README's Quick start (``quickstart_workflow``)
    on ``rows`` seeded Titanic-shaped records, 75 % written to a CSV and
    trained through ``DataReaders.Simple.csv_auto``; ``summary_pretty()``
    and ``model_insights().pretty()`` printed; saved, reloaded through
    ``load_score_function`` and one record served; the 25 % holdout
    streamed in batches of STREAM_BATCH (``StreamingReader.from_records``)
    through ``score(engine="compiled")``, within 1e-6 of one whole-holdout
    compiled score, and evaluated (AuPR). K1's launches are counted from
    zero just before the train; on a card, K1 against its plain version on
    the training matrix (``[k1-quickstart]``)."""
    from transmogrifai_tpu_torch.readers import StreamingReader
    dev = resolve_device(device)
    t0 = time.perf_counter()
    train, holdout = titanic.stratified_split(
        titanic.synthetic_titanic(rows, seed=17))
    os.makedirs(workdir, exist_ok=True)
    csv_path = os.path.join(workdir, "titanic.csv")
    write_csv(csv_path, train, QUICKSTART_COLUMNS)
    out = {"rows": rows, "train_records": len(train),
           "holdout_records": len(holdout),
           "write_csv_s": time.perf_counter() - t0}
    families: dict = {}
    clear_design_cache()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    t0 = time.perf_counter()
    wf, model, pred = quickstart_workflow(csv_path, dev, models, families)
    out["train_s"] = time.perf_counter() - t0
    out.update(_searched(families))
    wf_s = dict(wf.last_train_seconds)
    out["workflow_seconds"] = wf_s
    summary = model.summary_pretty()
    insights = model.model_insights()
    log(f"[quickstart] summary_pretty():\n{summary}")
    log(f"[quickstart] model_insights().pretty():\n{insights.pretty()}")
    selected = pred_stage(model, pred)
    s = selected.summary
    out.update(winner=s.best_model_name, winner_params=s.best_model_params,
               best_metric=s.best_validation_metric,
               metric_matrix=metric_matrix(selected).tolist(),
               insight_features=len(insights.features))
    log(f"[quickstart] {len(train)} CSV records trained on {dev} in "
        f"{out['train_s']:.2f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in wf_s.items()) + f"); winner "
        f"{s.best_model_name} {s.best_model_params} AuPR "
        f"{s.best_validation_metric:.6f}; K1 launches "
        f"{out['k1_launches']}")
    _log_families("quickstart", families)
    _check_k1("quickstart", dev, out)
    if dev.type == "cuda":
        checked = pred_stage(model, pred).input_features[1]
        out["k1"] = phase_k1_inputs(dev, matrix_k1_inputs(
            dev, model.train_dataset[checked.name].data, np.asarray(
                model.train_dataset["survived"].data, dtype=np.float64),
            "quickstart matrix"), "k1-quickstart", 11)
    # save, reload, serve one record
    path = os.path.join(workdir, "model")
    t0 = time.perf_counter()
    model.save(path)
    score = load_score_function(path, device=dev)
    served = score({"age": 29.0, "sex": "female"})[pred.name]
    out["save_load_s"] = time.perf_counter() - t0
    out["served"] = served
    log(f"[quickstart] saved, reloaded on {dev} and served one record in "
        f"{out['save_load_s']:.2f} s: {served}")
    if not all(np.isfinite(v) for v in served.values()):
        raise AssertionError(f"[quickstart] served {served}")
    # the holdout streamed against one whole score
    t0 = time.perf_counter()
    whole = model.score(holdout, engine="compiled")
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = [_scores(model.score(batch, engine="compiled"), pred.name)
             for batch in StreamingReader.from_records(holdout,
                                                       STREAM_BATCH)]
    stream_s = time.perf_counter() - t0
    p_whole = _scores(whole, pred.name)
    gap = float(np.abs(np.concatenate(parts) - p_whole).max())
    evaluator = BinaryClassificationEvaluator(label_col="survived",
                                              prediction_col=pred.name)
    metrics = evaluator.evaluate_all(whole)
    out.update(holdout_aupr=metrics.AuPR, holdout_auroc=metrics.AuROC,
               whole_score_s=whole_s, stream_s=stream_s,
               stream_batches=len(parts), stream_max_abs_diff=gap)
    log(f"[quickstart] holdout {len(holdout)} records: one compiled score "
        f"{whole_s:.3f} s, {len(parts)} streamed batches of {STREAM_BATCH} "
        f"{stream_s:.3f} s, max |stream - whole| score {gap:.3e} (tol "
        f"{COMPILED_SCORE_TOL}); AuPR {metrics.AuPR:.6f} AuROC "
        f"{metrics.AuROC:.6f}")
    if gap > COMPILED_SCORE_TOL or not np.isfinite(metrics.AuPR):
        raise AssertionError("[quickstart] the streamed holdout differs "
                             "from its whole score")
    out["_insight_input"] = {"model": model, "prediction": pred,
                             "path": path, "raw": whole,
                             "tag": "quickstart"}
    return out


def pred_stage(model, pred):
    """The SelectedModel that makes ``pred`` in the fitted ``model``."""
    return model._resolve(pred).origin_stage


class _Timed:
    """Adds the seconds of a bound method's calls to ``seconds[key]``."""

    def __init__(self, obj, method: str, seconds: dict, key: str):
        real = getattr(obj, method)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                seconds[key] = seconds.get(key, 0.0) + \
                    time.perf_counter() - t0
        setattr(obj, method, timed)


def timed_event_reader(sends_glob: str, clicks_glob: str, cutoff_ms: int,
                       seconds: dict, responses: bool = True):
    """``dataprep.event_reader`` over two ``AvroProductReader`` sources,
    its Avro reading, both sides' aggregation (reading included) and the
    whole join timed into ``seconds``. With ``responses`` False the reader
    refuses a response feature, as a log read before the day after the
    cutoff has happened would."""
    from transmogrifai_tpu_torch.examples import dataprep
    from transmogrifai_tpu_torch.readers import AvroProductReader
    sources = [AvroProductReader(g) for g in (sends_glob, clicks_glob)]
    for src in sources:
        _Timed(src, "read_records", seconds, "avro_read")
    reader = dataprep.event_reader(*sources, cutoff_ms)
    for side in (reader.left, reader.right):
        _Timed(side, "generate_dataset", seconds, "aggregate_and_read")
    _Timed(reader, "generate_dataset", seconds, "reader_total")
    if not responses:
        generate = reader.generate_dataset

        def predictors_only(raw_features):
            if any(f.is_response for f in raw_features):
                raise ValueError("the log holds no response yet")
            return generate(raw_features)
        reader.generate_dataset = predictors_only
    return reader


def _reader_split(seconds: dict) -> dict:
    """Avro reading, aggregation and join seconds of a timed reader."""
    read = seconds.get("avro_read", 0.0)
    agg = seconds.get("aggregate_and_read", 0.0)
    return {"avro_read_s": read, "aggregate_s": agg - read,
            "join_s": seconds.get("reader_total", 0.0) - agg}


def phase_readers(device, workdir: str, users: int = READERS_USERS,
                  models=None) -> dict:
    """[readers]: the seeded e-mail event log (``examples/dataprep.py``:
    ``users`` users, sends and clicks) written as deflate Avro files, two
    AggregateDataReaders over AvroProductReader sources joined left outer
    by JoinedAggregateReaders; the workflow (``dataprep.event_features``:
    sums over a day and a week, a mean, a logical or, the last campaign, a
    union of topics, the subjects' text, the clicks' midpoint; the label
    whether the user clicks in the day after the cutoff) trained at one
    cutoff with ``models`` (default: the card-against-CPU pool), then
    scored at a cutoff 7 days later through a second reader on the same
    files with its responses (evaluated), and through a third that
    refuses the response with the compiled engine (the label all NaN, the
    predictions within ``COMPILED_SCORE_TOL`` of those with responses).
    Seconds of Avro reading, aggregation, join,
    raw extraction, fits and the search by family; K1's launches by
    family and C, counted from zero just before the train; on a card, K1
    against its plain version on the training matrix (``[k1-readers]``)."""
    from transmogrifai_tpu_torch.examples import dataprep
    from transmogrifai_tpu_torch.features.columns import Dataset
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sends, clicks = dataprep.synthetic_event_log(users, seed=7)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    globs = dataprep.write_event_log(sends, clicks,
                                     os.path.join(workdir, "log"))
    write_s = time.perf_counter() - t0
    out = {"users": users, "sends": len(sends), "clicks": len(clicks),
           "events": len(sends) + len(clicks), "generate_s": gen_s,
           "write_avro_s": write_s,
           "avro_bytes": sum(os.path.getsize(os.path.join(workdir, "log", f))
                             for f in os.listdir(os.path.join(workdir,
                                                              "log")))}
    del sends, clicks
    log(f"[readers] {users} users, {out['sends']} sends and "
        f"{out['clicks']} clicks generated in {gen_s:.2f} s, written as "
        f"deflate Avro ({out['avro_bytes']} bytes) in {write_s:.2f} s")
    cut = dataprep.START_MS + 14 * dataprep.DAY_MS
    label, predictors = dataprep.event_features()
    vector = transmogrify(predictors)
    sel = dataprep.default_selector(
        dev, models if models is not None else small_models(dev))
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families)
    pred = sel.set_input(label, vector).get_output()
    clear_design_cache()
    train_sec: dict = {}
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    wf = (Workflow(device=dev).set_result_features(label, pred)
          .set_reader(timed_event_reader(*globs, cut, train_sec)))
    t0 = time.perf_counter()
    model = wf.train()
    out["train_s"] = time.perf_counter() - t0
    out.update(_searched(families))
    plan = wf.last_prepare_plan
    search_label = next(k for k in plan.fit_seconds
                        if k.startswith("ModelSelector("))
    out["train_reader"] = _reader_split(train_sec)
    out["workflow_seconds"] = dict(wf.last_train_seconds)
    out["raw_extraction_s"] = wf.last_train_seconds["raw_extraction"]
    out["search_s"] = plan.fit_seconds[search_label]
    out["fits_s"] = sum(v for k, v in plan.fit_seconds.items()
                        if k != search_label)
    X = model.train_dataset[vector.name].data
    selected = pred_stage(model, pred)
    s = selected.summary
    out.update(matrix_shape=list(X.shape), matrix_device=str(X.device),
               winner=s.best_model_name, winner_params=s.best_model_params,
               best_metric=s.best_validation_metric,
               metric_matrix=metric_matrix(selected).tolist())
    log(f"[readers] trained at the cutoff on {dev} in {out['train_s']:.2f} s:"
        f" Avro reading {out['train_reader']['avro_read_s']:.3f} s, "
        f"aggregation {out['train_reader']['aggregate_s']:.3f} s, join "
        f"{out['train_reader']['join_s']:.3f} s (raw extraction "
        f"{out['raw_extraction_s']:.3f} s); fits {out['fits_s']:.3f} s, "
        f"search {out['search_s']:.3f} s; matrix {tuple(X.shape)} on "
        f"{X.device}; winner {s.best_model_name} {s.best_model_params} "
        f"AuPR {s.best_validation_metric:.6f}; K1 launches "
        f"{out['k1_launches']}: " + " ".join(
            f"C={c}:{k}" for c, k in out["k1_launches_by_c"].items()))
    _log_families("readers", families)
    _check_k1("readers", dev, out)
    if dev.type == "cuda":
        out["k1"] = phase_k1_inputs(dev, matrix_k1_inputs(
            dev, X, np.asarray(model.train_dataset[label.name].data,
                               dtype=np.float64), "event-log matrix"),
            "k1-readers", 13)
    del X
    # a week later, through a second reader on the same files
    score_sec: dict = {}
    later = timed_event_reader(*globs, cut + 7 * dataprep.DAY_MS, score_sec)
    evaluator = BinaryClassificationEvaluator(label_col=label.name,
                                              prediction_col=pred.name)
    t0 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(later, evaluator)
    out["score_s"] = time.perf_counter() - t0
    out["score_reader"] = _reader_split(score_sec)
    free_sec: dict = {}
    free_reader = timed_event_reader(*globs, cut + 7 * dataprep.DAY_MS,
                                     free_sec, responses=False)
    t0 = time.perf_counter()
    free = model.score(free_reader, engine="compiled")
    out["score_without_responses_s"] = time.perf_counter() - t0
    out["score_without_responses_reader"] = _reader_split(free_sec)
    p, p_free = _scores(scored, pred.name), _scores(free, pred.name)
    gap = float(np.abs(p - p_free).max())
    label_nan = bool(np.isnan(free[label.name].data).all())
    out.update(score_rows=scored.n_rows, holdout_aupr=metrics.AuPR,
               holdout_auroc=metrics.AuROC,
               label_rate=float(np.mean(scored[label.name].data)),
               without_responses_max_abs_diff=gap,
               without_responses_label_nan=label_nan)
    log(f"[readers] scored 7 days later through a second reader: "
        f"{scored.n_rows} users in {out['score_s']:.2f} s (Avro reading "
        f"{out['score_reader']['avro_read_s']:.3f} s, aggregation "
        f"{out['score_reader']['aggregate_s']:.3f} s, join "
        f"{out['score_reader']['join_s']:.3f} s), label rate "
        f"{out['label_rate']:.4f}, AuPR {metrics.AuPR:.6f} AuROC "
        f"{metrics.AuROC:.6f}; without responses (compiled) "
        f"{out['score_without_responses_s']:.3f} s through a third reader "
        f"that refuses the response, label all NaN "
        f"{label_nan}, max |score - score with responses| {gap:.3e} (tol "
        f"{COMPILED_SCORE_TOL})")
    if not label_nan or gap > COMPILED_SCORE_TOL or not np.isfinite(
            metrics.AuPR):
        raise AssertionError("[readers] scoring without responses differs")
    path = os.path.join(workdir, "model")
    model.save(path)
    free_in = Dataset({f.name: scored[f.name] for f in predictors})
    out["_insight_input"] = {"model": model, "prediction": pred,
                             "path": path, "raw": free_in,
                             "tag": "readers"}
    return out


def _loco_rows(loco, X, meta, top_k: int):
    """(groups, diffs, seconds) of ``loco`` over the matrix ``X``."""
    from transmogrifai_tpu_torch.features.columns import FeatureColumn
    t0 = time.perf_counter()
    col = FeatureColumn.vector(X, meta)
    groups, diffs = loco.group_diffs(col)
    maps = loco.transform_columns([col])
    return groups, diffs, maps, time.perf_counter() - t0


def _top_k_agree(card: np.ndarray, cpu: np.ndarray, k: int,
                 tol: float) -> tuple:
    """Rows whose top-K groups by |diff| differ between the two diff
    matrices, among the rows where no tie straddles K (the K-th and
    K+1-th |diff| of the CPU's apart by more than 2 ``tol``); and the
    count of rows so compared."""
    k = min(k, cpu.shape[1])
    if k == cpu.shape[1]:
        return 0, cpu.shape[0]
    a, b = np.abs(card), np.abs(cpu)
    srt = -np.sort(-b, axis=1)
    clear = srt[:, k - 1] - srt[:, k] > 2 * tol
    top_a = np.argsort(-a, axis=1, kind="stable")[:, :k]
    top_b = np.argsort(-b, axis=1, kind="stable")[:, :k]
    differ = [i for i in np.flatnonzero(clear)
              if set(top_a[i]) != set(top_b[i])]
    return len(differ), int(clear.sum())


def phase_insights(device, inputs, trees=None, rows: int = INSIGHT_ROWS
                   ) -> dict:
    """[insights], for each workflow of ``inputs`` (the _insight_input of
    [quickstart] and [readers]): its first ``rows`` scored rows' feature
    vector (``compute_data_up_to``) on the card in its working dtype,
    through RecordInsightsLOCO on the card and, those same values in
    float64, on a CPU reload of the same saved model (every diff within
    INSIGHT_TOL, the same top-K groups wherever no tie straddles K), and
    RecordInsightsCorr fitted and applied on the card and on the CPU
    (correlations, normalizers and importances within INSIGHT_TOL, NaN
    alike); then ``feature_importances`` of each fixed tree model of
    ``trees`` ((tag, model) on the card) against its CPU reload: exact,
    summing to 1. Seconds of each; K1 launches none."""
    import tempfile
    from transmogrifai_tpu_torch.features.columns import (FeatureColumn,
                                                          PredictionColumn)
    from transmogrifai_tpu_torch.insights import (RecordInsightsCorr,
                                                  RecordInsightsLOCO)
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    dev = resolve_device(device)
    launches = level_hist.launches
    out = {}
    for inp in inputs:
        tag, model, pred = inp["tag"], inp["model"], inp["prediction"]
        raw = inp["raw"].take(np.arange(min(rows, inp["raw"].n_rows)))
        selected = pred_stage(model, pred)
        vec_f = selected.input_features[1]
        t0 = time.perf_counter()
        data = model.compute_data_up_to(pred, raw)
        compute_s = time.perf_counter() - t0
        meta = data[vec_f.name].metadata
        # the vector as the card holds it (the working dtype there); the
        # CPU reload reads those same values in float64
        X = torch.as_tensor(np.asarray(data[vec_f.name].data), device=dev,
                            dtype=working_dtype(dev))
        X_host = X.double().cpu().numpy()
        cpu_model = WorkflowModel.load(inp["path"], device="cpu")
        cpu_sel = pred_stage(cpu_model, pred)
        rec = {"rows": int(X_host.shape[0]), "columns": int(X_host.shape[1]),
               "vector_device": str(X.device), "vector_dtype": str(X.dtype),
               "compute_data_up_to_s": compute_s}
        # LOCO
        groups, d_card, maps, rec["loco_card_s"] = _loco_rows(
            RecordInsightsLOCO(model=selected, top_k=INSIGHT_TOP_K), X,
            meta, INSIGHT_TOP_K)
        _, d_cpu, _, rec["loco_cpu_s"] = _loco_rows(
            RecordInsightsLOCO(model=cpu_sel, top_k=INSIGHT_TOP_K), X_host,
            meta, INSIGHT_TOP_K)
        rec["loco_groups"] = len(groups)
        rec["loco_max_abs_diff"] = float(np.abs(d_card - d_cpu).max())
        rec["loco_top_k_differ"], rec["loco_rows_compared"] = _top_k_agree(
            d_card, d_cpu, INSIGHT_TOP_K, INSIGHT_TOL)
        # Corr, on the card's predictions
        preds = data[pred.name]
        fit_s = {}
        corr = {}
        for where, Xw in (("card", X), ("cpu", X_host)):
            cols = [PredictionColumn.from_arrays(
                preds.data, probability=preds.probability,
                raw_prediction=preds.raw_prediction),
                FeatureColumn.vector(Xw, meta)]
            t0 = time.perf_counter()
            cm = RecordInsightsCorr(top_k=INSIGHT_TOP_K).fit_columns(cols)
            imp = cm.importances(torch.as_tensor(
                Xw, device=dev if where == "card" else "cpu",
                dtype=working_dtype(dev if where == "card"
                                   else torch.device("cpu"))))
            cm.transform_columns(cols)
            fit_s[where] = time.perf_counter() - t0
            corr[where] = (cm, imp)
        (cc, ic), (cp, ip) = corr["card"], corr["cpu"]
        nan_same = bool(np.array_equal(np.isnan(cc.score_corr),
                                       np.isnan(cp.score_corr)))
        corr_gap = float(np.nanmax(np.abs(cc.score_corr - cp.score_corr))) \
            if np.isfinite(cp.score_corr).any() else 0.0
        norm_gap = max(float(np.abs(getattr(cc, a) - getattr(cp, a)).max()
                             / max(1.0, float(np.abs(getattr(cp, a)).max())))
                       for a in ("norm_shift", "norm_scale"))
        imp_gap = float(np.abs(ic - ip).max())
        rec.update(corr_card_s=fit_s["card"], corr_cpu_s=fit_s["cpu"],
                   corr_max_abs_diff=corr_gap, corr_nan_alike=nan_same,
                   corr_norm_max_rel_diff=norm_gap,
                   corr_importance_max_abs_diff=imp_gap)
        log(f"[insights] {tag}: {rec['rows']} rows x {rec['columns']} "
            f"columns on {rec['vector_device']} (compute_data_up_to "
            f"{compute_s:.3f} s); LOCO over {len(groups)} groups: card "
            f"{rec['loco_card_s']:.3f} s, CPU reload {rec['loco_cpu_s']:.3f}"
            f" s, max |card - cpu| diff {rec['loco_max_abs_diff']:.3e} (tol "
            f"{INSIGHT_TOL}), top-{INSIGHT_TOP_K} groups differ in "
            f"{rec['loco_top_k_differ']} of {rec['loco_rows_compared']} "
            f"rows without a tie at K; Corr card {fit_s['card']:.3f} s, CPU "
            f"{fit_s['cpu']:.3f} s, correlations {corr_gap:.3e}, NaN alike "
            f"{nan_same}, normalizers rel {norm_gap:.3e}, importances "
            f"{imp_gap:.3e}; e.g. {maps.data[0]}")
        if (rec["loco_max_abs_diff"] > INSIGHT_TOL
                or rec["loco_top_k_differ"] or corr_gap > INSIGHT_TOL
                or not nan_same or norm_gap > INSIGHT_TOL
                or imp_gap > INSIGHT_TOL):
            raise AssertionError(f"[insights] {tag}: card and CPU "
                                 f"insights disagree")
        out[tag] = rec
    for tag, model in trees or ():
        with tempfile.TemporaryDirectory() as path:
            t0 = time.perf_counter()
            stage = _model_stage(model)
            imp = stage.feature_importances
            card_s = time.perf_counter() - t0
            model.save(os.path.join(path, "m"))
            cpu = _model_stage(WorkflowModel.load(os.path.join(path, "m"),
                                                  device="cpu"))
            imp_cpu = cpu.feature_importances
        same = bool(np.array_equal(imp, imp_cpu))
        rec = {"model": type(stage).__name__, "trees_on": str(stage.device),
               "features": int(imp.size), "nonzero": int((imp > 0).sum()),
               "sum": float(imp.sum()), "seconds": card_s, "equal": same,
               "top": [int(j) for j in np.argsort(-imp, kind="stable")[:5]]}
        log(f"[insights] {tag}: feature_importances of {rec['model']} on "
            f"{rec['trees_on']} in {card_s:.4f} s: {rec['nonzero']} of "
            f"{rec['features']} columns split on, sum {rec['sum']!r}, "
            f"equal to the CPU reload's: {same}; top columns {rec['top']}")
        if not same or abs(rec["sum"] - 1.0) > 1e-12:
            raise AssertionError(f"[insights] {tag}: importances differ")
        out[tag] = rec
    out["k1_launches"] = level_hist.launches - launches
    if out["k1_launches"]:
        raise AssertionError("[insights] K1 launched while explaining")
    return out


def _model_stage(model):
    """The prediction model of a fitted workflow model."""
    from transmogrifai_tpu_torch.models.base import PredictionModel
    return next(s for s in model.stages() if isinstance(s, PredictionModel))


def fixed_tree_models(device, run: dict) -> list:
    """(tag, model) of a fixed depth-6 20-round GBT and a 50-tree depth-6
    forest on [readers]' event-log workflow (the --readers-only stand-in
    for phase 8c's Titanic trees)."""
    from transmogrifai_tpu_torch.examples import dataprep
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow
    dev = resolve_device(device)
    inp = run["_insight_input"]
    out = []
    for tag, est in (("gbt", GBTClassifier(num_rounds=20, max_depth=6,
                                           device=dev)),
                     ("rf", RandomForestClassifier(num_trees=50, max_depth=6,
                                                   device=dev))):
        label, predictors = dataprep.event_features()
        pred = est.set_input(label, transmogrify(predictors)).get_output()
        ds = inp["model"].train_dataset
        raw = type(ds)({f.name: ds[f.name] for f in [label] + predictors})
        model = (Workflow(device=dev).set_result_features(pred)
                 .set_input_dataset(raw).train())
        out.append((f"{tag}-fixed", model))
    return out


def phase_ingest_explain(device, quickstart_rows: int = QUICKSTART_ROWS,
                         users: int = READERS_USERS, trees=None,
                         families=FAMILIES, num_rounds: int = 20) -> dict:
    """[quickstart] and [readers], each searching the card-against-CPU
    pool (``small_models``: ``families`` at ``num_rounds`` boosting
    rounds), and [insights] in turn (``trees``: phase 8c's fixed GBT and
    forest; without them, fixed trees on [readers]' workflow), with their
    seconds."""
    import shutil
    import tempfile
    pool = lambda: small_models(device, num_rounds,  # noqa: E731
                                families=families)
    workdir = tempfile.mkdtemp(prefix="ingest_explain_")
    try:
        t0 = time.perf_counter()
        qs = phase_quickstart(device, os.path.join(workdir, "quickstart"),
                              quickstart_rows, models=pool())
        t1 = time.perf_counter()
        rd = phase_readers(device, os.path.join(workdir, "readers"), users,
                           models=pool())
        t2 = time.perf_counter()
        if trees is None:
            trees = fixed_tree_models(device, rd)
        t3 = time.perf_counter()
        ins = phase_insights(device, [qs.pop("_insight_input"),
                                      rd.pop("_insight_input")], trees)
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = {"quickstart": t1 - t0, "readers": t2 - t1,
               "insights": t4 - t3, "fixed_trees": t3 - t2,
               "total": (t2 - t0) + (t4 - t3)}
    within = seconds["total"] <= NEW_PHASES_BUDGET_S
    log(f"[ingest-explain] seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"(budget {NEW_PHASES_BUDGET_S} s for the three phases, reported "
        f"only: within {within}"
        f"{', the fixed trees outside it' if seconds['fixed_trees'] > 0.01 else ''})")
    return {"quickstart": qs, "readers": rd, "insights": ins,
            "seconds": seconds, "within_budget": within}


# ---------------------------------------------------------------------------
# the model layer: host-metric searches, fold edges, the MLP, the
# calibrator and the external-estimator adapter
# ---------------------------------------------------------------------------

#: records of the host-metric path (the Titanic DAG, ~587 columns)
HOST_METRIC_RECORDS = 20_000
#: records of the MLP path (the Iris DAG, its 8 columns)
MLP_RECORDS = 300_000
#: records of the MLP and host-metric card-against-CPU checks
MODELS_AGREE_RECORDS = 3_000


class OwnAuPR(BinaryClassificationEvaluator):
    """A user's evaluator: AuPR through its own ``metric_from``, which
    the device metric cannot see, so the validator takes its host path."""

    def metric_from(self, metrics) -> float:
        return float(metrics.AuPR)


def centroid_fit(X, y, shrink=0.0):
    """A host estimator for ``wrap_estimator``: shrunken class centroids."""
    classes = np.unique(y)
    cents = np.stack([X[y == c].mean(axis=0) for c in classes])
    return {"classes": classes, "centroids": cents * (1.0 - shrink)}


def centroid_predict(state, X):
    d2 = ((X[:, None, :] - state["centroids"][None, :, :]) ** 2).sum(-1)
    e = np.exp(-d2 + d2.min(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@contextlib.contextmanager
def batch_groups(record: dict):
    """Count the static groups ``batch_predict_raw`` stacks (one traversal
    each) and its calls inside the block."""
    real = trees.batch_predict_raw
    record.update(calls=0, groups=0, models=0)

    def spy(models, X):
        keys = {(type(m).__name__, m.depth, tuple(m.feats.shape),
                 tuple(m.leaves.shape)) for m in models
                if isinstance(m, (trees._EnsembleModel,
                                  trees.GBTClassifierModel,
                                  trees.GBTRegressorModel))}
        record["calls"] += 1
        record["groups"] += len(keys)
        out = real(models, X)
        record["models"] += len(out)
        return out
    trees.batch_predict_raw = spy
    try:
        yield record
    finally:
        trees.batch_predict_raw = real


def _search_matrix(device, X, y, evaluator=None, families=None,
                   per_candidate: bool = False) -> dict:
    """The card-against-CPU pool (``small_models``) searched on ``X``, y
    (3-fold stratified CV, the default splitter) under ``evaluator``
    (AuPR on the card when None), K1 counted from zero just before; with
    ``per_candidate`` the host path fits candidate by candidate on each
    fold's rows instead of its batched fits."""
    dev = resolve_device(device)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, evaluator=evaluator,
        models=small_models(dev), device=dev)
    if per_candidate:
        sel.validator._use_batched_kernel = lambda est: False
    if families is not None:
        for est, _ in sel.models:
            time_family(est, families, fit=True)
    clear_design_cache()
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    t0 = time.perf_counter()
    selected = sel.fit_arrays(X, y)
    seconds = time.perf_counter() - t0
    mm = metric_matrix(selected)
    s = selected.summary
    return {"metric_matrix": mm, "seconds": seconds,
            "winner": s.best_model_name, "winner_params": s.best_model_params,
            "k1_launches": level_hist.launches,
            "k1_launches_by_c": dict(sorted(
                level_hist.launches_by_c.items()))}


def phase_host_metric(device, rows: int = HOST_METRIC_RECORDS,
                      per_candidate: bool = False) -> dict:
    """[host-metric]: the Titanic DAG on ``rows`` records selected under
    ``LogLossEvaluator`` (no device metric) over the card-against-CPU pool
    (``small_models``: every default family, forests at 5 trees): every
    family takes its batched fold x grid fit, each fold's tree models score
    in one ``batch_predict_raw`` group a shape, the log loss runs on the
    host. Seconds and K1 launches by family and C, the groups, the winner
    and the holdout log loss and AuPR; every tree family must launch K1
    through ``fit_fold_grid_arrays``. Then the same pool on the same
    prepared matrix by the device path (AuPR) and by the host path (an
    AuPR evaluator overriding ``metric_from``): matrices within AGREE_TOL
    (GBT_SMALL_LEAF_TOL at the GBT points of min_child_weight 1), the
    same winner; then under ``TX_TREE_EDGES=fold``
    (its matrix and K1 launches) with K1 at one fold's design against its
    plain version (exact). With ``per_candidate``, the host path is timed
    once more fitting candidate by candidate (the loop the batched fits
    replace) on the same matrix."""
    from transmogrifai_tpu_torch.evaluators import LogLossEvaluator
    dev = resolve_device(device)
    records = titanic.synthetic_titanic(rows, seed=42)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, evaluator=LogLossEvaluator(),
        models=small_models(dev), device=dev)
    families: dict = {}
    for est, _ in sel.models:
        time_family(est, families, fit=True)
    clear_design_cache()
    validator.reset_family_profile()
    groups: dict = {}
    level_hist.launches = 0
    level_hist.launches_by_c.clear()
    with batch_groups(groups):
        run = titanic.run(records, device=dev, model_stage=sel)
    launches = level_hist.launches
    by_c = dict(sorted(level_hist.launches_by_c.items()))
    for rec in validator.family_profile():
        if rec["family"] in families:
            families[rec["family"]]["host_path_s"] = rec["seconds"]
    selected = next(s for s in run.model.stages()
                    if type(s).__name__ == "SelectedModel")
    s = selected.summary
    mm = metric_matrix(selected)
    logloss = LogLossEvaluator(label_col="survived",
                               prediction_col=run.prediction.name
                               ).evaluate_all(run.scored).LogLoss
    X = run.model.train_dataset[run.vector.name].data
    y = np.asarray(run.model.train_dataset["survived"].data,
                   dtype=np.float64)
    out = {"records": rows, "matrix_shape": list(X.shape),
           "train_s": sum(run.workflow.last_train_seconds.values()),
           "selector_timings_s": dict(s.timings), "families": families,
           "k1_launches": launches, "k1_launches_by_c": by_c,
           "batch_predict_raw": dict(groups), "winner": s.best_model_name,
           "winner_params": s.best_model_params,
           "best_metric": s.best_validation_metric,
           "holdout_logloss": logloss, "holdout_AuPR": run.metrics.AuPR,
           "metric_matrix": mm.tolist()}
    log(f"[host-metric] {rows} records on {dev}: matrix {tuple(X.shape)}; "
        f"train {out['train_s']:.2f} s; selector stages "
        f"{json.dumps({k: round(v, 3) for k, v in s.timings.items()})}; "
        f"batch_predict_raw {json.dumps(groups)}")
    for name, rec in families.items():
        log(f"[host-metric] {name}: {rec['candidates']} models x folds, "
            f"batched fits {rec['seconds']:.2f} s of the host path's "
            f"{rec['host_path_s']:.2f} s; K1 launches "
            f"{rec.get('k1_launches', 0)}: " + " ".join(
                f"C={c}:{k}" for c, k in rec["k1_launches_by_c"].items()))
    log(f"[host-metric] winner {s.best_model_name} {s.best_model_params} "
        f"mean LogLoss {s.best_validation_metric:.6f}; holdout LogLoss "
        f"{logloss:.6f} AuPR {run.metrics.AuPR:.6f}; K1 launches "
        f"{launches}")
    if set(families) != set(FAMILIES) or any(
            rec["calls"] != 1 for rec in families.values()):
        raise AssertionError(f"[host-metric] not every family took its "
                             f"batched fit once: {families}")
    if not np.isfinite(logloss) or mm.shape != (3, 20):
        raise AssertionError(f"[host-metric] bad result: {mm}, {logloss}")
    if dev.type == "cuda":
        idle = [f for f in TREE_FAMILIES
                if families[f].get("k1_launches", 0) == 0]
        if idle:
            raise AssertionError(f"[host-metric] K1 never launched by "
                                 f"{idle}'s fit_fold_grid_arrays")
    # the same pool and matrix by both validator paths
    device_run = _search_matrix(dev, X, y)
    host_families: dict = {}
    host_run = _search_matrix(dev, X, y, OwnAuPR(), host_families)
    # the same candidates, each fitted twice on the card (K1's float
    # atomics may break a near tie of a small-leaf GBT otherwise), scored
    # in float32 on the card or in float64 on the host: AGREE_TOL, and
    # GBT_SMALL_LEAF_TOL at the GBT points of min_child_weight 1 (on an
    # H100 at 15,000 x 567: GBT 1.14e-3-4.31e-3, the others <= 6.5e-7)
    a, b = device_run["metric_matrix"], host_run["metric_matrix"]
    gap = np.abs(a - b).max(axis=0)
    points = [(type(est).__name__, p) for est, grid in small_models("cpu")
              for p in grid]
    tol = np.array([GBT_SMALL_LEAF_TOL if name == "GBTClassifier"
                    and p.get("min_child_weight", 1.0) < 10 else AGREE_TOL
                    for name, p in points])
    by_point = {f"{name} {json.dumps(p)}": float(g)
                for (name, p), g in zip(points, gap)}
    same = (device_run["winner"], device_run["winner_params"]) == (
        host_run["winner"], host_run["winner_params"])
    out["device_vs_host"] = {
        "max_abs_diff": float(gap.max()), "by_point": by_point,
        "over_tol": [k for k, g, t in zip(by_point, gap, tol) if g > t],
        "same_winner": same,
        "device_s": device_run["seconds"], "host_s": host_run["seconds"],
        "host_families": host_families,
        "winner": [device_run["winner"], device_run["winner_params"]]}
    log(f"[host-metric] the same pool on the same {tuple(X.shape)} matrix: "
        f"device path {device_run['seconds']:.2f} s, host path (AuPR "
        f"through metric_from) {host_run['seconds']:.2f} s; max |device - "
        f"host| {gap.max():.3e} (tol {AGREE_TOL}, {GBT_SMALL_LEAF_TOL} at "
        f"GBT min_child_weight 1) by grid point {json.dumps(by_point)}; "
        f"winners {device_run['winner']} {device_run['winner_params']} / "
        f"{host_run['winner']} {host_run['winner_params']}")
    if out["device_vs_host"]["over_tol"] or not same:
        raise AssertionError("[host-metric] the device and host paths "
                             "disagree")
    if per_candidate:
        loop = _search_matrix(dev, X, y, OwnAuPR(), per_candidate=True)
        out["per_candidate"] = {
            "seconds": loop["seconds"], "batched_s": host_run["seconds"],
            "max_abs_diff_to_batched": float(np.abs(
                loop["metric_matrix"] - b).max()),
            "winner": [loop["winner"], loop["winner_params"]]}
        log(f"[host-metric] the host path candidate by candidate (fold "
            f"rows, the refit solvers) on the same matrix: "
            f"{loop['seconds']:.2f} s against the batched fits' "
            f"{host_run['seconds']:.2f} s; max |loop - batched| "
            f"{out['per_candidate']['max_abs_diff_to_batched']:.3e}; winner "
            f"{loop['winner']} {loop['winner_params']}")
    # TX_TREE_EDGES=fold: one design a fold
    old = os.environ.get("TX_TREE_EDGES")
    os.environ["TX_TREE_EDGES"] = "fold"
    try:
        fold_run = _search_matrix(dev, X, y)
    finally:
        if old is None:
            os.environ.pop("TX_TREE_EDGES")
        else:
            os.environ["TX_TREE_EDGES"] = old
    diff = float(np.abs(fold_run["metric_matrix"] - a).max())
    out["fold_edges"] = {k: (v.tolist() if isinstance(v, np.ndarray)
                             else v) for k, v in fold_run.items()}
    out["fold_edges"]["max_abs_diff_to_matrix_edges"] = diff
    log(f"[host-metric] TX_TREE_EDGES=fold: {fold_run['seconds']:.2f} s, "
        f"winner {fold_run['winner']} {fold_run['winner_params']}, max "
        f"|fold - matrix edges| {diff:.3e}; K1 launches "
        f"{fold_run['k1_launches']}: " + " ".join(
            f"C={c}:{k}" for c, k in fold_run["k1_launches_by_c"].items()))
    if not np.all(np.isfinite(fold_run["metric_matrix"])) or (
            dev.type == "cuda" and fold_run["k1_launches"] == 0):
        raise AssertionError("[host-metric] the fold-edge search failed")
    if dev.type == "cuda":
        folds = CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                                seed=42, stratify=True)._splits(y)
        Xh = X.cpu().numpy() if isinstance(X, torch.Tensor) else X

        def fold_design():
            design = _PackedDesign(Xh, 32, dev, edge_rows=folds[0][0])
            yield ("fold-0 design", design,
                   _problem_k1_stats(design, "cls", y), (1, 32), True)
        out["k1"] = phase_k1_inputs(dev, fold_design(), "host-metric", 13)
    clear_design_cache()
    return out


def phase_mlp(device, rows: int = MLP_RECORDS) -> dict:
    """[mlp]: the Iris example on ``rows`` records (its 8 columns) with the
    opt-in MLP grid (hidden (10,) and (32, 16)): the batched fold fits'
    seconds (the device search), the L-BFGS refit's seconds and
    iterations, the holdout F1 and Error; save, reload and serve 1,001
    holdout records one at a time, the holdout through the compiled plan
    (``_serve_problem``). Then an IsotonicRegressionCalibrator fitted on
    the winner's class-2 scores and a ``wrap_estimator`` family in a small
    search, each in its own workflow, served once through its plan, their
    coverage logged (the external family is a host stage)."""
    from transmogrifai_tpu_torch.examples import iris
    from transmogrifai_tpu_torch.models import mlp
    from transmogrifai_tpu_torch.models.registry import (
        default_multiclass_extra_models)
    dev = resolve_device(device)
    models = [(est, grid) for est, grid in default_multiclass_extra_models(dev)
              if type(est).__name__ == "MultilayerPerceptronClassifier"]
    refits = []
    real_fit = mlp._fit_mlp

    def timed_fit(*args, **kwargs):
        t0 = time.perf_counter()
        params, iterations = real_fit(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        refits.append({"seconds": time.perf_counter() - t0,
                       "iterations": iterations,
                       "rows": int(args[0].shape[0])})
        return params, iterations
    mlp._fit_mlp = timed_fit
    try:
        out = phase_problem(dev, iris, iris.synthetic_iris(rows), "mlp",
                            models=models, serve=True, expect_k1=False)
    finally:
        mlp._fit_mlp = real_fit
    run = out.pop("run")
    out["refits"] = refits
    fam = out["families"]["MultilayerPerceptronClassifier"]
    log(f"[mlp] batched fold fits (6 x 100 Adam steps a point, 3 folds as "
        f"lanes) with their metric: {fam['seconds']:.2f} s; L-BFGS refit "
        + ", ".join(f"{r['seconds']:.2f} s / {r['iterations']} iterations "
                    f"on {r['rows']} rows" for r in refits)
        + f"; holdout F1 {out['holdout']['F1']:.6f} Error "
        f"{out['holdout']['Error']:.6f}")
    if not refits or out["winner"] != "MultilayerPerceptronClassifier":
        raise AssertionError(f"[mlp] no MLP refit: {out['winner']}")
    # the calibrator on the winner's class-2 scores of the holdout
    scored = run.model.score(run.holdout)[run.prediction.name]
    cal_records = [{"score": float(p), "label": float(lab == 2)}
                   for p, lab in zip(scored.probability[:, 2],
                                     (r["label"] for r in run.holdout))]
    out["calibrator"] = _serve_one(dev, "calibrator", cal_records, "score",
                                   lambda: IsotonicRegressionCalibrator(
                                       device=dev))
    # a wrap_estimator family in a small search over the Iris columns
    ext_records = iris.synthetic_iris(3_000, seed=5)
    ext = iris.run(ext_records, device=dev, models=[(
        wrap_estimator(centroid_fit, centroid_predict),
        [{"shrink": 0.0}, {"shrink": 0.2}])])
    plan = ScoringPlan(ext.model, device=dev).compile()
    t0 = time.perf_counter()
    one = plan.score(ext.holdout[:1])[ext.prediction.name]
    cov = plan.describe()["coverage"]
    out["external"] = {"train_s": ext.seconds, "serve_s":
                       time.perf_counter() - t0, "coverage": cov,
                       "holdout": ext.metrics.to_json(),
                       "probability": one.probability[0].tolist()}
    log(f"[mlp] wrap_estimator family (shrunken centroids, 2 points) on "
        f"3,000 Iris records: train {ext.seconds:.2f} s, holdout F1 "
        f"{ext.metrics.F1:.6f}; served one record "
        f"{out['external']['serve_s'] * 1e3:.2f} ms, P = "
        f"{np.round(one.probability[0], 4).tolist()}; coverage "
        f"{json.dumps(cov)}")
    if "SelectedModel" not in str(cov["fallback"]) or not np.isclose(
            one.probability[0].sum(), 1.0):
        raise AssertionError("[mlp] the external family did not serve as "
                             "a host stage")
    del run
    clear_design_cache()
    return out


def _serve_one(dev, tag: str, records, column: str, make_stage) -> dict:
    """``make_stage()`` fitted on ``records`` (a Real ``column`` through
    transmogrify, a RealNN ``label``) in a workflow on ``dev``, then one
    record served through the compiled plan, against the columnar path."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.types import Real, RealNN
    from transmogrifai_tpu_torch.workflow import Workflow
    x = FeatureBuilder.of(column, Real).extract(
        lambda r: r.get(column)).as_predictor()
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    out_f = make_stage().set_input(label, transmogrify([x])).get_output()
    t0 = time.perf_counter()
    model = Workflow(device=dev).set_result_features(out_f) \
        .set_input_records(records).train()
    train_s = time.perf_counter() - t0
    plan = model.scoring_plan()
    t0 = time.perf_counter()
    one = float(plan.score(records[:1])[out_f.name].data[0])
    serve_s = time.perf_counter() - t0
    want = float(model.score(records[:1])[out_f.name].data[0])
    cov = plan.describe()["coverage"]
    log(f"[mlp] {tag} on {len(records)} holdout scores: train "
        f"{train_s:.2f} s; served one record {serve_s * 1e3:.2f} ms: "
        f"{one:.6f} (columnar {want:.6f}); coverage {json.dumps(cov)}")
    if abs(one - want) > COMPILED_SCORE_TOL or cov["fallback"] or not (
            0.0 <= one <= 1.0):
        raise AssertionError(f"[mlp] the {tag} did not serve on the card")
    return {"train_s": train_s, "serve_s": serve_s, "coverage": cov,
            "served": one, "columnar": want}


def phase_models_agree(device, rows: int = MODELS_AGREE_RECORDS) -> dict:
    """[models-agree]: the MLP's batched fold fits and eval matrix on
    ``rows`` Iris records, the card (float32) against the CPU (float64)
    from the same draws: each fold's validation probabilities and the
    metric matrix within AGREE_TOL; then the host-metric search (log
    loss) of the small pool on ``rows`` Titanic records on both, within
    AGREE_TOL (GBT_SMALL_LEAF_TOL at the GBT points of min_child_weight
    1, as in [families-agree]) with the same winner unless the CPU's top
    two lie within AGREE_TOL."""
    from transmogrifai_tpu_torch.evaluators import LogLossEvaluator
    from transmogrifai_tpu_torch.models.mlp import (
        MultilayerPerceptronClassifier)
    X, y = iris_matrix(rows, seed=7)
    cv = CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                         seed=42, stratify=True)
    splits = cv._splits(y)
    masks = np.zeros((3, len(y)))
    for f, (tr, _) in enumerate(splits):
        masks[f, tr] = 1.0
    Xv = np.stack([X[va] for _, va in splits])
    yv = np.stack([y[va] for _, va in splits])
    grid = [{"hidden_layers": (10,)}, {"hidden_layers": (32, 16)}]
    sides = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        est = MultilayerPerceptronClassifier(device=where)
        t0 = time.perf_counter()
        fitted = est.fit_fold_grid_arrays(X, y, masks, grid)
        probs = np.stack([[fitted[f][g].predict_arrays(Xv[f]).probability
                           for g in range(len(grid))] for f in range(3)])
        mm = est.eval_fold_grid_arrays(X, y, masks, grid, Xv, yv,
                                       ("multiclass", "F1"))
        sides[side] = (probs, mm, time.perf_counter() - t0)
    prob_gap = float(np.abs(sides["card"][0] - sides["cpu"][0]).max())
    mm_gap = float(np.abs(sides["card"][1] - sides["cpu"][1]).max())
    out = {"mlp": {"rows": rows, "probability_max_diff": prob_gap,
                   "metric_max_diff": mm_gap,
                   "card_s": sides["card"][2], "cpu_s": sides["cpu"][2]}}
    log(f"[models-agree] MLP batched fits on {rows} Iris records: card "
        f"{sides['card'][2]:.2f} s, cpu {sides['cpu'][2]:.2f} s; validation "
        f"probabilities max |card - cpu| {prob_gap:.3e}, F1 matrix "
        f"{mm_gap:.3e} (tol {AGREE_TOL})")
    if prob_gap > AGREE_TOL or mm_gap > AGREE_TOL:
        raise AssertionError("[models-agree] the MLP's fits disagree")
    records = titanic.synthetic_titanic(rows, seed=7)
    runs = {}
    for side, where in (("card", device), ("cpu", "cpu")):
        dev = resolve_device(where)
        sel = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, seed=42, stratify=True,
            evaluator=LogLossEvaluator(), models=small_models(dev),
            device=dev)
        t0 = time.perf_counter()
        run = titanic.run(records, device=dev, model_stage=sel)
        selected = next(s for s in run.model.stages()
                        if type(s).__name__ == "SelectedModel")
        runs[side] = (metric_matrix(selected), selected.summary,
                      time.perf_counter() - t0)
    a, b = runs["card"][0], runs["cpu"][0]
    results = runs["cpu"][1].validation_results
    tol = np.array([GBT_SMALL_LEAF_TOL if r.model_name == "GBTClassifier"
                    and r.params.get("min_child_weight", 1.0) < 10
                    else AGREE_TOL for r in results])
    finite = np.isfinite(b)
    gap = np.where(finite, np.abs(a - b), 0.0)
    over = [(results[i].model_name, results[i].params,
             float(gap[:, i].max())) for i in range(gap.shape[1])
            if gap[:, i].max() > tol[i]]
    means = np.sort(b[:, finite.all(axis=0)].mean(axis=0))
    close = len(means) > 1 and means[1] - means[0] < AGREE_TOL
    same = (runs["card"][1].best_model_name,
            runs["card"][1].best_model_params) == (
        runs["cpu"][1].best_model_name, runs["cpu"][1].best_model_params)
    by_point = {f"{r.model_name} {json.dumps(r.params)}":
                float(gap[:, i].max()) for i, r in enumerate(results)}
    out["host_metric"] = {"rows": rows, "max_abs_diff": float(gap.max()),
                          "by_point": by_point,
                          "nan_equal": bool(np.array_equal(
                              finite, np.isfinite(a))),
                          "same_winner": same, "over": over,
                          "card_s": runs["card"][2], "cpu_s": runs["cpu"][2]}
    log(f"[models-agree] host-metric search (log loss) on {rows} Titanic "
        f"records: card {runs['card'][2]:.2f} s, cpu {runs['cpu'][2]:.2f} s;"
        f" max |card - cpu| {gap.max():.3e} (tol {AGREE_TOL}, "
        f"{GBT_SMALL_LEAF_TOL} at GBT min_child_weight 1); winner card "
        f"{runs['card'][1].best_model_name} cpu "
        f"{runs['cpu'][1].best_model_name}"
        f"{' (top two within tol)' if close else ''}; over tol {over}; by "
        f"grid point {json.dumps(by_point)}")
    if over or not np.array_equal(finite, np.isfinite(a)) or not (
            same or close):
        raise AssertionError("[models-agree] the host-metric searches "
                             "disagree card to CPU")
    clear_design_cache()
    return out


def phase_models(device, agree: bool = True,
                 per_candidate: bool = False) -> dict:
    """The model layer's phases (without [models-agree] unless
    ``agree``; ``per_candidate``: see ``phase_host_metric``)."""
    seconds = {}
    t0 = time.perf_counter()
    out = {"host_metric": phase_host_metric(device,
                                            per_candidate=per_candidate)}
    seconds["host_metric"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["mlp"] = phase_mlp(device)
    seconds["mlp"] = time.perf_counter() - t0
    if agree:
        t0 = time.perf_counter()
        out["agree"] = phase_models_agree(device)
        seconds["models_agree"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"[models] phase seconds {json.dumps(seconds)}")
    return out


# ---------------------------------------------------------------------------
# the card-against-CPU phases, after the timed ones
# ---------------------------------------------------------------------------

#: records of [resume]: the Titanic DAG at full width (~587 columns).
#: Its searches are host-bound, so fewer records save little: on an H100
#: (``--runtime-only --resume-rows``, one host) [resume] took 51.3 s at
#: 10,000 records, 54.0 at 25,000 and 62.3 at 50,000, the three runtime
#: phases 85.2, 78.2 and 100.0 s against RUNTIME_PHASES_BUDGET_S
RESUME_ROWS = 25_000
#: the largest gap a GBT point recomputed after the kill may keep to run
#: A's metric. Its float32 gradient histograms add in K1's atomic order,
#: so near-tie splits fall otherwise than in run A at any depth: on an
#: H100 the largest gap of a run was 2.78e-3 to 5.50e-3 in ten runs at
#: 10,000 to 50,000 records (5.50e-3 at depth 6, min_child_weight 1,
#: 10,000 records; 5.45e-3 at 50,000), 1.8 times under this limit. The
#: other families keep AGREE_TOL (their gap 0 in every run)
RESUME_GBT_TOL = 1e-2
#: records of [quarantine]'s Titanic matrix
QUARANTINE_ROWS = 20_000
#: records the [heal] model trains on
HEAL_ROWS = 5_000
#: pause between [heal]'s traffic ticks while it waits on the lifecycle
#: (each tick 32 requests of the shifted tenant and 8 of the other)
HEAL_TICK_S = 0.02
#: [quarantine]'s allocator limit must leave the linear families this
#: many bytes above their measured need, and lie this far under RF's
QUARANTINE_MARGIN = 32 << 20
#: [resume], [quarantine] and [heal] together (seconds, reported beside
#: their total, not enforced)
RUNTIME_PHASES_BUDGET_S = 90


def _titanic_train(device, records, selector, resume_from=None,
                   listener=None):
    """The Titanic DAG (``titanic.build_features``) trained with
    ``selector`` on ``records``, no holdout scored: (model, seconds, the
    prepared vector feature)."""
    from transmogrifai_tpu_torch.workflow import Workflow
    survived, features = titanic.build_features()
    pred = selector.set_input(survived, features).get_output()
    wf = (Workflow(device=device).set_result_features(survived, pred)
          .set_input_records(records))
    if listener is not None:
        wf = wf.with_listener(listener)
    t0 = time.perf_counter()
    model = wf.train(resume_from=resume_from)
    return model, time.perf_counter() - t0, features


def _selected(model):
    return next(s for s in model.stages()
                if type(s).__name__ == "SelectedModel")


@contextlib.contextmanager
def journal_timer(rec: dict):
    """Time every journal line's write and fsync (``SearchJournal.
    _write_line``) into ``rec``: lines and seconds."""
    from transmogrifai_tpu_torch.runtime.journal import SearchJournal
    real = SearchJournal._write_line
    rec.setdefault("lines", 0)
    rec.setdefault("fsync_s", 0.0)

    def timed(self, line):
        t0 = time.perf_counter()
        real(self, line)
        rec["fsync_s"] += time.perf_counter() - t0
        rec["lines"] += 1
    SearchJournal._write_line = timed
    try:
        yield rec
    finally:
        SearchJournal._write_line = real


def _resume_case(dev, records, validation: str, kill: str,
                 tag: str = "resume") -> dict:
    """Run A (uninterrupted, journaled) and run B (killed by the fault
    plan ``kill``, then ``train(resume_from=...)``) of the Titanic DAG
    over the default pool (forests at PATH_TREES) under 3-fold CV,
    ``validation`` exact or racing. Fails unless the resumed run
    dispatches no journaled (family, rung) entry (so its journaled
    families launch K1 zero times), replays the journal bit for bit,
    picks run A's winner, races no candidate to another last rung than
    run A's where either is a journaled rung, and stays within AGREE_TOL
    of run A's metrics (RESUME_GBT_TOL at a recomputed GBT point)."""
    import tempfile
    from transmogrifai_tpu_torch.runtime import (FaultInjector, KillPoint,
                                                 read_journal, telemetry)
    from transmogrifai_tpu_torch.runtime.journal import JOURNAL_NAME

    def selector(ckpt, families):
        sel = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, seed=42, stratify=True, models=path_pool(dev),
            device=dev, validation=validation)
        sel.checkpoint_dir = ckpt
        for est, _ in sel.models:
            time_family(est, families)
        return sel

    def k1_by(families):
        """K1 launches by family and by C of ``time_family`` records."""
        by_c = collections.Counter()
        for rec in families.values():
            by_c.update(rec["k1_launches_by_c"])
        return ({f: rec["k1_launches"] for f, rec in families.items()},
                dict(sorted(by_c.items())))

    def reset():
        telemetry.reset()
        clear_design_cache()
        level_hist.launches = 0
        level_hist.launches_by_c.clear()

    out = {"validation": validation, "kill": kill}
    with tempfile.TemporaryDirectory() as dir_a, \
            tempfile.TemporaryDirectory() as dir_b:
        reset()
        fams_a: dict = {}
        jrec: dict = {}
        with journal_timer(jrec):
            model_a, out["run_a_s"], _ = _titanic_train(
                dev, records, selector(dir_a, fams_a))
        out["journal_bytes"] = os.path.getsize(
            os.path.join(dir_a, JOURNAL_NAME))
        out["journal_lines"] = jrec["lines"]
        out["journal_fsync_s"] = jrec["fsync_s"]
        out["run_a_k1_by_family"], out["run_a_k1_by_c"] = k1_by(fams_a)
        sum_a = _selected(model_a).summary
        reset()
        t0 = time.perf_counter()
        try:
            with FaultInjector.plan(kill):
                _titanic_train(dev, records, selector(dir_b, {}))
        except KillPoint:
            pass
        else:
            raise AssertionError(f"[{tag}] {kill} did not kill run B")
        out["run_b_killed_s"] = time.perf_counter() - t0
        info = read_journal(dir_b)
        journaled = {(e["family"], e["rung"]): e for e in info["entries"]}
        out["journaled"] = sorted("/".join(k) for k in journaled)
        out["resume_saved_fold_fits"] = info["resumeSavedFoldFits"]
        reset()
        fams_r: dict = {}
        sel_r = selector(None, fams_r)
        model_r, out["run_b_resume_s"], _ = _titanic_train(
            dev, records, sel_r, resume_from=dir_b)
        dispatched = {(k, r) for k, r, _, _ in telemetry.dispatch_log()}
        counters = telemetry.counters()
    out["journal_hits"] = counters.get("journal_hits", 0)
    out["dispatched_on_resume"] = sorted("/".join(k) for k in dispatched)
    out["resume_k1_by_family"], out["resume_k1_by_c"] = k1_by(fams_r)
    sum_r = _selected(model_r).summary
    out["winner"] = [sum_r.best_model_name, sum_r.best_model_params]
    # a family recomputed after the kill meets K1's float atomics anew:
    # GBT's float32 gradient sums then break near ties otherwise than in
    # run A (RESUME_GBT_TOL); every other family keeps AGREE_TOL
    res_a = {(r.model_name, r.grid_index): r for r in
             sum_a.validation_results}
    rungs_of = collections.defaultdict(set)
    for key, rung in journaled:
        rungs_of[key.partition(":")[2]].add(rung)
    gap, worst, other, over, parted = 0.0, None, 0.0, [], []
    for r in sum_r.validation_results:
        ref = res_a[(r.model_name, r.grid_index)]
        if len(r.metric_values) != len(ref.metric_values):
            # raced to another rung than in run A: a recomputed near tie
            # may prune otherwise past the journaled rungs, never at one
            parted.append((r.model_name, r.grid_index, ref.rung, r.rung))
            continue
        g = float(np.max(np.abs(np.subtract(r.metric_values,
                                            ref.metric_values))))
        if g > gap:
            gap, worst = g, f"{r.model_name}{r.params}"
        gbt = r.model_name == "GBTClassifier"
        if not gbt:
            other = max(other, g)
        if g > (RESUME_GBT_TOL if gbt else AGREE_TOL):
            over.append((r.model_name, r.params, g))
    out["max_metric_gap_vs_run_a"] = gap
    out["max_metric_gap_at"] = worst
    out["max_metric_gap_vs_run_a_not_gbt"] = other
    out["parted_from_run_a"] = [f"{n}[{gi}] rung {ra} -> {rr}"
                                for n, gi, ra, rr in parted]
    log(f"[{tag}] {validation}: run A {out['run_a_s']:.2f} s (journal "
        f"{out['journal_lines']} lines, {out['journal_bytes']} bytes, "
        f"{out['journal_fsync_s'] * 1e3:.1f} ms writing and fsyncing), K1 "
        f"{json.dumps(out['run_a_k1_by_family'])} by C "
        f"{json.dumps(out['run_a_k1_by_c'])}; run B killed by {kill} "
        f"after {out['run_b_killed_s']:.2f} s with {out['journaled']} "
        f"journaled ({out['resume_saved_fold_fits']} fold fits); resumed in "
        f"{out['run_b_resume_s']:.2f} s, journal hits {out['journal_hits']}"
        f", dispatched {out['dispatched_on_resume']}, K1 "
        f"{json.dumps(out['resume_k1_by_family'])} by C "
        f"{json.dumps(out['resume_k1_by_c'])}; winner {out['winner']} (run "
        f"A {sum_a.best_model_name} {sum_a.best_model_params}); largest "
        f"metric gap to run A {gap:.3g} at {worst}, {other:.3g} outside "
        f"GBT; {len(parted)} candidates raced to another rung "
        f"{out['parted_from_run_a']}")
    at_journaled = [p for p in parted if validation == "exact" or
                    {f"rung{p[2]}", f"rung{p[3]}"} & rungs_of[p[0]]]
    if at_journaled:
        raise AssertionError(f"[{tag}] candidates parted from run A at a "
                             f"journaled rung: {at_journaled}")
    if not journaled or out["journal_hits"] < len(journaled):
        raise AssertionError(f"[{tag}] resume replayed "
                             f"{out['journal_hits']} of {len(journaled)} "
                             f"journaled entries")
    if dispatched & set(journaled) or not dispatched:
        raise AssertionError(f"[{tag}] resume dispatched "
                             f"{sorted(dispatched)} against the journaled "
                             f"{sorted(journaled)}")
    if validation == "exact":
        done = {key.partition(":")[2] for key, _ in journaled}
        if done & set(fams_r):
            raise AssertionError(f"[{tag}] journaled families {sorted(done)}"
                                 f" dispatched on resume: {fams_r}")
    else:
        rung0 = sel_r.validator.rung_profile[0]
        if rung0["familySeconds"] or any(r == "rung0" for _, r in
                                         dispatched):
            raise AssertionError(f"[{tag}] rung 0 dispatched on resume: "
                                 f"{rung0}")
    if dev.type == "cuda" and not any(
            out["resume_k1_by_family"].values()):
        raise AssertionError(f"[{tag}] the resumed search launched no K1")
    # replayed entries equal the journal bit for bit: an exact family's
    # results, and a raced candidate's where it was pruned at that rung
    by_name = {(r.model_name, r.grid_index): r for r in
               sum_r.validation_results}
    for (key, rung), e in journaled.items():
        name = key.partition(":")[2]
        for gi, row in zip(e["cands"], e["metrics"]):
            r = by_name[(name, gi)]
            replayed = (rung in ("exact", "exact-host")
                        or f"rung{r.pruned_at}" == rung)
            if replayed and r.metric_values != list(row):
                raise AssertionError(
                    f"[{tag}] {name}[{gi}] replayed {r.metric_values} "
                    f"against the journal's {row}")
    if (sum_r.best_model_name, sum_r.best_model_params) != \
            (sum_a.best_model_name, sum_a.best_model_params):
        raise AssertionError(f"[{tag}] resumed winner {out['winner']} is "
                             f"not run A's {sum_a.best_model_name} "
                             f"{sum_a.best_model_params}")
    if over:
        raise AssertionError(f"[{tag}] resumed metrics off run A's beyond "
                             f"their tolerance: {over}")
    return out


def phase_resume(device, rows: int = RESUME_ROWS) -> dict:
    """[resume]: kill-and-resume of the Titanic search at ``rows`` records
    under exact CV (killed at GBTClassifier's dispatch) and under racing
    (killed at the rung 1 boundary)."""
    dev = resolve_device(device)
    train, _ = titanic.stratified_split(
        titanic.synthetic_titanic(rows, seed=42))
    t0 = time.perf_counter()
    out = {"rows": rows, "train_rows": len(train),
           "exact": _resume_case(dev, train, "exact",
                                 "family:GBTClassifier:dispatch:1=kill"),
           "racing": _resume_case(dev, train, "racing",
                                  "rung:1:boundary:1=kill")}
    out["seconds"] = time.perf_counter() - t0
    launches = sum(sum(out[v][k].values()) for v in ("exact", "racing")
                   for k in ("run_a_k1_by_family", "resume_k1_by_family"))
    out["k1_launches"] = launches
    return out


def _peak_memory(est, peaks: dict) -> None:
    """Wrap ``est``'s device search to record the bytes allocated when it
    starts and the peak of the call above them. A tree family starts
    from an empty design cache, so its peak holds its own binning."""
    search = est.eval_fold_grid_arrays

    def measured(*args, **kwargs):
        if type(est).__name__ in TREE_FAMILIES:
            clear_design_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = search(*args, **kwargs)
        torch.cuda.synchronize()
        peaks[type(est).__name__] = {
            "base": base, "peak": torch.cuda.max_memory_allocated() - base}
        return out
    est.eval_fold_grid_arrays = measured


def _start_memory(est, seen: dict) -> None:
    """Wrap ``est``'s device search to record the bytes allocated when
    each call starts (after a family before it was quarantined, what it
    left behind shows here)."""
    search = est.eval_fold_grid_arrays

    def measured(*args, **kwargs):
        torch.cuda.synchronize()
        seen.setdefault(type(est).__name__, []).append(
            torch.cuda.memory_allocated())
        return search(*args, **kwargs)
    est.eval_fold_grid_arrays = measured


def phase_quarantine(device, rows: int = QUARANTINE_ROWS) -> dict:
    """[quarantine], in a process of its own: the Titanic search over the
    default pool (forests at PATH_TREES) once unlimited, measuring the
    device memory each family needs above the search's entry at its peak,
    then again with the allocator limited
    (``torch.cuda.set_per_process_memory_fraction``, set around the
    search) to the midpoint of the linear families' need and RF's, so
    that RF meets a real ``torch.cuda.OutOfMemoryError`` (GBT, whose peak
    is the same binning, too): ``train()`` completes with the survivors,
    the summary names RF (kind transient, its retry spent), every family
    starts from the bytes the first did (nothing of a quarantined one
    stays on the card), K1 then matches its plain version on the same
    matrix, and an injected OOM at every family raises one
    AllFamiliesFailedError naming all four."""
    import gc
    from transmogrifai_tpu_torch.runtime import RetryPolicy
    dev = resolve_device(device)
    t0 = time.perf_counter()
    train, _ = titanic.stratified_split(
        titanic.synthetic_titanic(rows, seed=7))

    def selector(attempts):
        sel = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, seed=42, stratify=True, models=path_pool(dev),
            device=dev)
        sel.retry_policy = RetryPolicy(max_attempts=attempts,
                                       base_delay=0.05)
        return sel

    peaks: dict = {}
    sel = selector(2)
    for est, _ in sel.models:
        _peak_memory(est, peaks)
    real_ref = sel.fit_columns
    entry: dict = {}

    def at_entry(cols):
        torch.cuda.synchronize()
        entry["allocated"] = torch.cuda.memory_allocated()
        return real_ref(cols)
    sel.fit_columns = at_entry
    model, ref_s, _ = _titanic_train(dev, train, sel)
    ref = _selected(model).summary
    # each family's need: the bytes above the search's entry at its peak
    # (the fold arrays and a tree family's own binning included: the
    # binning is both tree families' peak, 545 MB at 15,000 rows on an
    # H100, so GBT does not fit where RF does not either)
    need = {f: p["base"] + p["peak"] - entry["allocated"]
            for f, p in peaks.items()}
    lin = max(need[f] for f in LINEAR_FAMILIES)
    rf = need["RandomForestClassifier"]
    if rf < lin + 2 * QUARANTINE_MARGIN:
        raise AssertionError(f"[quarantine] RF's need {rf} bytes is not "
                             f"clear of the linear families' {lin}: no "
                             f"limit fails RF and fits them")
    headroom = (lin + rf) // 2
    del model
    clear_design_cache()
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    limit: dict = {}
    sel2 = selector(2)
    for est, _ in sel2.models:
        _start_memory(est, limit.setdefault("allocated_at_start", {}))
    real_fit = sel2.fit_columns

    def limited(cols):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        limit["reserved_at_search"] = torch.cuda.memory_reserved(dev)
        limit["bytes"] = limit["reserved_at_search"] + headroom
        torch.cuda.set_per_process_memory_fraction(limit["bytes"] / total,
                                                   dev)
        try:
            return real_fit(cols)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
    sel2.fit_columns = limited
    model2, lim_s, vector = _titanic_train(dev, train, sel2)
    summ = _selected(model2).summary
    q = {r["family"]: r for r in summ.quarantined}
    X = model2.train_dataset[vector.name].data
    y = np.asarray(model2.train_dataset["survived"].data, dtype=np.float64)
    k1 = phase_k1_inputs(dev, matrix_k1_inputs(dev, X, y, "quarantine"),
                         "quarantine", seed=17)
    del X
    all_failed = all_families_fail(dev, train, selector(1))
    out = {"rows": rows, "train_rows": len(train),
           "peaks": peaks, "need": need, "limit": limit,
           "headroom": headroom,
           "reference_s": ref_s, "reference_winner": ref.best_model_name,
           "limited_s": lim_s, "quarantined": summ.quarantined,
           "winner": [summ.best_model_name, summ.best_model_params],
           "k1": k1, "all_failed": all_failed,
           "seconds": time.perf_counter() - t0}
    log(f"[quarantine] {len(train)} train rows; bytes each family needs "
        f"above the search's entry: " + ", ".join(f"{f} {n}" for f, n in
                                                  need.items())
        + f"; limit {limit.get('bytes')} bytes ({headroom} above the "
        f"{limit.get('reserved_at_search')} reserved at the search; "
        f"allocated at each call's start "
        f"{json.dumps(limit.get('allocated_at_start'))}); "
        f"unlimited train {ref_s:.2f} s (winner {ref.best_model_name}), "
        f"limited {lim_s:.2f} s: quarantined "
        + json.dumps(summ.quarantined)
        + f"; winner {summ.best_model_name}; K1 after the OOM: "
        + ", ".join(f"{c['case']} err {c['max_abs_err']:.3g}"
                    for c in k1["cases"])
        + f"; every family OOM: AllFamiliesFailedError {all_failed}")
    rec = q.get("RandomForestClassifier")
    if rec is None or rec["kind"] != "transient" or rec["retries"] != 1 \
            or rec["errorType"] != "OutOfMemoryError":
        raise AssertionError(f"[quarantine] RF was not quarantined by a "
                             f"real OOM after its retry: {summ.quarantined}")
    if set(q) & set(LINEAR_FAMILIES):
        raise AssertionError(f"[quarantine] a linear family did not fit: "
                             f"{summ.quarantined}")
    # nothing of a quarantined family stays on the card: every family
    # starts from the bytes the first one started from
    starts = limit["allocated_at_start"]
    first = starts["LogisticRegression"][0]
    left = {f: max(v) - first for f, v in starts.items()}
    if any(b > 0 for b in left.values()):
        raise AssertionError(f"[quarantine] a family started above the "
                             f"first one's {first} bytes: {left}")
    if summ.best_model_name in q:
        raise AssertionError(f"[quarantine] quarantined winner "
                             f"{summ.best_model_name}")
    return out


def all_families_fail(device, records, selector) -> list:
    """The Titanic DAG trained with ``selector`` under an injected OOM at
    every family's every dispatch: the families the one
    AllFamiliesFailedError names, which must be all of the pool's."""
    from transmogrifai_tpu_torch.runtime import (AllFamiliesFailedError,
                                                 FaultInjector)
    pool = sorted(type(est).__name__ for est, _ in selector.models)
    try:
        with FaultInjector.plan("family:*:dispatch:*=oom"):
            _titanic_train(device, records, selector)
    except AllFamiliesFailedError as e:
        named = sorted(r.family for r in e.records)
    else:
        raise AssertionError("[quarantine] every family failed and train() "
                             "raised no AllFamiliesFailedError")
    if named != pool:
        raise AssertionError(f"[quarantine] AllFamiliesFailedError named "
                             f"{named}, not {pool}")
    return named


def heal_models(device, num_trees: int = 5, num_rounds: int = 20):
    """[heal]'s pool: LogisticRegression (its default grid), RF at
    ``num_trees`` trees and GBT at ``num_rounds`` rounds on 4-point
    grids."""
    return small_models(device, num_rounds=num_rounds, num_trees=num_trees,
                        families=("LogisticRegression",
                                  "RandomForestClassifier", "GBTClassifier"))


def shifted(records):
    """``records`` under covariate shift: every age 100 years older, every
    passenger male (the labels kept)."""
    return [dict(r, age=(r["age"] or 30.0) + 100.0, sex="male")
            for r in records]


def phase_heal(device, rows: int = HEAL_ROWS, models=heal_models) -> dict:
    """[heal]: a Titanic model trained on ``rows`` records with a
    BinaryClassificationModelSelector over ``models(device)``, served with
    the lifecycle and the drift sentinel. Tenant ``a`` receives a
    covariate-shifted stream until its sentinel degrades; the background
    retrain (a ``register_refit`` factory of the same DAG over the base
    records and the labeled ring) runs on the device and launches K1, the
    canary passes and the entry swaps; then a
    ``lifecycle:titanic:postswap:1=preempt`` fault rolls it back. Tenant
    ``b`` keeps its original entry object and its answers throughout,
    and every answer carries the served model's result names. Requests
    dropped (must be 0), ``plan_compiles()`` at and after the swap
    (flat), the retrain's seconds and served p50 / p99 before, during and
    after the retrain."""
    from transmogrifai_tpu_torch.runtime import FaultInjector, telemetry
    from transmogrifai_tpu_torch.serving import (
        DriftThresholds, LifecycleConfig, ServeConfig, plan_compiles,
        serve_in_process)
    from transmogrifai_tpu_torch.workflow import Workflow
    dev = resolve_device(device)
    t0 = time.perf_counter()
    records = titanic.synthetic_titanic(rows, seed=21)
    train, holdout = titanic.stratified_split(records)

    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device=dev, models=models(dev))
    survived, features = titanic.build_features()
    prediction = sel.set_input(survived, features).get_output()

    def workflow():
        # the same unfitted DAG each time: a candidate answers under the
        # served model's result names
        return Workflow(device=dev).set_result_features(survived,
                                                        prediction)

    model = workflow().set_input_records(train).train()
    train_s = time.perf_counter() - t0
    pred = model.result_features[1].name
    telemetry.reset()
    config = ServeConfig(
        max_wait_ms=5.0, max_batch=64, sentinel=True,
        # the fresh sentinel's fingerprints come from the ring: at 256 rows
        # the sparse cabin column alone read 0.53 against the same stream
        # on an H100, so the ring and the first report are larger
        drift_thresholds=DriftThresholds(warn=0.2, degrade=0.5,
                                         min_rows=512),
        lifecycle=LifecycleConfig(
            retrain_budget_seconds=300.0, canary_rows=1024,
            metric_slack=0.05, watch_batches=1_000_000,
            cooldown_seconds=3600.0))
    server, client = serve_in_process({"titanic": model}, config,
                                      device=dev)
    server.register_refit("titanic", workflow_factory=workflow,
                          base_records=train)
    lat = {"before": [], "during": [], "after": []}
    sent = [0]
    answered = [0]

    def stage():
        c = telemetry.counters()
        if not c.get("lifecycle_detect"):
            return "before"
        return "during" if not c.get("lifecycle_swaps") else "after"

    def tick(batch_a, batch_b=()):
        when = stage()
        done = {}
        futs = []
        for tenant, batch in (("a", batch_a), ("b", batch_b)):
            for r in batch:
                f = client.submit(dict(r), model="titanic", tenant=tenant)
                i = len(futs)
                f.add_done_callback(
                    lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
                futs.append((f, time.perf_counter()))
        sent[0] += len(futs)
        rows_out = []
        for i, (f, t_sub) in enumerate(futs):
            row = f.result(timeout=120.0)
            if pred not in row:
                raise AssertionError(f"[heal] a request failed: {row}")
            answered[0] += 1
            lat[when].append((done.get(i, time.perf_counter()) - t_sub)
                             * 1e3)
            rows_out.append(row)
        return rows_out[len(batch_a):]

    def wait(counter, feed, limit_s=600.0):
        t_w = time.monotonic()
        while not telemetry.counters().get(counter):
            c = telemetry.counters()
            failed = [k for k in ("lifecycle_retrain_failures",
                                  "lifecycle_canary_fail",
                                  "lifecycle_swap_failures") if c.get(k)]
            if failed or time.monotonic() - t_w > limit_s:
                raise AssertionError(
                    f"[heal] {counter} never came ({failed}): "
                    f"{server.metrics_snapshot()['lifecycle']}")
            feed()
            time.sleep(HEAL_TICK_S)

    def stream(rows, n):
        """The next ``n`` of ``rows``, cycling: a stream of distinct
        records, as the sentinel expects of live traffic."""
        pos = [0]

        def take():
            k = pos[0]
            pos[0] += n
            return [rows[(k + i) % len(rows)] for i in range(n)]
        return take

    try:
        entry0 = server.plans.get("titanic")
        server.prewarm(buckets=[b for b in entry0.plan.buckets()
                                if b <= config.max_batch])
        control = holdout[:16]
        base_b = tick((), control)
        # before the shift only tenant b is served (at the same 40
        # requests a tick): tenant a's ring then holds shifted rows alone
        # when its sentinel degrades, and so do the fingerprints its
        # candidate's sentinel is built from
        warm_b = stream(holdout, 40)
        for _ in range(8):
            tick((), warm_b())
        live_b = stream(holdout, 8)
        drifted = stream(shifted(holdout), 32)

        def drift():
            tick(drifted(), live_b())

        level_hist.launches = 0
        level_hist.launches_by_c.clear()
        t_drift = time.perf_counter()
        wait("lifecycle_detect", drift)
        t_detect = time.perf_counter()
        wait("lifecycle_swaps", drift)
        t_swap = time.perf_counter()
        k1_launches = level_hist.launches
        k1_by_c = dict(sorted(level_hist.launches_by_c.items()))
        compiles_at_swap = plan_compiles()
        for _ in range(10):
            drift()
        compiles_after = plan_compiles()
        swapped = server.plans.entry_for("titanic", "a")
        rows_b = tick((), control)
        same_b = all(r0[pred] == r1[pred] for r0, r1 in zip(base_b, rows_b))
        entry_b_kept = server.plans.entry_for("titanic", "b") is entry0
        mark = telemetry.events_mark()
        with FaultInjector.plan("lifecycle:titanic:postswap:1=preempt"):
            wait("lifecycle_rollbacks", drift, limit_s=60.0)
        rolled = [e for e in telemetry.events_since(mark)
                  if e["event"] == "lifecycle"
                  and e.get("phase") == "rollback"]
        restored = server.plans.entry_for("titanic", "a") is entry0
        drift()
        snap = server.metrics_snapshot()
        history = list(server.lifecycle.history)
    finally:
        server.stop()
    retrain = next((h for h in history if h["phase"] == "retrain_end"), {})
    out = {"rows": rows, "train_s": train_s,
           "requests": sent[0], "answered": answered[0],
           "requests_dropped": sent[0] - answered[0],
           "failed_batches": snap["failed_batches"],
           "plan_compiles_at_swap": compiles_at_swap,
           "plan_compiles_after": compiles_after,
           "retrain_s": retrain.get("seconds"),
           "retrain_rows": retrain.get("rows"),
           "detect_after_s": t_detect - t_drift,
           "swap_after_detect_s": t_swap - t_detect,
           "k1_launches": k1_launches, "k1_launches_by_c": k1_by_c,
           "tenant_b_entry_kept": entry_b_kept,
           "tenant_b_answers_equal": same_b,
           "swapped_generation": getattr(swapped.model,
                                         "trained_generation", None),
           "rollback": rolled[0] if rolled else None,
           "restored_original": restored,
           "phases": [h["phase"] for h in history],
           "seconds": time.perf_counter() - t0}
    for when, ms in lat.items():
        out[f"ms_p50_{when}"] = float(np.percentile(ms, 50)) if ms else None
        out[f"ms_p99_{when}"] = float(np.percentile(ms, 99)) if ms else None
        out[f"requests_{when}"] = len(ms)
    log(f"[heal] model trained on {len(train)} records in {train_s:.2f} s; "
        f"sentinel degraded {out['detect_after_s']:.2f} s into the shifted "
        f"stream, swapped {out['swap_after_detect_s']:.2f} s later (retrain "
        f"{out['retrain_s']} s on {out['retrain_rows']} rows, K1 "
        f"{k1_launches} launches by C {json.dumps(k1_by_c)}); "
        f"plan_compiles at the swap {compiles_at_swap}, after "
        f"{compiles_after}; rollback {json.dumps(out['rollback'])}; "
        f"requests {sent[0]}, dropped {out['requests_dropped']}, failed "
        f"batches {out['failed_batches']}; tenant b's entry kept "
        f"{entry_b_kept}, answers equal {same_b}; served ms p50 / p99: "
        + ", ".join(f"{w} {out[f'ms_p50_{w}']:.3f} / "
                    f"{out[f'ms_p99_{w}']:.3f} ({out[f'requests_{w}']})"
                    for w in lat if lat[w])
        + f"; phases {out['phases']}")
    if out["requests_dropped"] or out["failed_batches"]:
        raise AssertionError(f"[heal] requests dropped: {out}")
    if compiles_after != compiles_at_swap:
        raise AssertionError(f"[heal] {compiles_after - compiles_at_swap} "
                             f"compiles after the prewarmed swap")
    if not (entry_b_kept and same_b):
        raise AssertionError("[heal] tenant b lost its original entry or "
                             "its answers changed")
    if not restored or not rolled or not rolled[0].get("restored") \
            or "InjectedPreemption" not in rolled[0].get("reason", ""):
        raise AssertionError(f"[heal] no rollback to the original entry: "
                             f"{rolled}")
    if out["phases"] != ["detect", "retrain_start", "retrain_end",
                         "canary_pass", "swap", "rollback"]:
        raise AssertionError(f"[heal] lifecycle phases {out['phases']}")
    if dev.type == "cuda" and k1_launches == 0:
        raise AssertionError("[heal] the retrain launched no K1")
    return out


def _spawned(name: str, device):
    """``name`` (a phase of this module) in a spawned process of its own."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        return pool.apply(_agree_phase, (name, device))


def runtime_budget(out: dict, in_worker: bool = False) -> dict:
    """The seconds of [resume], [heal] and [quarantine] in ``out``
    against RUNTIME_PHASES_BUDGET_S, logged and recorded. ``in_worker``:
    [resume] and [quarantine] ran in the AgreeWorker, beside the
    card-against-CPU processes on the same card and host, and their
    seconds say so (``--runtime-only`` times them alone)."""
    total = sum(out[k]["seconds"] for k in ("resume", "heal", "quarantine"))
    out["seconds"] = total
    out["within_budget"] = total <= RUNTIME_PHASES_BUDGET_S
    out["resume_quarantine_in_worker"] = in_worker
    log(f"[runtime] [resume] {out['resume']['seconds']:.1f} s, [heal] "
        f"{out['heal']['seconds']:.1f} s, [quarantine] "
        f"{out['quarantine']['seconds']:.1f} s: {total:.1f} s against the "
        f"{RUNTIME_PHASES_BUDGET_S} s budget ("
        + ("within" if out["within_budget"] else "over")
        + (", [resume] and [quarantine] under contention in the worker"
           if in_worker else "") + ")")
    return out


def phase_runtime(device, resume_rows: int = RESUME_ROWS) -> dict:
    """``--runtime-only``: [resume], [heal], then [quarantine] in a
    spawned process, against their budget."""
    out = {"resume": phase_resume(device, resume_rows)}
    out["heal"] = phase_heal(device)
    out["quarantine"] = _spawned("phase_quarantine", device)
    return runtime_budget(out)


#: the card-against-CPU phases of the whole smoke, [problems-agree] as its
#: three searches ("name:part"), longest first by their CPU halves on the
#: host of one H100 (in one run: phase 6 111.9 s, [validate-agree]
#: 106.1, [wf-agree] 90.0, Boston 71.9, Iris 69.5). They run after the
#: last timed phase, one process each while the host has cores for it,
#: so no path is timed while one of them loads the host or the card;
#: [resume] (its checks count dispatches, not seconds: it took 96.2 s
#: at 10,000 records timed alone in the whole smoke on an H100, where
#: ``--runtime-only`` takes 51.3 s) and [quarantine] (which limits its
#: own process's allocator) join them, so their seconds there are read
#: under contention
AGREE_PHASES = ("phase_card_vs_cpu", "phase_resume", "phase_validate_agree",
                "phase_workflow_agree", "phase_problems_agree:boston",
                "phase_problems_agree:iris", "phase_families_agree",
                "phase_models_agree", "phase_text_agree",
                f"phase_problems_agree:k{WIDE_K}", "phase_quarantine")


def _agree_worker_init(threads: int) -> None:
    torch.set_num_threads(threads)


def _agree_phase(name: str, device):
    """``name`` (one of AGREE_PHASES) at its whole-smoke arguments, under
    ``forbid_quarantines`` unless it is [quarantine]."""
    if name == "phase_quarantine":
        return phase_quarantine(device)
    with forbid_quarantines(name):
        if name == "phase_card_vs_cpu":
            return phase_card_vs_cpu(device, CARD_VS_CPU_ROWS, COLS)
        name, _, part = name.partition(":")
        if part:
            return globals()[name](device, parts=(part,))
        return globals()[name](device)


class AgreeWorker:
    """AGREE_PHASES in ``workers`` spawned processes (default: one a
    phase, at most one a core), each with its share of the host's cores,
    taken in order as a process comes free; ``result`` waits for one of
    them and raises what it raised. ``close`` stops the processes."""

    def __init__(self, device, workers: int = None):
        cores = len(os.sched_getaffinity(0))
        workers = workers or min(len(AGREE_PHASES), cores)
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(workers, initializer=_agree_worker_init,
                             initargs=(max(1, cores // workers),))
        self.pending = {name: self.pool.apply_async(_agree_phase,
                                                    (name, device))
                        for name in AGREE_PHASES}

    def result(self, name: str):
        return self.pending[name].get()

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


#: the family quarantines of this process's phases, recorded by
#: ``forbid_quarantines``
QUARANTINES: list = []


def check_no_quarantines(where: str) -> None:
    """Fail if a family was quarantined since the last check."""
    if QUARANTINES:
        found = list(QUARANTINES)
        QUARANTINES.clear()
        raise AssertionError(f"[{where}] families quarantined outside "
                             f"[quarantine]: {found}")


@contextlib.contextmanager
def forbid_quarantines(where: str = "smoke"):
    """Record every family quarantine made inside the block (a search's
    and the lifecycle's) and fail on leaving it, as at each of ``Laps``'s
    laps, if there was one. The runtime carries a search on with the
    families that are left; the smoke must stop instead, since a family
    that fails on the card (a CUDA out-of-memory, a cuBLAS error) is a
    fault of the path. Every phase but [quarantine] runs under it."""
    from transmogrifai_tpu_torch.runtime.context import RuntimeContext
    real = RuntimeContext.quarantine

    def recorded(self, family, reason, kind, *args, **kwargs):
        QUARANTINES.append(f"{family} ({kind}): {reason}")
        return real(self, family, reason, kind, *args, **kwargs)
    QUARANTINES.clear()
    RuntimeContext.quarantine = recorded
    try:
        yield
    finally:
        RuntimeContext.quarantine = real
    check_no_quarantines(where)


def write_out(path, result: dict) -> None:
    """Every measurement as JSON at ``path``, when one is given."""
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1, default=str)


class Laps:
    """Wall seconds of each phase of a run, in order (each lap ends where
    the next begins)."""

    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 1)
        self._t = now
        check_no_quarantines(name)

    def log(self) -> None:
        log(f"[phase-seconds] {json.dumps(self.seconds)}")


@forbid_quarantines()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--k1-only", action="store_true",
                    help="stop after phase 3 and print its JSON last: "
                         "times K1 alone, e.g. in edited copies of a "
                         "checkout run in turns")
    ap.add_argument("--workflow-rows", type=int, default=100_000,
                    help="records of the Titanic workflow phase")
    ap.add_argument("--workflow-only", action="store_true",
                    help="run only the build and the workflow phases "
                         "and print their JSON last")
    ap.add_argument("--cv-rows", type=int, default=25_000,
                    help="records of the workflow-CV phase")
    ap.add_argument("--validate-only", action="store_true",
                    help="run only the build and the feature-validation "
                         "phases ([validate] with its own exact search, "
                         "[workflow-cv], [validate-agree]) and print "
                         "their JSON last")
    ap.add_argument("--problems-only", action="store_true",
                    help="run only the build and the multiclass and "
                         "regression phases ([k1-problems], [iris], "
                         "[boston], [problems-agree]) and print their "
                         "JSON last")
    ap.add_argument("--families-rows", type=int, default=FAMILIES_ROWS,
                    help="records of the family workflow phase")
    ap.add_argument("--families-only", action="store_true",
                    help="run only the build and the feature-family "
                         "phases ([families] with K1 at its shapes, "
                         "[families-agree]) and print their JSON last")
    ap.add_argument("--text-rows", type=int, default=TEXT_ROWS,
                    help="records of the text workflow phase")
    ap.add_argument("--text-only", action="store_true",
                    help="run only the build and the text phases ([text] "
                         "with K1 at its shapes and its serving, "
                         "[text-agree]) and print their JSON last")
    ap.add_argument("--readers-only", action="store_true",
                    help="run only the build and the ingestion and "
                         "explainability phases ([quickstart], [readers], "
                         "[insights] with fixed trees on the event log) "
                         "and print their JSON last")
    ap.add_argument("--models-only", action="store_true",
                    help="run only the build and the model-layer phases "
                         "([host-metric], [mlp], [models-agree]) and print "
                         "their JSON last")
    ap.add_argument("--per-candidate", action="store_true",
                    help="with --models-only: time the host path once more "
                         "candidate by candidate, the loop its batched fits "
                         "replace")
    ap.add_argument("--runtime-only", action="store_true",
                    help="run only the build and the fault-tolerant "
                         "runtime phases ([resume], [heal], [quarantine] "
                         "in a spawned process) and print their JSON last")
    ap.add_argument("--resume-rows", type=int, default=RESUME_ROWS,
                    help="with --runtime-only: records of [resume]")
    ap.add_argument("--agree-witness-rows", type=int, default=None,
                    help="with --workflow-only: run only [wf-agree] at "
                         "this many records with the linear families' "
                         "float64 witness on the card, and print its "
                         "JSON last")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = resolve_device("cuda")
    laps = Laps()
    info = phase_device()
    phase_build()
    laps("device+build")
    if args.runtime_only:
        rt = phase_runtime(device, args.resume_rows)
        laps("11 runtime")
        write_out(args.out, {"device": info, "runtime": rt})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"runtime": rt}, default=str))
        return 0
    if args.text_only:
        txt = phase_text_all(device, args.text_rows)
        laps("9k-9l text")
        write_out(args.out, {"device": info, "text": txt})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"text": txt}, default=str))
        return 0
    if args.models_only:
        mod = phase_models(device, per_candidate=args.per_candidate)
        laps("9p-9r models")
        write_out(args.out, {"device": info, "models": mod})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"models": mod}, default=str))
        return 0
    if args.readers_only:
        ie = phase_ingest_explain(device)
        laps("9m-9o ingest-explain")
        write_out(args.out, {"device": info, "ingest_explain": ie})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"ingest_explain": ie}, default=str))
        return 0
    if args.workflow_only and args.agree_witness_rows:
        witness = phase_workflow_agree(device, args.agree_witness_rows,
                                       witness=True)
        laps("9 wf-agree witness")
        write_out(args.out, {"device": info, "workflow_agree": witness})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"workflow_agree": witness}, default=str))
        return 0
    if args.families_only:
        fam = phase_families_all(device, args.families_rows)
        laps("9i-9j families")
        write_out(args.out, {"device": info, "families": fam})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"families": fam}, default=str))
        return 0
    if args.problems_only:
        problems = phase_problems(device)
        laps("9e-9h problems")
        write_out(args.out, {"device": info, "problems": problems})
        laps.log()
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"problems": problems}, default=str))
        return 0
    if args.validate_only:
        checks = phase_validation(device, args.workflow_rows, args.cv_rows)
        write_out(args.out, {"device": info, **checks})
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps(checks, default=str))
        return 0
    if args.workflow_only:
        wf_run = phase_workflow(device, args.workflow_rows, profile=False)
        wf_run["copies"] = phase_workflow_copies(device)
        serve_saved, serve_compiled = phase_serving(wf_run)
        for t in serve_compiled.get("trees", ()):
            t.pop("_model")
        wf_agree = phase_workflow_agree(device)
        checks = phase_validation(device, args.workflow_rows, args.cv_rows,
                                  exact=exact_of(wf_run))
        write_out(args.out, {"device": info, "workflow": wf_run,
                             "serve_saved": serve_saved,
                             "serve_compiled": serve_compiled,
                             "workflow_agree": wf_agree, **checks})
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(info["smi"])
        print(json.dumps({"workflow": wf_run, "serve_saved": serve_saved,
                          "serve_compiled": serve_compiled,
                          "workflow_agree": wf_agree, **checks},
                         default=str))
        return 0
    X, y = make_data(args.rows, COLS)
    laps("data")
    k1 = phase_k1(device, X)
    k1["forest"] = phase_k1_forest(device, X, y)
    laps("3 k1")
    if args.k1_only:
        write_out(args.out, {"device": info, "k1": k1})
        log(info["smi"])
        print(json.dumps({"k1": k1}))
        return 0
    return _whole_smoke(args, device, info, laps, t_start, X, y, k1)


def _whole_smoke(args, device, info: dict, laps: "Laps", t_start: float,
                 X: np.ndarray, y: np.ndarray, k1: dict) -> int:
    """The whole smoke after phase 3: the timed paths one at a time, then
    the card-against-CPU phases in an ``AgreeWorker``."""
    main_run = phase_main(device, X, y)
    laps("4 main")
    selected = main_run.pop("selected")
    # K1's share of the search: launches at each C times its time there,
    # at each family's shape (the refit at the winner's)
    ms_by_family = {"RandomForestClassifier": k1["forest"]["ms_by_c"],
                    "GBTClassifier": k1["ms_by_c"]}
    k1_s = {}
    for name in TREE_FAMILIES:
        rec = main_run["families"][name]
        ms_by_c, by_c = ms_by_family[name], rec["k1_launches_by_c"]
        if set(by_c) - set(ms_by_c):
            raise AssertionError(f"K1 ran at untimed slot counts "
                                 f"{sorted(by_c)}")
        k1_s[name] = sum(k * ms_by_c[c] for c, k in by_c.items()) / 1e3
        log(f"[main] {name}: K1 time, launches x ms per C: "
            f"{k1_s[name]:.3f} s of {rec['seconds']:.2f} s")
    main_run["k1_seconds_estimate"] = k1_s
    phase_serve(selected, X[-1000:])
    laps("7 serve")
    # the linear products and the search profiles run on the search's
    # own rows
    X_s, y_s = search_rows(X, y)
    linear_ops = phase_linear_ops(device, X_s, y_s)
    lbfgs, svc = phase_lbfgs(device, X, y)
    phase_serve(svc, X[-1000:], tag="serve-svc")
    laps("5 linear")
    # the second main path: the Titanic workflow, its matrix born on the
    # card; K1's counts are zeroed inside, just before its train
    wf_run = phase_workflow(device, args.workflow_rows, profile=False)
    wf_run["copies"] = phase_workflow_copies(device)
    laps("8 workflow")
    # the third and fourth paths: save, reload and serve phase 8's model
    # record by record, then through the compiled plan and the server
    serve_saved, serve_compiled = phase_serving(wf_run)
    # phase 8c's fixed GBT and forest, whose importances [insights] reads
    fixed_trees = [(f"{t['stage']}-8c", t.pop("_model"))
                   for t in serve_compiled["trees"]]
    laps("8b-8c serving")
    # the feature-validation paths: the validated DAG raced at phase 8's
    # size (its exact search is phase 8's), workflow CV, card against CPU
    checks = phase_validation(device, args.workflow_rows, args.cv_rows,
                              exact=exact_of(wf_run), agree=False)
    laps("9b-9c validation")
    # the multiclass and regression paths: Iris and Boston, each counted
    # from zero just before its train
    problems = phase_problems(device, agree=False)
    laps("9e-9g problems")
    # every transmogrify feature family: its workflow, counted from zero
    # just before its train, K1 at its shapes, save, serve, card vs CPU
    fam = phase_families_all(device, args.families_rows, agree=False)
    laps("9i families")
    # the text workflow: Word2Vec and LDA fitted on the card, its search
    # counted from zero just before its train, K1 on the text matrix,
    # save, serve under a default ServeConfig(), card against CPU
    txt = phase_text_all(device, args.text_rows, agree=False)
    laps("9k text")
    # ingestion and explainability: the README's Quick start from a CSV,
    # the keyed event log from Avro files, the insights of both on the
    # card against CPU reloads, phase 8c's trees' importances; each
    # search counted from zero just before its train
    ie = phase_ingest_explain(device, trees=fixed_trees)
    del fixed_trees
    laps("9m-9o ingest-explain")
    # the model layer: a host-metric search (log loss) of every family's
    # batched fits, both validator paths and fold edges on its matrix,
    # then the MLP, the calibrator and an external family
    mod = phase_models(device, agree=False)
    laps("9p-9q models")
    prof = {}
    prof["lr_search"] = phase_fista_profile(device, X_s, y_s)
    gbt, rf = profiled_estimators(device)
    prof["gbt"], gbt_model = phase_profile(
        "depth-6 20-round GBT fit", lambda: gbt.fit_arrays(X, y),
        lambda: tree_loop(gbt, X, y))
    phase_serve(gbt_model, X[-1000:], tag="serve-gbt")
    prof["rf"], forest = phase_profile("depth-6 50-tree RF fit",
                                       lambda: rf.fit_arrays(X, y),
                                       lambda: tree_loop(rf, X, y))
    phase_serve(forest, X[-1000:], tag="serve-rf")
    prof["rf_search"], _ = phase_profile(
        "RF search, depth-12 group (6 points x 3 folds), 5 trees",
        search_slice(device, X_s, y_s))
    clear_design_cache()
    laps("10 profiles")
    # self-healing serving under live traffic, timed alone; the runtime's
    # [resume] and [quarantine] run in the worker below
    runtime = {"heal": phase_heal(device)}
    laps("11b heal")
    # the card-against-CPU phases, after the last timed phase
    torch.cuda.empty_cache()
    worker = AgreeWorker(device)
    try:
        agree = worker.result("phase_card_vs_cpu")
        wf_agree = worker.result("phase_workflow_agree")
        checks["validate_agree"] = worker.result("phase_validate_agree")
        problems["agree"] = {
            **worker.result("phase_problems_agree:iris"),
            **worker.result("phase_problems_agree:boston"),
            **worker.result(f"phase_problems_agree:k{WIDE_K}")}
        fam["agree"] = worker.result("phase_families_agree")
        txt["agree"] = worker.result("phase_text_agree")
        mod["agree"] = worker.result("phase_models_agree")
        runtime["resume"] = worker.result("phase_resume")
        runtime["quarantine"] = worker.result("phase_quarantine")
    finally:
        worker.close()
    laps("6, 9, 9d, 9h, 9j, 9l, 9r agree, 11a resume, 11c quarantine")
    runtime_budget(runtime, in_worker=True)
    validate, wf_cv = checks["validate"], checks["workflow_cv"]
    fam_run = fam["families"]
    cases = k1["cases"] + k1["extra"] + k1["forest"]["cases"] + [
        validate["rung_k1_case"]] + problems["k1"]["cases"] + \
        fam_run["k1"]["cases"] + txt["text"]["k1"]["cases"] + \
        ie["quickstart"]["k1"]["cases"] + ie["readers"]["k1"]["cases"] + \
        mod["host_metric"]["k1"]["cases"] + \
        runtime["quarantine"]["k1"]["cases"]
    worst = max(k1["cases"], key=lambda c: c["C"])
    entry = {"name": "level_hist", "route": "cuda", "source": K1_SOURCE,
             "replaces": K1_REPLACES, "launches": main_run["k1_launches"],
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             "ms": worst["ms"], "plain_ms": worst["plain_ms"],
             "bound_ms": worst["bound_ms"], "bound_by": "bytes",
             "bound_ms_int32_ids": worst["bound_ms_int32_ids"],
             "library_ms": worst["library_ms"], "ok": True,
             "launches_by_c": main_run["k1_launches_by_c"],
             "launches_by_family": {
                 name: rec["k1_launches"]
                 for name, rec in main_run["families"].items()},
             "launches_workflow": wf_run["k1_launches"],
             "launches_workflow_by_c": wf_run["k1_launches_by_c"],
             "launches_workflow_by_family": {
                 name: rec["k1_launches"]
                 for name, rec in wf_run["families"].items()},
             "launches_serve_saved": serve_saved["k1_launches"],
             "launches_serve_compiled": serve_compiled["k1_launches"],
             "launches_validate": validate["k1_launches"],
             "launches_validate_by_c": validate["k1_launches_by_c"],
             "launches_validate_by_family": {
                 name: rec["k1_launches"]
                 for name, rec in validate["families"].items()},
             "launches_workflow_cv": wf_cv["k1_launches"],
             "launches_workflow_cv_by_c": wf_cv["k1_launches_by_c"],
             "launches_workflow_cv_by_family": {
                 name: rec["k1_launches"]
                 for name, rec in wf_cv["families"].items()},
             "cases": cases}
    entry["launches_families"] = fam_run["k1_launches"]
    entry["launches_families_by_c"] = fam_run["k1_launches_by_c"]
    entry["launches_families_by_family"] = dict(
        {name: rec["k1_launches"]
         for name, rec in fam_run["families"].items()},
        DecisionTreeNumericBucketizer=fam_run["bucketizer"]["k1_launches"])
    entry["launches_families_serve"] = fam_run["serve"]["k1_launches"]
    txt_run = txt["text"]
    entry["launches_text"] = txt_run["k1_launches"]
    entry["launches_text_by_c"] = txt_run["k1_launches_by_c"]
    entry["launches_text_by_family"] = {
        name: rec["k1_launches"]
        for name, rec in txt_run["families"].items()}
    entry["launches_text_serve"] = txt_run["serve"]["k1_launches"]
    for tag in ("quickstart", "readers"):
        run = ie[tag]
        entry[f"launches_{tag}"] = run["k1_launches"]
        entry[f"launches_{tag}_by_c"] = run["k1_launches_by_c"]
        entry[f"launches_{tag}_by_family"] = {
            name: rec.get("k1_launches", 0)
            for name, rec in run["families"].items()}
    entry["launches_insights"] = ie["insights"]["k1_launches"]
    hm = mod["host_metric"]
    entry["launches_host_metric"] = hm["k1_launches"]
    entry["launches_host_metric_by_c"] = hm["k1_launches_by_c"]
    entry["launches_host_metric_by_family"] = {
        name: rec.get("k1_launches", 0)
        for name, rec in hm["families"].items()}
    entry["launches_host_metric_device_vs_host_by_family"] = {
        name: rec.get("k1_launches", 0) for name, rec in
        hm["device_vs_host"]["host_families"].items()}
    entry["launches_fold_edges"] = hm["fold_edges"]["k1_launches"]
    entry["launches_fold_edges_by_c"] = hm["fold_edges"]["k1_launches_by_c"]
    entry["launches_mlp"] = mod["mlp"]["k1_launches"]
    res = runtime["resume"]
    entry["launches_resume"] = res["k1_launches"]
    for v in ("exact", "racing"):
        entry[f"launches_resume_{v}_by_family"] = {
            "run_a": res[v]["run_a_k1_by_family"],
            "resumed": res[v]["resume_k1_by_family"]}
    entry["launches_heal"] = runtime["heal"]["k1_launches"]
    entry["launches_heal_by_c"] = runtime["heal"]["k1_launches_by_c"]
    for tag in ("iris", "boston"):
        run = problems[tag]
        entry[f"launches_{tag}"] = run["k1_launches"]
        entry[f"launches_{tag}_by_c"] = run["k1_launches_by_c"]
        entry[f"launches_{tag}_by_family"] = {
            name: rec.get("k1_launches", 0)
            for name, rec in run["families"].items()}
    write_out(args.out, {"device": info, "k1": k1, "main": main_run,
                         "linear_ops": linear_ops, "lbfgs": lbfgs,
                         "agree": agree, "workflow": wf_run,
                         "serve_saved": serve_saved,
                         "serve_compiled": serve_compiled,
                         "workflow_agree": wf_agree, **checks,
                         "problems": problems, "families": fam,
                         "text": txt, "ingest_explain": ie,
                         "models": mod, "runtime": runtime,
                         "profile": prof,
                         "phase_seconds": laps.seconds,
                         "seconds": time.perf_counter() - t_start})
    laps.log()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(info["smi"])
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
