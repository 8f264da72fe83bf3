"""A text workflow on the PyTorch port: the reference's text pillars in one
binary workflow.

Every stage is one of the JAX package's, at its default parameters:

- ``body.tokenize()`` into ``TfIdfVectorizer()`` (min_df 1, max_vocab
  10,000), ``Word2Vec()`` (32 dimensions, min_count 2, 5 epochs; its SGD
  on the workflow's device) and ``.lda()`` (k = 10; its E- and M-steps in
  float64 on the workflow's device);
- ``body`` into ``LangDetector``, ``TextLenTransformer`` and
  ``NameEntityRecognizer``;
- ``NGramSimilarity(title, body)``, ``EmailToPickList``,
  ``UrlToPickList``, ``PhoneNumberParser`` and ``StringIndexer`` on
  ``category``;

all through ``transmogrify`` to the default binary selector (the whole
default pool under 3-fold stratified CV, as Titanic's) on a stratified 75 %
split, the 25 % holdout scored through
``Evaluators.BinaryClassification.au_pr()``, ``LogLossEvaluator`` and
``BinScoreEvaluator``. About 2,300 columns, most of them TF-IDF's.

The records (``synthetic_text``) are drawn with numpy from a seed: bodies
of 10-40 tokens from a vocabulary of 2,000 lower-case words (Zipf weights
under two topic mixtures), about 5 % of them in a non-Latin script
(Cyrillic or Han), with capitalised given names from the name-entity
tagger's gazetteer; a short title from the body's own words; the testkit's
e-mails, URLs and phone numbers; a ``category`` of 20 values; and a binary
label drawn from the document's topic share plus noise.

Run:  python -m transmogrifai_tpu_torch.examples.text [--rows N]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, NamedTuple, Optional

import numpy as np

from ..evaluators import (BinScoreEvaluator, BinScoreMetrics, Evaluators,
                          LogLossEvaluator, LogLossMetrics)
from ..evaluators.base import EvaluationMetrics
from ..features.builder import FeatureBuilder
from ..features.columns import Dataset
from ..features.feature import Feature
from ..ops import (EmailToPickList, LangDetector, NameEntityRecognizer,
                   NGramSimilarity, PhoneNumberParser, StringIndexer,
                   TextLenTransformer, TfIdfVectorizer, UrlToPickList,
                   Word2Vec, transmogrify)
from ..selector import BinaryClassificationModelSelector
from ..testkit import RandomData, RandomText
from ..types import URL, Email, Phone, RealNN, Text
from ..utils.text_ner import _GIVEN_NAMES
from ..workflow import Workflow, WorkflowModel
from .titanic import stratified_split

__all__ = ["synthetic_text", "build_features", "default_selector", "run",
           "TextRun", "SEED", "VOCABULARY", "CATEGORIES"]

SEED = 11
#: lower-case words of the Latin vocabulary
VOCABULARY = 2000
#: values of the ``category`` column
CATEGORIES = 20
#: share of bodies in a non-Latin script, and the size of each script's
#: vocabulary
NON_LATIN = 0.05
NON_LATIN_WORDS = 60
#: share of bodies that carry a capitalised given name, and every how
#: many'th name of the tagger's gazetteer (sorted) the bodies draw from
NAMED = 0.6
NAME_STRIDE = 6
#: standard deviation of the label's noise on the topic share
LABEL_NOISE = 0.2

_CYRILLIC = "абвгдежзийклмнопрстуфхцчшщыэюя"
_HAN = "的一是不了人我在有他这中大来上国个到说们为子和你地出道也时年"


def _words(rng, n: int, alphabet: str, lo: int, hi: int) -> List[str]:
    """``n`` distinct words of ``lo``-``hi`` letters of ``alphabet``."""
    letters = np.array(list(alphabet))
    out: dict = {}
    while len(out) < n:
        w = "".join(rng.choice(letters, int(rng.integers(lo, hi + 1))))
        out.setdefault(w, None)
    return list(out)


def synthetic_text(n: int, seed: int = SEED) -> List[dict]:
    """``n`` text records (see the module docstring), drawn in bulk with
    numpy from ``seed`` and the testkit's generators."""
    rng = np.random.default_rng(seed)
    vocab = np.array(_words(rng, VOCABULARY, "abcdefghijklmnopqrstuvwxyz",
                            3, 8))
    zipf = 1.0 / np.arange(1, VOCABULARY + 1) ** 1.07
    zipf /= zipf.sum()
    topics = [np.empty(VOCABULARY), np.empty(VOCABULARY)]
    for t in topics:
        t[rng.permutation(VOCABULARY)] = zipf
    other = [np.array(_words(rng, NON_LATIN_WORDS, _CYRILLIC, 3, 7)),
             np.array(_words(rng, NON_LATIN_WORDS, _HAN, 2, 2))]
    names = sorted(_GIVEN_NAMES)[::NAME_STRIDE]
    lengths = rng.integers(10, 41, n)
    share = rng.beta(2.0, 2.0, n)              # topic A's share of a body
    total = int(lengths.sum())
    doc_of = np.repeat(np.arange(n), lengths)
    pick_a = rng.random(total) < share[doc_of]
    words = np.where(pick_a, rng.choice(VOCABULARY, total, p=topics[0]),
                     rng.choice(VOCABULARY, total, p=topics[1]))
    script = np.where(rng.random(n) < NON_LATIN,
                      rng.integers(1, 3, n), 0)  # 0 Latin, 1 Cyrillic, 2 Han
    other_words = rng.integers(0, NON_LATIN_WORDS, total)
    named = rng.random(n) < NAMED
    name_at = rng.random(n)
    name_of = rng.integers(0, len(names), n)
    stops = rng.integers(8, 13, n)             # tokens per sentence
    title_len = rng.integers(3, 7, n)
    label = (share + LABEL_NOISE * rng.normal(size=n) > 0.5).astype(float)
    category = rng.integers(0, CATEGORIES, n)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])

    data = RandomData(seed=seed)
    data.with_column("email", RandomText.emails(seed=seed + 1)
                     .with_probability_of_empty(0.1))
    data.with_column("url", RandomText.urls(seed=seed + 2)
                     .with_probability_of_empty(0.1))
    data.with_column("phone", RandomText.phones(seed=seed + 3)
                     .with_probability_of_empty(0.1))
    records = data.records(n)
    for i, r in enumerate(records):
        lo, hi = starts[i], starts[i] + lengths[i]
        toks = (list(vocab[words[lo:hi]]) if script[i] == 0
                else list(other[script[i] - 1][other_words[lo:hi]]))
        title = " ".join(toks[:title_len[i]])
        if named[i]:
            toks.insert(int(name_at[i] * len(toks)),
                        names[name_of[i]].capitalize())
        sentences = [" ".join(toks[j:j + stops[i]])
                     for j in range(0, len(toks), stops[i])]
        r["body"] = ". ".join(sentences) + "."
        r["title"] = title
        r["category"] = f"cat{category[i]:02d}"
        r["label"] = float(label[i])
    return records


def build_features():
    """(label, the combined feature vector) of the text DAG."""
    def raw(name, ftype):
        return FeatureBuilder.of(name, ftype).extract(
            lambda r, k=name: r.get(k)).as_predictor()

    body, title = raw("body", Text), raw("title", Text)
    email, url, phone = raw("email", Email), raw("url", URL), \
        raw("phone", Phone)
    category = raw("category", Text)
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    tokens = body.tokenize()
    derived = [
        TfIdfVectorizer().set_input(tokens).get_output(),
        Word2Vec().set_input(tokens).get_output(),
        tokens.lda(),
        LangDetector().set_input(body).get_output(),
        TextLenTransformer().set_input(body).get_output(),
        NameEntityRecognizer().set_input(body).get_output(),
        NGramSimilarity().set_input(title, body).get_output(),
        EmailToPickList().set_input(email).get_output(),
        UrlToPickList().set_input(url).get_output(),
        PhoneNumberParser().set_input(phone).get_output(),
        StringIndexer().set_input(category).get_output(),
    ]
    return label, transmogrify(derived)


def default_selector(device="cuda", seed: int = 42, models=None):
    """The default binary selector: the whole default pool (or
    ``models``) under 3-fold stratified CV, on ``device``."""
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=seed, stratify=True, models=models,
        device=device)


class TextRun(NamedTuple):
    #: the holdout's binary metrics (through the AuPR evaluator)
    metrics: EvaluationMetrics
    log_loss: LogLossMetrics
    bin_score: BinScoreMetrics
    #: wall seconds of train, score and evaluation
    seconds: float
    model: WorkflowModel
    workflow: Workflow
    vector: Feature
    prediction: Feature
    scored: Dataset
    #: the 25 % holdout's records
    holdout: List[dict]


def run(records, device="cuda", model_stage=None, listener=None,
        verbose: bool = False) -> TextRun:
    """Train on a stratified 75 % split of ``records`` on ``device``,
    score the 25 % holdout and evaluate it for AuPR (and the other binary
    metrics), log loss and calibration bins. ``model_stage`` replaces the
    default selector (it must compute on ``device``); ``listener``
    collects the per-stage profile."""
    train, test = stratified_split(records, label_key="label")
    label, vector = build_features()
    stage = model_stage if model_stage is not None \
        else default_selector(device)
    prediction = stage.set_input(label, vector).get_output()
    t0 = time.perf_counter()
    wf = (Workflow(device=device).set_result_features(label, prediction)
          .set_input_records(train))
    if listener is not None:
        wf = wf.with_listener(listener)
    model = wf.train()
    scored, metrics = model.score_and_evaluate(
        test, Evaluators.BinaryClassification.au_pr(
            label_col="label", prediction_col=prediction.name))
    log_loss = LogLossEvaluator(
        label_col="label", prediction_col=prediction.name
    ).evaluate_all(scored)
    bin_score = BinScoreEvaluator(
        label_col="label", prediction_col=prediction.name
    ).evaluate_all(scored)
    elapsed = time.perf_counter() - t0
    if verbose:
        width = model.train_dataset[vector.name].data.shape[1]
        print(f"Train rows: {len(train)}, holdout rows: {len(test)}, "
              f"columns: {width}")
        print(f"Holdout AuPR:   {metrics.AuPR:.4f}")
        print(f"Holdout AuROC:  {metrics.AuROC:.4f}")
        print(f"Holdout LogLoss: {log_loss.LogLoss:.4f}")
        print(f"Holdout Brier:  {bin_score.BrierScore:.4f}")
        print(f"Wall clock: {elapsed:.2f}s")
    return TextRun(metrics, log_loss, bin_score, elapsed, model, wf,
                   vector, prediction, scored, test)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(synthetic_text(args.rows, args.seed), device=args.device,
                 verbose=True)
    from ..local import load_score_function
    path = os.path.join(tempfile.mkdtemp(prefix="text_"), "model")
    result.model.save(path)
    served = load_score_function(path, device=args.device)(
        dict(result.holdout[0]))
    print(f"saved -> {path}; served one record: "
          f"P(label)={served[result.prediction.name]['probability_1']:.3f}")


if __name__ == "__main__":
    main()
