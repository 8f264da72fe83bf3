"""The text stages of the PyTorch port against the JAX package's, on the
same seeded inputs (CPU, float64):

- language detection (script routing, n-gram profiles) and name-entity
  tagging over the text example's bodies and hand-written sentences:
  equal;
- the derived-value stages (phone, e-mail, URL, MIME type, language, text
  length, n-gram and Jaccard similarity, occurrence, index dropping, the
  collection lift), the name-entity recognizer and the index stages
  (``StringIndexer``, ``IndexToString``, ``PredictionDeIndexer``): equal
  outputs, host passes in both packages;
- ``CountVectorizer`` and ``TfIdfVectorizer``: equal vocabularies, values
  and metadata; ``Word2Vec`` from the same seed: vectors and document means
  within 1e-9 (the same SGD steps in float64, summed in another order);
  ``LDA``: topic-word matrix and document mixtures within 1e-8 (400
  fixed-point iterations with digamma in float64);
- the JAX package's fitted text stages carried across by
  ``models.convert.from_jax_model`` and loaded from its saved stage JSON
  transform as the JAX stages do;
- the estimators and the example default to the card and raise without
  one."""
import base64

import numpy as np
import pytest
import torch

import transmogrifai_tpu.ops as jops
import transmogrifai_tpu.types as jtypes
from transmogrifai_tpu.features.builder import FeatureBuilder as JaxBuilder
from transmogrifai_tpu.features.columns import FeatureColumn as JaxColumn
from transmogrifai_tpu.features.columns import (
    PredictionColumn as JaxPredictionColumn)
from transmogrifai_tpu.utils import text_lang as jlang
from transmogrifai_tpu.utils import text_ner as jner
from transmogrifai_tpu.workflow import persistence as jax_persistence
import transmogrifai_tpu_torch.ops as tops
import transmogrifai_tpu_torch.types as ttypes
from transmogrifai_tpu_torch.examples import text
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.features.columns import FeatureColumn
from transmogrifai_tpu_torch.features.columns import PredictionColumn
from transmogrifai_tpu_torch.models.convert import from_jax_model
from transmogrifai_tpu_torch.utils import text_lang, text_ner
from transmogrifai_tpu_torch.workflow.persistence import stage_from_json

#: Word2Vec's vectors and document means: the same float64 SGD steps from
#: the same draws, the gradient scatter-adds summed in another order
W2V_TOL = 1e-9
#: LDA's topic-word matrix and document mixtures: 20 x 20 E-step and 20
#: M-step iterations with digamma, products summed in another order
LDA_TOL = 1e-8

SENTENCES = [
    "Dr. Alice Smith of Acme Corp met John in Paris on Monday at 10:30am.",
    "The University of Chicago paid $1,200 for 15% of the shares in 2019.",
    "Mary said that Olivia would fly to Tokyo with Mr. Brown next March.",
    "el perro y el gato están en el jardín de la casa con María.",
    "der schnelle braune fuchs springt über den faulen hund in Berlin.",
    "быстрая коричневая лиса прыгает через ленивую собаку.",
    "我们在北京的大学学习中文。", "東京で日本語を勉強しています。",
    "안녕하세요 반갑습니다", "Γεια σου κόσμε", "", None, "12345 ...",
]


@pytest.fixture(scope="module")
def corpus():
    recs = text.synthetic_text(160, seed=5)
    bodies = [r["body"] for r in recs] + SENTENCES
    return {"records": recs, "bodies": bodies,
            "tokens": [None if b is None else list(tops.tokenize(b))
                       for b in bodies]}


def _features(name, jtype, ttype):
    return (JaxBuilder.of(name, jtype).extract(
        lambda r: r.get(name)).as_predictor(),
        FeatureBuilder.of(name, ttype).extract(
            lambda r: r.get(name)).as_predictor())


def _cols(values, jtype, ttype):
    return (JaxColumn.from_values(jtype, list(values)),
            FeatureColumn.from_values(ttype, list(values)))


def _values(col):
    data = col.data
    if isinstance(data, torch.Tensor):
        data = data.numpy()
    return [None if (isinstance(v, float) and np.isnan(v)) else v
            for v in (data.tolist() if isinstance(data, np.ndarray)
                      else list(data))]


def _same_transform(jstage, tstage, inputs):
    """Wire both stages to ``inputs`` ((name, jax type, port type,
    values) each) and compare their ``transform_columns`` outputs."""
    jf, tf, jc, tc = [], [], [], []
    for name, jt, tt, values in inputs:
        a, b = _features(name, jt, tt)
        jf.append(a)
        tf.append(b)
        ca, cb = _cols(values, jt, tt)
        jc.append(ca)
        tc.append(cb)
    jstage.set_input(*jf)
    tstage.set_input(*tf)
    want = jstage.transform_columns(jc)
    got = tstage.transform_columns(tc)
    assert got.ftype.__name__ == want.ftype.__name__
    assert _values(got) == _values(want)
    return got


def test_language_detection_matches_jax(corpus):
    for b in corpus["bodies"]:
        assert text_lang.detect_language(b) == jlang.detect_language(b)
        if b:
            assert text_lang.dominant_script(b) == jlang.dominant_script(b)
            assert text_lang.ngram_profile(b) == jlang.ngram_profile(b)
    langs = {text_lang.detect_language(b)[0] for b in corpus["bodies"]}
    assert {"ru", "zh", "ja", "ko", "el", "es", "de"} <= langs
    doc, prof = (text_lang.ngram_profile(SENTENCES[0]),
                 text_lang._PROFILES["en"])
    assert text_lang.profile_distance(doc, prof) == \
        jlang.profile_distance(doc, prof)


def test_name_entity_tagging_matches_jax(corpus):
    tagger, ref = text_ner.HeuristicNameEntityTagger(), \
        jner.HeuristicNameEntityTagger()
    tagged = 0
    for b in corpus["bodies"]:
        sents = text_ner.split_sentences(b)
        assert sents == jner.split_sentences(b)
        for s in sents:
            got = tagger.tag(s)
            assert got == ref.tag(s)
            tagged += bool(got)
    assert tagged > 50
    assert text_ner.NameEntityType.values == jner.NameEntityType.values


def test_name_entity_recognizer_matches_jax(corpus):
    got = _same_transform(
        jops.NameEntityRecognizer(), tops.NameEntityRecognizer(),
        [("body", jtypes.Text, ttypes.Text, corpus["bodies"])])
    assert got.ftype is ttypes.MultiPickListMap
    assert any(v for v in _values(got))


def _phones(rng, n):
    return [None if i % 9 == 0 else
            "".join(str(d) for d in rng.integers(0, 10, rng.integers(5, 17)))
            for i in range(n)]


B64 = [base64.b64encode(b).decode() for b in (
    b"%PDF-1.4 body", b"\x89PNG\r\n", b"\xff\xd8\xff\xe0", b"GIF89a",
    b"PK\x03\x04", b"\x1f\x8b\x08", b"<?xml version", b"{\"a\": 1}",
    b"plain words", b"\xfe\xfe\x00\xff")] + [None, "!!notbase64"]


@pytest.mark.parametrize("stage,inputs", [
    ("PhoneNumberParser", "phone"), ("EmailToPickList", "email"),
    ("EmailToPickList-prefix", "email"), ("UrlToPickList", "url"),
    ("UrlToPickList-protocol", "url"), ("MimeTypeDetector", "b64"),
    ("LangDetector", "body"), ("TextLenTransformer", "body"),
    ("NGramSimilarity", "title-body"), ("JaccardSimilarity", "sets"),
    ("ToOccurTransformer", "email"),
])
def test_derived_stages_match_jax(corpus, stage, inputs):
    recs = corpus["records"]
    rng = np.random.default_rng(7)
    cols = {
        "phone": ("phone", jtypes.Phone, ttypes.Phone,
                  [r["phone"] for r in recs] + _phones(rng, 40)),
        "email": ("email", jtypes.Email, ttypes.Email,
                  [r["email"] for r in recs] + ["bad", "a@b", None]),
        "url": ("url", jtypes.URL, ttypes.URL,
                [r["url"] for r in recs] + ["ftp://x.org/a", "nourl", None]),
        "b64": ("b64", jtypes.Base64, ttypes.Base64, B64),
        "body": ("body", jtypes.Text, ttypes.Text, corpus["bodies"]),
    }
    name, _, part = stage.partition("-")
    kw = {"part": part} if part else {}
    if inputs == "title-body":
        titles = [r["title"] for r in recs] + SENTENCES[::-1]
        ins = [("title", jtypes.Text, ttypes.Text, titles), cols["body"]]
    elif inputs == "sets":
        a = [set(rng.choice(list("abcdef"), rng.integers(0, 4)))
             for _ in range(60)]
        b = [set(rng.choice(list("abcdef"), rng.integers(0, 4)))
             for _ in range(60)]
        ins = [("s1", jtypes.MultiPickList, ttypes.MultiPickList, a),
               ("s2", jtypes.MultiPickList, ttypes.MultiPickList, b)]
    else:
        ins = [cols[inputs]]
    got = _same_transform(getattr(jops, name)(**kw),
                          getattr(tops, name)(**kw), ins)
    assert len(set(map(str, _values(got)))) > 1


def test_collection_and_drop_indices_match_jax(corpus):
    rng = np.random.default_rng(3)
    maps = [{k: "".join(rng.choice(list("xyz"), rng.integers(0, 6)))
             for k in rng.choice(list("pqr"), rng.integers(0, 3))}
            for _ in range(40)]
    got = _same_transform(
        jops.CollectionTransformer(jops.TextLenTransformer(),
                                   output_type=jtypes.IntegralMap),
        tops.CollectionTransformer(tops.TextLenTransformer(),
                                   output_type=ttypes.IntegralMap),
        [("m", jtypes.TextMap, ttypes.TextMap, maps)])
    assert got.ftype is ttypes.IntegralMap
    # DropIndicesBy over a count vector: drop the two commonest terms
    jf, tf = _features("toks", jtypes.TextList, ttypes.TextList)
    jc, tc = _cols(corpus["tokens"], jtypes.TextList, ttypes.TextList)
    jm = jops.CountVectorizer().set_input(jf)
    tm = tops.CountVectorizer().set_input(tf)
    jv, tv = jm.fit_columns([jc]), tm.fit_columns([tc])
    jv.set_input(jf)
    tv.set_input(tf)
    drop = set(tv.vocabulary[0][:2])
    jd = jops.DropIndicesByTransformer(
        match_fn=lambda c: c.indicator_value in drop).set_input(
        jv.get_output())
    td = tops.DropIndicesByTransformer(
        match_fn=lambda c: c.indicator_value in drop).set_input(
        tv.get_output())
    a = jd.transform_columns([jv.transform_columns([jc])])
    b = td.transform_columns([tv.transform_columns([tc])])
    np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
    assert b.data.shape[1] == len(tv.vocabulary[0]) - 2
    assert [c.indicator_value for c in b.metadata.columns] == \
        [c.indicator_value for c in a.metadata.columns]


def test_index_stages_match_jax(corpus):
    recs = corpus["records"]
    cats = [r["category"] for r in recs] + [None, "cat00"]
    jf, tf = _features("category", jtypes.Text, ttypes.Text)
    jc, tc = _cols(cats, jtypes.Text, ttypes.Text)
    jm = jops.StringIndexer().set_input(jf).fit_columns([jc])
    tm = tops.StringIndexer().set_input(tf).fit_columns([tc])
    assert tm.labels == jm.labels and len(tm.labels) == text.CATEGORIES
    jm.set_input(jf)
    tm.set_input(tf)
    unseen = ["cat07", "nope", None]
    for values in (cats, unseen):
        a, b = _cols(values, jtypes.Text, ttypes.Text)
        np.testing.assert_array_equal(tm.transform_columns([b]).data,
                                      jm.transform_columns([a]).data)
    strict = tops.StringIndexer(handle_invalid="error").set_input(
        tf).fit_columns([tc])
    strict.set_input(tf)
    with pytest.raises(ValueError, match="Unseen"):
        strict.transform_columns([_cols(unseen, jtypes.Text,
                                        ttypes.Text)[1]])
    idx = list(np.arange(-1, len(tm.labels) + 2, dtype=float))
    _same_transform(jops.IndexToString(labels=jm.labels),
                    tops.IndexToString(labels=tm.labels),
                    [("i", jtypes.RealNN, ttypes.RealNN, idx)])
    # the de-indexer reads the labels through the indexed response
    jl = jm.set_input(jf).get_output()
    tl = tm.set_input(tf).get_output()
    preds = np.array(idx)
    jp = JaxPredictionColumn.from_arrays(preds)
    tp = PredictionColumn.from_arrays(preds)
    jpred = JaxBuilder.of("pred", jtypes.Prediction).extract(
        lambda r: None).as_predictor()
    tpred = FeatureBuilder.of("pred", ttypes.Prediction).extract(
        lambda r: None).as_predictor()
    jd = jops.PredictionDeIndexer().set_input(jl, jpred)
    td = tops.PredictionDeIndexer().set_input(tl, tpred)
    want = jd.transform_columns([jm.transform_columns([jc]), jp])
    got = td.transform_columns([tm.transform_columns([tc]), tp])
    assert list(got.data) == list(want.data)


def _fit_pair(name, corpus, **kw):
    jf, tf = _features("toks", jtypes.TextList, ttypes.TextList)
    jc, tc = _cols(corpus["tokens"], jtypes.TextList, ttypes.TextList)
    dev = {"device": "cpu"} if name in ("Word2Vec", "LDA") else {}
    je = getattr(jops, name)(**kw).set_input(jf)
    te = getattr(tops, name)(**kw, **dev).set_input(tf)
    jm, tm = je.fit_columns([jc]), te.fit_columns([tc])
    jm.set_input(jf)
    tm.set_input(tf)
    return jm, tm, jm.transform_columns([jc]), tm.transform_columns([tc])


def _metas(col):
    return [(c.parent_feature_name, c.parent_feature_type, c.grouping,
             c.indicator_value, c.descriptor_value)
            for c in col.metadata.columns]


@pytest.mark.parametrize("name,kw", [
    ("CountVectorizer", {}), ("CountVectorizer", {"binary": True,
                                                  "min_df": 2}),
    ("TfIdfVectorizer", {}), ("TfIdfVectorizer", {"max_vocab": 50}),
], ids=["count", "count-binary", "tfidf", "tfidf-50"])
def test_count_vectorizers_match_jax(corpus, name, kw):
    jm, tm, want, got = _fit_pair(name, corpus, **kw)
    assert tm.vocabulary == jm.vocabulary
    if name == "TfIdfVectorizer":
        assert tm.idf == jm.idf
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))
    assert _metas(got) == _metas(want)


def test_word2vec_matches_jax(corpus):
    jm, tm, want, got = _fit_pair("Word2Vec", corpus, vector_size=16,
                                  epochs=2)
    assert tm.vocabulary == jm.vocabulary and len(tm.vocabulary) > 100
    np.testing.assert_allclose(tm.vectors, np.asarray(jm.vectors),
                               rtol=0, atol=W2V_TOL)
    np.testing.assert_allclose(np.asarray(got.data),
                               np.asarray(want.data), rtol=0, atol=W2V_TOL)
    assert _metas(got) == _metas(want)
    assert np.abs(tm.vectors).max() > 1e-3          # training moved them


def test_lda_matches_jax(corpus):
    jm, tm, want, got = _fit_pair("LDA", corpus, k=5, max_iter=10)
    assert tm.vocabulary == jm.vocabulary
    np.testing.assert_allclose(tm.topic_word, np.asarray(jm.topic_word),
                               rtol=0, atol=LDA_TOL)
    a, b = np.asarray(want.data), np.asarray(got.data)
    np.testing.assert_allclose(b, a, rtol=0, atol=LDA_TOL)
    np.testing.assert_allclose(b.sum(axis=1), 1.0, atol=1e-12)
    assert _metas(got) == _metas(want)
    assert tm.device.type == "cpu"


@pytest.mark.parametrize("name,kw", [
    ("Word2Vec", {"vector_size": 8, "epochs": 1}), ("LDA", {"k": 3,
                                                           "max_iter": 3}),
    ("CountVectorizer", {}), ("TfIdfVectorizer", {}),
])
def test_jax_stages_carry_across(corpus, name, kw, tmp_path):
    """The JAX package's fitted stage, converted and loaded from its
    saved JSON, transforms as the JAX stage does."""
    jm, _, want, _ = _fit_pair(name, corpus, **kw)
    tf = _features("toks", jtypes.TextList, ttypes.TextList)[1]
    tc = _cols(corpus["tokens"], jtypes.TextList, ttypes.TextList)[1]
    arrays = {}
    doc = jax_persistence.stage_to_json(jm, arrays)
    for stage in (from_jax_model(jm, device="cpu"),
                  stage_from_json(doc, arrays, "cpu")):
        assert stage.uid == jm.uid
        stage.set_input(tf)
        got = stage.transform_columns([tc])
        np.testing.assert_allclose(np.asarray(got.data),
                                   np.asarray(want.data), rtol=0,
                                   atol=1e-12)


def test_string_indexer_carries_across(corpus):
    jf, tf = _features("category", jtypes.Text, ttypes.Text)
    values = [r["category"] for r in corpus["records"]] + ["new"]
    jc, tc = _cols(values, jtypes.Text, ttypes.Text)
    jm = jops.StringIndexer().set_input(jf).fit_columns([jc])
    jm.set_input(jf)
    arrays = {}
    doc = jax_persistence.stage_to_json(jm, arrays)
    for stage in (from_jax_model(jm), stage_from_json(doc, arrays, "cpu")):
        stage.set_input(tf)
        np.testing.assert_array_equal(stage.transform_columns([tc]).data,
                                      jm.transform_columns([jc]).data)


@pytest.mark.parametrize("entry", [
    lambda: tops.Word2Vec().fit_columns([FeatureColumn.from_values(
        ttypes.TextList, [("a", "b", "a", "b")])]),
    lambda: tops.LDA().fit_columns([FeatureColumn.from_values(
        ttypes.TextList, [("a", "b")])]),
    lambda: tops.LDAModel(["a"], np.ones((1, 1)), 0.1),
    lambda: text.default_selector(),
    lambda: text.run(text.synthetic_text(40)),
])
def test_text_entries_need_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
