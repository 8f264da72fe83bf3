"""The port's testkit against the JAX package's: from the same seeds every
generator gives the same values, value for value and type for type, and
``RandomData`` the same records, so ``chip_smoke.py`` (which imports no
JAX) drives the same data as the JAX tests; the contract battery of
``StageSpecBase`` runs on a ported stage."""
import numpy as np
import pytest

import transmogrifai_tpu.testkit as jk
import transmogrifai_tpu.types as jt
import transmogrifai_tpu_torch.testkit as tk
import transmogrifai_tpu_torch.types as tt
from transmogrifai_tpu_torch.examples import families
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.columns import Dataset, FeatureColumn
from transmogrifai_tpu_torch.ops import DateToUnitCircleVectorizer

N = 200

#: (id, generator factory taking (testkit module, types module))
GENERATORS = [
    ("real-uniform", lambda k, t: k.RandomReal.uniform(-1, 3, seed=1)),
    ("real-normal", lambda k, t: k.RandomReal.normal(0, 2, seed=2)
     .with_probability_of_empty(0.2)),
    ("real-poisson", lambda k, t: k.RandomReal.poisson(3.0, seed=3)),
    ("real-exponential", lambda k, t: k.RandomReal.exponential(2.0, seed=4)),
    ("real-gamma", lambda k, t: k.RandomReal.gamma(2.0, 1.5, seed=5)),
    ("real-lognormal", lambda k, t: k.RandomReal.lognormal(0, 0.5, seed=6)),
    ("real-weibull", lambda k, t: k.RandomReal.weibull(1.5, 2.0, seed=7)),
    ("realnn", lambda k, t: k.RandomReal.uniform(0, 1, ftype=t.RealNN,
                                                 seed=8)),
    ("integral", lambda k, t: k.RandomIntegral.integers(0, 50, seed=9)
     .with_probability_of_empty(0.15)),
    ("dates", lambda k, t: k.RandomIntegral.dates(seed=10)
     .with_probability_of_empty(0.2)),
    ("datetimes", lambda k, t: k.RandomIntegral.datetimes(seed=11)),
    ("binary", lambda k, t: k.RandomBinary(0.4, seed=12)
     .with_probability_of_empty(0.1)),
    ("strings", lambda k, t: k.RandomText.strings(seed=13)
     .with_probability_of_empty(0.1)),
    ("textareas", lambda k, t: k.RandomText.textareas(seed=14)),
    ("emails", lambda k, t: k.RandomText.emails(seed=15)),
    ("emails-domain", lambda k, t: k.RandomText.emails("x.org", seed=16)),
    ("urls", lambda k, t: k.RandomText.urls(seed=17)),
    ("phones", lambda k, t: k.RandomText.phones(seed=18)),
    ("ids", lambda k, t: k.RandomText.ids(seed=19)),
    ("countries", lambda k, t: k.RandomText.countries(seed=20)),
    ("states", lambda k, t: k.RandomText.states(seed=21)),
    ("cities", lambda k, t: k.RandomText.cities(seed=22)),
    ("streets", lambda k, t: k.RandomText.streets(seed=23)),
    ("postal-codes", lambda k, t: k.RandomText.postal_codes(seed=24)),
    ("picklists", lambda k, t: k.RandomText.picklists(["a", "b", "c"],
                                                      seed=25)),
    ("comboboxes", lambda k, t: k.RandomText.comboboxes(["u", "v"],
                                                        seed=26)),
    ("text-list", lambda k, t: k.RandomList(k.RandomText.strings(seed=27),
                                            seed=28)),
    ("date-list", lambda k, t: k.RandomList(
        k.RandomIntegral.dates(seed=29), min_size=1, max_size=3,
        ftype=t.DateList, seed=30).with_probability_of_empty(0.3)),
    ("set", lambda k, t: k.RandomSet(["x", "y", "z", "w"], seed=31)
     .with_probability_of_empty(0.2)),
    ("numeric-map", lambda k, t: k.RandomMap(
        k.RandomReal.uniform(0, 5, seed=32), t.NumericMap, min_size=1,
        max_size=3, seed=33).with_probability_of_empty(0.2)),
    ("picklist-map", lambda k, t: k.RandomMap(
        k.RandomText.picklists(["p", "q"], seed=34), t.PickListMap,
        key_prefix="key", seed=35)),
    ("set-map", lambda k, t: k.RandomMap(
        k.RandomSet(["m", "n", "o"], seed=36), t.MultiPickListMap,
        max_size=2, seed=37)),
    ("date-map", lambda k, t: k.RandomMap(
        k.RandomIntegral.dates(seed=38), t.DateMap, max_size=2, seed=39)),
    ("vector-normal", lambda k, t: k.RandomVector(4, seed=40)),
    ("vector-uniform", lambda k, t: k.RandomVector(3, "uniform", seed=41)
     .with_probability_of_empty(0.1)),
]


def _plain(v):
    """A boxed value as plain python, arrays as lists, for equality."""
    v = getattr(v, "value", v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, float) and v != v:
        return "NaN"  # a missing numeric column value
    return v


@pytest.mark.parametrize("make", [g[1] for g in GENERATORS],
                         ids=[g[0] for g in GENERATORS])
def test_generator_matches_jax(make):
    ref, got = make(jk, jt), make(tk, tt)
    a, b = ref.take(N), got.take(N)
    assert [type(v).__name__ for v in b] == [type(v).__name__ for v in a]
    assert [_plain(v) for v in b] == [_plain(v) for v in a]
    # after a reset of each (the outer stream only, in both packages) the
    # next draws match too, and so do their columns, or their errors (a
    # vector column with empties does not stack in either package)
    ref.reset(), got.reset()
    assert [_plain(v) for v in got.take(N)] == \
        [_plain(v) for v in ref.take(N)]
    try:
        ca = ref.column(N // 2)
    except ValueError as e:
        with pytest.raises(type(e)):
            got.column(N // 2)
        return
    cb = got.column(N // 2)
    assert cb.ftype.__name__ == ca.ftype.__name__
    assert [_plain(x) for x in cb.data] == [_plain(x) for x in ca.data]


def test_random_data_records_match_jax():
    """``RandomData.records`` and ``columns`` over every family of the
    family workflow's generators."""
    def build(k, t):
        data = k.RandomData(seed=7)
        data.with_column("r", k.RandomReal.normal(seed=1)
                         .with_probability_of_empty(0.2))
        data.with_column("s", k.RandomSet(["a", "b", "c"], seed=2))
        data.with_column("m", k.RandomMap(k.RandomReal.uniform(seed=3),
                                          t.NumericMap, seed=4))
        data.with_column("l", k.RandomList(k.RandomText.strings(seed=5),
                                           seed=6))
        return data
    a, b = build(jk, jt).records(N), build(tk, tt).records(N)
    assert [{k: _plain(v) for k, v in r.items()} for r in b] == \
        [{k: _plain(v) for k, v in r.items()} for r in a]
    ca, cb = build(jk, jt).columns(N), build(tk, tt).columns(N)
    assert list(cb) == list(ca)
    for name in ca:
        assert [_plain(x) for x in cb[name].data] == \
            [_plain(x) for x in ca[name].data]


def test_family_records_are_the_jax_testkits():
    """The family workflow's records: the testkit columns equal the JAX
    testkit's drawn with the JAX package's seeds, and every value is a
    valid raw value of its family's type."""
    recs = families.synthetic_families(N)
    ref = jk.RandomData(seed=families.SEED)
    for name, gen in _jax_family_generators(families.SEED).items():
        ref.with_column(name, gen)
    jrecs = ref.records(N)
    for r, j in zip(recs, jrecs):
        assert {k: _plain(r[k]) for k in j} == {k: _plain(v)
                                                for k, v in j.items()}
        assert r["label"] in (0.0, 1.0)
        geo = r["geo"]
        assert geo is None or (len(geo) == 3 and -60 <= geo[0] <= 60)
    assert 0.05 < np.mean([r["geo"] is None for r in recs]) < 0.2
    for name, (ftype, _) in families.family_generators().items():
        FeatureColumn.from_values(ftype, [r[name] for r in recs])


def _jax_family_generators(seed0):
    """The JAX package's family generators (``tests/test_scoring_plan``)
    under the example's names, built from the JAX testkit."""
    k, t = jk, jt
    return {
        "real": k.RandomReal.normal(0, 2, seed=seed0 + 1)
        .with_probability_of_empty(0.2),
        "integral": k.RandomIntegral.integers(0, 50, seed=seed0 + 2)
        .with_probability_of_empty(0.15),
        "flag": k.RandomBinary(0.4, seed=seed0 + 3)
        .with_probability_of_empty(0.1),
        "when": k.RandomIntegral.dates(seed=seed0 + 4)
        .with_probability_of_empty(0.2),
        "pick": k.RandomText.picklists(["a", "b", "c", "d"], seed=seed0 + 5)
        .with_probability_of_empty(0.15),
        "tags": k.RandomSet(["x", "y", "z", "w"], seed=seed0 + 6)
        .with_probability_of_empty(0.2),
        "blurb": k.RandomText.strings(seed=seed0 + 7)
        .with_probability_of_empty(0.1),
        "nums": k.RandomMap(k.RandomReal.uniform(0, 5, seed=seed0 + 8),
                            t.NumericMap, min_size=1, max_size=3,
                            seed=seed0 + 9).with_probability_of_empty(0.2),
        "words": k.RandomMap(k.RandomText.picklists(["p", "q", "r"],
                                                    seed=seed0 + 10),
                             t.PickListMap, min_size=1, max_size=3,
                             seed=seed0 + 11).with_probability_of_empty(0.2),
        "sets": k.RandomMap(k.RandomSet(["m", "n", "o"], seed=seed0 + 12),
                            t.MultiPickListMap, min_size=1, max_size=2,
                            seed=seed0 + 13).with_probability_of_empty(0.2),
        "whens": k.RandomMap(k.RandomIntegral.dates(seed=seed0 + 14),
                             t.DateMap, min_size=1, max_size=2,
                             seed=seed0 + 15).with_probability_of_empty(0.2),
        "dates": k.RandomList(k.RandomIntegral.dates(seed=seed0 + 16),
                              min_size=1, max_size=3, ftype=t.DateList,
                              seed=seed0 + 17).with_probability_of_empty(0.3),
    }


class TestUnitCircleContract(tk.StageSpecBase):
    """The port's StageSpecBase battery (batch equals row, save and load,
    params) on a ported stage fed the testkit's dates."""

    def build(self):
        f = FeatureBuilder.of("d", tt.Date).extract(
            lambda r: r["d"]).as_predictor()
        col = tk.RandomIntegral.dates(seed=3).with_probability_of_empty(
            0.2).column(40)
        return (DateToUnitCircleVectorizer("DayOfWeek").set_input(f),
                Dataset({"d": col}))
