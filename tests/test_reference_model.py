"""The host model (manticoresearch_tpu/reference_model.py) against the
engine, for every query class the GPU smoke test checks, in both of the
planner's execution spaces (dense accumulators and the sparse candidate
pipeline)."""
import numpy as np
import pytest

from manticoresearch_tpu.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu.query.planner import AttrFilterDef
from manticoresearch_tpu.reference_model import HostModel
from manticoresearch_tpu.synthetic import build_corpus, term_name

N_DOCS, VOCAB, AVG_LEN = 4000, 400, 30


@pytest.fixture(scope="module")
def corpus():
    packed = build_corpus(N_DOCS, VOCAB, AVG_LEN, seed=5)[0]
    return packed, SearchIndex(packed), HostModel(packed)


def _terms(seed, n):
    rng = np.random.RandomState(seed)
    return [term_name(int(t), VOCAB)
            for t in rng.choice(np.arange(2, 150), n, replace=False)]


CASES = [
    ("term", 1, 0, None),
    ("and", 2, 0, None),
    ("or", 2, 0, None),
    ("or", 3, 0, None),                       # order-sensitive float sum
    ("and", 2, 0, ("year", 2005, 2018)),
    ("phrase", 2, 0, None),
    ("proximity", 2, 5, None),
]


def _match(kind, terms, slop):
    if kind == "phrase":
        return f'"{terms[0]} {terms[1]}"'
    if kind == "proximity":
        return f'"{terms[0]} {terms[1]}"~{slop}'
    return (" | " if kind == "or" else " ").join(terms)


@pytest.mark.parametrize("space", ["never", "always"])
@pytest.mark.parametrize("kind,n_terms,slop,rng_", CASES,
                         ids=[f"{c[0]}{c[1]}{'_range' if c[3] else ''}"
                              for c in CASES])
def test_engine_equals_host_model(corpus, monkeypatch, space, kind, n_terms,
                                  slop, rng_):
    monkeypatch.setenv("MT_SPARSE", space)
    _packed, idx, model = corpus
    for seed in range(6):
        terms = _terms(seed * 7 + n_terms, n_terms)
        filt = ([AttrFilterDef(rng_[0], "range_i", lo=rng_[1], hi=rng_[2])]
                if rng_ else [])
        r = idx.search(SearchQuery(match=_match(kind, terms, slop),
                                   filters=filt, limit=20))
        assert r.error is None, r.error
        rows, w = model.evaluate(kind, terms, slop=slop, attr_range=rng_)
        assert [(m.docid, m.weight) for m in r.matches] == \
            model.top(rows, w, 20)
        assert r.total_found == len(rows)


@pytest.mark.parametrize("space", ["never", "always"])
def test_factor_ranker_equals_host_model(corpus, monkeypatch, space):
    """ranker=expr over the float factors atc and tf_idf: on the CPU the
    engine's weights equal the host model's exactly (on a GPU its log and
    pow may move a weight by one; chip_smoke.py allows that)."""
    monkeypatch.setenv("MT_SPARSE", space)
    packed, idx, model = corpus
    rng = np.random.RandomState(11)
    n_weights = 0
    for _ in range(4):
        terms = [term_name(int(t), VOCAB)
                 for t in rng.choice(np.arange(0, 60), 2, replace=False)]
        r = idx.search(SearchQuery(match=" ".join(terms), limit=4000,
                                   max_matches=4000,
                                   ranker=("expr", "sum((atc+tf_idf)*1000)")))
        assert r.error is None, r.error
        rows, _ = model.evaluate("and", terms)
        w = np.trunc(model.factor_weights(terms, rows)).astype(np.int64)
        assert [(m.docid, m.weight) for m in r.matches] == \
            model.top(rows, w, 4000)
        assert r.total_found == len(rows)
        n_weights += len(rows)
    assert n_weights > 100


@pytest.mark.parametrize("space", ["never", "always"])
def test_group_by_equals_host_model(corpus, monkeypatch, space):
    monkeypatch.setenv("MT_SPARSE", space)
    _packed, idx, model = corpus
    for t in _terms(3, 4):
        r = idx.search(SearchQuery(
            match=t, group_by="group_id", select=["count(*)", "sum(year)"],
            sort=[("@count", False)], limit=10))
        assert r.error is None, r.error
        got = [(m.attrs["group_id"], m.attrs["count(*)"], m.attrs["sum(year)"])
               for m in r.matches]
        rows, w = model.evaluate("term", [t])
        assert got == model.group(rows, w, "group_id", 10, sum_attr="year")


def test_host_model_rejects_what_it_does_not_cover(corpus):
    _packed, _idx, model = corpus
    t = _terms(1, 2)
    with pytest.raises(ValueError):
        model.evaluate("phrase", t[:1])
    with pytest.raises(ValueError):
        model.evaluate("and", [t[0], t[0]])
    with pytest.raises(KeyError):
        model.evaluate("term", ["no-such-term"])
