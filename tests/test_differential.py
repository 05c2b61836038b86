"""Differential testing: the same corpus served through three independent
execution paths must return identical results for randomized queries —
single plain index vs multi-segment RT vs 8-way mesh-sharded distributed.

This is the ubertest idea (SURVEY §4: one suite driving plain AND rt
backends) applied to randomized query generation.
"""
import numpy as np
import pytest

from manticoresearch_tpu.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.index.rt import RtIndex
from manticoresearch_tpu.parallel.sharded import (ShardedIndex, make_mesh,
                                                  partition_documents)
from manticoresearch_tpu.query.planner import AttrFilterDef
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron",
         "search", "engine", "fast", "index", "query", "card", "device"]

COLORS = ["red", "green", "blue", "cyan"]

SCHEMA = Schema(fields=["title", "body"],
                attrs=[AttrDef("year", AttrType.UINT),
                       AttrDef("score", AttrType.FLOAT),
                       AttrDef("color", AttrType.STRING)])


def make_docs(n=120, seed=11):
    rng = np.random.RandomState(seed)
    docs = []
    for i in range(1, n + 1):
        docs.append(dict(
            id=i,
            title=" ".join(rng.choice(WORDS, rng.randint(1, 4))),
            body=" ".join(rng.choice(WORDS, rng.randint(4, 16))),
            year=int(2000 + rng.randint(0, 12)),
            score=float(np.round(rng.rand(), 3)),
            color=COLORS[rng.randint(len(COLORS))],
        ))
    return docs


def random_query(rng) -> SearchQuery:
    def w():
        return WORDS[rng.randint(len(WORDS))]

    kind = rng.randint(8)
    if kind == 0:
        match = w()
    elif kind == 1:
        match = f"{w()} {w()}"
    elif kind == 2:
        match = f"{w()} | {w()} | {w()}"
    elif kind == 3:
        match = f"{w()} -{w()}"
    elif kind == 4:
        match = f'"{w()} {w()}"'
    elif kind == 5:
        match = f'"{w()} {w()} {w()}"~{rng.randint(1, 5)}'
    elif kind == 6:
        match = f"@title {w()}"
    else:
        match = f"{w()} NEAR/{rng.randint(1, 6)} {w()}"
    filters = []
    fr = rng.rand()
    if fr < 0.3:
        lo = 2000 + rng.randint(0, 10)
        filters.append(AttrFilterDef("year", "range_i", lo=lo, hi=lo + 3))
    elif fr < 0.5:
        filters.append(AttrFilterDef(
            "color", "values",
            values=[COLORS[rng.randint(len(COLORS))]],
            exclude=bool(rng.randint(2))))
    ranker = ["proximity_bm25", "bm25", "wordcount",
              "sph04"][rng.randint(4)]
    return SearchQuery(match=match, filters=filters, limit=30,
                       ranker=ranker)


@pytest.fixture(scope="module")
def corpora():
    docs = make_docs()
    b = IndexBuilder(SCHEMA)
    b.add_documents(docs)
    single = SearchIndex(b.build())

    rt = RtIndex("t", SCHEMA)
    rng = np.random.RandomState(5)
    order = rng.permutation(len(docs))
    # commit in 7 chunks -> multiple segments, out-of-order inserts
    for chunk in np.array_split(order, 7):
        for i in chunk:
            rt.insert(docs[int(i)])
        rt.commit()
    assert len(rt.segments) > 1

    shards = []
    for part in partition_documents(docs, 8):
        bb = IndexBuilder(SCHEMA)
        bb.add_documents(part)
        shards.append(bb.build())
    sharded = ShardedIndex(shards, make_mesh(8))
    return single, rt, sharded


def _tie_normalized(matches, limit=30):
    """Canonicalize equal-weight runs: [(weight, sorted docids)] — except
    a final run clipped by the result window keeps only its count (which
    docids survive the clip is a sorter artifact on both sides)."""
    runs: list[tuple[int, list[int]]] = []
    for m in matches:
        if runs and runs[-1][0] == m.weight:
            runs[-1][1].append(m.docid)
        else:
            runs.append((m.weight, [m.docid]))
    out = []
    for i, (w, ids) in enumerate(runs):
        clipped = (i == len(runs) - 1 and len(matches) == limit)
        out.append((w, len(ids) if clipped else sorted(ids)))
    return out


def test_differential_random_queries(corpora):
    single, rt, sharded = corpora
    rng = np.random.RandomState(99)
    n_checked = 0
    for qi in range(40):
        q = random_query(rng)
        r1 = single.search(q)
        r2 = rt.search(q)
        r3 = sharded.search(q)
        assert r1.error is None, (q.match, r1.error)
        assert r2.error is None, (q.match, r2.error)
        assert r3.error is None, (q.match, r3.error)
        ids1 = [m.docid for m in r1.matches]
        ws1 = [m.weight for m in r1.matches]
        # RT order within full-tie runs is the shared match-queue's pop
        # artifact keyed on SEGMENT-local rowids (sphinxsort.cpp:4534
        # MatchRelevanceLt_fn; our ref_queue_order emulation, anchored by
        # golden test_066) — the reference's RT diverges from a plain
        # index there too, so compare with ties normalized docid-asc.
        assert _tie_normalized(r2.matches) == _tie_normalized(r1.matches), \
            f"RT diverged on {q.match!r}"
        assert sorted(m.weight for m in r2.matches) == sorted(ws1), \
            f"RT weights diverged on {q.match!r}"
        assert [m.docid for m in r3.matches] == ids1, \
            f"sharded diverged on {q.match!r}"
        assert [m.weight for m in r3.matches] == ws1, \
            f"sharded weights diverged on {q.match!r}"
        assert r2.total_found == r1.total_found == r3.total_found
        n_checked += 1
    assert n_checked == 40


@pytest.mark.slow
def test_differential_at_scale():
    """Randomized differential at 200k docs (opt-in: -m slow): plain vs
    8-way sharded, packed store active on both, with BLOCK=128 and bucket
    boundaries genuinely crossed."""
    import os
    rng = np.random.RandomState(3)
    n = int(os.environ.get("MT_DIFF_DOCS", "200000"))
    vocab_tail = [f"w{i:04d}" for i in range(800)]
    words = WORDS + vocab_tail

    def gen_docs():
        zipf = rng.zipf(1.3, n * 12)
        tid = np.minimum(zipf - 1, len(words) - 1)
        docs = []
        off = 0
        for i in range(1, n + 1):
            ln = 8 + (i % 9)
            body = " ".join(words[t] for t in tid[off:off + ln])
            off += ln
            docs.append(dict(id=i, title=words[tid[off % len(tid)]],
                             body=body, year=2000 + i % 12,
                             score=float((i % 977) / 977.0),
                             color=COLORS[i % len(COLORS)]))
        return docs

    docs = gen_docs()
    b = IndexBuilder(SCHEMA)
    b.add_documents(docs)
    single = SearchIndex(b.build())
    shards = []
    for part in partition_documents(docs, 8):
        bb = IndexBuilder(SCHEMA)
        bb.add_documents(part)
        shards.append(bb.build())
    sharded = ShardedIndex(shards, make_mesh(8))

    qrng = np.random.RandomState(17)
    for qi in range(25):
        q = random_query(qrng)
        r1 = single.search(q)
        r3 = sharded.search(q)
        assert r1.error is None, (q.match, r1.error)
        assert r3.error is None, (q.match, r3.error)
        ids1 = [m.docid for m in r1.matches]
        ws1 = [m.weight for m in r1.matches]
        assert [m.docid for m in r3.matches] == ids1, \
            f"sharded diverged at scale on {q.match!r}"
        assert [m.weight for m in r3.matches] == ws1, \
            f"sharded weights diverged at scale on {q.match!r}"
