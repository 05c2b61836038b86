"""The order rules exact answers rest on: top-k ties lowest index first
(JAX's documented rule for lax.top_k, which the engine relies on — these
fail if a backend stops honouring it), float sums in slot order (a GPU
runs a scatter-add with duplicate indices as unordered atomics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manticoresearch_tpu.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu.ops.search import (segment_running_sums,
                                            segment_sums_in_order)
from manticoresearch_tpu.reference_model import HostModel
from manticoresearch_tpu.synthetic import SCHEMA, build_corpus, term_name


def _want_top(key, k):
    o = np.lexsort((np.arange(len(key)), -key.astype(np.int64)))[:k]
    return key[o], o


@pytest.mark.parametrize("keys", ["all_equal", "mixed", "few_distinct",
                                  "with_int32_min"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_top_k_ties_lowest_index_first(keys, k):
    rng = np.random.RandomState(k)
    n = 1000
    key = {"all_equal": np.full(n, 7),
           "mixed": rng.randint(-10**6, 10**6, n),
           "few_distinct": rng.randint(0, 3, n),
           "with_int32_min": np.where(rng.rand(n) < 0.99, -(2**31),
                                      rng.randint(0, 5, n)),
           }[keys].astype(np.int32)
    w, idx = jax.jit(lambda x: jax.lax.top_k(x, k))(key)
    want_w, want_idx = _want_top(key, k)
    np.testing.assert_array_equal(np.asarray(w), want_w)
    np.testing.assert_array_equal(np.asarray(idx), want_idx)


def test_top_k_ties_lowest_index_first_vmapped():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 4, (5, 300)).astype(np.int32)
    w, idx = jax.jit(jax.vmap(lambda x: jax.lax.top_k(x, 10)))(keys)
    for b in range(5):
        want_w, want_idx = _want_top(keys[b], 10)
        np.testing.assert_array_equal(np.asarray(idx[b]), want_idx)
        np.testing.assert_array_equal(np.asarray(w[b]), want_w)


@pytest.mark.parametrize("space", ["never", "always"])
def test_engine_equal_weights_lowest_docid_first(monkeypatch, space):
    """Every document holds the term once, so every weight is equal: the
    engine must return the lowest docids, in order, in both spaces."""
    from manticoresearch_tpu.index.builder import build_from_pretokenized
    monkeypatch.setenv("MT_SPARSE", space)
    n = 3000
    rng = np.random.RandomState(6)
    lens = rng.randint(2, 9, n)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    terms = rng.randint(1, 40, offsets[-1])
    terms[offsets[:-1]] = 0                  # word 0 once per document
    docids = rng.permutation(np.arange(1, n + 1) * 3)
    packed = build_from_pretokenized(
        SCHEMA, docids, terms, offsets,
        {"year": np.full(n, 2001), "group_id": np.zeros(n, np.int64)},
        [term_name(i, 40) for i in range(40)])
    r = SearchIndex(packed).search(SearchQuery(match=term_name(0, 40),
                                               limit=25))
    assert r.error is None, r.error
    assert len({m.weight for m in r.matches}) == 1
    assert [m.docid for m in r.matches] == list(range(3, 76, 3))
    assert r.total_found == n


def _order_sensitive_triples(n):
    """Segments of three float32 values whose sum depends on the order of
    addition: ((a + b) + c) != (a + (c + b))."""
    rng = np.random.RandomState(1)
    out = []
    while len(out) < n:
        a, b, c = (rng.standard_normal(3) * [1e4, 1.0, 1e-3]).astype(
            np.float32)
        if (a + b) + c != a + (c + b):
            out.append((a, b, c))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("max_len", [3, None])
def test_segment_sums_in_order_is_sequential(max_len):
    trip = _order_sensitive_triples(50)
    vals = trip.reshape(-1)
    seg = np.repeat(np.arange(50, dtype=np.int32), 3)
    head = np.tile([True, False, False], 50)
    got = jax.jit(lambda s, h, v: segment_sums_in_order(
        s, h, v, 50, max_len))(seg, head, vals)
    want = (trip[:, 0] + trip[:, 1]) + trip[:, 2]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_segment_sums_drop_entries_past_max_len():
    vals = np.array([1, 2, 4, 8, 16], np.float32)
    seg = np.array([0, 0, 0, 1, 1], np.int32)
    head = np.array([True, False, False, True, False])
    got = segment_sums_in_order(seg, head, vals, 2, 2)
    np.testing.assert_array_equal(np.asarray(got), [3.0, 24.0])


def test_segment_running_sums_restart_at_heads():
    vals = np.arange(1, 7, dtype=np.float32)
    head = np.array([True, False, True, False, False, True])
    got = np.asarray(segment_running_sums(vals, head))
    np.testing.assert_array_equal(got, [1, 3, 3, 7, 12, 6])


def test_three_term_sum_equal_in_both_spaces(monkeypatch):
    """A 3-term OR adds three tf*idf terms per doc that has all three; the
    sparse pipeline must add them in slot order as the dense path and the
    host model do."""
    packed = build_corpus(3000, 300, 40, seed=9)[0]
    idx, model = SearchIndex(packed), HostModel(packed)
    terms = [term_name(t, 300) for t in (3, 5, 8)]
    out = {}
    for space in ("never", "always"):
        monkeypatch.setenv("MT_SPARSE", space)
        r = idx.search(SearchQuery(match=" | ".join(terms), limit=50))
        assert r.error is None, r.error
        out[space] = [(m.docid, m.weight) for m in r.matches]
    rows, w = model.evaluate("or", terms)
    assert out["never"] == out["always"] == model.top(rows, w, 50)


def test_factor_cell_sums_in_stream_order_skip_padding(monkeypatch):
    """Per-(row, field, qword) float sums of the ranking factors add each
    cell's hits in stream order, and padded hit slots cost no trips of the
    in-order loop: it runs as often as the most hits in one cell, however
    much padding the stream carries."""
    from manticoresearch_tpu.ops import factors
    trips = []
    real = factors.segment_sums_in_order

    def counting(seg, head, vals, n_seg, max_len=None):
        head = np.asarray(head)
        i = np.arange(len(head))
        trips.append(int((i - np.maximum.accumulate(np.where(head, i, 0)))
                         .max()) + 1)
        return real(seg, head, vals, n_seg, max_len)

    monkeypatch.setattr(factors, "segment_sums_in_order", counting)
    N, F, Q, n_hits, n_pad = 40, 2, 3, 300, 20000
    rng = np.random.RandomState(8)
    row = np.concatenate([rng.randint(0, N, n_hits), np.full(n_pad, N)])
    field = np.concatenate([rng.randint(0, F, n_hits), np.zeros(n_pad)])
    q = np.concatenate([rng.randint(0, Q, n_hits), np.zeros(n_pad)])
    ok = np.arange(n_hits + n_pad) < n_hits
    vals = np.where(ok, rng.standard_normal(n_hits + n_pad)
                    * 10.0 ** rng.randint(-3, 4, n_hits + n_pad), 7.0
                    ).astype(np.float32)
    perm = rng.permutation(n_hits + n_pad)   # padding spread through
    row, field, q, ok, vals = (a[perm] for a in (row, field, q, ok, vals))
    ctx = factors.FactorContext(N=N, F=F, S=Q, stream=None, lcs=None,
                                bm25part=None, termmask=None, rt={},
                                field_lens=None)
    got = ctx._sum_per_cell(jnp.asarray(row, jnp.int32),
                            jnp.asarray(field, jnp.int32),
                            jnp.asarray(q, jnp.int32), jnp.asarray(ok),
                            jnp.asarray(vals), Q)
    want = np.zeros((N + 1, F, Q), np.float32)
    np.add.at(want, (row[ok], field[ok].astype(int), q[ok].astype(int)),
              vals[ok])                      # sequential, stream order
    np.testing.assert_array_equal(np.asarray(got), want)
    cell = (row[ok] * F + field[ok]) * Q + q[ok]
    assert trips == [int(np.bincount(cell.astype(int)).max())]
    assert trips[0] < 20


def test_float_group_sum_repeats_bit_for_bit():
    """Float SUM over groups of a thousand rows is the same on every run
    (fixed association) and within the rounding bound of that association
    of the exact sum: (ceil(log2 n) + 1) * eps * sum |x| for n rows. Every
    |x| is far above the bound, so a lost or doubled row fails."""
    from manticoresearch_tpu.exec.session import Catalog, Session
    cat = Catalog()
    s = Session(cat)
    assert s.execute("CREATE TABLE f (body text, g uint, x float)")[0] \
        .error is None
    rng = np.random.RandomState(2)
    n = 3000
    xs = ((100.0 + np.abs(rng.standard_normal(n)) * 1000)
          * rng.choice([-1, 1], n)).astype(np.float32)
    vals = ", ".join(f"({i + 1}, 'w', {i % 3}, {float(x)!r})"
                     for i, x in enumerate(xs))
    assert s.execute(f"INSERT INTO f (id, body, g, x) VALUES {vals}")[0] \
        .error is None
    q = "SELECT g, SUM(x) FROM f WHERE MATCH('w') GROUP BY g ORDER BY g ASC"
    first = s.execute(q)[0].rows
    assert first == s.execute(q)[0].rows
    assert len(first) == 3
    eps = float(np.finfo(np.float32).eps)
    for g, total in first:
        x = xs[np.arange(n) % 3 == int(g)].astype(np.float64)
        bound = (np.ceil(np.log2(len(x))) + 1) * eps * np.sum(np.abs(x))
        assert bound < 100.0 / 2
        assert abs(float(total) - float(np.sum(x))) <= bound


def test_pretokenized_build_hit_order():
    """build_from_pretokenized lays hits out in (term, row, position)
    order, rows in docid order, whatever order the documents come in."""
    from manticoresearch_tpu.index.builder import build_from_pretokenized
    rng = np.random.RandomState(4)
    n = 300
    lens = rng.randint(0, 20, n)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    terms = rng.randint(0, 50, offsets[-1])
    attrs = {"year": np.full(n, 2001), "group_id": np.arange(n) % 7}
    vocab = [term_name(i, 50) for i in range(50)]
    docids = rng.permutation(n) + 1
    packed = build_from_pretokenized(SCHEMA, docids, terms, offsets, attrs,
                                     vocab)
    # the same hits, sorted independently: (term, docid, position)
    doc = np.repeat(docids, lens)
    pos = np.arange(len(terms)) - np.repeat(offsets[:-1], lens) + 1
    o = np.lexsort((pos, doc, terms))
    np.testing.assert_array_equal(packed.doc_ids, np.arange(1, n + 1))
    np.testing.assert_array_equal(packed.hit_packed & ((1 << 23) - 1),
                                  pos[o])
    hit_rows = np.repeat(packed.post_rowid, np.diff(packed.post_hit_offset))
    np.testing.assert_array_equal(packed.doc_ids[hit_rows], doc[o])
    np.testing.assert_array_equal(
        np.repeat(np.arange(50), np.diff(packed.term_offsets)),
        np.unique(np.stack([terms[o], doc[o]]), axis=1)[0])
    # listed in docid order, the same documents build the same index
    inv = np.argsort(docids)
    asc = build_from_pretokenized(
        SCHEMA, docids[inv],
        np.concatenate([terms[offsets[i]:offsets[i + 1]] for i in inv]),
        np.concatenate([[0], np.cumsum(lens[inv])]),
        {k: v[inv] for k, v in attrs.items()}, vocab)
    for name in ("doc_ids", "term_offsets", "post_rowid", "post_tf",
                 "post_tfq", "post_hit_offset", "hit_packed"):
        np.testing.assert_array_equal(getattr(asc, name),
                                      getattr(packed, name))


def test_tfq_is_float32_division():
    """tfq = tf / (tf + 1.2) in float32, as the device recomputes it from
    bit-packed tf: a float64 division rounded to float32 differs for many
    tf values (tf = 6, 8, 12, ...)."""
    from manticoresearch_tpu.index.merge import merge_packed
    packed = build_corpus(500, 50, 200, seed=3)[0]
    tf32 = packed.post_tf.astype(np.float32)
    want = tf32 / (tf32 + np.float32(1.2))
    assert packed.post_tf.max() >= 12
    np.testing.assert_array_equal(packed.post_tfq, want)
    merged = merge_packed([packed], [set(packed.doc_ids.tolist())])
    tf32 = merged.post_tf.astype(np.float32)
    np.testing.assert_array_equal(merged.post_tfq,
                                  tf32 / (tf32 + np.float32(1.2)))
