"""A plain host model of the engine's ranking and grouping, for checking.

It answers the query classes the device path serves on a single-field
index — one term, AND / OR of terms, a two-word phrase "a b", a two-word
proximity "a b"~N, an optional inclusive integer range filter,
GROUP BY one attribute with COUNT(*) and an integer SUM, and the float
factors atc and tf_idf of the expression ranker (`factor_weights`) —
straight from the index's posting and hit arrays in numpy and plain
Python, with none of the device code. Results are compared with the
engine's exactly: (docid, weight) lists, total_found, group keys and
aggregates (factor weights: see `factor_weights`' callers for the
tolerance a GPU's log and pow need).

Semantics (default ranker proximity_bm25, field weight 1; the reference's
sphinxsearch.cpp / searchnode.cpp / sphinxsort.cpp):
- idf = log((N - df + 1) / df) / (2 log(1 + N)) / n_qwords, rounded to
  float32 (sphCreateRanker, sphinxsearch.cpp:4317);
- tf*idf per matched term in float32 (tfq = tf / (tf + 1.2) in float32),
  summed in float32 in query-slot order starting from 0;
  bm25part = trunc((sum + 0.5) * 1000) in float32 (sphinxsearch.cpp:1070);
- the ranker's hit stream, in (doc, position) order: term hits carry
  their query position, weight 1 and span 1; a phrase emits one hit per
  occurrence at its start (weight 2, span 2); a proximity node emits a hit
  at every member hit that ends a window holding every member within
  qlen + N - 1 positions, weighted 2 when the latest hits of both members
  sit at their query distance, else 1. A hit extends the current chain
  when it is in the same document, at a later position, and its
  position - query position equals the previous hit's plus that hit's
  span - 1; the chain value is the sum of weights along the chain (capped
  at 255), and LCS is the largest chain value in the document
  (RankerState_Proximity_fn, sphinxsearch.cpp:1320);
- weight = bm25part + LCS * 1000; ties order by docid ascending
  (sphinxsort.cpp:4534);
- a group is represented by its best row (weight desc, docid asc); groups
  order by COUNT(*) desc, then that row's docid asc.
"""
from __future__ import annotations

import math

import numpy as np

K1 = np.float32(1.2)
POS_MASK = (1 << 23) - 1
SCALE = 1000


class HostModel:
    def __init__(self, packed):
        if packed.schema.n_fields != 1:
            raise ValueError("the host model covers single-field indexes")
        self.p = packed
        self.n_docs = int(packed.n_docs)

    # ---- per-term data --------------------------------------------------
    def _tid(self, term: str) -> int:
        tid = self.p.term_id(term)
        if tid < 0:
            raise KeyError(term)
        return tid

    def df(self, term: str) -> int:
        return int(self.p.term_docs[self._tid(term)])

    def postings(self, term: str):
        """(rows int64 ascending, tfq float32) of the term."""
        tid = self._tid(term)
        t0, t1 = int(self.p.term_offsets[tid]), int(self.p.term_offsets[tid + 1])
        tf = self.p.post_tf[t0:t1].astype(np.float32)
        return self.p.post_rowid[t0:t1].astype(np.int64), tf / (tf + K1)

    def hits(self, term: str):
        """(rows, positions) of every occurrence, in (row, position) order."""
        tid = self._tid(term)
        t0, t1 = int(self.p.term_offsets[tid]), int(self.p.term_offsets[tid + 1])
        h0 = int(self.p.post_hit_offset[t0])
        h1 = int(self.p.post_hit_offset[t1])
        rows = np.repeat(self.p.post_rowid[t0:t1].astype(np.int64),
                         np.diff(self.p.post_hit_offset[t0:t1 + 1]))
        pos = (self.p.hit_packed[h0:h1] & POS_MASK).astype(np.int64)
        return rows, pos

    def idf(self, term: str, n_qwords: int) -> np.float32:
        n, df = self.n_docs, self.df(term)
        n_total = max(n, df)
        v = math.log((n_total - df + 1) / df) / (2.0 * math.log(1 + n_total))
        return np.float32(v / n_qwords)

    # ---- weights --------------------------------------------------------
    def _tfidf_sum(self, terms, rows):
        """float32 sum over `terms` (slot order) of tf*idf at `rows`."""
        acc = np.zeros(len(rows), np.float32)
        n_q = len(dict.fromkeys(terms))
        for t in terms:
            prow, tfq = self.postings(t)
            i = np.searchsorted(prow, rows)
            i = np.minimum(i, max(len(prow) - 1, 0))
            present = (prow[i] == rows) if len(prow) else \
                np.zeros(len(rows), bool)
            c = tfq[i] * self.idf(t, n_q)
            acc = np.where(present, acc + c, acc).astype(np.float32)
        return acc

    @staticmethod
    def _lcs(rows, pos, qpos, weight, span, out_rows):
        """Chain LCS per row of `out_rows` over one hit stream."""
        key = rows * (1 << 24) + pos
        o = np.argsort(key, kind="stable")
        rows, pos, qpos = rows[o], pos[o], qpos[o]
        weight, span = weight[o], span[o]
        delta = pos - qpos
        n = len(rows)
        linked = np.zeros(n, bool)
        if n > 1:
            linked[1:] = ((rows[1:] == rows[:-1]) & (pos[1:] > pos[:-1])
                          & (delta[1:] == delta[:-1] + span[:-1] - 1))
        start = np.maximum.accumulate(np.where(linked, 0, np.arange(n)))
        cw = np.cumsum(weight)
        chain = np.minimum(cw - cw[start] + weight[start], 255)
        lcs = np.zeros(len(out_rows), np.int64)
        if n:
            ur, first = np.unique(rows, return_index=True)
            best = np.maximum.reduceat(chain, first)
            j = np.searchsorted(ur, out_rows)
            j = np.minimum(j, len(ur) - 1)
            lcs = np.where(ur[j] == out_rows, best[j], 0)
        return lcs

    def _bm25part(self, tfidf):
        return np.trunc((tfidf + np.float32(0.5)) * np.float32(SCALE)
                        ).astype(np.int64)

    def evaluate(self, kind: str, terms: list[str], slop: int = 0,
                 attr_range: tuple[str, int, int] | None = None):
        """All matching rows (ascending) and their int weights.

        kind: "term" | "and" | "or" (terms in query order) | "phrase" |
        "proximity" (two terms, `slop` = N of "a b"~N).
        attr_range: (attr, lo, hi), inclusive."""
        if kind in ("phrase", "proximity") and len(terms) != 2:
            raise ValueError("phrase/proximity take two terms")
        if len(set(terms)) != len(terms):
            raise ValueError("terms must be distinct")
        post_rows = [self.postings(t)[0] for t in terms]
        if kind in ("term", "or"):
            rows = np.unique(np.concatenate(post_rows))
        else:
            rows = post_rows[0]
            for r in post_rows[1:]:
                rows = np.intersect1d(rows, r)
        hits = [self.hits(t) for t in terms]
        if kind in ("term", "and", "or"):
            hr = np.concatenate([h[0] for h in hits])
            hp = np.concatenate([h[1] for h in hits])
            qp = np.concatenate([np.full(len(h[0]), i + 1, np.int64)
                                 for i, h in enumerate(hits)])
            ones = np.ones(len(hr), np.int64)
            lcs = self._lcs(hr, hp, qp, ones, ones, rows)
        else:
            (ar, ap), (br, bp) = hits
            akey, bkey = ar * (1 << 24) + ap, br * (1 << 24) + bp
            if kind == "phrase":
                ok = np.isin(akey + 1, bkey)
                er, ep = ar[ok], ap[ok]
                ew = np.full(len(er), 2, np.int64)
            else:
                window = 1 + slop          # qlen + N; key - member < window
                er = np.concatenate([ar, br])
                ep = np.concatenate([ap, bp])
                ekey = er * (1 << 24) + ep
                ok = np.ones(len(er), bool)
                member_delta = []
                for mkey, qd in ((akey, 0), (bkey, 1)):
                    j = np.searchsorted(mkey, ekey, side="right") - 1
                    has = j >= 0
                    mk = mkey[np.maximum(j, 0)]
                    ok &= has & (mk // (1 << 24) == er) & (ekey - mk < window)
                    member_delta.append(mk % (1 << 24) - qd)
                ew = np.where(member_delta[0] == member_delta[1], 2, 1)
                er, ep, ew = er[ok], ep[ok], ew[ok]
            rows = np.intersect1d(rows, np.unique(er))
            ones = np.ones(len(er), np.int64)
            lcs = self._lcs(er, ep, ones, ew, ones * 2, rows)
        if attr_range is not None:
            name, lo, hi = attr_range
            v = self.p.attrs_int[name][rows]
            keep = (v >= lo) & (v <= hi)
            rows, lcs = rows[keep], lcs[keep]
        tfidf = self._tfidf_sum(terms, rows)
        return rows, self._bm25part(tfidf) + lcs * SCALE

    def factor_weights(self, terms: list[str], rows):
        """float32 value of the ranker `sum((atc + tf_idf) * 1000)` at
        `rows` (distinct terms, each with its idf as in `evaluate`).

        tf_idf adds idf(term) over the document's hits in position order.
        atc (UpdateATC/TermTC, sphinxsearch.cpp:3904-3995): the hits of
        the query terms in one document, in (position, query position)
        order; for each hit, walking up to 10 hits back and then up to 10
        forward, the first hit of each query term seen in that direction
        at another position adds idf(term) / distance^1.75, a quarter of
        that when it is the hit's own term; a document's per-term sums of
        those values, times idf(term), add to ws, and atc = ln(1 + ws)."""
        n_q = len(terms)
        idf = [self.idf(t, n_q) for t in terms]
        per_doc: dict[int, list[tuple[int, int]]] = {}
        want = set(np.asarray(rows).tolist())
        for q, t in enumerate(terms):
            for r, p in zip(*(a.tolist() for a in self.hits(t))):
                if r in want:
                    per_doc.setdefault(r, []).append((p, q))
        out = np.zeros(len(rows), np.float32)
        for i, r in enumerate(np.asarray(rows).tolist()):
            hits = sorted(per_doc.get(r, []))
            tf_idf = np.float32(0)
            per_term = [np.float32(0)] * n_q
            for h, (pos, q) in enumerate(hits):
                tf_idf = np.float32(tf_idf + idf[q])
                tc = np.float32(0)
                for step in (-1, 1):
                    seen = set()
                    for d in range(1, 11):
                        j = h + step * d
                        if not 0 <= j < len(hits):
                            break
                        pos_j, q_j = hits[j]
                        if pos_j == pos or q_j in seen:
                            continue
                        seen.add(q_j)
                        c = np.float32(idf[q_j] / np.power(
                            np.float32(abs(pos - pos_j)), np.float32(1.75)))
                        if q_j == q:
                            c = np.float32(c * np.float32(0.25))
                        tc = np.float32(tc + c)
                per_term[q] = np.float32(per_term[q] + tc)
            ws = np.float32(0)
            for q in range(n_q):
                ws = np.float32(ws + per_term[q] * idf[q])
            atc = np.log(np.float32(1) + ws)
            out[i] = np.float32((atc + tf_idf) * np.float32(SCALE))
        return out

    # ---- result shapes --------------------------------------------------
    def top(self, rows, weights, k: int):
        """[(docid, weight)] of the best k (weight desc, docid asc)."""
        docids = self.p.doc_ids[rows].astype(np.int64)
        o = np.lexsort((docids, -weights))[:k]
        return list(zip(docids[o].tolist(), weights[o].tolist()))

    def group(self, rows, weights, key: str, k: int,
              sum_attr: str | None = None):
        """[(key, count[, sum])] of the first k groups by COUNT(*) desc,
        then the representative row's docid asc."""
        keys = self.p.attrs_int[key][rows].astype(np.int64)
        docids = self.p.doc_ids[rows].astype(np.int64)
        o = np.lexsort((docids, -weights, keys))
        keys_s, docids_s = keys[o], docids[o]
        uk, first, counts = np.unique(keys_s, return_index=True,
                                      return_counts=True)
        rep = docids_s[first]
        cols = [uk, counts]
        if sum_attr is not None:
            v = self.p.attrs_int[sum_attr][rows].astype(np.int64)[o]
            cols.append(np.add.reduceat(v, first) if len(v) else
                        np.zeros(0, np.int64))
        order = np.lexsort((rep, -counts))[:k]
        return [tuple(int(c[i]) for c in cols) for i in order]
