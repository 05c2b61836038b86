"""Expression ranker factors (OPTION ranker=expr('...')).

Behavioral model: RankerState_Expr_fn + factor expressions
(/root/reference/src/sphinxsearch.cpp:1964, factor list 2861-2995,
Expr_BM25F_T:2562). Factors are computed from the ranker hit stream as dense
per-doc / per-(doc,field) / per-(doc,qword) arrays; the formula then
evaluates as vector ops and truncates to the int match weight.

Implemented factors:
  doc-level:  bm25, max_lcs, field_mask, query_word_count, doc_word_count,
              bm25a(k1,b), bm25f(k1,b[,{field=w,...}])
  field-level (inside sum(...)): lcs, user_weight, hit_count, word_count,
              tf_idf, min_hit_pos, exact_hit
BM25F follows Expr_BM25F_T::Eval literally: weighted tf summed over fields,
fres += tf/(tf + k1*(1-b+b*dl/avgdl))*idf, + 0.5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .search import segment_sums_in_order

DOC_FACTORS = {"bm25", "max_lcs", "field_mask", "query_word_count",
               "doc_word_count"}
FIELD_FACTORS = {"lcs", "user_weight", "hit_count", "word_count", "tf_idf",
                 "min_hit_pos", "exact_hit", "sum_idf", "min_idf", "max_idf",
                 "min_gaps", "atc",
                 "exact_order", "lccs", "wlccs", "min_best_span_pos"}


def factor_names(tree) -> set[str]:
    op = tree[0]
    if op == "attr":
        return {tree[1]}
    if op == "call":
        out = {tree[1].lower()}
        for a in tree[2]:
            out |= factor_names(a)
        return out
    out = set()
    for c in tree[1:]:
        if isinstance(c, tuple):
            out |= factor_names(c)
    return out


class FactorContext:
    """Computes factor arrays from the sorted ranker hit stream."""

    def __init__(self, *, N, F, S, stream, lcs, bm25part, termmask, rt,
                 field_lens, fl_on: bool = True, raw_stream=None,
                 max_qpos: int = 0):
        # stream: (hrow, hpk, hqp, hslot, valid_mask) — sorted not required.
        # With query dupes `stream` is DEDUPED (one count per physical
        # hit, folded to the first-instance qpos: m_dTermsHit/m_dTermDupes,
        # sphinxsearch.cpp:3446) while raw_stream keeps every emission —
        # exact_order/lccs/atc walk raw hits in the reference.
        self.N, self.F, self.S = N, F, S
        self.stream = stream
        self.raw_stream = raw_stream if raw_stream is not None else stream
        self.max_qpos = int(max_qpos) if max_qpos else max(S, 1)
        self.lcs = lcs                  # [N+1, F]
        self.bm25part = bm25part        # [N+1] int
        self.termmask = termmask        # [N+1, W] multi-word bitmask
        self.rt = rt
        self.field_lens = field_lens    # [N+1, F]
        # without index_field_lengths the reference has no LENGTH attrs:
        # bm25a/bm25f see dl=0 (sphinxsearch.cpp m_iDocLen fallback)
        self.fl_bm25 = 1.0 if fl_on else 0.0
        self._cache: dict[str, jax.Array] = {}

    def _scatter_field(self, vals, reduce="add", init=0):
        hrow, hpk, hqp, hslot, valid = self.stream
        hfield = (hpk >> 24) & 0xFF
        row = jnp.where(valid, hrow, self.N)
        if reduce == "add" and jnp.issubdtype(vals.dtype, jnp.floating):
            return self._sum_per_cell(hrow, hfield, 0, valid, vals, 1)[
                :, :, 0]
        if reduce == "add":
            return jnp.zeros((self.N + 1, self.F), vals.dtype).at[
                row, hfield].add(jnp.where(valid, vals, 0))
        if reduce == "min":
            big = jnp.asarray(init, vals.dtype)
            return jnp.full((self.N + 1, self.F), big, vals.dtype).at[
                row, hfield].min(jnp.where(valid, vals, big))
        raise ValueError(reduce)

    def _sum_per_cell(self, srow, sfield, sq, ok, vals, Q):
        """[N+1, F, Q] sums of per-hit `vals` over (row, field, qword)
        cells, each cell's hits added in stream order
        (segment_sums_in_order), so the float result is the same on every
        run and backend. Hits that are not `ok` (bucket padding) sort last
        as one-entry segments and are dropped, so the in-order loop runs
        only as many times as the most hits in one cell."""
        N, F = self.N, self.F
        row = jnp.where(ok, srow, N + 1)
        q = jnp.broadcast_to(jnp.asarray(sq, jnp.int32), row.shape)
        row, field, q, v = jax.lax.sort(
            (row, sfield.astype(jnp.int32), q, jnp.where(ok, vals, 0.0)),
            num_keys=3)
        new = ((row[1:] != row[:-1]) | (field[1:] != field[:-1])
               | (q[1:] != q[:-1]))
        head = jnp.concatenate([jnp.ones(1, bool), new]) | (row > N)
        seg = jnp.cumsum(head.astype(jnp.int32)) - 1
        sums = segment_sums_in_order(seg, head, v, v.shape[0])
        return jnp.zeros((N + 1, F, Q), v.dtype).at[
            jnp.where(head, row, N + 1), field, q].set(sums[seg],
                                                       mode="drop")

    def get(self, name: str):
        if name in self._cache:
            return self._cache[name]
        v = self._compute(name)
        self._cache[name] = v
        return v

    def _seen_qword_field(self):
        """[N+1, F, S] 0/1: qword slot seen in (doc, field)."""
        if "_seen" in self._cache:
            return self._cache["_seen"]
        hrow, hpk, hqp, hslot, valid = self.stream
        hfield = (hpk >> 24) & 0xFF
        row = jnp.where(valid, hrow, self.N)
        seen = jnp.zeros((self.N + 1, self.F, max(self.S, 1)),
                         jnp.int32).at[
            row, hfield, jnp.clip(hslot, 0, max(self.S - 1, 0))].max(
            jnp.where(valid, 1, 0))
        self._cache["_seen"] = seen
        return seen

    def _field_tf(self):
        """[N+1, F, S]: per-(doc, field, qword) hit counts."""
        if "_ftf" in self._cache:
            return self._cache["_ftf"]
        hrow, hpk, hqp, hslot, valid = self.stream
        hfield = (hpk >> 24) & 0xFF
        row = jnp.where(valid, hrow, self.N)
        ftf = jnp.zeros((self.N + 1, self.F, max(self.S, 1)),
                        jnp.int32).at[
            row, hfield, jnp.clip(hslot, 0, max(self.S - 1, 0))].add(
            jnp.where(valid, 1, 0))
        self._cache["_ftf"] = ftf
        return ftf

    def _sorted_stream(self):
        """Stream sorted by (row, packed pos): (srow, spk, sqp, sslot,
        sval). Invalid hits sort to row N with pk 0."""
        if "_sorted" in self._cache:
            return self._cache["_sorted"]
        hrow, hpk, hqp, hslot, valid = self.stream
        row = jnp.where(valid, hrow, self.N)
        pk = jnp.where(valid, hpk, 0)
        payload = (jnp.clip(hqp, 0, 255)
                   | (jnp.clip(hslot, 0, 255) << 8)
                   | (jnp.where(valid, 1, 0) << 16))
        srow, spk, spl = jax.lax.sort((row, pk, payload), num_keys=2)
        out = (srow, spk, spl & 0xFF, (spl >> 8) & 0xFF, (spl >> 16) & 1)
        self._cache["_sorted"] = out
        return out

    def _sorted_raw_stream(self):
        """raw_stream sorted by (row, packed pos, qpos) — every emission,
        unfolded qpos (exact_order/lccs/atc walk raw hits)."""
        if "_sorted_raw" in self._cache:
            return self._cache["_sorted_raw"]
        hrow, hpk, hqp, hslot, valid = self.raw_stream
        row = jnp.where(valid, hrow, self.N)
        pk = jnp.where(valid, hpk, 0)
        payload = (jnp.clip(hqp, 0, 255)
                   | (jnp.clip(hslot, 0, 255) << 8)
                   | (jnp.where(valid, 1, 0) << 16))
        srow, spk, spl = jax.lax.sort((row, pk, payload), num_keys=3)
        out = (srow, spk, spl & 0xFF, (spl >> 8) & 0xFF, (spl >> 16) & 1)
        self._cache["_sorted_raw"] = out
        return out

    def max_window_hits(self, n: int):
        """[N+1, F]: max hits within any n-position window of a field
        (m_dMaxWindowHits): for each hit, count stream hits in
        [pos, pos+n-1] of the same row+field via a bounded predecessor
        search, then per-field scatter-max."""
        from .search import _lex_search_le
        srow, spk, _, _, sval = self._sorted_stream()
        sfield = (spk >> 24) & 0xFF
        M = srow.shape[0]
        idx = jnp.arange(M, dtype=jnp.int32)
        n_iters = max(1, int(np.ceil(np.log2(max(M, 2))))) + 1
        hi_key = spk + jnp.int32(max(n, 1) - 1)
        lo = jnp.zeros_like(idx)
        hi = jnp.full_like(idx, M)
        j, ex = _lex_search_le(srow, hi_key, srow, spk, lo, hi, n_iters)
        same = ex & (srow[jnp.clip(j, 0, M - 1)] == srow) & \
            ((spk[jnp.clip(j, 0, M - 1)] >> 24) == (spk >> 24))
        cnt = jnp.where(same & (sval == 1), j - idx + 1, 0).astype(jnp.int32)
        return jnp.zeros((self.N + 1, self.F), jnp.int32).at[
            jnp.where(sval == 1, srow, self.N), sfield].max(cnt)

    def _compute(self, name: str):
        N, F, S = self.N, self.F, self.S
        rt = self.rt
        hrow, hpk, hqp, hslot, valid = self.stream
        if name == "bm25":
            return self.bm25part
        if name == "max_lcs":
            # maximum possible LCS over the query (reference m_iMaxLCS):
            # number of keywords for plain bag-of-words queries
            return jnp.int32(S)
        if name == "field_mask":
            seen = self._seen_qword_field()
            anyf = (jnp.sum(seen, axis=-1) > 0).astype(jnp.int32)
            bits = anyf * (jnp.int32(1) << jnp.arange(F, dtype=jnp.int32)
                           )[None, :]
            return jnp.sum(bits, axis=-1)
        if name == "query_word_count":
            return jnp.int32(S)
        if name == "doc_word_count":
            # unique matched keywords in doc = popcount(termmask)
            cnt = jnp.zeros(N + 1, jnp.int32)
            for s in range(S):
                cnt = cnt + ((self.termmask[:, s >> 5] >> (s & 31)) & 1)
            return cnt
        if name == "lcs":
            return self.lcs
        if name == "user_weight":
            return jnp.broadcast_to(rt["field_weights"][None, :], (N + 1, F))
        if name == "hit_count":
            return self._scatter_field(jnp.ones_like(hrow))
        if name == "word_count":
            return jnp.sum(self._seen_qword_field(), axis=-1)
        if name == "tf_idf":
            # sum of idf over stream hit occurrences per field
            # (factor docs: sum(tf(w)*idf(w)) = sum idf over occurrences)
            return self._scatter_field(rt["idf"][jnp.clip(hslot, 0, S - 1)])
        if name == "min_hit_pos":
            pos = hpk & ((1 << 23) - 1)
            mh = self._scatter_field(pos, reduce="min", init=2**22)
            return jnp.where(mh >= 2**22, 0, mh)
        if name in ("sum_idf", "min_idf", "max_idf"):
            # idf aggregated over the UNIQUE query words matched in the
            # field (sphinxsearch.cpp factor list: m_dSumIDF/m_dMinIDF/
            # m_dMaxIDF accumulate once per distinct matched keyword)
            seen = self._seen_qword_field().astype(jnp.float32)  # [N+1,F,S]
            idf = rt["idf"][:S][None, None, :]
            if name == "sum_idf":
                return jnp.sum(seen * idf, axis=-1)
            any_seen = jnp.sum(seen, axis=-1) > 0
            if name == "max_idf":
                v = jnp.max(jnp.where(seen > 0, idf, -jnp.inf), axis=-1)
            else:
                v = jnp.min(jnp.where(seen > 0, idf, jnp.inf), axis=-1)
            return jnp.where(any_seen, v, 0.0)
        if name == "exact_order":
            # per-field consecutive-qpos chain over RAW hits
            # (sphinxsearch.cpp:3503-3515): the counter advances when a
            # hit's qpos == last+1; the field sets when the chain reaches
            # query_word_count (distinct non-excluded positions) — qpos
            # gaps from stopwords/dupes stall the chain, so the target
            # can be reached before max qpos
            srow, spk, sqp, _ssl, sval = self._sorted_raw_stream()
            sfield = (spk >> 24) & 0xFF
            M = srow.shape[0]
            sidx = jnp.arange(M, dtype=jnp.int32)
            svalb = sval == 1
            rown = jnp.where(svalb, srow, N)
            cur = jnp.full((N + 1, F), -1, jnp.int32)
            alive2 = jnp.ones((N + 1, F), jnp.bool_)
            count = jnp.zeros((N + 1, F), jnp.int32)
            for qv in range(1, self.max_qpos + 1):
                m = (svalb & (sqp == qv)
                     & (sidx > cur[rown, sfield])
                     & alive2[rown, sfield])
                nxt = jnp.full((N + 1, F), M, jnp.int32).at[
                    jnp.where(m, rown, N),
                    jnp.where(m, sfield, 0)].min(jnp.where(m, sidx, M))
                found = nxt < M
                count = count + jnp.where(found & alive2, 1, 0)
                alive2 = alive2 & found
                cur = jnp.where(found, nxt, cur)
            target = self.rt["exact_target"][0] \
                if "exact_target" in self.rt else jnp.int32(S)
            return (count >= target).astype(jnp.int32)
        if name == "min_best_span_pos" and "qpos_fold" in rt:
            # dupe queries: the HANDLE_DUPES machine extends spans through
            # ANY dupe qpos whose qpos delta equals the position delta
            # (m_uCurQposMask>>iDelta & m_uLcsTailQposMask,
            # sphinxsearch.cpp:3358) — chain the RAW stream (unfolded
            # qpos) grouped by constant delta = pos - qpos, runs over
            # consecutive positions, min start among runs reaching lcs
            pos_mask = (1 << 23) - 1
            hrow, hpk, hqp, _hslot, valid = self.raw_stream
            row = jnp.where(valid, hrow, N).astype(jnp.int32)
            fld = ((hpk >> 24) & 0xFF).astype(jnp.int32)
            pos = (hpk & pos_mask).astype(jnp.int32)
            delta = jnp.where(valid, pos - hqp.astype(jnp.int32),
                              jnp.int32(1 << 24))
            srow, sfld, sdelta, spos = jax.lax.sort(
                (row, fld, delta, pos), num_keys=4)
            sval = (srow < N) & (sdelta < (1 << 24))
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            p_row = jnp.concatenate([jnp.full(1, -1, srow.dtype),
                                     srow[:-1]])
            p_fld = jnp.concatenate([jnp.full(1, -1, sfld.dtype),
                                     sfld[:-1]])
            p_dl = jnp.concatenate([jnp.full(1, -(1 << 24), sdelta.dtype),
                                    sdelta[:-1]])
            p_pos = jnp.concatenate([jnp.full(1, -9, spos.dtype),
                                     spos[:-1]])
            samekey = (srow == p_row) & (sfld == p_fld) & (sdelta == p_dl)
            linked = samekey & ((spos == p_pos + 1) | (spos == p_pos))
            run_start = jax.lax.cummax(jnp.where(linked, 0, idx))
            # same-(delta,pos) re-emissions count once
            hw = jnp.where(sval & ~(samekey & (spos == p_pos)), 1, 0
                           ).astype(jnp.int32)
            cumw = jnp.cumsum(hw)
            runw = cumw - cumw[run_start] + hw[run_start]
            lcs_here = self.lcs[jnp.where(sval, srow, N), sfld]
            best = sval & (runw >= lcs_here)
            start_pos = spos[run_start]
            big = jnp.int32(2**22)
            out = jnp.full((N + 1, F), big, jnp.int32).at[
                jnp.where(best, srow, N), sfld].min(
                jnp.where(best, start_pos, big))
            return jnp.where(out >= big, 0, out)
        if name == "min_best_span_pos":
            # position where the longest LCS span begins in the field
            # (m_iMinBestSpanPos): redo the LCS linked-run scan over the
            # sorted term stream, find runs whose weight reaches the
            # field's lcs, take the minimum start position. Exact for
            # keyword queries (phrase-emission spans rank via the kernel).
            pos_mask = (1 << 23) - 1
            srow, spk, sqp, sslot, sval = self._sorted_stream()
            sfield = (spk >> 24) & 0xFF
            spos = spk & pos_mask
            delta = spos - sqp
            p_row = jnp.concatenate([jnp.full(1, -1, srow.dtype), srow[:-1]])
            p_fld = jnp.concatenate([jnp.full(1, -1, sfield.dtype),
                                     sfield[:-1]])
            p_pk = jnp.concatenate([jnp.zeros(1, spk.dtype), spk[:-1]])
            p_delta = jnp.concatenate([jnp.zeros(1, delta.dtype), delta[:-1]])
            p_val = jnp.concatenate([jnp.zeros(1, sval.dtype), sval[:-1]])
            linked = ((srow == p_row) & (sfield == p_fld) & (spk > p_pk)
                      & (delta == p_delta) & (sval == 1) & (p_val == 1))
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            run_start = jax.lax.cummax(jnp.where(linked, 0, idx))
            hw = jnp.where(sval == 1, 1, 0).astype(jnp.int32)
            cumw = jnp.cumsum(hw)
            runw = cumw - cumw[run_start] + hw[run_start]
            lcs_here = self.lcs[jnp.where(sval == 1, srow, N), sfield]
            best = (sval == 1) & (runw >= lcs_here)
            start_pos = spos[run_start]
            big = jnp.int32(2**22)
            out = jnp.full((N + 1, F), big, jnp.int32).at[
                jnp.where(best, srow, N), sfield].min(
                jnp.where(best, start_pos, big))
            return jnp.where(out >= big, 0, out)
        if name in ("lccs", "wlccs"):
            # Longest Common Contiguous Subsequence between query and field
            # (sphinxsearch.cpp m_dLCCS/m_dWLCCS): a chain of hits where doc
            # position AND query position both advance by exactly 1. Same
            # segmented-scan formulation as the LCS ranker: sort the stream
            # by (row, packed pos), mark linked pairs, reset-cumsum runs,
            # per-field scatter-max. lccs counts keywords; wlccs sums idf.
            pos_mask = (1 << 23) - 1
            row = jnp.where(valid, hrow, N)
            pk = jnp.where(valid, hpk, 0)
            payload = (jnp.clip(hqp, 0, 255)
                       | (jnp.clip(hslot, 0, 255) << 8)
                       | (jnp.where(valid, 1, 0) << 16))
            srow, spk, spl = jax.lax.sort((row, pk, payload), num_keys=2)
            sqp = spl & 0xFF
            sslot = (spl >> 8) & 0xFF
            sval = (spl >> 16) & 1
            sfield = (spk >> 24) & 0xFF
            spos = spk & pos_mask
            p_row = jnp.concatenate([jnp.full(1, -1, srow.dtype), srow[:-1]])
            p_fld = jnp.concatenate([jnp.full(1, -1, sfield.dtype),
                                     sfield[:-1]])
            p_pos = jnp.concatenate([jnp.zeros(1, spos.dtype), spos[:-1]])
            p_qp = jnp.concatenate([jnp.zeros(1, sqp.dtype), sqp[:-1]])
            p_val = jnp.concatenate([jnp.zeros(1, sval.dtype), sval[:-1]])
            linked = ((srow == p_row) & (sfield == p_fld)
                      & (spos == p_pos + 1) & (sqp == p_qp + 1)
                      & (sval == 1) & (p_val == 1))
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            run_start = jax.lax.cummax(jnp.where(linked, 0, idx))
            if name == "lccs":
                hv = jnp.where(sval == 1, 1, 0).astype(jnp.int32)
            else:
                hv = jnp.where(sval == 1,
                               rt["idf"][jnp.clip(sslot, 0, S - 1)], 0.0)
            cumv = jnp.cumsum(hv)
            runv = cumv - cumv[run_start] + hv[run_start]
            out = jnp.zeros((N + 1, F), runv.dtype).at[
                jnp.where(sval == 1, srow, N), sfield].max(
                jnp.where(sval == 1, runv, jnp.zeros_like(runv)))
            return out
        if name == "min_gaps":
            # minimum gaps over windows containing every distinct matched
            # keyword of the field (UpdateMinGaps, sphinxsearch.cpp:3643):
            # classic minimum-window — for each window-end hit i, the start
            # is min over present slots of that slot's latest occurrence;
            # gaps = span - (distinct_words - 1) - 1.
            pos_mask = (1 << 23) - 1
            srow, spk, sqp, sslot, sval = self._sorted_stream()
            sfield = ((spk >> 24) & 0xFF).astype(jnp.int32)
            spos = (spk & pos_mask).astype(jnp.int32)
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            p_row = jnp.concatenate([jnp.full(1, -1, srow.dtype),
                                     srow[:-1]])
            p_fld = jnp.concatenate([jnp.full(1, -1, sfield.dtype),
                                     sfield[:-1]])
            head = (srow != p_row) | (sfield != p_fld)
            seg_id = jnp.cumsum(head.astype(jnp.int32)) - 1
            seen = self._seen_qword_field()      # [N+1, F, S]
            rowv = jnp.where(sval == 1, srow, N)
            W = jnp.sum(seen, axis=-1)[rowv, sfield]  # words in segment
            j_min = jnp.full(M, 2**30, jnp.int32)
            all_ok = jnp.ones(M, dtype=bool)
            for s in range(S):
                is_s = (sslot == s) & (sval == 1)
                last_s = jax.lax.cummax(jnp.where(is_s, idx, -1))
                lc = jnp.clip(last_s, 0, M - 1)
                ok_s = (last_s >= 0) & (seg_id[lc] == seg_id)
                present = seen[rowv, sfield, s] > 0
                j_min = jnp.where(present & ok_s,
                                  jnp.minimum(j_min, last_s), j_min)
                all_ok &= (~present) | ok_s
            jc = jnp.clip(j_min, 0, M - 1)
            gaps = spos - spos[jc] - (W - 1)
            valid = all_ok & (sval == 1) & (W >= 1)
            big = jnp.int32(2**30)
            out = jnp.full((N + 1, F), big, jnp.int32).at[
                jnp.where(valid, srow, N), sfield].min(
                jnp.where(valid, gaps, big))
            return jnp.where(out >= big, 0, out)
        if name == "atc" and "idf_by_qpos" in rt:
            # raw-stream ATC (UpdateATC walks every emission; dupe qpos
            # carry the first instance's idf, same-qpos pairs x0.25)
            pos_mask = (1 << 23) - 1
            srow, spk, sqp, _sslot, sval = self._sorted_raw_stream()
            sfield = ((spk >> 24) & 0xFF).astype(jnp.int32)
            spos = (spk & pos_mask).astype(jnp.int32)
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            idf_q = rt["idf_by_qpos"]
            Q = int(idf_q.shape[0])
            qc = jnp.clip(sqp, 0, Q - 1)
            nw = (self.max_qpos + 32) // 32
            tc = jnp.zeros(M, jnp.float32)
            for step in (-1, 1):
                seen_m = [jnp.zeros(M, jnp.int32) for _ in range(nw)]
                for d in range(1, 11):
                    j = idx + step * d
                    jc = jnp.clip(j, 0, M - 1)
                    ok = ((j >= 0) & (j < M) & (sval == 1)
                          & (srow[jc] == srow) & (sfield[jc] == sfield)
                          & (sval[jc] == 1))
                    q_j = jnp.clip(qc[jc], 0, nw * 32 - 1)
                    delta = jnp.abs(spos - spos[jc])
                    ok &= delta > 0
                    already = jnp.zeros(M, dtype=bool)
                    for w in range(nw):
                        already |= ((seen_m[w] >> (q_j & 31)) & 1
                                    ).astype(bool) & ((q_j >> 5) == w)
                    take = ok & ~already
                    dup = q_j == qc
                    contrib = idf_q[jnp.clip(q_j, 0, Q - 1)] / (
                        delta.astype(jnp.float32) ** jnp.float32(1.75))
                    contrib = jnp.where(dup, contrib * 0.25, contrib)
                    tc = tc + jnp.where(take, contrib, 0.0)
                    for w in range(nw):
                        seen_m[w] = seen_m[w] | jnp.where(
                            take & ((q_j >> 5) == w),
                            jnp.int32(1) << (q_j & 31), 0)
            A = self._sum_per_cell(srow, sfield, qc, sval == 1, tc, Q)
            # log(1.0f + ws) in f32 — the reference rounds 1+ws BEFORE the log
            # (UpdateATC, sphinxsearch.cpp:3992); log1p differs at ulp
            ws = jnp.sum(A * idf_q[None, None, :], axis=-1)
            return jnp.log(jnp.float32(1.0) + ws)
        if name == "atc":
            # aggregate term closeness (UpdateATC/TermTC, sphinxsearch.cpp
            # :3904-3995): per hit, sum idf(neighbor)/|dpos|^1.75 over the
            # nearest distinct-keyword neighbors within 10 stream hits each
            # way (same-keyword pairs x0.25, same-position skipped);
            # field atc = log(1 + sum_q atc_q * idf_q).
            pos_mask = (1 << 23) - 1
            srow, spk, sqp, sslot, sval = self._sorted_stream()
            sfield = ((spk >> 24) & 0xFF).astype(jnp.int32)
            spos = (spk & pos_mask).astype(jnp.int32)
            M = srow.shape[0]
            idx = jnp.arange(M, dtype=jnp.int32)
            idfv = rt["idf"][: max(S, 1)]
            slot_c = jnp.clip(sslot, 0, max(S - 1, 0))
            n_words = (max(S, 1) + 31) // 32
            tc = jnp.zeros(M, jnp.float32)
            for step in (-1, 1):
                seen_m = [jnp.zeros(M, jnp.int32) for _ in range(n_words)]
                for d in range(1, 11):
                    j = idx + step * d
                    jc = jnp.clip(j, 0, M - 1)
                    ok = ((j >= 0) & (j < M) & (sval == 1)
                          & (srow[jc] == srow) & (sfield[jc] == sfield)
                          & (sval[jc] == 1))
                    slot_j = slot_c[jc]
                    delta = jnp.abs(spos - spos[jc])
                    ok &= delta > 0            # same hitpos: skipped
                    already = jnp.zeros(M, dtype=bool)
                    for w in range(n_words):
                        already |= ((seen_m[w] >> (slot_j & 31)) & 1
                                    ).astype(bool) & ((slot_j >> 5) == w)
                    take = ok & ~already
                    dup = slot_j == slot_c
                    contrib = idfv[slot_j] / (
                        delta.astype(jnp.float32) ** jnp.float32(1.75))
                    contrib = jnp.where(dup, contrib * 0.25, contrib)
                    tc = tc + jnp.where(take, contrib, 0.0)
                    for w in range(n_words):
                        seen_m[w] = seen_m[w] | jnp.where(
                            take & ((slot_j >> 5) == w),
                            jnp.int32(1) << (slot_j & 31), 0)
            A = self._sum_per_cell(srow, sfield, slot_c, sval == 1, tc,
                                   max(S, 1))
            ws = jnp.sum(A * idfv[None, None, :], axis=-1)
            return jnp.log(jnp.float32(1.0) + ws)
        if name == "exact_hit":
            # field content == query: first hit at pos 1 and the field's
            # token count equals the lcs span (approximation of the
            # reference's exact-hit flag; TODO end-flag-based exactness)
            mh = self.get("min_hit_pos")
            return ((mh == 1) & (self.field_lens[:, :F] <= self.lcs)
                    ).astype(jnp.int32)
        raise NotImplementedError(f"ranking factor {name!r}")

    # ---- BM25 variants ------------------------------------------------
    def bm25a(self, k1: float, b: float):
        ftf = self._field_tf()                       # [N+1, F, S]
        tf = jnp.sum(ftf, axis=1).astype(jnp.float32)  # [N+1, S]
        dl = jnp.sum(self.field_lens[:, : self.F], axis=1
                     ).astype(jnp.float32) * jnp.float32(self.fl_bm25)
        avgdl = self.rt["avg_doc_len"][0]
        idf = self.rt["idf"][: self.S][None, :]
        norm = jnp.float32(k1) * (1.0 - b + b * dl[:, None] /
                                  jnp.maximum(avgdl, 1e-6))
        res = jnp.sum(jnp.where(tf > 0, tf / (tf + norm) * idf, 0.0),
                      axis=-1)
        return res + jnp.float32(0.5)

    def bm25f(self, k1: float, b: float, weights=None):
        # Expr_BM25F_T::Eval — literal
        ftf = self._field_tf().astype(jnp.float32)   # [N+1, F, S]
        if weights is None:
            w = jnp.ones(self.F, jnp.float32)
        else:
            w = weights.astype(jnp.float32)
        tf = jnp.sum(ftf * w[None, :, None], axis=1)  # [N+1, S]
        dl = jnp.float32(self.fl_bm25) * jnp.sum(
            self.field_lens[:, : self.F].astype(jnp.float32)
                     * w[None, :], axis=1)
        # weighted avgdl = sum_f total_field_len_f * w_f / total_docs
        avgdl = jnp.sum(self.rt["total_field_lens"] * w) / \
            jnp.maximum(self.rt["total_docs"][0], 1.0)
        idf = self.rt["idf"][: self.S][None, :]
        denom = tf + jnp.float32(k1) * (1.0 - b + b * dl[:, None] /
                                        jnp.maximum(avgdl, 1e-6))
        res = jnp.sum(jnp.where(tf > 0, tf / denom * idf, 0.0), axis=-1)
        return res + jnp.float32(0.5)


def eval_ranker_expr(tree, ctx: FactorContext, per_field: bool = False):
    """Evaluate a ranker formula tree to a [N+1] (or [N+1,F] inside sum)."""
    op = tree[0]
    if op == "num":
        return jnp.float32(tree[1])
    if op == "attr":
        name = tree[1].lower()
        if per_field:
            if name in FIELD_FACTORS:
                return ctx.get(name)
            if name in DOC_FACTORS:
                v = ctx.get(name)
                return v[..., None] if getattr(v, "ndim", 0) == 1 else v
            raise NotImplementedError(f"factor {name!r}")
        if name in DOC_FACTORS:
            return ctx.get(name)
        if name in FIELD_FACTORS:
            raise ValueError(
                f"field factor {name!r} only valid inside sum()")
        raise NotImplementedError(f"factor {name!r}")
    if op == "neg":
        return -eval_ranker_expr(tree[1], ctx, per_field)
    if op in ("add", "sub", "mul", "div", "cmp_gt", "cmp_ge", "cmp_lt",
              "cmp_le", "cmp_eq", "cmp_ne", "and", "or", "mod"):
        a = eval_ranker_expr(tree[1], ctx, per_field)
        b = eval_ranker_expr(tree[2], ctx, per_field)
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "div":
            return a / b
        if op == "mod":
            return a % b
        if op == "and":
            return ((a != 0) & (b != 0)).astype(jnp.float32)
        if op == "or":
            return ((a != 0) | (b != 0)).astype(jnp.float32)
        t = {"cmp_gt": a > b, "cmp_ge": a >= b, "cmp_lt": a < b,
             "cmp_le": a <= b, "cmp_eq": a == b, "cmp_ne": a != b}
        return t[op].astype(jnp.float32)
    if op == "call":
        name = tree[1].upper()
        args = tree[2]
        if name == "SUM":
            inner = eval_ranker_expr(args[0], ctx, per_field=True)
            return jnp.sum(inner.astype(jnp.float32), axis=-1)
        if name == "MAX_WINDOW_HITS":
            if not per_field:
                raise ValueError(
                    "max_window_hits() only valid inside sum()")
            return ctx.max_window_hits(int(args[0][1]))
        if name == "BM25A":
            k1 = args[0][1]
            b = args[1][1]
            return ctx.bm25a(float(k1), float(b))
        if name == "BM25F":
            k1 = float(args[0][1])
            b = float(args[1][1])
            weights = None
            if len(args) > 2 and args[2][0] == "fieldweights":
                # planner resolved {field=w,...} to schema field order
                weights = jnp.asarray(list(args[2][1]), jnp.float32)
            return ctx.bm25f(k1, b, weights)
        if name in ("MIN", "MAX"):
            a = eval_ranker_expr(args[0], ctx, per_field)
            b = eval_ranker_expr(args[1], ctx, per_field)
            return jnp.minimum(a, b) if name == "MIN" else jnp.maximum(a, b)
        if name == "ABS":
            return jnp.abs(eval_ranker_expr(args[0], ctx, per_field))
        if name == "IF":
            c = eval_ranker_expr(args[0], ctx, per_field)
            a = eval_ranker_expr(args[1], ctx, per_field)
            b = eval_ranker_expr(args[2], ctx, per_field)
            return jnp.where(c != 0, a, b)
        if name in ("LN", "LOG2", "LOG10", "SQRT", "EXP"):
            f = {"LN": jnp.log, "LOG2": jnp.log2, "LOG10": jnp.log10,
                 "SQRT": jnp.sqrt, "EXP": jnp.exp}[name]
            return f(eval_ranker_expr(args[0], ctx, per_field))
        if name == "POW":
            return jnp.power(eval_ranker_expr(args[0], ctx, per_field),
                             eval_ranker_expr(args[1], ctx, per_field))
        raise NotImplementedError(f"ranker function {name}()")
    raise NotImplementedError(f"ranker expr node {op!r}")
