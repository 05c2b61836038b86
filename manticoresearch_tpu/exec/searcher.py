"""Single-index search driver — the MultiQuery analog (sphinx.cpp:15362).

Ties together: FT parse -> plan -> compiled device program -> result
hydration (docids, attrs from host SoA copies) + per-query meta stats
(SHOW META semantics: total / total_found / per-word docs & hits).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..index.builder import PackedIndex
from ..ops.device_index import upload
from ..ops.search import INT32_MIN, get_batched_search_fn, get_search_fn
from ..query.ftparser import FtQueryParser
from ..query.planner import AttrFilterDef, CompiledQuery, plan_query
from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer


@dataclass
class SearchQuery:
    match: str = ""
    filters: list[AttrFilterDef] = dc_field(default_factory=list)
    # boolean combination of `filters` (WHERE with OR / parens):
    # ("leaf", i) | ("and"/"or", (children...)); None = AND of all
    filter_tree: tuple | None = None
    limit: int = 20
    offset: int = 0
    max_matches: int = 1000
    ranker: str = "proximity_bm25"
    field_weights: dict[str, int] = dc_field(default_factory=dict)
    # sort: list of (key, asc) — key is "weight", "id", or attr name.
    # None = implicit relevance sort (FUNC_REL_DESC: weight desc with
    # per-chunk-rowid tie order — distinct from an explicit
    # `ORDER BY weight() DESC, id ASC`, golden test_066)
    sort: list[tuple[str, bool]] | None = None
    idf_plain: bool = False
    tfidf_normalized: bool = True
    expansion_limit: int = 0             # max dict terms per wildcard
    boolean_simplify: bool = False       # opt-in boolean transforms
    expand_keywords: bool = False        # keyword -> (kw | kw* | =kw)
    global_idf: bool = False             # use the table's .idf file stats
    collation: str = "binary"            # string compare collation
    select: list[str] | None = None      # None = * (all attrs)
    cutoff: int = 0
    group_by: str | None = None          # attr name or expression
    group_n: int = 1                     # GROUP N BY: rows kept per group
    having: tuple | None = None          # (colname, op, value) host filter
    # WITHIN GROUP ORDER BY: which member represents the group
    # (sphinxsort m_sSortBy vs m_sGroupSortBy); None = weight desc, id asc
    within_sort: list[tuple[str, bool]] | None = None
    # OPTION not_terms_only_allowed=1 (searchdsql.cpp:744): a pure-NOT
    # query evaluates as fullscan-minus-matches instead of erroring
    not_only_allowed: bool = False
    # aggregates without GROUP BY (CSphImplicitGroupSorter): the rep-row
    # replace rule compares ROWID only (CheckReplaceEntry,
    # sphinxsort.cpp:4420), unlike explicit groupers
    implicit_group: bool = False


@dataclass
class WordStat:
    word: str
    docs: int
    hits: int


@dataclass
class Match:
    docid: int
    weight: int
    attrs: dict[str, Any]


@dataclass
class SearchResult:
    matches: list[Match]
    total: int            # matches available in the result window (<= max_matches)
    total_found: int      # total matching docs
    time_ms: float
    word_stats: list[WordStat]
    error: str | None = None
    warning: str | None = None
    profile: list = dc_field(default_factory=list)  # (stage, seconds) pairs
    # distributed merges: the minimized result schema over the parts that
    # actually returned matches (MinimizeSchemas skips empty result sets,
    # searchd.cpp:4305); None = use the table's static schema
    schema: object = None


class SearchIndex:
    """A searchable index: host PackedIndex + device arrays + text pipeline."""

    def __init__(self, packed: PackedIndex, device=None):
        self.packed = packed
        self.device = upload(packed, device)
        self.tokenizer = Tokenizer(packed.tokenizer_settings)
        self.dictionary = Dictionary(packed.dict_settings)
        self.parser = FtQueryParser(
            self.tokenizer, self.dictionary, packed.schema.fields
        )
        self._plan_cache: dict = {}

    @property
    def schema(self):
        return self.packed.schema

    @property
    def n_docs(self) -> int:
        return self.packed.n_docs

    def delete_documents(self, docids: list[int]) -> int:
        """Dead-row map update (DeadRowMap_c semantics, killlist.h:22)."""
        import jax.numpy as jnp

        alive = np.array(self.device.alive)  # writable host copy
        killed = 0
        for d in docids:
            r = self.packed.rowid_of_docid(int(d))
            if r >= 0 and alive[r]:
                alive[r] = False
                killed += 1
        if killed:
            self.device.alive = jnp.asarray(alive)
        return killed

    # ------------------------------------------------------------------
    def plan(self, q: SearchQuery) -> CompiledQuery:
        # plan cache (the spirit of sphinxqcache.cpp, applied to the
        # parse+plan stage): repeated query shapes skip AST work entirely.
        # Safe per index generation — this SearchIndex's CSR never mutates.
        emit_factors = _wants_packedfactors(q.select)
        key = (
            q.match, q.ranker, q.max_matches, q.offset + q.limit,
            tuple(q.sort or ()), q.idf_plain, q.tfidf_normalized,
            emit_factors,
            q.expansion_limit, q.boolean_simplify, q.expand_keywords,
            q.collation, q.not_only_allowed,
            tuple(sorted(q.field_weights.items())),
            tuple((f.attr, f.kind, tuple(f.values), f.lo, f.hi, f.exclude,
                   f.lo_excl, f.hi_excl) for f in q.filters),
            q.filter_tree,
        )
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        ast = self.parser.parse(q.match,
                                not_only_allowed=q.not_only_allowed)
        order = _resolve_order(q, self.schema)
        cq = plan_query(
            ast, self.packed,
            filters=q.filters, ranker=q.ranker, max_matches=q.max_matches,
            filter_tree=q.filter_tree, window=q.offset + q.limit,
            order=order, field_weights=q.field_weights,
            idf_plain=q.idf_plain, tfidf_normalized=q.tfidf_normalized,
            emit_factors=emit_factors, expansion_limit=q.expansion_limit,
            packed_store=self.packed.packed_store(),
            boolean_simplify=q.boolean_simplify,
            expand_keywords=q.expand_keywords,
            collation=q.collation,
        )
        if len(self._plan_cache) > 8192:
            self._plan_cache.clear()
        self._plan_cache[key] = cq
        return cq

    def search(self, q: SearchQuery) -> SearchResult:
        late = self._late_filters(q)
        if late:
            return self._search_late_filtered(q, late)
        if q.group_by:
            gb = q.group_by
            if "." in gb and self.schema.attr(gb) is None:
                base = gb.split(".", 1)[0]
                ad = self.schema.attr(base)
                if ad is not None and ad.type.value == "json":
                    return self._host_grouped(q)
            return self._search_grouped(q)
        primary = (q.sort or [("weight", False)])[0][0]
        if "." in primary and primary not in ("weight()",):
            base = primary.split(".", 1)[0]
            ad = self.schema.attr(base)
            if ad is not None and ad.type.value == "json":
                # JSON-path ORDER BY: fetch the match window (bounded by
                # max_matches, like the reference sorter) and host-sort
                from dataclasses import replace as _rep
                from .multi import _apply_sort
                wide = _rep(q, sort=[("weight", False), ("id", True)],
                            offset=0, limit=q.max_matches)
                res = self.search(wide)
                if res.error:
                    return res
                _apply_sort(res.matches, q)
                res.matches = res.matches[q.offset:q.offset + q.limit]
                return res
        t0 = time.perf_counter()
        prof: list[tuple[str, float]] = []
        try:
            cq = self.plan(q)
        except (ValueError, NotImplementedError) as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        prof.append(("parse_and_plan", time.perf_counter() - t0))

        from ..ops.search import plan_shape_was_warm
        warm = plan_shape_was_warm(
            cq.sig, self.packed.n_docs, max(self.schema.n_fields, 1),
            cq.slot_pb, cq.slot_hb, cq.n_hit_iters)
        fn = get_search_fn(
            cq.sig, self.packed.n_docs, max(self.schema.n_fields, 1),
            cq.slot_pb, cq.slot_hb, cq.n_hit_iters,
        )
        t1 = time.perf_counter()
        out = fn(self.device.data_pytree(), cq.runtime)
        rowids = np.asarray(out["rowid"])
        weights = np.asarray(out["weight"])
        found = int(out["found"])
        prof.append(("device_exec_fetch", time.perf_counter() - t1))
        t2 = time.perf_counter()
        res = self._finish(q, cq, rowids, weights, found, t0,
                           pf_out=out if cq.sig.emit_factors else None)
        prof.append(("finalize", time.perf_counter() - t2))
        res.profile = prof
        res.warm_plan = warm
        if getattr(cq, "warning", ""):
            res.warning = cq.warning
        from ..query.explain import render_plan
        res.plan_repr = render_plan(cq.ast, self.schema)
        return res

    def search_batch(self, queries: list[SearchQuery]) -> list[SearchResult]:
        """Batched execution: queries grouped by plan shape share ONE device
        launch and ONE packed result fetch (multi-query optimization,
        sphinx.cpp:15474 — each device->host fetch has a fixed cost)."""
        t0 = time.perf_counter()
        results: list[SearchResult | None] = [None] * len(queries)
        groups: dict[tuple, list[int]] = {}
        plans: list[CompiledQuery | None] = [None] * len(queries)
        deferred: list[tuple[int, object]] = []
        g_groups: dict[tuple, list[int]] = {}
        g_plans: dict[int, tuple] = {}
        for i, q in enumerate(queries):
            if q.group_by:
                gb = q.group_by
                if "." in gb and self.schema.attr(gb) is None:
                    results[i] = self.search(q)     # host-grouped path
                    continue
                try:
                    plan = self._plan_grouped(q)
                except (ValueError, NotImplementedError) as e:
                    results[i] = SearchResult([], 0, 0, 0.0, [],
                                              error=str(e))
                    continue
                (cq, gspec, aggs, agg_names, plain_cols, gconcats,
                 k) = plan
                if gconcats:
                    # GROUP_CONCAT needs the dense eligible mask — keep
                    # the overlapped single-launch path
                    _, fin = self._search_grouped(q, _defer=True)
                    deferred.append((i, fin))
                    continue
                g_plans[i] = plan
                gkey = (cq.sig, gspec, cq.slot_pb, cq.slot_hb,
                        cq.n_hit_iters)
                g_groups.setdefault(gkey, []).append(i)
                continue
            try:
                cq = self.plan(q)
            except (ValueError, NotImplementedError) as e:
                results[i] = SearchResult([], 0, 0, 0.0, [], error=str(e))
                continue
            plans[i] = cq
            key = (cq.sig, cq.slot_pb, cq.slot_hb, cq.n_hit_iters)
            groups.setdefault(key, []).append(i)

        import jax

        data = self.device.data_pytree()
        # phase 1: dispatch every group's launch asynchronously
        pending = []
        for (sig, pb, hb, nhi), idxs in groups.items():
            fn = get_batched_search_fn(
                sig, self.packed.n_docs, max(self.schema.n_fields, 1),
                pb, hb, nhi)
            # pad the batch dim to a pow2 so group size doesn't multiply
            # compile shapes (dummy slots repeat the last query)
            B = 1
            while B < len(idxs):
                B <<= 1
            padded = [plans[i].runtime for i in idxs]
            padded += [padded[-1]] * (B - len(padded))
            rt_b = jax.tree.map(lambda *xs: np.stack(xs), *padded)
            pending.append((sig, idxs, fn(data, rt_b)))
        # grouped queries batch the same way (one launch + shared fetch per
        # plan shape — the FACET multi-sorter single pass)
        from ..ops.groupby import get_batched_groupby_fn
        g_pending = []
        for (sig, gspec, pb, hb, nhi), idxs in g_groups.items():
            fn = get_batched_groupby_fn(
                sig, gspec, self.packed.n_docs,
                max(self.schema.n_fields, 1), pb, hb, nhi)
            B = 1
            while B < len(idxs):
                B <<= 1
            padded = [g_plans[i][0].runtime for i in idxs]
            padded += [padded[-1]] * (B - len(padded))
            rt_b = jax.tree.map(lambda *xs: np.stack(xs), *padded)
            g_pending.append((gspec, idxs, fn(data, rt_b)))
        # phase 2: ONE device->host fetch — group outputs concatenated on
        # device first (every separate fetch has a fixed cost)
        outs = [p[2] for p in pending] + [p[2] for p in g_pending]
        if len(outs) > 1:
            import jax.numpy as jnp
            flat = jnp.concatenate([o.reshape(-1) for o in outs])
            flat_host = np.asarray(flat)
            fetched = []
            off = 0
            for o in outs:
                size = int(np.prod(o.shape))
                fetched.append(flat_host[off:off + size].reshape(o.shape))
                off += size
        else:
            fetched = [np.asarray(o) for o in outs]
        g_fetched = fetched[len(pending):]
        # phase 3: unpack
        for (sig, idxs, _), packed_out in zip(pending, fetched):
            k = sig.k
            for bi, i in enumerate(idxs):
                row = packed_out[bi]
                results[i] = self._finish(
                    queries[i], plans[i], row[:k], row[k:2 * k],
                    int(row[2 * k]), t0)
        for (gspec, idxs, _), pout in zip(g_pending, g_fetched):
            k = gspec.k
            for bi, i in enumerate(idxs):
                row = pout[bi]
                (cq, gspec_i, aggs, agg_names, plain_cols, gconcats,
                 kk) = g_plans[i]
                out = {"rep_rowid": row[0:k], "rep_weight": row[k:2 * k],
                       "group_key": row[2 * k:3 * k],
                       "count": row[3 * k:4 * k],
                       "n_groups": int(row[-2]), "found": int(row[-1])}
                off2 = 4 * k
                for j, a in enumerate(aggs):
                    arr = row[off2:off2 + k]
                    off2 += k
                    if a.kind == "avg" or (a.is_float and a.kind in
                                           ("sum", "min", "max")):
                        arr = arr.view(np.float32)
                    out[f"agg{j}"] = arr
                results[i] = self._render_grouped(
                    queries[i], cq, gspec_i, out, list(aggs),
                    list(agg_names), list(plain_cols), list(gconcats),
                    kk, t0)
        # phase 4: GROUP_CONCAT stragglers — launches have been in flight
        # since phase 0; the fetches now drain overlapped device work
        for i, fin in deferred:
            results[i] = fin()
        return results  # type: ignore[return-value]

    def _late_filters(self, q: SearchQuery) -> list:
        return late_filters_for(q, self.schema)

    def _search_late_filtered(self, q: SearchQuery,
                              late: list) -> SearchResult:
        return run_late_filtered(self.search, q, late)

    def _host_grouped(self, q: SearchQuery) -> SearchResult:
        """GROUP BY over a JSON path: the key is host-evaluated per match
        (the reference also computes JSON grouping via host expressions);
        aggregates reduce in Python over the match window (bounded by
        max_matches)."""
        import re as _re
        from dataclasses import replace as _rep

        from ..query.expr import ExprError, eval_expr_host, parse_expr

        t0 = time.perf_counter()
        try:
            parse_expr(q.group_by)
        except ExprError as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        base_q = _rep(q, group_by=None, select=None, having=None,
                      sort=(q.within_sort
                            or [("weight", False), ("id", True)]),
                      offset=0, limit=q.max_matches)
        res = self.search(base_q)
        if res.error:
            return res
        rows, total = self._host_group_body(res.matches, q)
        dt = (time.perf_counter() - t0) * 1000.0
        return SearchResult(rows, total, total, dt, res.word_stats)


    def _host_group_body(self, matches, q):
        # one index = one grouper streaming matches in scan order: the
        # rep-row rules are the sorter's own push rules (shared_grouper)
        return host_group_matches(matches, q, shared_grouper=True)

    def _search_grouped(self, q: SearchQuery, _defer: bool = False):
        """GROUP BY execution (CSphKBufferGroupSorter semantics via the
        sort-segment-reduce tail, ops/groupby.py).

        _defer=True returns (launched, finish): the device launch happens
        immediately (async dispatch) and finish() does the blocking
        fetch + rendering — search_batch overlaps grouped launches this
        way instead of paying launch+RTT serially per query."""
        import re as _re

        from ..ops.groupby import AggSpec, GroupSpec, get_groupby_fn
        from ..query.expr import infer_is_float, parse_expr

        t0 = time.perf_counter()
        if self.packed.n_docs == 0:
            res = SearchResult([], 0, 0, 0.0, [])
            if _defer:
                return True, (lambda: res)
            return res
        gb_ad = self.schema.attr(q.group_by)
        # bigint keys group host-side: the device key array is i32-clipped,
        # which would collapse distinct 64-bit values (golden test_050)
        host_only = (gb_ad is not None
                     and gb_ad.type.value in ("multi", "multi64",
                                              "bigint"))
        if gb_ad is None and self._expr_refs_bigint(q.group_by):
            host_only = True   # expression keys over bigint attrs too
        if getattr(q, "group_n", 1) > 1:
            host_only = True   # GROUP N BY emits N member rows per group
        if q.within_sort:
            wad = self.schema.attr(q.within_sort[0][0])
            if wad is not None and wad.type.value not in (
                    "int", "bigint", "bool", "timestamp", "float"):
                host_only = True   # string/JSON rep order: host compare
        if host_only:
            # GROUP BY an MVA attr duplicates the match into one group
            # per value (sphinxsort MVA group iterator) — host-grouped
            res = self._host_grouped(q)
            if _defer:
                return True, (lambda: res)
            return res
        try:
            plan = self._plan_grouped(q)
        except (ValueError, NotImplementedError) as e:
            err = SearchResult([], 0, 0, 0.0, [], error=str(e))
            if _defer:
                return True, (lambda: err)
            return err
        (cq, gspec, aggs, agg_names, plain_cols, gconcats, k) = plan

        from ..query.expr import ExprError
        try:
            fn = get_groupby_fn(
                cq.sig, gspec, self.packed.n_docs,
                max(self.schema.n_fields, 1),
                cq.slot_pb, cq.slot_hb, cq.n_hit_iters)
            out = fn(self.device.data_pytree(), cq.runtime)
        except ExprError:
            # aggregate references a host-only value (e.g.
            # COUNT(DISTINCT id): 64-bit ids live host-side) — host-group
            res = self._host_grouped(q)
            if _defer:
                return True, (lambda: res)
            return res

        def _finish_grouped():
            return self._render_grouped(
                q, cq, gspec, out, aggs, agg_names, plain_cols, gconcats,
                k, t0)
        if _defer:
            return True, _finish_grouped
        return _finish_grouped()

    def _expr_refs_bigint(self, expr_text: str) -> bool:
        """True when an expression references a bigint attr — such keys
        must group host-side (device arrays are i32-clipped)."""
        from ..query.expr import parse_expr
        try:
            tree = parse_expr(expr_text)
        except Exception:   # noqa: BLE001 — non-expr keys group elsewhere
            return False
        found = False

        def walk(t):
            nonlocal found
            if isinstance(t, (list, tuple)):
                if len(t) >= 2 and t[0] == "attr" \
                        and isinstance(t[1], str):
                    ad = self.schema.attr(t[1])
                    if ad is not None and ad.type.value == "bigint":
                        found = True
                for x in t:
                    if isinstance(x, (list, tuple)):
                        walk(x)
        walk(tree)
        return found

    def _plan_grouped(self, q: SearchQuery):
        """Plan a device GROUP BY query: (cq, gspec, aggs, agg_names,
        plain_cols, gconcats, k). Raises ValueError/NotImplementedError on
        unsupported shapes (caller falls back or errors)."""
        import re as _re

        from ..ops.groupby import AggSpec, GroupSpec
        from ..query.expr import infer_is_float, parse_expr

        ast = self.parser.parse(q.match,
                                not_only_allowed=q.not_only_allowed)
        cq = plan_query(
            ast, self.packed,
            filters=q.filters, ranker=q.ranker,
            filter_tree=q.filter_tree,
            max_matches=q.max_matches, window=q.offset + q.limit,
            order=("rel",), field_weights=q.field_weights,
            idf_plain=q.idf_plain, tfidf_normalized=q.tfidf_normalized,
            packed_store=self.packed.packed_store(),
        )
        key_expr = parse_expr(q.group_by)

        agg_re = _re.compile(
            r"^\s*(count|sum|min|max|avg)\s*\(\s*(distinct\s+)?(.*?)\s*\)\s*$",
            _re.IGNORECASE)
        gc_re = _re.compile(
            r"^\s*group_concat\s*\(\s*(.*?)\s*\)\s*$", _re.IGNORECASE)
        aggs: list[AggSpec] = []
        agg_names: list[str] = []
        plain_cols: list[str] = []
        gconcats: list[tuple[str, str]] = []
        for sel in (q.select or ["count(*)"]):
            gm = gc_re.match(sel)
            if gm:
                # GROUP_CONCAT runs host-side over the match mask
                # (sphinxsort.cpp:1904+ computes it on CPU too)
                if self.schema.attr(q.group_by) is None:
                    raise NotImplementedError(
                        "GROUP_CONCAT requires a plain-attribute "
                        "GROUP BY")
                gconcats.append((sel, gm.group(1)))
                continue
            m = agg_re.match(sel)
            if not m:
                if sel == "*":
                    # SELECT * in a grouped query returns every attr of
                    # the group's representative row
                    plain_cols.extend(
                        a.name for a in self.schema.attrs
                        if a.name != q.group_by
                        and a.name not in plain_cols)
                elif sel not in ("id", "weight()") and sel != q.group_by:
                    plain_cols.append(sel)
                continue
            kind = m.group(1).lower()
            arg = m.group(3)
            arg_ad = self.schema.attr(arg.strip())
            if kind != "count" and arg_ad is not None and \
                    arg_ad.type.value in ("multi", "multi64", "string",
                                          "json"):
                raise ValueError(
                    f"can not aggregate non-scalar attribute "
                    f"'{arg.strip()}'")
            if kind == "count" and m.group(2):
                aggs.append(AggSpec("count_distinct", parse_expr(arg)))
            elif kind == "count":
                aggs.append(AggSpec("count", None))
            else:
                tree = parse_expr(arg)
                aggs.append(AggSpec(
                    kind, tree, infer_is_float(tree, self.schema)))
            agg_names.append(sel)
        if "count(*)" not in [a.lower().replace(" ", "")
                              for a in agg_names]:
            aggs.append(AggSpec("count", None))
            agg_names.append("count(*)")

        order = _resolve_group_order(q, self.schema)
        within: tuple = ("rel",)
        if q.within_sort:
            wname, wasc = q.within_sort[0]
            if wname in ("weight", "@weight", "weight()"):
                within = ("rel",)
            elif wname in ("id", "@id"):
                within = ("rowid", wasc)
            else:
                wad = self.schema.attr(wname)
                if wad is None:
                    raise ValueError(
                        f"unknown WITHIN GROUP ORDER BY attr {wname!r}")
                within = ("attr", wname, wasc, wad.type.value == "float")
        k = max(1, min(q.max_matches, q.offset + q.limit,
                       max(self.packed.n_docs, 1)))
        gspec = GroupSpec(key_expr=key_expr, aggs=tuple(aggs),
                          order=order, k=k,
                          emit_eligible=bool(gconcats), within=within)
        return (cq, gspec, tuple(aggs), tuple(agg_names),
                tuple(plain_cols), tuple(gconcats), k)

    def _render_grouped(self, q, cq, gspec, out, aggs, agg_names,
                        plain_cols, gconcats, k, t0) -> SearchResult:
        rep_rowid = np.asarray(out["rep_rowid"])
        rep_weight = np.asarray(out["rep_weight"])
        gkey = np.asarray(out["group_key"])
        count = np.asarray(out["count"])
        n_groups = int(out["n_groups"])

        n_avail = min(n_groups, k)
        gb_ad = self.schema.attr(q.group_by)
        str_uniq = (self.packed.str_ordinals(q.group_by)[0]
                    if gb_ad is not None and gb_ad.type.value == "string"
                    else None)
        rows = []
        for i in range(n_avail):
            r = int(rep_rowid[i])
            if str_uniq is not None:
                gv = int(gkey[i])
                keyval = str_uniq[gv] if 0 <= gv < len(str_uniq) else ""
            else:
                keyval = int(gkey[i])
            attrs = {q.group_by: keyval}
            for j, name in enumerate(agg_names):
                a = aggs[j]
                if a.kind == "count":
                    attrs[name] = int(count[i])
                else:
                    v = np.asarray(out[f"agg{j}"])[i]
                    attrs[name] = float(v) if a.kind == "avg" or a.is_float \
                        else int(v)
            need = set(plain_cols or [])
            # projection expressions re-evaluate over the rep match's
            # attrs: hydrate every schema attr a select expr references
            # (select ((idd265-1000) mod 3) i ... group by i, test_183)
            import re as _re2
            for sel in (q.select or []):
                for tok in _re2.findall(r"[A-Za-z_][A-Za-z_0-9]*", sel):
                    if self.schema.attr(tok) is not None:
                        need.add(tok)
            base = self._hydrate(np.asarray([r]), np.asarray([rep_weight[i]]),
                                 sorted(need))
            attrs.update(base[0].attrs)
            attrs["@groupby"] = keyval
            rows.append(Match(base[0].docid, int(rep_weight[i]), attrs))

        if gconcats:
            elig = np.asarray(out["eligible"])[: self.packed.n_docs]
            keycol = self._host_column(q.group_by)
            live = np.nonzero(elig)[0]
            for sel, arg in gconcats:
                argcol = self._host_column(arg)
                mp: dict = {}
                for r in live:
                    mp.setdefault(keycol[int(r)], []).append(
                        str(argcol[int(r)]))
                joined = {k2: ",".join(v) for k2, v in mp.items()}
                for m2 in rows:
                    m2.attrs[sel] = joined.get(m2.attrs.get(q.group_by), "")

        if q.having is not None:
            col, op_s, val = q.having
            import operator as _op
            ops = {"=": _op.eq, "!=": _op.ne, "<>": _op.ne, "<": _op.lt,
                   "<=": _op.le, ">": _op.gt, ">=": _op.ge}
            rows = [m for m in rows
                    if ops[op_s](m.attrs.get(col, m.weight
                                 if col in ("weight()", "@weight") else 0),
                                 val)]

        rows = rows[q.offset:q.offset + q.limit]
        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in cq.stat_list]
        return SearchResult(rows, min(n_groups, q.max_matches), n_groups,
                            dt, stats)

    def _finish(self, q: SearchQuery, cq: CompiledQuery,
                rowids: np.ndarray, weights: np.ndarray, found: int,
                t0: float, pf_out=None) -> SearchResult:
        if q.cutoff:
            # OPTION cutoff=N (reference: stop after N matches; with a full
            # vector pass the observable semantics are the caps)
            found = min(found, q.cutoff)
        n_avail = min(found, cq.sig.k)
        sel = np.arange(n_avail)
        rowids = rowids[:n_avail]
        weights = weights[:n_avail]
        if cq.sig.order[0] == "rel":
            keep = weights != INT32_MIN
            rowids, weights, sel = rowids[keep], weights[keep], sel[keep]

        lo = min(q.offset, len(rowids))
        hi = min(q.offset + q.limit, len(rowids))
        rowids, weights, sel = rowids[lo:hi], weights[lo:hi], sel[lo:hi]

        matches = self._hydrate(rowids, weights, q.select)
        for m, r in zip(matches, rowids.tolist()):
            # physical row id within this part — RT part merges tie-break
            # on it (MatchRelevanceLt_fn rowid compare; multi.py heap)
            m._rowid = int(r)
        if pf_out is not None:
            pf = {k: np.asarray(v) for k, v in pf_out.items()
                  if k.startswith("pf_")}
            pf_keys = [s2 for s2 in (q.select or [])
                       if s2.lower().replace(" ", "").startswith(
                           "packedfactors(")]
            for m, j in zip(matches, sel.tolist()):
                for pk in (pf_keys or ["packedfactors()"]):
                    as_json = "json=1" in pk.lower().replace(" ", "")
                    m.attrs[pk] = _render_packed_factors(
                        pf, j, self.schema.fields, cq.slot_terms,
                        cq.runtime, as_json=as_json)
        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in cq.stat_list]
        total = min(found, q.max_matches)
        res = SearchResult(matches, total, found, dt, stats)
        from ..query.explain import render_plan
        res.plan_repr = render_plan(cq.ast, self.schema)
        return res

    def _host_column(self, name: str):
        """One attribute as a host-side per-row sequence (actual values —
        strings, not ordinals)."""
        p = self.packed
        if name == "id":
            return p.doc_ids
        for store in (p.attrs_int, p.attrs_big, p.attrs_float, p.attrs_str,
                      p.attrs_json, p.stored_fields):
            if name in store:
                return store[name]
        raise ValueError(f"unknown attribute {name!r}")

    def _hydrate(self, rowids: np.ndarray, weights: np.ndarray,
                 select: list[str] | None) -> list[Match]:
        p = self.packed
        out = []
        attr_names = (
            select if select is not None
            else [a.name for a in p.schema.attrs] + list(p.stored_fields)
        )
        for r, w in zip(rowids.tolist(), weights.tolist()):
            attrs: dict[str, Any] = {}
            for name in attr_names:
                if name in ("id", "weight()", "weight"):
                    continue
                if "." in name and name.split(".", 1)[0] in p.attrs_json:
                    name = name.split(".", 1)[0]   # hydrate the JSON base
                if name in p.attrs_int:
                    attrs[name] = int(p.attrs_int[name][r])
                elif name in p.attrs_big:
                    attrs[name] = int(p.attrs_big[name][r])
                elif name in p.attrs_float:
                    attrs[name] = float(p.attrs_float[name][r])
                elif name in p.attrs_str:
                    attrs[name] = p.attrs_str[name][r]
                elif name in p.attrs_json:
                    attrs[name] = p.attrs_json[name][r]
                elif name in p.attrs_mva:
                    off, vals = p.attrs_mva[name]
                    attrs[name] = [int(x) for x in vals[off[r]:off[r + 1]]]
                elif name in p.stored_fields:
                    # docstore hydration (stored full-text fields)
                    attrs[name] = p.stored_fields[name][r]
            out.append(Match(int(p.doc_ids[r]), int(w), attrs))
        return out


def _wants_packedfactors(select) -> bool:
    return any(s.lower().replace(" ", "").startswith("packedfactors(")
               for s in (select or []))


def _render_packed_factors(pf: dict, j: int, fields, slot_terms,
                           runtime, as_json: bool = False) -> str:
    """Text form of the factor blob (PACKEDFACTORS() / the SPH_UDF_FACTORS
    layout rendered like the reference's ToString path): doc-level factors,
    then per-field blocks for matched fields, then per-word tf/idf."""
    def _f(v):
        # PrintVarFloat (sphinxutils.cpp:2377): "%f" (6 decimals) when it
        # round-trips to the same float32, else "%1.8f"
        f32 = np.float32(v)
        s2 = f"{float(f32):.6f}"
        if np.float32(float(s2)) == f32:
            return s2
        return f"{float(f32):.8f}"

    if as_json:
        fields_out = []
        for f, fname in enumerate(fields):
            if not int(pf["pf_hit_count"][j, f]):
                continue
            fields_out.append(
                f'{{"field":{f}, "lcs":{int(pf["pf_lcs"][j, f])}, '
                f'"hit_count":{int(pf["pf_hit_count"][j, f])}, '
                f'"word_count":{int(pf["pf_word_count"][j, f])}, '
                f'"tf_idf":{_f(pf["pf_tf_idf"][j, f])}, '
                f'"min_idf":{_f(pf["pf_min_idf"][j, f])}, '
                f'"max_idf":{_f(pf["pf_max_idf"][j, f])}, '
                f'"sum_idf":{_f(pf["pf_sum_idf"][j, f])}, '
                f'"min_hit_pos":{int(pf["pf_min_hit_pos"][j, f])}, '
                f'"min_best_span_pos":'
                f'{int(pf["pf_min_best_span_pos"][j, f])}, '
                f'"exact_hit":{int(pf["pf_exact_hit"][j, f])}, '
                f'"max_window_hits":'
                f'{int(pf["pf_max_window_hits"][j, f])}, '
                f'"min_gaps":{int(pf["pf_min_gaps"][j, f])}, '
                f'"exact_order":{int(pf["pf_exact_order"][j, f])}, '
                f'"lccs":{int(pf["pf_lccs"][j, f])}, '
                f'"wlccs":{_f(pf["pf_wlccs"][j, f])}, '
                f'"atc":{_f(pf["pf_atc"][j, f])}}}')
        idf = np.asarray(runtime["idf"])
        words_out = []
        for s, term in enumerate(slot_terms):
            tf = int(pf["pf_word_tf"][j, s])
            if tf:
                words_out.append(f'{{"tf":{tf}, "idf":{_f(idf[s])}}}')
        return (f'{{"bm25":{int(pf["pf_bm25"][j])}, '
                f'"bm25a":{_f(pf["pf_bm25a"][j])}, '
                f'"field_mask":{int(pf["pf_field_mask"][j])}, '
                f'"doc_word_count":{int(pf["pf_doc_word_count"][j])}, '
                f'"fields":[{", ".join(fields_out)}], '
                f'"words":[{", ".join(words_out)}]}}')
    parts = [
        f"bm25={int(pf['pf_bm25'][j])}, "
        f"bm25a={_f(pf['pf_bm25a'][j])}, "
        f"field_mask={int(pf['pf_field_mask'][j])}, "
        f"doc_word_count={int(pf['pf_doc_word_count'][j])}",
    ]
    for f, fname in enumerate(fields):
        if not int(pf["pf_hit_count"][j, f]):
            continue
        parts.append(
            f"field{f}=(lcs={int(pf['pf_lcs'][j, f])}, "
            f"hit_count={int(pf['pf_hit_count'][j, f])}, "
            f"word_count={int(pf['pf_word_count'][j, f])}, "
            f"tf_idf={_f(pf['pf_tf_idf'][j, f])}, "
            f"min_idf={_f(pf['pf_min_idf'][j, f])}, "
            f"max_idf={_f(pf['pf_max_idf'][j, f])}, "
            f"sum_idf={_f(pf['pf_sum_idf'][j, f])}, "
            f"min_hit_pos={int(pf['pf_min_hit_pos'][j, f])}, "
            f"min_best_span_pos={int(pf['pf_min_best_span_pos'][j, f])}, "
            f"exact_hit={int(pf['pf_exact_hit'][j, f])}, "
            f"max_window_hits={int(pf['pf_max_window_hits'][j, f])}, "
            f"min_gaps={int(pf['pf_min_gaps'][j, f])}, "
            f"exact_order={int(pf['pf_exact_order'][j, f])}, "
            f"lccs={int(pf['pf_lccs'][j, f])}, "
            f"wlccs={_f(pf['pf_wlccs'][j, f])}, "
            f"atc={_f(pf['pf_atc'][j, f])})")
    idf = np.asarray(runtime["idf"])
    qpos_r = np.asarray(runtime.get("qpos", np.arange(1, len(slot_terms) + 1)))
    for s, term in enumerate(slot_terms):
        tf = int(pf["pf_word_tf"][j, s])
        if tf:
            # word index = query position - 1 (PackFactors iterates
            # qpos entries; dupes leave gaps: word0..word2, word4, word6)
            wi = int(qpos_r[s]) - 1 if s < len(qpos_r) else s
            parts.append(f"word{wi}=(tf={tf}, idf={_f(idf[s])})")
    return ", ".join(parts)


def _resolve_group_order(q: SearchQuery, schema) -> tuple:
    sort = q.sort or [("weight", False), ("id", True)]
    primary, asc = sort[0]
    p = primary.lower().replace(" ", "")
    if p in ("weight", "@weight", "weight()"):
        return ("rel",)
    if p in ("@count", "count(*)"):
        return ("count", asc)
    if p in ("@groupby", "groupby()") or primary == q.group_by:
        return ("gkey", asc)
    if p in ("id", "@id"):
        return ("rowid", asc)
    ad = schema.attr(primary)
    if ad is not None:
        return ("attr", primary, asc, ad.type.value == "float")
    raise ValueError(f"unsupported group ORDER BY {primary!r}")


def _resolve_order(q: SearchQuery, schema) -> tuple:
    sort = q.sort or [("weight", False), ("id", True)]
    primary, asc = sort[0]
    if primary in ("weight", "@weight", "weight()"):
        if not asc:
            return ("rel",)
        # ORDER BY weight ASC — rare; treat as attr sort on weight TODO
        return ("rel",)
    if primary in ("id", "@id"):
        # docid order == rowid order; device sorts by rowid via attr path on
        # a synthetic key — use rel for now when asc (rowids ascending)
        return ("attr_id", asc)
    ad = schema.attr(primary)
    if ad is None:
        # per-index sorter setup failure (sortsetup.cpp:407); over a
        # multi-part FROM this drops just this part from the merge
        # (golden test_163 'order by str2' over dist1)
        raise ValueError(f"sort-by attribute '{primary}' not found")
    is_float = ad.type.value == "float"
    return ("attr", primary, asc, is_float)


def late_filters_for(q, schema) -> list:
    """Filters naming a computed expression instead of an attr (the
    reference's late-stage filters, sphinxfilter.cpp expr filters):
    evaluated host-side over the match window."""
    from ..query.expr import ExprError, parse_expr
    out = []
    for f in q.filters:
        nm = f.attr
        ad = schema.attr(nm)
        if ad is not None and ad.type.value in ("multi", "multi64") \
                and any(abs(int(v)) > 2**31 - 1
                        for v in (f.values or [])
                        ) or (ad is not None
                              and ad.type.value in ("multi", "multi64")
                              and any(x is not None
                                      and abs(int(x)) > 2**31 - 1
                                      for x in (f.lo, f.hi))):
            # 64-bit MVA filter values exceed the device's i32 value
            # pool — evaluate host-side over the match window
            # (golden test_140 multi64 equality)
            out.append(f)
            continue
        if ad is not None or nm in ("id", "@id"):
            continue
        import re as _re
        if _re.fullmatch(r"\w+(\.\w+)+", nm):
            base = nm.split(".", 1)[0]
            ad = schema.attr(base)
            if ad is not None and ad.type.value == "json":
                continue   # JSON-path filters run on their own path
        try:
            parse_expr(nm)
        except ExprError:
            continue   # let the planner report the unknown attr
        out.append(f)
    return out


def run_late_filtered(search_fn, q, late):
    """Strip late filters, run wide via search_fn, post-filter host-side."""
    from dataclasses import replace as _rep

    from ..query.expr import ExprError, eval_expr_host, parse_expr
    lset = {id(f) for f in late}
    wide = _rep(q, filters=[f for f in q.filters if id(f) not in lset],
                offset=0, limit=q.max_matches)
    res = search_fn(wide)
    if res.error:
        return res
    trees = [(parse_expr(f.attr), f) for f in late]

    def passes(m) -> bool:
        for tree, f in trees:
            try:
                v = eval_expr_host(tree, m.attrs, m.weight, m.docid)
            except ExprError:
                return False
            vs = v if isinstance(v, (list, tuple)) else [v]
            if f.kind == "values":
                ok = any(x in f.values for x in vs)
            else:
                def in_range(x):
                    if x is None:
                        return False
                    if f.lo is not None and (
                            x < f.lo or (f.lo_excl and x == f.lo)):
                        return False
                    if f.hi is not None and (
                            x > f.hi or (f.hi_excl and x == f.hi)):
                        return False
                    return True
                ok = any(in_range(x) for x in vs)
            if ok == bool(f.exclude):
                return False
        return True

    kept = [m for m in res.matches if passes(m)]
    total = len(kept)
    res.matches = kept[q.offset:q.offset + q.limit]
    res.total = min(total, q.max_matches)
    res.total_found = total
    return res


def host_group_matches(matches, q, shared_grouper=False):
    """Host-side GROUP BY over an already-fetched match list (bounded
    by max_matches upstream). Serves the JSON-path fallback and exact
    COUNT(DISTINCT) merging over multiple RT segments/parts
    (search_grouped_parts). Returns (rows, n_groups).

    shared_grouper: the parts are chunks of ONE index streamed through a
    single sorter (a COUNT(DISTINCT) sorter can't be cloned —
    CanBeCloned(), sphinxsort.cpp:4360): the group rep follows the
    push-order replace rules instead of the per-part group merge."""
    import re as _re

    from ..query.expr import ExprError, eval_expr_host, parse_expr

    key_tree = parse_expr(q.group_by)

    agg_re = _re.compile(
        r"^\s*(count|sum|min|max|avg)\s*\(\s*(distinct\s+)?(.*?)"
        r"\s*\)\s*$", _re.IGNORECASE)
    selects = list(q.select or ["count(*)"])
    if not any(agg_re.match(s2) for s2 in selects):
        selects.append("count(*)")

    def keyof(m):
        try:
            v = eval_expr_host(key_tree, m.attrs, m.weight, m.docid)
        except ExprError:
            v = None
        if isinstance(v, list):
            # MVA group key: the match lands in one group PER value
            # (sphinxsort MVA group iterator)
            return v
        return v if not isinstance(v, dict) else str(v)

    # group-creation order = push order: parts sequentially, each part in
    # scan (rowid) order; MVA values expand in stored (sorted) order.
    # This order is observable through SortGroups()'s tie handling
    # (ref_group_sort) — full ties surface REVERSED.
    groups: dict = {}
    for m in sorted(matches,
                    key=lambda m2: (getattr(m2, "_part", 0),
                                    getattr(m2, "_rowid", m2.docid))):
        k0 = keyof(m)
        for k1 in (k0 if isinstance(k0, list) else [k0]):
            groups.setdefault(k1, []).append(m)

    def _within_sorted(ms):
        # multi-pass stable sort (handles string desc) picking the
        # WITHIN GROUP ORDER BY representative
        ms = sorted(ms, key=lambda m: m.docid)
        for col, asc in reversed(q.within_sort):
            if col in ("weight", "@weight", "weight()"):
                ms.sort(key=lambda m: m.weight, reverse=not asc)
            elif col in ("id", "@id"):
                ms.sort(key=lambda m: m.docid, reverse=not asc)
            else:
                default: object = 0
                for m in ms:
                    v = m.attrs.get(col)
                    if v is not None:
                        default = type(v)()
                        break
                ms.sort(key=lambda m, _c=col, _d=default:
                        m.attrs.get(_c) if m.attrs.get(_c) is not None
                        else _d, reverse=not asc)
        return ms

    rows = []
    for key, ms in groups.items():
        if q.within_sort:
            ms = _within_sorted(ms)
        elif shared_grouper:
            # ONE sorter over all parts: rep starts at the first push
            # and is replaced per the grouper's rule — explicit groups
            # need the entry to beat the rep STRICTLY on (weight desc,
            # rowid asc) (PushIntoExistingGroup MatchIsGreater,
            # sphinxsort.cpp:3127); the implicit grouper compares ONLY
            # rowids (CheckReplaceEntry, sphinxsort.cpp:4420) — golden
            # test_412 keeps the later insert as rep. ms is already in
            # push order, so a stable sort keeps first-push tie wins.
            if getattr(q, "implicit_group", False):
                ms = sorted(ms, key=lambda m: getattr(m, "_rowid",
                                                      m.docid))
            else:
                ms = sorted(ms, key=lambda m: (-m.weight,
                                               getattr(m, "_rowid",
                                                       m.docid)))
        else:
            # default rep mirrors the reference's grouped MERGE: each
            # part groups first, then group rows merge by key keeping
            # the row of the subgroup with the larger count (ties: the
            # later part); within a part: weight desc, docid asc
            part_counts: dict[int, int] = {}
            for m in ms:
                p2 = getattr(m, "_part", 0)
                part_counts[p2] = part_counts.get(p2, 0) + 1
            best_part = max(part_counts,
                            key=lambda p2: (part_counts[p2], p2))
            ms = sorted(ms, key=lambda m: (
                getattr(m, "_part", 0) != best_part,
                -m.weight, m.docid))
        n_rep = max(1, int(getattr(q, "group_n", 1) or 1))
        rep = ms[0]
        attrs = {q.group_by: key}
        for sel in selects:
            am = agg_re.match(sel)
            if not am:
                continue
            kind = am.group(1).lower()
            arg = am.group(3)
            if kind == "count" and am.group(2):
                vals = set()
                tree = parse_expr(arg)
                for m2 in ms:
                    try:
                        v2 = eval_expr_host(tree, m2.attrs,
                                            m2.weight, m2.docid)
                    except ExprError:
                        continue
                    if isinstance(v2, list):
                        # COUNT(DISTINCT mva): each value counts
                        vals.update(v2)
                    else:
                        vals.add(v2)
                attrs[sel] = len(vals)
                continue
            if kind == "count":
                attrs[sel] = len(ms)
                continue
            tree = parse_expr(arg)
            nums = []
            for m2 in ms:
                try:
                    v = eval_expr_host(tree, m2.attrs, m2.weight,
                                       m2.docid)
                except ExprError:
                    v = None
                if v is not None and not isinstance(v, str):
                    nums.append(v)
            if not nums:
                attrs[sel] = 0
            elif kind == "sum":
                attrs[sel] = sum(nums)
            elif kind == "min":
                attrs[sel] = min(nums)
            elif kind == "max":
                attrs[sel] = max(nums)
            else:
                attrs[sel] = sum(nums) / len(nums)
        # GROUP N BY: up to N member rows per group, each carrying the
        # group's aggregates (CSphKBufferNGroupSorter)
        grp_rows = []
        for rep2 in ms[:n_rep]:
            a2 = dict(attrs)
            a2.update(rep2.attrs)
            if not isinstance(rep2.attrs.get(q.group_by), list):
                a2[q.group_by] = key
            a2["@groupby"] = key
            grp_rows.append(Match(rep2.docid, rep2.weight, a2))
        rows.append((grp_rows, rep, len(ms)))

    # group ordering: the reference's SortGroups() — ORDER BY keys with
    # the rep-rowid fallthrough, and sphSort's observable tie handling
    # (exec/multi.py ref_group_sort)
    from .multi import ref_group_sort

    def _group_keys(grp_rows, rep, cnt):
        ks = []
        head = grp_rows[0]
        for col, asc2 in (q.sort or [("weight", False)]):
            lc = col.lower().replace(" ", "")
            if lc in ("@count", "count(*)"):
                v: object = cnt
            elif lc in ("weight", "@weight", "weight()"):
                v = rep.weight
            elif lc in ("@groupby", "@group", "groupby()") \
                    or col == q.group_by:
                gv = head.attrs.get("@groupby")
                v = (gv if isinstance(gv, (int, float, bool))
                     else str(gv))
            elif lc in ("id", "@id"):
                v = rep.docid
            else:
                v = head.attrs.get(col, 0)
                if v is None:
                    v = 0
                elif not isinstance(v, (int, float, bool)):
                    v = str(v)
            ks.append((v, not asc2))
        return ks

    ents = [(_group_keys(gr, rep3, cnt3),
             getattr(rep3, "_rowid", rep3.docid))
            for gr, rep3, cnt3 in rows]
    order2 = ref_group_sort(ents)
    rows = [m for gi in order2 for m in rows[gi][0]]

    # the grouper buffer holds at most max_matches GROUPS
    # (CSphKBufferGroupSorter size; golden test_180 option max_matches=2
    # returns 2 group rows with exact aggregates)
    rows = rows[:q.max_matches]

    if q.having is not None:
        col, op_s, val = q.having
        import operator as _op
        ops = {"=": _op.eq, "!=": _op.ne, "<>": _op.ne, "<": _op.lt,
               "<=": _op.le, ">": _op.gt, ">=": _op.ge}
        rows = [m for m in rows if ops[op_s](m.attrs.get(col, 0), val)]

    total = len(rows)
    rows = rows[q.offset:q.offset + q.limit]
    return rows, total
