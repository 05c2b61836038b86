"""Group-by / aggregation tail over the match core.

Behavioral model: the reference's group-by sorters (CSphKBufferGroupSorter
family, /root/reference/src/sphinxsort.cpp:1690-3000): hash groups by key,
keep the best row per group (within-group order: weight desc, docid asc),
maintain aggregates (COUNT(*)/@count, COUNT(DISTINCT), SUM/MIN/MAX/AVG),
then order groups for output.

Device redesign: replace the hash table with sort-segment-reduce —
  1. sort rows by (group key, ~weight, rowid): within-group best-first
  2. segment boundaries = group starts; segment id by cumsum
  3. aggregates = scatter-reduce over segment ids
  4. group ordering + top-k over the boundary rows only
COUNT(DISTINCT x) uses a second sort keyed (group, x) and counts value
boundaries per group.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp

from ..query.expr import eval_expr
from ..query.plan import PlanSig
from .search import INT32_MIN, build_match_core, segment_running_sums

INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class AggSpec:
    kind: str            # "count" | "sum" | "min" | "max" | "avg" | "count_distinct"
    expr: tuple | None   # expr tree (None for count)
    is_float: bool = False


@dataclass(frozen=True)
class GroupSpec:
    key_expr: tuple                  # expr tree producing the group key (int)
    aggs: tuple[AggSpec, ...]
    order: tuple                     # ("rel",) | ("gkey", asc) | ("count", asc)
                                     # | ("agg", idx, asc) | ("attr", name, asc, is_float)
    k: int                           # max groups returned
    emit_eligible: bool = False      # also output the raw match mask
                                     # (host-side GROUP_CONCAT needs members)
    within: tuple = ("rel",)         # WITHIN GROUP ORDER BY: which row
                                     # represents the group — ("rel",) |
                                     # ("attr", name, asc, is_float) |
                                     # ("rowid", asc)


@lru_cache(maxsize=512)
def _build_groupby_fn(sig: PlanSig, gspec: GroupSpec, n_rows: int,
                      n_fields: int, slot_pb: tuple = (),
                      slot_hb: tuple = (), n_hit_iters: int = 0):
    if gspec.emit_eligible and sig.sparse:
        # host-side GROUP_CONCAT needs a dense per-row match mask
        from dataclasses import replace
        sig = replace(sig, sparse=False)
    core = build_match_core(sig, n_rows, n_fields, slot_pb, slot_hb,
                            n_hit_iters)
    N = n_rows
    # sparse Z mirrors build_match_core (ops/search.py:352): scan plans
    # stream a scan_bucket-sized candidate window, term plans the slot
    # posting union
    Z = ((sig.scan_bucket if getattr(sig, "scan_index", None)
          else int(sum(slot_pb))) if sig.sparse else N + 1)
    k = gspec.k

    def fn(data, rt):
        eligible, weight, rows, attrs, _dbg = core(data, rt)
        key = eval_expr(gspec.key_expr, attrs, weight)
        key = jnp.broadcast_to(key, (Z,)).astype(jnp.int32)

        idx = jnp.arange(Z, dtype=jnp.int32)
        sk = jnp.where(eligible, key, INT32_MAX)
        # within-group order decides the representative (boundary) row:
        # default weight desc, rowid asc (sphinxsort.cpp:4534); WITHIN
        # GROUP ORDER BY substitutes the primary key. s_idx carries the
        # pre-sort position for attr-aligned gathers.
        if gspec.within[0] == "rel":
            # weight may be a scalar constant (ranker=none fullscans)
            wkey = jnp.broadcast_to(~weight, (Z,))
        elif gspec.within[0] == "attr":
            _, wname, wasc, wfloat = gspec.within
            wv = attrs[wname]
            wvi = _f32_sortable_i32(wv) if wfloat else wv.astype(jnp.int32)
            wvi = jnp.broadcast_to(wvi, (Z,))
            wkey = wvi if wasc else ~wvi
        elif gspec.within[0] == "rowid":
            wkey = rows if gspec.within[1] else ~rows
        else:
            raise NotImplementedError(f"within order {gspec.within}")
        s_key, s_wkey, s_row, s_idx = jax.lax.sort(
            (sk, wkey, rows, idx), num_keys=3)
        s_w = jnp.broadcast_to(weight, (Z,))[s_idx]
        s_elig = s_key != INT32_MAX

        prev_key = jnp.concatenate([jnp.full(1, INT32_MIN, jnp.int32),
                                    s_key[:-1]])
        new_group = (s_key != prev_key) & s_elig
        gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1  # [-1 for pre-first]
        gid = jnp.maximum(gid, 0)
        # sink Z-1 is safe: gid <= n_eligible-1 <= Z-2 whenever any row is
        # ineligible, and the sink is unused when every row is eligible
        gid_scatter = jnp.where(s_elig, gid, Z - 1)
        n_groups = jnp.sum(new_group.astype(jnp.int32))

        counts = jnp.zeros(Z, jnp.int32).at[gid_scatter].add(
            jnp.where(s_elig, 1, 0))

        agg_results = []
        for a in gspec.aggs:
            if a.kind == "count":
                agg_results.append(counts)
                continue
            if a.kind == "count_distinct":
                dv = eval_expr(a.expr, attrs, weight)
                dv = jnp.broadcast_to(dv, (Z,)).astype(jnp.int32)
                d_key, d_val = jax.lax.sort(
                    (sk, dv), num_keys=2)
                d_elig = d_key != INT32_MAX
                dp_key = jnp.concatenate(
                    [jnp.full(1, INT32_MIN, jnp.int32), d_key[:-1]])
                dp_val = jnp.concatenate(
                    [jnp.zeros(1, jnp.int32), d_val[:-1]])
                d_new = ((d_key != dp_key) | (d_val != dp_val)) & d_elig
                d_gid = jnp.cumsum(((d_key != dp_key) & d_elig
                                    ).astype(jnp.int32)) - 1
                d_gid = jnp.where(d_elig, jnp.maximum(d_gid, 0), Z - 1)
                agg_results.append(
                    jnp.zeros(Z, jnp.int32).at[d_gid].add(
                        jnp.where(d_new, 1, 0)))
                continue
            v = eval_expr(a.expr, attrs, weight)
            v = jnp.broadcast_to(v, (Z,))
            # accumulator dtype strictly follows is_float so the packed
            # batched layout's bitcast round-trips deterministically
            v = v.astype(jnp.float32 if a.is_float else jnp.int32)
            v_sorted = v[s_idx]
            if a.kind in ("sum", "avg"):
                in_float = a.is_float or a.kind == "avg"
                dt = jnp.float32 if in_float else jnp.int32
                vals = jnp.where(s_elig, v_sorted, 0).astype(dt)
                if not in_float:
                    acc = jnp.zeros(Z, dt).at[gid_scatter].add(vals)
                else:
                    # float sums in a fixed order (groups are contiguous
                    # after the sort), read at each group's last row
                    run = segment_running_sums(vals, new_group)
                    last = s_elig & jnp.concatenate(
                        [new_group[1:] | ~s_elig[1:], jnp.ones(1, bool)])
                    acc = jnp.zeros(Z, dt).at[
                        jnp.where(last, gid_scatter, Z)].set(run, mode="drop")
                if a.kind == "avg":
                    acc = acc / jnp.maximum(counts, 1).astype(jnp.float32)
                agg_results.append(acc)
            elif a.kind == "min":
                big = jnp.asarray(
                    jnp.inf if a.is_float else INT32_MAX, v_sorted.dtype)
                acc = jnp.full(Z, big, v_sorted.dtype).at[gid_scatter].min(
                    jnp.where(s_elig, v_sorted, big))
                agg_results.append(acc)
            elif a.kind == "max":
                small = jnp.asarray(
                    -jnp.inf if a.is_float else INT32_MIN, v_sorted.dtype)
                acc = jnp.full(Z, small, v_sorted.dtype).at[gid_scatter].max(
                    jnp.where(s_elig, v_sorted, small))
                agg_results.append(acc)
            else:
                raise NotImplementedError(f"aggregate {a.kind}")

        # ---- order groups, take top-k (boundary rows represent groups) ----
        # implicit final tie-break: the group REPRESENTATIVE's rowid asc —
        # the reference's grouped comparators (MatchRelevanceLt_fn /
        # MatchGeneric*_fn, sphinxsort.cpp:4541,4678) always fall through
        # to a.m_tRowID > b.m_tRowID, and a grouped entry carries the
        # rowid of its best within-group member (PushIntoExistingGroup
        # clones the better match wholesale, sphinxsort.cpp:3136)
        def order_top(okey):
            tie = jnp.where(new_group, s_row, INT32_MAX)
            nk, _tie_s, pos_s = jax.lax.sort(
                (~okey, tie, jnp.arange(Z, dtype=jnp.int32)), num_keys=2)
            return ~nk[:k], pos_s[:k]

        if gspec.order[0] == "rel":
            okey = jnp.where(new_group, s_w, INT32_MIN)
        elif gspec.order[0] == "gkey":
            asc = gspec.order[1]
            okey = jnp.where(new_group, s_key if not asc else ~s_key,
                             INT32_MIN)
        elif gspec.order[0] == "count":
            asc = gspec.order[1]
            cnt_b = counts[gid]
            okey = jnp.where(new_group, cnt_b if not asc else ~cnt_b,
                             INT32_MIN)
        elif gspec.order[0] == "rowid":
            # groups ordered by their representative row's id (the
            # boundary row: best weight, lowest rowid within the group)
            asc = gspec.order[1]
            okey = jnp.where(new_group, ~s_row if asc else s_row,
                             INT32_MIN)
        elif gspec.order[0] == "attr":
            _, name, asc, is_float = gspec.order
            v = attrs[name][s_idx]
            if is_float:
                vi = _f32_sortable_i32(v)
            else:
                vi = v.astype(jnp.int32)
            okey = jnp.where(new_group, vi if not asc else ~vi, INT32_MIN)
        else:
            raise NotImplementedError(f"group order {gspec.order}")
        top_key, top_pos = order_top(okey)

        valid_out = top_key != INT32_MIN
        out_gid = gid[top_pos]
        out = {
            "rep_rowid": jnp.where(valid_out, s_row[top_pos], N),
            "rep_weight": jnp.where(valid_out, s_w[top_pos], 0),
            "group_key": jnp.where(valid_out, s_key[top_pos], 0),
            "count": jnp.where(valid_out, counts[out_gid], 0),
            "n_groups": n_groups,
            "found": jnp.sum(eligible.astype(jnp.int32)),
        }
        for i, acc in enumerate(agg_results):
            out[f"agg{i}"] = jnp.where(valid_out, acc[out_gid], 0)
        if gspec.emit_eligible:
            out["eligible"] = eligible
        return out

    return fn


@lru_cache(maxsize=512)
def get_groupby_fn(sig: PlanSig, gspec: GroupSpec, n_rows: int,
                   n_fields: int, slot_pb: tuple = (), slot_hb: tuple = (),
                   n_hit_iters: int = 0):
    return jax.jit(_build_groupby_fn(sig, gspec, n_rows, n_fields,
                                     slot_pb, slot_hb, n_hit_iters))


def groupby_row_width(gspec: GroupSpec) -> int:
    """i32 row width of the packed batched layout: k x (rowid, weight,
    key, count) ++ k per aggregate ++ (n_groups, found)."""
    return gspec.k * (4 + len(gspec.aggs)) + 2


@lru_cache(maxsize=512)
def get_batched_groupby_fn(sig: PlanSig, gspec: GroupSpec, n_rows: int,
                           n_fields: int, slot_pb: tuple = (),
                           slot_hb: tuple = (), n_hit_iters: int = 0):
    """Batched variant: vmap over per-query runtimes, one launch + ONE
    packed i32 fetch for B same-shape grouped queries (the multi-sorter
    single pass of CheckMultiQuery/FACET, sphinx.cpp:15474 — and the
    one-fetch-per-batch that the relevance path already has in
    get_batched_search_fn). Float aggregates ride bitcast to i32."""
    kern = _build_groupby_fn(sig, gspec, n_rows, n_fields, slot_pb,
                             slot_hb, n_hit_iters)
    vkern = jax.vmap(kern, in_axes=(None, 0))

    def packed(data, rt_b):
        out = vkern(data, rt_b)
        parts = [out["rep_rowid"], out["rep_weight"], out["group_key"],
                 out["count"]]
        for i in range(len(gspec.aggs)):
            arr = out[f"agg{i}"]
            if arr.dtype != jnp.int32:
                arr = jax.lax.bitcast_convert_type(arr, jnp.int32)
            parts.append(arr)
        parts.append(out["n_groups"][:, None])
        parts.append(out["found"][:, None])
        return jnp.concatenate(parts, axis=1)

    return jax.jit(packed)


def _f32_sortable_i32(v):
    """Map float32 bits to int32 preserving float order (IEEE754 trick:
    positives keep their bit pattern, negatives are complemented)."""
    b = jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.int32)
    return jnp.where(b >= 0, b, (~b) ^ jnp.int32(-(2**31)))
