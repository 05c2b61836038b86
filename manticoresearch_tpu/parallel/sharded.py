"""Distributed-index search over a device mesh.

Behavioral model: the reference's distributed index + agent fan-out
(DistributedIndex_t, searchdha.h:679; RunSubset scatter-gather,
searchd.cpp:6550-6860; per-agent merged chunks searchd.cpp:6737) and the
global-IDF aggregation (SetupLocalDF, searchd.cpp:5869).

Device-native redesign (SURVEY §5.8): shards are doc partitions living as
mesh-sharded SoA arrays (leading axis = mesh axis "shard"). One shard_mapped
XLA program runs the per-shard search kernel, then merges per-shard top-k
candidates with an all_gather across the mesh + a replicated multi-key sort with the
exact reference tie-break (weight desc, docid asc — docids carried as i32
hi/lo pairs so 63-bit ids compare exactly). The entire master/agent protocol
collapses into one program launch; "local df" aggregation happens host-side
from per-shard dictionaries (equivalent to the psum formulation because df is
static per index generation).
"""
from __future__ import annotations

import bisect
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.builder import PackedIndex
from ..ops.search import INT32_MIN, build_kernel
from ..query.plan import PlanSig
from ..query.planner import (CompiledQuery, plan_query, _next_pow2,
                             _next_pow4)
from ..schema import Schema
from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer

shard_map = jax.shard_map


class _UnionView:
    """A virtual 'index' exposing the union dictionary of all shards —
    used by the planner for AST lowering, wildcard expansion and global IDF
    (df summed across shards = SetupLocalDF semantics)."""

    def __init__(self, shards: list[PackedIndex]):
        self.schema = shards[0].schema
        self.n_docs = sum(s.n_docs for s in shards)
        union: dict[str, tuple[int, int]] = {}
        for s in shards:
            for t, df, th in zip(s.term_strs, s.term_docs.tolist(),
                                 s.term_hits.tolist()):
                d0, h0 = union.get(t, (0, 0))
                union[t] = (d0 + df, h0 + th)
        self.term_strs = sorted(union)
        self.term_docs = np.array(
            [union[t][0] for t in self.term_strs], np.int32
        ) if self.term_strs else np.zeros(0, np.int32)
        self.term_hits = np.array(
            [union[t][1] for t in self.term_strs], np.int32
        ) if self.term_strs else np.zeros(0, np.int32)
        T = len(self.term_strs)
        self.term_offsets = np.zeros(T + 1, np.int32)
        self.post_hit_offset = np.zeros(1, np.int32)
        self.hit_packed = np.zeros(0, np.int32)
        fls = [s.field_lens for s in shards if s.field_lens.size]
        self.field_lens = (np.concatenate(fls) if fls
                           else np.zeros((0, 1), np.int32))
        self.attrs_mva = {}

    def term_id(self, term: str) -> int:
        i = bisect.bisect_left(self.term_strs, term)
        if i < len(self.term_strs) and self.term_strs[i] == term:
            return i
        return -1


def _pad_to(arr: np.ndarray, size: int, value) -> np.ndarray:
    if len(arr) >= size:
        return arr
    pad = np.full(size - len(arr), value, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def make_mesh(n_shards: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_shards is None:
        n_shards = len(devs)
    return Mesh(np.array(devs[:n_shards]), (axis,))


class ShardedIndex:
    """A distributed index: docs partitioned over mesh devices."""

    def __init__(self, shards: list[PackedIndex], mesh: Mesh | None = None):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = shards
        self.mesh = mesh if mesh is not None else make_mesh(len(shards))
        self.axis = self.mesh.axis_names[0]
        D = self.mesh.devices.size
        if len(shards) != D:
            raise ValueError(f"{len(shards)} shards for {D} mesh devices")
        self.union = _UnionView(shards)
        self.schema: Schema = shards[0].schema
        self.tokenizer = Tokenizer(shards[0].tokenizer_settings)
        self.dictionary = Dictionary(shards[0].dict_settings)
        from ..query.ftparser import FtQueryParser
        self.parser = FtQueryParser(
            self.tokenizer, self.dictionary, self.schema.fields)
        self._stack()
        self._fn_cache: dict = {}

    # ------------------------------------------------------------------
    def _stack(self) -> None:
        shards = self.shards
        D = len(shards)
        N = max(s.n_docs for s in shards)
        Pmax = max(max(s.n_postings for s in shards), 1)
        Hmax = max(max(len(s.hit_packed) for s in shards), 1)
        self.n_common = N

        def _pow2(x, lo=1024):
            n = lo
            while n < x:
                n <<= 1
            return n

        max_df = max((int(s2.term_docs.max()) for s2 in shards
                      if s2.n_terms), default=0)
        # padding must match the planner's pow4 slot buckets (they can
        # round above the next pow2)
        pad_p = _next_pow4(max_df, 1024)
        max_th = 0
        for s2 in shards:
            if s2.n_terms:
                pth = (s2.post_hit_offset[s2.term_offsets[1:]]
                       - s2.post_hit_offset[s2.term_offsets[:-1]])
                if len(pth):
                    max_th = max(max_th, int(pth.max()))
        pad_h = _next_pow4(max_th, 1024)
        Pmax += pad_p
        Hmax += pad_h

        post_rowid = np.full((D, Pmax), N, np.int32)
        post_tfq = np.zeros((D, Pmax), np.float32)
        post_tf = np.zeros((D, Pmax), np.int32)
        post_fm = np.zeros((D, Pmax), np.int32)
        pho = np.zeros((D, Pmax + 1), np.int32)
        hitp = np.zeros((D, Hmax), np.int32)
        hitr = np.full((D, Hmax), N, np.int32)
        alive = np.zeros((D, N + 1), bool)
        Fn = max(self.schema.n_fields, 1)
        flens = np.zeros((D, N + 1, Fn), np.int32)
        dhi = np.zeros((D, N + 1), np.int32)
        dlo = np.zeros((D, N + 1), np.int32)
        for i, s in enumerate(shards):
            p = s.n_postings
            post_rowid[i, :p] = s.post_rowid
            post_tfq[i, :p] = s.post_tfq
            post_tf[i, :p] = s.post_tf
            post_fm[i, :p] = s.post_fieldmask
            pho[i, : p + 1] = s.post_hit_offset
            pho[i, p + 1:] = s.post_hit_offset[-1] if p else 0
            h = len(s.hit_packed)
            hitp[i, :h] = s.hit_packed
            hitr[i, :h] = np.repeat(s.post_rowid, s.post_tf)
            hitr[i, h:] = N
            alive[i, : s.n_docs] = True
            if s.field_lens.size:
                flens[i, : s.n_docs, : s.field_lens.shape[1]] = s.field_lens
            did = np.append(s.doc_ids,
                            np.full(N - s.n_docs + 1,
                                    2**63 - 1)).astype(np.uint64)
            dhi[i] = (did >> np.uint64(32)).astype(np.int64) \
                .astype(np.int32)
            dlo[i] = ((did & np.uint64(0xFFFFFFFF)).astype(np.int64)
                      - 2**31).astype(np.int32)

        attrs = {}
        for a in self.schema.attrs:
            if not a.type.is_numeric_device:
                continue
            dt = np.float32 if a.type.value == "float" else np.int32
            col = np.zeros((D, N), dt)
            for i, s in enumerate(shards):
                src = (s.attrs_int.get(a.name) if a.name in s.attrs_int
                       else s.attrs_float.get(a.name)
                       if a.name in s.attrs_float
                       else s.attrs_big.get(a.name))
                if src is not None:
                    col[i, : len(src)] = np.clip(
                        src, -(2**31), 2**31 - 1
                    ).astype(dt) if dt == np.int32 else src.astype(dt)
            attrs[a.name] = col

        SBmax = max(max((len(s2.sent_rowid) for s2 in shards), default=0), 1)
        PBmax = max(max((len(s2.para_rowid) for s2 in shards), default=0), 1)
        sbr = np.full((D, SBmax), 2**31 - 1, np.int32)
        sbk = np.full((D, SBmax), 2**31 - 1, np.int32)
        pbr = np.full((D, PBmax), 2**31 - 1, np.int32)
        pbk = np.full((D, PBmax), 2**31 - 1, np.int32)
        for i, s in enumerate(shards):
            sbr[i, : len(s.sent_rowid)] = s.sent_rowid
            sbk[i, : len(s.sent_pkey)] = s.sent_pkey
            pbr[i, : len(s.para_rowid)] = s.para_rowid
            pbk[i, : len(s.para_pkey)] = s.para_pkey

        data = {
            "post_hit_offset": pho, "hit_packed": hitp,
            "hit_rowid": hitr, "alive": alive, "field_lens": flens,
            "sent_rowid": sbr, "sent_pkey": sbk,
            "para_rowid": pbr, "para_pkey": pbk,
            "docid_hi": dhi, "docid_lo": dlo,
            "attrs": attrs, "mva_offsets": {}, "mva_values": {},
        }

        # ---- packed posting store with GLOBAL width classes ------------
        # Each shard packs with the UNION's pack decision and the
        # elementwise-max width classes across shards, so one plan's
        # static slot_packed shapes hold on every shard — the 2.2x HBM
        # multiplier now reaches the multi-chip path (round-2 gap).
        from ..ops.packed_store import (CLASSES, PACK_MIN, PLANE_WORDS,
                                        build_store)
        u = self.union
        u_arr = np.array(u.term_strs) if u.term_strs else np.zeros(0, str)
        union_sel = (u.term_docs.astype(np.int64) >= PACK_MIN
                     if len(u.term_strs) else np.zeros(0, bool))
        shard_pos = []
        for s in shards:
            pos = (np.searchsorted(u_arr, np.array(s.term_strs))
                   if s.n_terms else np.zeros(0, np.int64))
            shard_pos.append(pos)
        u_cls = np.zeros((len(u.term_strs), 3), np.int8)
        for s, pos in zip(shards, shard_pos):
            if not s.n_terms:
                continue
            _, cls = build_store(
                s.term_docs, s.term_offsets, s.post_rowid, s.post_tf,
                s.post_tfq, s.post_fieldmask,
                force_packed=union_sel[pos], classes_only=True)
            np.maximum.at(u_cls, pos, cls)
        self._stores = []
        for s, pos in zip(shards, shard_pos):
            self._stores.append(build_store(
                s.term_docs, s.term_offsets, s.post_rowid, s.post_tf,
                s.post_tfq, s.post_fieldmask,
                force_packed=(union_sel[pos] if s.n_terms
                              else np.zeros(0, bool)),
                force_class=(u_cls[pos] if s.n_terms
                             else np.zeros((0, 3), np.int8))))
        # union-term class values (1-based like PackedStore.term_class)
        self._u_cls = np.where(union_sel[:, None], u_cls + 1,
                               0).astype(np.int8) \
            if len(u.term_strs) else np.zeros((0, 3), np.int8)

        # slices never clamp: every class/residual array is over-padded
        # by the largest possible slot bucket (the single-chip upload does
        # the same; see ops/device_index.py)
        from ..ops.packed_store import BLOCK
        pad_blocks = pad_p // BLOCK + 1
        for c in CLASSES:
            nbm = max(max((st.rw_words[c].shape[0]
                           for st in self._stores), default=0), 1) \
                + pad_blocks
            for kind, attr_name in (("pkrw_w", "rw_words"),
                                    ("pktf_w", "tf_words"),
                                    ("pkfm_w", "fm_words")):
                nk = max(max((getattr(st, attr_name)[c].shape[0]
                              for st in self._stores), default=0), 1) \
                    + pad_blocks
                arr = np.zeros((D, nk, PLANE_WORDS * c), np.uint32)
                for i, st in enumerate(self._stores):
                    w = getattr(st, attr_name)[c]
                    arr[i, : w.shape[0]] = w
                data[f"{kind}_{c}"] = arr
            bs = np.zeros((D, nbm), np.int32)
            for i, st in enumerate(self._stores):
                b = st.rw_base[c]
                bs[i, : len(b)] = b
            data[f"pkrw_b_{c}"] = bs
        Rmax = max(max((len(st.res_rowid) for st in self._stores),
                       default=0), 1) + pad_p
        res_r = np.full((D, Rmax), N, np.int32)
        res_q = np.zeros((D, Rmax), np.float32)
        res_f = np.zeros((D, Rmax), np.int32)
        for i, st in enumerate(self._stores):
            r = len(st.res_rowid)
            res_r[i, :r] = st.res_rowid
            res_q[i, :r] = st.res_tfq
            res_f[i, :r] = st.res_fieldmask
        data["res_rowid"] = res_r
        data["res_tfq"] = res_q
        data["res_fieldmask"] = res_f

        sharding = NamedSharding(self.mesh, P(self.axis))
        self.data = jax.tree.map(
            lambda x: jax.device_put(x, sharding), data)

    # ------------------------------------------------------------------
    def _merge_k(self, sig: PlanSig) -> tuple[int, int]:
        """(k_local, k): per-shard chunk size and merged-result size."""
        k_local = max(1, min(sig.k, self.n_common))
        return k_local, min(sig.k, len(self.shards) * k_local)

    def _sharded_fn(self, sig: PlanSig, slot_pb, slot_hb, n_hit_iters):
        """One shard_mapped XLA program serving a whole BATCH of same-shape
        queries: per-shard kernels vmapped over the batch, per-shard top-k
        chunks merged with an all_gather across the mesh + a replicated multi-key
        sort (one pre-merged chunk per shard, like agents return one chunk
        each — searchd.cpp:6737; merge = MinimizeAggrResult semantics,
        searchd.cpp:4816,3990). Output is ONE packed i32 array
        [B, 5k+1] = weight[k] ++ docid_hi[k] ++ docid_lo[k] ++ rowid[k] ++
        shard[k] ++ found, so a batch pays a single device->host fetch."""
        key = (sig, slot_pb, slot_hb, n_hit_iters)
        if key in self._fn_cache:
            return self._fn_cache[key]

        N = self.n_common
        F = max(self.schema.n_fields, 1)
        D = len(self.shards)
        from dataclasses import replace
        k_local, k = self._merge_k(sig)
        kern = build_kernel(replace(sig, k=k_local), N, F, slot_pb,
                            slot_hb, n_hit_iters)
        axis = self.axis

        order = sig.order

        def per_shard(data, rt_shard, rt_repl):
            # shard_map keeps the sharded axis as a size-1 leading dim
            data = jax.tree.map(lambda x: x[0], data)
            rt_shard = jax.tree.map(lambda x: x[0], rt_shard)  # (B, ...)

            def one(rs, rr):
                return kern(data, {**rs, **rr})

            out = jax.vmap(one)(rt_shard, rt_repl)
            rid = out["rowid"]          # (B, k_local)
            w = out["weight"]
            B = rid.shape[0]
            hi = data["docid_hi"][rid]
            lo = data["docid_lo"][rid]

            def g(x):                   # (B, kl) -> (B, D*kl)
                return jax.lax.all_gather(x, axis) \
                    .transpose(1, 0, 2).reshape(B, -1)

            gw, ghi, glo, grid = g(w), g(hi), g(lo), g(rid)
            gshard = jnp.broadcast_to(
                jnp.repeat(jnp.arange(D, dtype=jnp.int32), k_local),
                (B, D * k_local))
            found = jax.lax.psum(out["found"], axis)    # (B,)
            if order[0] == "attr":
                # attr-ordered merge: the sort key (numeric attr value)
                # rides the gather; ties break (docid asc) like the
                # reference sorter comparators (sphinxsort.cpp)
                name, asc, is_float = order[1], order[2], order[3]
                col = data["attrs"][name]
                keyv = col[jnp.clip(rid, 0, col.shape[0] - 1)]
                if is_float:
                    sortk = keyv if asc else -keyv
                    pad = jnp.float32(jnp.inf)
                else:
                    sortk = keyv if asc else ~keyv
                    pad = jnp.int32(2**31 - 1)
                # entries past the shard's own match count are garbage
                # rows (the attr-ordered kernel fills the chunk): they
                # must sort last in the merge
                valid = (jnp.arange(k_local, dtype=jnp.int32)[None, :]
                         < out["found"][:, None])
                sortk = jnp.where(valid, sortk, pad)
                gk = g(sortk)
                _, shi, slo, sw2, srid, sshard = jax.lax.sort(
                    (gk, ghi, glo, gw, grid, gshard), num_keys=3)
            else:
                # merged order: weight desc, docid asc
                nw, shi, slo, srid, sshard = jax.lax.sort(
                    (~gw, ghi, glo, grid, gshard), num_keys=3)
                sw2 = ~nw
            return jnp.concatenate(
                [sw2[:, :k], shi[:, :k], slo[:, :k], srid[:, :k],
                 sshard[:, :k], found[:, None]], axis=1)

        smapped = shard_map(
            per_shard,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=P(),
            check_vma=False,
        )
        fn = jax.jit(smapped)
        self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def _per_shard_indexes(self):
        """Lazy per-shard SearchIndex list (extra HBM; built on demand for
        grouped / attr-ordered queries whose merge runs host-side)."""
        if not hasattr(self, "_shard_idx"):
            from ..exec.searcher import SearchIndex
            self._shard_idx = [SearchIndex(p) for p in self.shards]
        return self._shard_idx

    def global_stats(self):
        """Union total_docs + per-term df across shards (SetupLocalDF,
        searchd.cpp:5869). Cached — shards are immutable."""
        if not hasattr(self, "_gstats"):
            total = sum(p.n_docs for p in self.shards)
            df: dict = {}
            for p in self.shards:
                for t, d in zip(p.term_strs, p.term_docs.tolist()):
                    df[t] = df.get(t, 0) + d
            self._gstats = (total, df)
        return self._gstats

    def _per_shard_search(self, q):
        from dataclasses import replace as dc_rep

        from ..exec.multi import _search_with_stats, merge_part_results
        total_docs, df = self.global_stats()
        part_q = dc_rep(q, offset=0, limit=q.offset + q.limit, select=None)
        kw = dict(total_docs_override=total_docs, local_df=df)
        results = [_search_with_stats(p, part_q, kw)
                   for p in self._per_shard_indexes()]
        return merge_part_results(results, q, self.schema)

    def plan(self, q) -> CompiledQuery:
        from ..exec.searcher import _resolve_order
        ast = self.parser.parse(q.match)
        try:
            order = _resolve_order(q, self.schema)
        except ValueError:
            order = ("rel",)
        if order[0] not in ("rel", "attr"):
            order = ("rel",)
        return plan_query(
            ast, self.union,
            filters=q.filters, ranker=q.ranker, max_matches=q.max_matches,
            filter_tree=q.filter_tree,
            order=order, field_weights=q.field_weights,
            idf_plain=q.idf_plain, tfidf_normalized=q.tfidf_normalized,
            packed_store=self._union_store(),
        )

    def _union_store(self):
        """Union-term pseudo PackedStore: carries the GLOBAL width classes
        so the plan's slot_packed matches every shard's layout; the
        per-shard starts are filled into the runtime at dispatch."""
        if not hasattr(self, "_ustore"):
            T = len(self.union.term_strs)

            class _U:
                term_class = self._u_cls
                term_start = np.zeros((T, 3), np.int32)
                res_offsets = np.zeros(T + 1, np.int32)
            self._ustore = _U()
        return self._ustore

    def search(self, q):
        return self.search_batch([q])[0]

    def _prep(self, q):
        """Classify + lower one query for the shard_mapped program.
        Returns ("fallback", None) when the query needs per-shard kernels
        with a host merge, ("error", msg) on plan errors, or
        ("ok", (cq, rt_shard, rt_repl, slot_pb, slot_hb, n_hit_iters))
        with HOST (un-device_put) runtime arrays — rt_shard leaves are
        (D, ...), rt_repl leaves are per-query."""
        if getattr(q, "group_by", None):
            return "fallback", None

        def _host_merge_filter(f) -> bool:
            # string ordinals and JSON columns are per-shard structures;
            # such filters run on per-shard kernels + host merge
            if "." in f.attr:
                return True
            ad = self.schema.attr(f.attr)
            return ad is not None and ad.type.value in ("string", "json")

        def _ici_sortable() -> bool:
            sort = q.sort or [("weight", False)]
            primary = sort[0][0]
            if primary in ("weight", "@weight", "weight()"):
                return True
            ad = self.schema.attr(primary)
            if ad is None or ad.type.value not in (
                    "uint", "bool", "timestamp", "float", "bigint"):
                return False
            # secondary keys beyond the implicit docid tiebreak need the
            # host merge
            rest = [c for c, _a in sort[1:] if c not in ("id", "@id")]
            return not rest

        if (any(_host_merge_filter(f) for f in (q.filters or []))
                or not _ici_sortable()):
            # per-shard kernels + host merge, with GLOBAL term stats so
            # weights match the single shard_mapped program (SetupLocalDF)
            return "fallback", None
        try:
            cq = self.plan(q)
        except (ValueError, NotImplementedError) as e:
            return "error", str(e)

        if any(e[4] for e in cq.sig.slot_limited):
            # ZONE-limited slots: zone span arrays are per-shard (ragged),
            # so run per-shard kernels + host merge instead of one
            # shard_mapped program
            return "fallback", None

        S = max(cq.sig.n_slots, 1)
        D = len(self.shards)
        starts = np.zeros((D, S), np.int32)
        lengths = np.zeros((D, S), np.int32)
        hstarts = np.zeros((D, S), np.int32)
        hlengths = np.zeros((D, S), np.int32)
        pk_starts = np.zeros((D, S, 3), np.int32)
        slot_packed = tuple(getattr(cq.sig, "slot_packed", ()) or ())
        for d, sh in enumerate(self.shards):
            store_d = self._stores[d]
            for s, term in enumerate(cq.slot_terms):
                tid = sh.term_id(term)
                if tid < 0:
                    continue
                t0_, t1_ = int(sh.term_offsets[tid]), int(sh.term_offsets[tid + 1])
                hs = int(sh.post_hit_offset[t0_]) if t1_ > t0_ else 0
                he = int(sh.post_hit_offset[t1_]) if t1_ > t0_ else 0
                hstarts[d, s] = hs
                hlengths[d, s] = he - hs
                lengths[d, s] = t1_ - t0_
                if slot_packed and slot_packed[s][0]:
                    pk_starts[d, s] = store_d.term_start[tid]
                    starts[d, s] = 0
                else:
                    starts[d, s] = (int(store_d.res_offsets[tid])
                                    if slot_packed else t0_)

        # per-slot buckets must be COMMON across shards (one program):
        # pow2 of the max per-shard size
        Sreal = cq.sig.n_slots
        slot_pb = tuple(_next_pow4(int(lengths[:, s].max()), 1024)
                        for s in range(Sreal))
        slot_hb = tuple(_next_pow4(int(hlengths[:, s].max()), 1024)
                        for s in range(Sreal))
        Hmax = int(self.data["hit_packed"].shape[1])
        n_hit_iters = max(1, math.ceil(math.log2(max(Hmax, 2)))) + 1

        rt_shard = {
            "starts": starts, "lengths": lengths,
            "hit_starts": hstarts, "hit_lengths": hlengths,
        }
        if slot_packed:
            rt_shard["pk_starts"] = pk_starts
        rt_repl = {
            "idf": cq.runtime["idf"], "mult": cq.runtime["mult"],
            "qpos": cq.runtime["qpos"],
            "field_weights": cq.runtime["field_weights"],
            "filter_vals": cq.runtime["filter_vals"],
            "total_field_lens": cq.runtime["total_field_lens"],
            "total_docs": cq.runtime["total_docs"],
            "avg_doc_len": cq.runtime["avg_doc_len"],
        }
        # replicated small arrays the kernel may read depending on the plan
        # (dupe folding, payload merge-group idf)
        for k in ("qpos_fold", "slot_fold", "gidf"):
            if k in cq.runtime:
                rt_repl[k] = cq.runtime[k]
        return "ok", (cq, rt_shard, rt_repl, slot_pb, slot_hb, n_hit_iters)

    def search_batch(self, queries):
        """Batched distributed execution: queries grouped by plan shape
        share ONE shard_mapped launch and ONE packed fetch (the same
        multi-query batching the single-index path has —
        exec/searcher.py:search_batch — applied to the agent fan-out
        analog: every query in the batch scatter-gathers across all
        shards inside one XLA program)."""
        import time
        from ..exec.searcher import SearchResult
        t0 = time.perf_counter()
        results: list = [None] * len(queries)
        bundles: dict[int, tuple] = {}
        groups: dict[tuple, list[int]] = {}
        for i, q in enumerate(queries):
            st, val = self._prep(q)
            if st == "error":
                results[i] = SearchResult([], 0, 0, 0.0, [], error=val)
            elif st == "fallback":
                results[i] = self._fallback_search(q)
            else:
                bundles[i] = val
                cq = val[0]
                groups.setdefault((cq.sig, val[3], val[4], val[5]),
                                  []).append(i)

        sharding = NamedSharding(self.mesh, P(self.axis))
        repl = NamedSharding(self.mesh, P())
        # phase 1: dispatch every group's launch asynchronously
        pending = []
        for (sig, pb, hb, nhi), idxs in groups.items():
            fn = self._sharded_fn(sig, pb, hb, nhi)
            # pad the batch dim to a pow2 so group size doesn't multiply
            # compile shapes (dummy slots repeat the last query)
            B = 1
            while B < len(idxs):
                B <<= 1
            rss = [bundles[i][1] for i in idxs]
            rrs = [bundles[i][2] for i in idxs]
            rss += [rss[-1]] * (B - len(rss))
            rrs += [rrs[-1]] * (B - len(rrs))
            # rt_shard leaves (D, ...) -> (D, B, ...); rt_repl -> (B, ...)
            rt_shard = jax.tree.map(
                lambda *xs: np.stack(xs, axis=1), *rss)
            rt_repl = jax.tree.map(
                lambda *xs: np.stack([np.asarray(x) for x in xs]), *rrs)
            rt_shard = jax.tree.map(
                lambda x: jax.device_put(x, sharding), rt_shard)
            rt_repl = jax.tree.map(
                lambda x: jax.device_put(x, repl), rt_repl)
            pending.append((idxs, fn(self.data, rt_shard, rt_repl)))
        # phase 2: ONE device->host fetch for all groups
        outs = [p[1] for p in pending]
        if len(outs) > 1:
            flat = jnp.concatenate([o.reshape(-1) for o in outs])
            fh = np.asarray(flat)
            fetched = []
            off = 0
            for o in outs:
                size = int(np.prod(o.shape))
                fetched.append(fh[off:off + size].reshape(o.shape))
                off += size
        else:
            fetched = [np.asarray(o) for o in outs]
        # phase 3: unpack + render
        for (idxs, _), pout in zip(pending, fetched):
            for bi, i in enumerate(idxs):
                cq = bundles[i][0]
                _, k = self._merge_k(cq.sig)
                row = pout[bi]
                results[i] = self._render_merged(
                    queries[i], cq, row[:k], row[k:2 * k],
                    row[2 * k:3 * k], row[3 * k:4 * k],
                    row[4 * k:5 * k], int(row[5 * k]), t0)
        return results

    def _fallback_search(self, q):
        if getattr(q, "group_by", None):
            # grouped queries: per-shard grouped kernels + exact host merge
            # (COUNT/SUM/MIN/MAX; same semantics as RT segment merge)
            from ..exec.multi import search_grouped_parts
            return search_grouped_parts(
                self._per_shard_indexes(), q, self.schema,
                single_part_hint="query a single shard for exact distinct")
        return self._per_shard_search(q)

    def _render_merged(self, q, cq, w, hi, lo, rid, shard, found, t0):
        import time
        from ..exec.searcher import Match, SearchResult, WordStat
        hi = hi.astype(np.int64)
        lo = lo.astype(np.int64)

        n_avail = min(found, cq.sig.k)
        keep = w[:n_avail] != INT32_MIN
        w, hi, lo, rid, shard = (x[:n_avail][keep] for x in (w, hi, lo, rid, shard))
        docids = (hi << 32) | (lo + 2**31)

        lo_i = min(q.offset, len(w))
        hi_i = min(q.offset + q.limit, len(w))
        matches = []
        for i in range(lo_i, hi_i):
            sh = self.shards[int(shard[i])]
            r = int(rid[i])
            attrs = {}
            for a in self.schema.attrs:
                if a.name in sh.attrs_int:
                    attrs[a.name] = int(sh.attrs_int[a.name][r])
                elif a.name in sh.attrs_big:
                    attrs[a.name] = int(sh.attrs_big[a.name][r])
                elif a.name in sh.attrs_float:
                    attrs[a.name] = float(sh.attrs_float[a.name][r])
                elif a.name in sh.attrs_str:
                    attrs[a.name] = sh.attrs_str[a.name][r]
            for fname, vals in sh.stored_fields.items():
                attrs[fname] = vals[r]
            matches.append(Match(int(docids[i]), int(w[i]), attrs))

        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in
                 zip(cq.slot_terms, cq.slot_df, cq.slot_hits)]
        return SearchResult(matches, n_avail, found, dt, stats)


def partition_documents(docs: list[dict], n_shards: int) -> list[list[dict]]:
    """Round-robin doc partition (the reference leaves sharding to the user's
    distributed config; round-robin by id keeps shards balanced)."""
    out: list[list[dict]] = [[] for _ in range(n_shards)]
    for d in docs:
        out[int(d["id"]) % n_shards].append(d)
    return out
