#!/usr/bin/env python
"""Benchmark: the BASELINE.json config matrix on one GPU.

Methodology:
- every timing rep dispatches a FRESH query batch, never a repeat of an
  input already run;
- warmup batches compile the plan shapes; measurement batches draw new
  terms from the same frequency bands so shapes stay warm;
- each batch pays one device->host fetch (the serving daemon's batching
  model); per-batch wall times give p50/p99 batch latency;
- the measurement window is time-boxed so a compile storm still
  produces a (partial) result instead of running past the deadline.

Refuses to run without a GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N,
   "device": {...}, "configs": {...}, "latency_ms": {...}}
and exits non-zero, after an error line of the same shape, on failure.

The reference publishes no benchmark numbers (SURVEY §6; BASELINE.md
documents the round-2 reference-build attempt and its bison/flex
blocker), so vs_baseline is against the fixed VS_BASELINE_QPS estimate.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

VS_BASELINE_QPS = 2000.0


def build_corpus(n_docs: int, vocab: int, avg_len: int, seed: int = 42):
    from manticoresearch_tpu.synthetic import build_corpus as _build
    return _build(n_docs, vocab, avg_len, seed)[0]


class WorkloadGen:
    """Query generators per BASELINE config.

    Every draw returns a (warmup_term, measured_term) TWIN: two distinct
    terms from the same (posting-bucket, hit-bucket) class, so warmup
    batches compile exactly the plan shapes the measured batches use
    while the measured batch is never a repeat of an input already run
    (a serving daemon compiles each shape once)."""

    def __init__(self, rng, vocab: int, packed, lo=3, hi=2000):
        self.rng = rng
        self.vocab = vocab
        self.width = max(4, len(str(vocab - 1)))
        # class map over the sampling band: (pb, hb) -> term ids
        def p2(x):
            n = 1024
            while n < x:
                n <<= 1
            return n
        self.band = []
        classes: dict = {}
        td = packed.term_docs
        th = packed.term_hits if hasattr(packed, "term_hits") else None
        # the packed-store width classes are part of the plan shape too
        # (sig.slot_packed): twins must share them or warmup misses
        store = packed.packed_store()
        for t in range(lo, min(hi, vocab)):
            df = int(td[t]) if t < len(td) else 0
            hits = int(th[t]) if th is not None and t < len(th) else df
            pk = tuple(store.term_class[t]) if t < len(store.term_class) \
                else (0, 0, 0)
            classes.setdefault((p2(df), p2(hits), pk), []).append(t)
        # keep classes with >= 2 members so twins differ; cap the class
        # count (top by population) — every distinct class is a distinct
        # compiled plan shape, and the matrix of shapes (esp. two-term
        # configs) otherwise turns warmup into a compile storm
        pool = sorted((v for v in classes.values() if len(v) >= 2),
                      key=len, reverse=True)[:4]
        self.classes = pool
        if not self.classes:
            self.classes = [list(range(lo, min(hi, vocab)))]

    def _fmt(self, t):
        return f"t{t:0{self.width}d}"

    def term(self, avoid_class: int = -1):
        """-> (warm_term_str, measured_term_str, class_id): twins from one
        shape class (avoid_class forces a different class so two-term
        queries never collapse a slot in one batch arm only)."""
        while True:
            ci = int(self.rng.randint(len(self.classes)))
            if ci != avoid_class or len(self.classes) == 1:
                break
        cls = self.classes[ci]
        i, j = self.rng.choice(len(cls), 2, replace=False) \
            if len(cls) >= 2 else (0, 0)
        return self._fmt(cls[i]), self._fmt(cls[j]), ci

    def config1(self, n):
        """single-term MATCH() BM25 top-10."""
        from manticoresearch_tpu.exec.searcher import SearchQuery
        pairs = [self.term() for _ in range(n)]
        return ([SearchQuery(match=w, limit=10) for w, _m, _c in pairs],
                [SearchQuery(match=m, limit=10) for _w, m, _c in pairs])

    def config2(self, n):
        """boolean AND/OR + integer range filters (mixed)."""
        from manticoresearch_tpu.exec.searcher import SearchQuery
        from manticoresearch_tpu.query.planner import AttrFilterDef
        warm, meas = [], []
        for _ in range(n):
            r = self.rng.rand()
            w1, m1, c1 = self.term()
            w2, m2, _c2 = self.term(avoid_class=c1)
            if r < 0.4:
                warm.append(SearchQuery(match=w1, limit=10))
                meas.append(SearchQuery(match=m1, limit=10))
            elif r < 0.7:
                warm.append(SearchQuery(match=f"{w1} {w2}", limit=10))
                meas.append(SearchQuery(match=f"{m1} {m2}", limit=10))
            elif r < 0.9:
                warm.append(SearchQuery(match=f"{w1} | {w2}", limit=10))
                meas.append(SearchQuery(match=f"{m1} | {m2}", limit=10))
            else:
                filt = [AttrFilterDef("year", "range_i", lo=2005, hi=2018)]
                warm.append(SearchQuery(match=f"{w1} {w2}", filters=filt,
                                        limit=10))
                meas.append(SearchQuery(match=f"{m1} {m2}", filters=filt,
                                        limit=10))
        return warm, meas

    def config3(self, n):
        """phrase / proximity + per-field weights (positional path)."""
        from manticoresearch_tpu.exec.searcher import SearchQuery
        warm, meas = [], []
        fwt = {"content": 3}
        for _ in range(n):
            w1, m1, c1 = self.term()
            w2, m2, _c2 = self.term(avoid_class=c1)
            if self.rng.rand() < 0.5:
                warm.append(SearchQuery(match=f'"{w1} {w2}"', limit=10,
                                        field_weights=fwt))
                meas.append(SearchQuery(match=f'"{m1} {m2}"', limit=10,
                                        field_weights=fwt))
            else:
                warm.append(SearchQuery(match=f'"{w1} {w2}"~5', limit=10,
                                        field_weights=fwt))
                meas.append(SearchQuery(match=f'"{m1} {m2}"~5', limit=10,
                                        field_weights=fwt))
        return warm, meas

    def config4(self, n):
        """faceted: GROUP BY + aggregate + ORDER BY count."""
        from manticoresearch_tpu.exec.searcher import SearchQuery

        def mk(t):
            return SearchQuery(match=t, group_by="group_id",
                               select=["count(*)", "sum(year)"],
                               sort=[("@count", False)], limit=10)
        pairs = [self.term() for _ in range(n)]
        return ([mk(w) for w, _m, _c in pairs],
                [mk(m) for _w, m, _c in pairs])


def _run_batches(idx, gen_pair, n_batches, batch_size, budget_s,
                 batched=True, deadline=None):
    """For each measured batch, first run its shape-twin warmup batch
    (same plan shapes, different terms): compiles are paid outside the
    timed region and no input is ever dispatched twice. QPS uses the
    MEDIAN batch time — robust to a residual cold compile, which still
    shows in the p99 latency. Returns (qps, [batch_secs]); qps is None
    when the global deadline left no room to measure anything."""
    def run(batch):
        rs = (idx.search_batch(batch) if batched
              else [idx.search(q) for q in batch])
        for r in rs:
            assert r.error is None, r.error

    times = []
    t_all = time.perf_counter()
    for bi in range(n_batches):
        if deadline is not None and time.perf_counter() > deadline:
            break
        warm, meas = gen_pair(batch_size)
        run(warm)
        if bi == 0:
            # the first warmup pays the compiles; the measurement budget
            # starts once shapes are hot (the global deadline still
            # bounds total wall)
            t_all = time.perf_counter()
        t0 = time.perf_counter()
        run(meas)
        times.append(time.perf_counter() - t0)
        if time.perf_counter() - t_all > budget_s:
            break
    if not times:
        return None, []
    qps = batch_size / float(np.median(times))
    return qps, times


def parity_recall_at_10(idx, gen, n_queries: int = 24) -> float:
    """Couple the measured QPS to a parity-checked result set: before
    timing, run single-term top-10 queries on the SAME built index and
    compare the engine's (docid, weight) lists with the host model of the
    reference semantics (manticoresearch_tpu/reference_model.py). Returns
    mean recall@10 (1.0 = exact)."""
    from manticoresearch_tpu.exec.searcher import SearchQuery
    from manticoresearch_tpu.reference_model import HostModel

    model = HostModel(idx.packed)
    total = 0.0
    for _ in range(n_queries):
        _w, term, _c = gen.term()
        r = idx.search(SearchQuery(match=term, limit=10))
        if r.error is not None:
            raise RuntimeError(r.error)
        got = [(m.docid, m.weight) for m in r.matches]
        want = model.top(*model.evaluate("term", [term]), 10)
        hit = sum(1 for g in got if g in want)
        total += hit / max(len(want), len(got), 1)
    return round(total / max(n_queries, 1), 4)


def _emit_error(err: str, stage: str):
    """Failure contract: print one parseable JSON line with an `error`
    field (the caller then exits non-zero)."""
    print(json.dumps({
        "metric": "mixed_boolean_bm25_top10_qps",
        "value": 0.0,
        "unit": "qps",
        "vs_baseline": 0.0,
        "error": f"{stage}: {err}"[:2000],
        "configs": {},
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--avg-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--budget", type=float, default=45.0,
                    help="per-config measurement budget, seconds")
    ap.add_argument("--deadline", type=float, default=900.0,
                    help="global wall deadline, seconds: finish what's "
                    "measured and emit the JSON line (0 = unbounded)")
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma list of BASELINE configs to run")
    ap.add_argument("--scale-docs", default="1000000",
                    help="comma list of extra corpus sizes for the scale "
                    "section (config 1+3 re-runs); empty disables")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    from manticoresearch_tpu.compile_cache import configure_compile_cache
    from manticoresearch_tpu.gpu import card_lines, require_gpus
    devs = require_gpus()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "cards": card_lines()}
    configure_compile_cache()

    from manticoresearch_tpu.exec.searcher import SearchIndex

    t0 = time.perf_counter()
    packed = build_corpus(args.docs, args.vocab, args.avg_len)
    t_build = time.perf_counter() - t0
    idx = SearchIndex(packed)
    rng = np.random.RandomState(7)
    gen = WorkloadGen(rng, args.vocab, packed)

    # parity gate BEFORE timing: the same built index must
    # reproduce an independent host model of the reference scoring. QPS is
    # only honest next to recall@10 = 1.0.
    recall = parity_recall_at_10(idx, gen)
    if recall < 1.0:
        raise RuntimeError(f"recall@10 parity failed: {recall} < 1.0 "
                           "(device results diverge from the host "
                           "reference model); refusing to report QPS")

    wanted = {c.strip() for c in args.configs.split(",")}
    deadline = (time.perf_counter() + args.deadline) if args.deadline \
        else None
    configs = {}
    warnings: list[str] = []
    all_times: list[float] = []
    mains = [(cid, fn, b2) for cid, fn, b2 in (
        ("1_single_term_bm25", gen.config1, True),
        ("2_boolean_filters", gen.config2, True),
        ("3_phrase_proximity", gen.config3, True),
        ("4_facet_groupby", gen.config4, True),
    ) if cid[0] in wanted]
    # reserve tail slices for config 5 + the scale section so early
    # compile storms can't consume their wall
    n_slices = len(mains) + (1 if "5" in wanted else 0) \
        + (1 if str(args.scale_docs).strip(", ") else 0)
    t_cfg0 = time.perf_counter()
    for ci_, (cid, gen_fn, batched) in enumerate(mains):
        # per-config deadline slice: one config's compile storm (a cold
        # persistent cache recompiles everything) must not starve the rest
        cfg_deadline = deadline
        if deadline is not None:
            frac = (ci_ + 1) / max(n_slices, 1)
            cfg_deadline = min(deadline,
                               t_cfg0 + (deadline - t_cfg0) * frac)
        if deadline is not None and time.perf_counter() > deadline:
            configs[cid] = None
            warnings.append(f"{cid}: global deadline exhausted before "
                            "this config ran")
            continue
        bs = args.batch if batched else max(args.batch // 8, 8)
        if cid.startswith("4"):
            bs = max(args.batch // 4, 8)   # grouped kernels are heavier
        qps, times = _run_batches(idx, gen_fn, args.batches, bs,
                                  args.budget, batched, cfg_deadline)
        if qps is None:
            # a missing config must be an explicit null + warning, never
            # a silent drop
            configs[cid] = None
            warnings.append(f"{cid}: deadline slice expired before one "
                            "measured batch completed")
            continue
        configs[cid] = round(qps, 1)
        all_times += times
        if args.verbose:
            import sys
            print(f"# {cid}: {qps:.1f} qps over {len(times)} fresh batches "
                  f"(batch p50 {np.percentile(times, 50)*1e3:.0f}ms)",
                  file=sys.stderr)

    if "5" in wanted:
        # config 5: distributed over mesh shards (one shard per device;
        # on one card this is a 1-shard shard_map, which still measures
        # the shard_mapped program + packed posting path). Batched: one
        # shard_mapped launch serves the whole batch (searchd.cpp:6737
        # one-merged-chunk-per-agent, as one XLA program).
        cid5 = "5_distributed"
        if deadline is not None and time.perf_counter() > deadline:
            configs[cid5] = None
            warnings.append(f"{cid5}: global deadline exhausted")
        else:
            import jax as _jax
            from manticoresearch_tpu.parallel.sharded import ShardedIndex
            from manticoresearch_tpu.synthetic import build_corpus as _bc
            D = min(8, len(_jax.devices()))
            shards = _bc(args.docs, args.vocab, args.avg_len, n_shards=D)
            sidx = ShardedIndex(shards[:D])
            cfg_deadline = deadline
            if deadline is not None:
                frac = (len(mains) + 1) / max(n_slices, 1)
                cfg_deadline = min(deadline,
                                   t_cfg0 + (deadline - t_cfg0) * frac)
            qps, times = _run_batches(sidx, gen.config1, args.batches,
                                      args.batch, args.budget,
                                      batched=True, deadline=cfg_deadline)
            cid5 = f"5_distributed_{len(shards[:D])}shard"
            if qps is not None:
                configs[cid5] = round(qps, 1)
                all_times += times
                if args.verbose:
                    import sys
                    print(f"# {cid5} ({D} shards): {qps:.1f} qps",
                          file=sys.stderr)
            else:
                configs[cid5] = None
                warnings.append(f"{cid5}: deadline slice expired before "
                                "one measured batch completed")

    # scale section: re-run key configs on a large corpus to exercise
    # the sparse pipeline at its own target scale (the >=400k-doc gate
    # activates here, and the packed store is what makes it fit)
    scale = {}
    for nd in [int(x) for x in str(args.scale_docs).split(",") if x]:
        if nd <= 0:
            continue
        if deadline is not None and time.perf_counter() > deadline - 60:
            scale[f"{nd // 1000}k_docs"] = None
            warnings.append(f"scale {nd // 1000}k: deadline exhausted "
                            "before the corpus was built")
            continue
        t0 = time.perf_counter()
        p2 = build_corpus(nd, args.vocab, args.avg_len, seed=43)
        idx2 = SearchIndex(p2)
        gen2 = WorkloadGen(np.random.RandomState(11), args.vocab, p2)
        sc = {"build_s": round(time.perf_counter() - t0, 1)}
        for cid, fn in (("1_single_term_bm25", gen2.config1),
                        ("3_phrase_proximity", gen2.config3)):
            if cid[0] not in wanted:
                continue
            if deadline is not None and time.perf_counter() > deadline:
                sc[cid] = None
                warnings.append(f"scale {nd // 1000}k {cid}: deadline")
                continue
            qps2, t2 = _run_batches(idx2, fn, args.batches, args.batch,
                                    args.budget, True, deadline)
            if qps2 is not None:
                sc[cid] = round(qps2, 1)
                if args.verbose:
                    import sys
                    print(f"# scale {nd//1000}k {cid}: {qps2:.1f} qps",
                          file=sys.stderr)
            else:
                sc[cid] = None
                warnings.append(f"scale {nd // 1000}k {cid}: deadline "
                                "slice expired")
        scale[f"{nd // 1000}k_docs"] = sc
        del idx2, p2, gen2

    # headline: configs 1+2 blended (the round-1 comparable number)
    meas = {k: v for k, v in configs.items() if v is not None}
    head = [v for k, v in meas.items() if k[0] in "12"]
    headline = round(float(np.mean(head)) if head
                     else float(np.mean(list(meas.values())))
                     if meas else 0.0, 1)
    lat = {
        "batch_p50_ms": round(float(np.percentile(all_times, 50)) * 1e3, 1),
        "batch_p99_ms": round(float(np.percentile(all_times, 99)) * 1e3, 1),
    } if all_times else {}
    if args.verbose:
        import sys
        print(f"# build={t_build:.1f}s docs={args.docs} "
              f"postings={packed.n_postings}", file=sys.stderr)

    out = {
        "metric": f"mixed_boolean_bm25_top10_qps_{args.docs // 1000}k_docs",
        "value": headline,
        "unit": "qps",
        "vs_baseline": round(headline / VS_BASELINE_QPS, 3),
        "recall_at_10": recall,
        "configs": configs,
        "scale": scale,
        "latency_ms": lat,
        "device": device,
    }
    if warnings:
        out["warnings"] = warnings
    print(json.dumps(out))


if __name__ == "__main__":
    try:
        main()
    except Exception as _e:  # noqa: BLE001 — report, then fail
        import traceback
        import sys
        traceback.print_exc(file=sys.stderr)
        _emit_error(str(_e) or type(_e).__name__, "run")
        sys.exit(1)
