#!/usr/bin/env python
"""Smoke test of the served path on NVIDIA GPUs.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the corpus split over four cards

One card: build the seeded 1,000,000-document synthetic corpus
(manticoresearch_tpu/synthetic.py), save it, start the real daemon in this
process with the saved index as a plain table, and send query phases to it
over the MySQL wire and HTTP:
  (a) single-term MATCH top-10        (b) AND / OR / AND + year range
  (c) phrase "a b" and proximity      (d) GROUP BY group_id, one FACET
  (e) phase (b) through /json/search  (f) an RT table: 10,000 INSERTed
      (and /sql), equal to the wire       rows read back
  (g) AND queries ranked by the expression ranker over the float
      factors atc and tf_idf
Every answer of (a)-(f) is compared exactly with the host model
(manticoresearch_tpu/reference_model.py); (g) matches it exactly in
documents and totals and within 1 in each weight (see factor_answer_ok);
phases (a)-(d) and (g) run twice and must answer identically.

Four cards: the same corpus as four shards of a ShardedIndex on a 4-card
mesh answers phases (a)-(c); its answers must equal one card's SearchIndex
over the whole corpus and the host model. Nothing else runs.

Timings, compile counts, device memory and the cards' names and power
limits print along the way. The last line is one JSON object
{"ok": true, "device": {...}}. Without GPUs, or when any phase fails, the
script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(HERE, ".smoke")     # listed in .gitignore
SEED = 42
VOCAB = 50_000
AVG_LEN = 100
TOP_K = 10
FACTOR_RANKER = "sum((atc+tf_idf)*1000)"


class PhaseFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


# ---------------------------------------------------------------- queries
def term_bands(model, n_docs: int):
    """(dense, sparse) term pools by document frequency. At 1M docs the
    planner sends a single term with df <= 65,536 (a 64k posting bucket
    is at most N/4) through the sparse candidate pipeline, and more
    frequent terms through the dense one; the pools sit on either side."""
    df = model.p.term_docs
    ids = np.arange(len(df))
    dense = ids[(df > 0.07 * n_docs) & (df < 0.5 * n_docs)]
    sparse = ids[(df >= 0.002 * n_docs) & (df <= 0.05 * n_docs)]
    check(len(dense) >= 4 and len(sparse) >= 8,
          f"corpus too small for term bands ({len(dense)}, {len(sparse)})")
    terms = model.p.term_strs
    return [terms[i] for i in dense], [terms[i] for i in sparse]


def make_phases(model, n_docs: int, per_phase: int, seed: int = 7):
    """Query specs per phase: dicts with the host-model call (kind, terms,
    slop, range) and the SphinxQL text. Fresh seeded terms throughout."""
    rng = np.random.RandomState(seed)
    dense, sparse = term_bands(model, n_docs)

    def pick(pool, n):
        return [pool[i] for i in rng.choice(len(pool), n, replace=False)]

    def spec(kind, terms, slop=0, rng_=None):
        ops = {"term": " ", "and": " ", "or": " | "}
        if kind == "phrase":
            match = f'"{terms[0]} {terms[1]}"'
        elif kind == "proximity":
            match = f'"{terms[0]} {terms[1]}"~{slop}'
        else:
            match = ops[kind].join(terms)
        where = f"MATCH('{match}')"
        if rng_ is not None:
            where += f" AND {rng_[0]} BETWEEN {rng_[1]} AND {rng_[2]}"
        return {"kind": kind, "terms": terms, "slop": slop, "range": rng_,
                "match": match,
                "sql": f"SELECT id, weight() FROM main WHERE {where} "
                       f"LIMIT {TOP_K}"}

    half = per_phase // 2
    a = [spec("term", [t]) for t in pick(dense, min(half, len(dense)))]
    a += [spec("term", [t]) for t in pick(sparse, per_phase - len(a))]
    b = []
    year = ("year", 2005, 2018)
    for i in range(per_phase):
        r = i % 4
        if r == 0:
            b.append(spec("and", pick(sparse, 1) + pick(dense, 1)))
        elif r == 1:
            b.append(spec("or", pick(sparse, 2)))
        elif r == 2:
            # three terms: a float sum whose order matters, in the
            # sparse pipeline
            b.append(spec("or", pick(sparse, 3)))
        else:
            b.append(spec("and", pick(sparse, 1) + pick(dense, 1), rng_=year))
    c = []
    for i in range(per_phase):
        pair = pick(dense, 2) if i % 2 == 0 else pick(sparse, 1) + pick(dense, 1)
        c.append(spec("phrase", pair) if i < half
                 else spec("proximity", pair, slop=5))
    d = []
    for i in range(per_phase - 1):
        t = pick(dense if i % 2 == 0 else sparse, 1)
        s = spec("term", t)
        s["group"] = True
        s["sql"] = (f"SELECT group_id, count(*), sum(year) FROM main "
                    f"WHERE MATCH('{t[0]}') GROUP BY group_id "
                    f"ORDER BY count(*) DESC LIMIT {TOP_K}")
        d.append(s)
    t = pick(sparse, 1)
    s = spec("term", t)
    s["facet"] = True
    s["sql"] = (f"SELECT id, weight() FROM main WHERE MATCH('{t[0]}') "
                f"LIMIT {TOP_K} FACET group_id ORDER BY count(*) DESC "
                f"LIMIT {TOP_K}")
    d.append(s)
    g = []
    for i in range(half):
        s = spec("and", pick(sparse, 2) if i % 2 == 0
                 else pick(sparse, 1) + pick(dense, 1))
        s["sql"] += f" OPTION ranker=expr('{FACTOR_RANKER}')"
        g.append(s)
    return {"a": a, "b": b, "c": c, "d": d, "g": g}


def expected(model, s):
    """The host model's answer for one spec, in the shape answers take."""
    rows, w = model.evaluate(s["kind"], s["terms"], slop=s["slop"],
                             attr_range=s["range"])
    if s.get("group"):
        return {"groups": model.group(rows, w, "group_id", TOP_K,
                                      sum_attr="year")}
    out = {"top": model.top(rows, w, TOP_K), "total": len(rows)}
    if s.get("facet"):
        out["groups"] = model.group(rows, w, "group_id", TOP_K)
    return out


def factor_answer_ok(model, s, ans) -> int:
    """Check one phase (g) answer against the host model; return how many
    of its weights are one off.

    The factors are float32 values that pass through the card's log and
    pow, which may differ from numpy's by an ulp or two (the probe says
    how far), so a weight = trunc(value) may land one off where the value
    sits at an integer boundary. Exact: the documents matched and
    total_found. Within 1: each returned weight. And the list is in
    (weight desc, docid asc) order, with no document left out that the
    host model puts more than 1 above the last one returned."""
    rows, _ = model.evaluate("and", s["terms"])
    host = dict(zip(model.p.doc_ids[rows].tolist(), np.trunc(
        model.factor_weights(s["terms"], rows)).astype(np.int64).tolist()))
    top = ans["top"]
    where = f"phase g: {s['sql']}\n got {ans}"
    check(ans["total"] == len(rows), f"{where}\n total want {len(rows)}")
    check(len(top) == min(TOP_K, len(rows)), where)
    check(top == sorted(top, key=lambda dw: (-dw[1], dw[0])), where)
    off = 0
    for docid, w in top:
        check(docid in host and abs(host[docid] - w) <= 1,
              f"{where}\n host weight {host.get(docid)} for {docid}")
        off += host[docid] != w
    if top:
        taken = {docid for docid, _ in top}
        missed = [(d, w) for d, w in host.items()
                  if d not in taken and w > top[-1][1] + 1]
        check(not missed, f"{where}\n left out {missed[:5]}")
    return off


# ---------------------------------------------------------------- probes
def exactness_probes(n: int, log=print):
    """The device behaviours exact answers rest on, at width `n`, each
    beside its plain numpy reference: lax.top_k keeps the lower index on
    equal keys (checked: the engine relies on it), a float scatter-add
    with duplicate indices (reported) and the engine's in-order segment
    sums (checked). Also reports how far the backend's float32 log and
    pow (the ATC ranking factor) are from numpy's, in ulps."""
    import jax
    import jax.numpy as jnp

    from manticoresearch_tpu.ops.search import segment_sums_in_order
    rng = np.random.RandomState(3)
    key = rng.randint(0, 50, n).astype(np.int32)        # many equal keys
    want = np.lexsort((np.arange(n), -key))[:TOP_K]
    got = np.asarray(jax.jit(lambda k: jax.lax.top_k(k, TOP_K)[1])(key))
    check(np.array_equal(got, want), "lax.top_k tie order")
    log("probe: lax.top_k keeps the lower index first on ties")

    n_seg = max(n // 8, 1)
    seg = np.sort(rng.randint(0, n_seg, n)).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    seq = np.zeros(n_seg, np.float32)
    np.add.at(seq, seg, vals)                           # sequential order
    scat = jax.jit(lambda s, v: jnp.zeros(n_seg, jnp.float32).at[s].add(v))
    r1, r2 = np.asarray(scat(seg, vals)), np.asarray(scat(seg, vals))
    head = np.concatenate([[True], seg[1:] != seg[:-1]])
    ordered = np.asarray(jax.jit(
        lambda s, h, v: segment_sums_in_order(s, h, v, n_seg))(
        seg, head, vals))
    check(np.array_equal(ordered, seq),
          "segment_sums_in_order differs from the sequential sum")
    log(f"probe: float32 scatter-add with duplicate indices: same bits "
        f"run to run {np.array_equal(r1, r2)}, equal to the sequential sum "
        f"{np.array_equal(r1, seq)}; segment_sums_in_order: exact")

    x = np.linspace(1.0, 1000.0, n, dtype=np.float32)
    dev_log, dev_pow = jax.jit(
        lambda v: (jnp.log(v), v ** jnp.float32(1.75)))(x)

    def ulps(a, b):
        ai = np.asarray(a).view(np.int32).astype(np.int64)
        return int(np.max(np.abs(ai - b.view(np.int32).astype(np.int64))))
    log(f"probe: float32 log / pow(x, 1.75) vs numpy, max ulps: "
        f"{ulps(dev_log, np.log(x))} / "
        f"{ulps(dev_pow, x ** np.float32(1.75))}")


# ------------------------------------------------------------ the daemon
class Served:
    """The daemon on a thread of this process, and one client of each
    front end."""

    def __init__(self, index_dir: str):
        from manticoresearch_tpu.config import load_config
        from manticoresearch_tpu.server.daemon import Daemon
        from manticoresearch_tpu.server.mysql_client import MiniMysqlClient

        cfg_path = os.path.join(WORK_DIR, "smoke.toml")
        with open(cfg_path, "w") as f:
            f.write(f'[searchd]\nlisten_mysql = 0\nlisten_http = 0\n\n'
                    f'[index.main]\ntype = "plain"\npath = "{index_dir}"\n')
        cfg = load_config(cfg_path)
        self.daemon = Daemon(None, 0, 0, config=cfg)
        self.thread = threading.Thread(
            target=lambda: asyncio.run(self.daemon.run()), daemon=True)
        self.thread.start()
        check(self.daemon.ready.wait(120), "daemon did not start")
        ports = self.daemon.listening_ports()
        self.http_base = f"http://127.0.0.1:{ports['http']}"
        self.sql = MiniMysqlClient("127.0.0.1", ports["mysql"], timeout=600)

    def close(self):
        try:
            self.sql.close()
        finally:
            self.daemon.stop()
            self.thread.join(60)
        check(not self.thread.is_alive(), "daemon did not stop")

    def query(self, sql: str):
        res = self.sql.query_all(sql)
        for r in res:
            check("error" not in r, f"{sql}: {r.get('error')}")
        return res

    def total_found(self) -> int:
        meta = dict(self.query("SHOW META")[0]["rows"])
        return int(meta["total_found"])

    def http(self, path: str, body: bytes, ctype: str):
        req = urllib.request.Request(self.http_base + path, data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())


def answer(served, s):
    """One spec through the MySQL wire, in the shape `expected` gives."""
    res = served.query(s["sql"])
    if s.get("group"):
        return {"groups": [tuple(int(v) for v in r) for r in res[0]["rows"]]}
    out = {"top": [(int(r[0]), int(r[1])) for r in res[0]["rows"]],
           "total": served.total_found()}
    if s.get("facet"):
        check(len(res) == 2, f"FACET gave {len(res)} result sets")
        out["groups"] = [tuple(int(v) for v in r) for r in res[1]["rows"]]
    return out


def json_search(served, s):
    """A phase (b) spec through /json/search."""
    must = [{"query_string": s["match"]}]
    q = {"bool": {"must": must}}
    if s["range"] is not None:
        name, lo, hi = s["range"]
        q["bool"]["filter"] = [{"range": {name: {"gte": lo, "lte": hi}}}]
    out = served.http("/json/search", json.dumps(
        {"index": "main", "query": q, "limit": TOP_K}).encode(),
        "application/json")
    check("error" not in out, f"/json/search: {out.get('error')}")
    hits = out["hits"]
    return {"top": [(int(h["_id"]), int(h["_score"])) for h in hits["hits"]],
            "total": int(hits["total"])}


def run_phase(name, specs, fn, model, log):
    t0 = time.perf_counter()
    got = []
    for s in specs:
        ans = fn(s)
        want = expected(model, s)
        check(ans == want, f"phase {name}: {s['sql']}\n got  {ans}\n want {want}")
        got.append(ans)
    log(f"phase {name}: {len(specs)} queries match the host model "
        f"({time.perf_counter() - t0:.3f} s)")
    return got


def rt_phase(served, n_rows: int, log):
    """(f) SphinxQL INSERTs into a new RT table; every acknowledged row
    must be read back."""
    t0 = time.perf_counter()
    served.query("CREATE TABLE rtsmoke (title text, gid uint)")
    batch = 100
    for lo in range(0, n_rows, batch):
        vals = ", ".join(
            f"({i + 1}, 'rtall w{i % 97} u{i}', {i % 10})"
            for i in range(lo, min(lo + batch, n_rows)))
        r = served.query(f"INSERT INTO rtsmoke (id, title, gid) VALUES {vals}")
        check(r[0].get("affected") == min(batch, n_rows - lo),
              f"INSERT acknowledged {r[0].get('affected')} rows")
    cnt = served.query("SELECT COUNT(*) FROM rtsmoke WHERE MATCH('rtall')")
    check(cnt[0]["rows"] == [[str(n_rows)]], f"count(*) {cnt[0]['rows']}")
    ids = served.query(f"SELECT id FROM rtsmoke WHERE MATCH('rtall') "
                       f"ORDER BY id ASC LIMIT {n_rows} "
                       f"OPTION max_matches={n_rows}")
    check([int(r[0]) for r in ids[0]["rows"]] == list(range(1, n_rows + 1)),
          "MATCH did not read back every inserted row")
    check(served.total_found() == n_rows, "total_found != rows inserted")
    w5 = served.query(f"SELECT id FROM rtsmoke WHERE MATCH('w5') "
                      f"ORDER BY id ASC LIMIT {n_rows} "
                      f"OPTION max_matches={n_rows}")
    check([int(r[0]) for r in w5[0]["rows"]]
          == [i + 1 for i in range(n_rows) if i % 97 == 5],
          "MATCH('w5') rows differ from the inserted ones")
    log(f"phase f: {n_rows} rows inserted and read back "
        f"({time.perf_counter() - t0:.3f} s)")


def run_served(n_docs: int, per_phase: int, rt_rows: int, log=print):
    """Build, save, serve and check the corpus: phases (a)-(g) and the
    repeat of (a)-(d), (g). Raises PhaseFailure on any mismatch."""
    import jax

    from manticoresearch_tpu.index.storage import save_packed
    from manticoresearch_tpu.reference_model import HostModel
    from manticoresearch_tpu.synthetic import build_corpus

    t0 = time.perf_counter()
    packed = build_corpus(n_docs, VOCAB, AVG_LEN, SEED)[0]
    log(f"corpus: {packed.n_docs} docs, {packed.n_postings} postings, "
        f"{len(packed.hit_packed)} hits, built in "
        f"{time.perf_counter() - t0:.3f} s")
    index_dir = os.path.join(WORK_DIR, "main")
    t0 = time.perf_counter()
    save_packed(packed, index_dir)
    log(f"index saved in {time.perf_counter() - t0:.3f} s")
    model = HostModel(packed)
    phases = make_phases(model, n_docs, per_phase)

    t0 = time.perf_counter()
    served = Served(index_dir)
    try:
        stats = jax.devices()[0].memory_stats() or {}
        log(f"daemon up in {time.perf_counter() - t0:.3f} s; device "
            f"bytes_in_use {stats.get('bytes_in_use', 'not reported')}")
        first = {k: run_phase(k, phases[k], lambda s: answer(served, s),
                              model, log)
                 for k in "abcd"}
        got_e = run_phase("e", phases["b"], lambda s: json_search(served, s),
                          model, log)
        check(got_e == first["b"], "/json/search differs from the wire")
        s0 = phases["b"][0]
        out = served.http("/sql", urllib.parse.urlencode(
            {"query": s0["sql"]}).encode(),
            "application/x-www-form-urlencoded")
        check([(int(h["_id"]), int(h["_score"]))
               for h in out["hits"]["hits"]] == first["b"][0]["top"],
              "/sql differs from the wire")
        rt_phase(served, rt_rows, log)
        t0 = time.perf_counter()
        first["g"] = [answer(served, s) for s in phases["g"]]
        off = sum(factor_answer_ok(model, s, ans)
                  for s, ans in zip(phases["g"], first["g"]))
        log(f"phase g: {len(phases['g'])} queries, ranker=expr"
            f"('{FACTOR_RANKER}'): documents and totals equal to the host "
            f"model, {off} of {sum(len(a['top']) for a in first['g'])} "
            f"weights one off, none further "
            f"({time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        again = {k: [answer(served, s) for s in phases[k]] for k in "abcdg"}
        check(again == first,
              "phases (a)-(d), (g) answered differently on repeat")
        log(f"repeat of phases a-d, g: identical "
            f"({time.perf_counter() - t0:.3f} s)")
    finally:
        served.close()


def run_four_cards(n_docs: int, per_phase: int, log=print):
    """Phases (a)-(c) on a 4-shard ShardedIndex over four cards, against
    one card's SearchIndex over the whole corpus and the host model."""
    import jax

    from manticoresearch_tpu.exec.searcher import SearchIndex, SearchQuery
    from manticoresearch_tpu.parallel.sharded import ShardedIndex, make_mesh
    from manticoresearch_tpu.query.planner import AttrFilterDef
    from manticoresearch_tpu.reference_model import HostModel
    from manticoresearch_tpu.synthetic import build_corpus

    t0 = time.perf_counter()
    whole = build_corpus(n_docs, VOCAB, AVG_LEN, SEED)[0]
    shards = build_corpus(n_docs, VOCAB, AVG_LEN, SEED, n_shards=4)
    log(f"corpus: {whole.n_docs} docs whole and as 4 shards, built in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    one = SearchIndex(whole, device=jax.devices()[0])
    four = ShardedIndex(shards, make_mesh(4))
    log(f"indexes on device in {time.perf_counter() - t0:.3f} s")
    model = HostModel(whole)
    phases = make_phases(model, n_docs, per_phase)
    for name in "abc":
        t0 = time.perf_counter()
        for s in phases[name]:
            filt = ([AttrFilterDef(s["range"][0], "range_i",
                                   lo=s["range"][1], hi=s["range"][2])]
                    if s["range"] else [])
            q = SearchQuery(match=s["match"], filters=filt, limit=TOP_K)
            want = expected(model, s)
            for label, idx in (("one card", one), ("four cards", four)):
                r = idx.search(q)
                check(r.error is None, f"{label}: {r.error}")
                got = {"top": [(m.docid, m.weight) for m in r.matches],
                       "total": r.total_found}
                check(got == want, f"{label} phase {name}: {s['match']}\n"
                      f" got  {got}\n want {want}")
        log(f"phase {name}: {len(phases[name])} queries, four cards = one "
            f"card = host model ({time.perf_counter() - t0:.3f} s)")


# ------------------------------------------------------------------ main
def _compile_counter():
    """Count XLA programs built (or fetched from the persistent cache)
    and the seconds spent on them, from JAX's monitoring events."""
    import jax

    box = {"programs": 0, "seconds": 0.0, "cache_hits": 0}

    def on_duration(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            box["programs"] += 1
            box["seconds"] += duration

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            box["cache_hits"] += 1

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    jax.monitoring.register_event_listener(on_event)
    return box


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card ShardedIndex path")
    ap.add_argument("--docs", type=int, default=1_000_000,
                    help="corpus size (smaller sizes are for a first "
                         "compile check)")
    args = ap.parse_args(argv)

    from manticoresearch_tpu.gpu import NoGpuError, card_lines, require_gpus
    count = 4 if args.four_cards else 1
    try:
        devs = require_gpus(count)
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    from manticoresearch_tpu.compile_cache import configure_compile_cache
    from manticoresearch_tpu.native import get_native_lib

    def log(msg):
        print(msg, flush=True)

    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    for ln in card_lines():
        log(f"card: {ln}")
    log(f"compile cache: {configure_compile_cache()}")
    log(f"native tokenizer loaded: {get_native_lib() is not None}")
    compiles = _compile_counter()
    t0 = time.perf_counter()
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    try:
        if args.four_cards:
            # 8 queries a phase: every plan shape compiles twice in this
            # mode (one card and the sharded program)
            run_four_cards(args.docs, 8, log)
        else:
            exactness_probes(args.docs, log)
            run_served(args.docs, 16, 10_000, log)
    except PhaseFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    log(f"compiles: {compiles['programs']} programs, "
        f"{compiles['seconds']:.3f} s, {compiles['cache_hits']} from the "
        f"persistent cache; total {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
