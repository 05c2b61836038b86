"""Protocol frontends end-to-end: HTTP JSON API + MySQL wire protocol,
over real sockets (the reference tests its daemon with real connections —
helpers.inc StartSearchd; same idea in-process)."""
import asyncio
import json
import threading
import time

import pytest

from manticoresearch_tpu.exec.session import Catalog, Session
from manticoresearch_tpu.server.http import HttpServer
from manticoresearch_tpu.server.mysql import MysqlServer
from manticoresearch_tpu.server.mysql_client import MiniMysqlClient


def _seed(catalog):
    s = Session(catalog)
    for r in s.execute(
            "CREATE TABLE films (title text, plot text, year uint, "
            "rating float)"):
        assert r.error is None, r.error
    r = s.execute(
        "INSERT INTO films (id, title, plot, year, rating) VALUES "
        "(1, 'The Matrix', 'hacker discovers reality', 1999, 8.7), "
        "(2, 'The Matrix Reloaded', 'hacker fights machines', 2003, 7.2), "
        "(3, 'Inception', 'dream within a dream heist', 2010, 8.8), "
        "(4, 'Blade Runner', 'replicant hunter in future city', 1982, 8.1)")
    assert r[0].error is None


@pytest.fixture(scope="module")
def catalog():
    c = Catalog()
    _seed(c)
    return c


# ---------------- HTTP (direct dispatch, no socket) ----------------

@pytest.fixture(scope="module")
def http(catalog):
    return HttpServer(catalog)


def http_json(http, route, payload):
    status, _, body = http.handle_request(
        "POST", route, {}, json.dumps(payload).encode())
    return status, json.loads(body)


class TestHttpJson:
    def test_search_match(self, http):
        status, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"match": {"title": "matrix"}},
        })
        assert status.startswith("200")
        assert out["hits"]["total"] == 2
        ids = [h["_id"] for h in out["hits"]["hits"]]
        assert sorted(ids) == [1, 2]

    def test_search_bool_and_range(self, http):
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"bool": {
                "must": [{"match": {"_all": "hacker"}}],
                "filter": [{"range": {"year": {"gte": 2000}}}],
            }},
        })
        assert [h["_id"] for h in out["hits"]["hits"]] == [2]

    def test_search_must_not(self, http):
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"bool": {
                "must": [{"match": {"title": "matrix"}}],
                "must_not": [{"match": {"title": "reloaded"}}],
            }},
        })
        assert [h["_id"] for h in out["hits"]["hits"]] == [1]

    def test_match_phrase(self, http):
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"match_phrase": {"plot": "within heist"}},
        })
        assert out["hits"]["total"] == 0
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"match_phrase": {"plot": "a dream heist"}},
        })
        assert [h["_id"] for h in out["hits"]["hits"]] == [3]

    def test_sort_and_source(self, http):
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"match_all": {}},
            "sort": [{"rating": "desc"}],
            "_source": ["year"],
            "limit": 2,
        })
        hits = out["hits"]["hits"]
        assert [h["_id"] for h in hits] == [3, 1]
        assert hits[0]["_source"] == {"year": 2010}

    def test_aggs(self, http):
        _, out = http_json(http, "/json/search", {
            "index": "films",
            "query": {"match": {"_all": "hacker | dream | replicant"}},
            "aggs": {"by_year": {"terms": {"field": "year", "size": 10}}},
        })
        buckets = out["aggregations"]["by_year"]["buckets"]
        assert {b["key"]: b["doc_count"] for b in buckets} == {
            1999: 1, 2003: 1, 2010: 1, 1982: 1}

    def test_insert_and_delete(self, http):
        status, out = http_json(http, "/json/insert", {
            "index": "films", "id": 100,
            "doc": {"title": "Alien", "plot": "space horror", "year": 1979,
                    "rating": 8.5}})
        assert out["result"] == "created"
        _, out = http_json(http, "/json/search", {
            "index": "films", "query": {"match": {"_all": "alien"}}})
        assert out["hits"]["total"] == 1
        _, out = http_json(http, "/json/delete", {
            "index": "films", "id": 100})
        assert out["deleted"] == 1

    def test_bulk(self, http):
        body = "\n".join([
            json.dumps({"insert": {"index": "films", "id": 201,
                                   "doc": {"title": "Dune", "plot": "desert",
                                           "year": 2021, "rating": 8.0}}}),
            json.dumps({"delete": {"index": "films", "id": 201}}),
        ])
        status, _, payload = http.handle_request("POST", "/json/bulk", {},
                                                 body.encode())
        out = json.loads(payload)
        assert not out["errors"]

    def test_sql_endpoint(self, http):
        status, _, payload = http.handle_request(
            "POST", "/sql", {},
            b"query=SELECT id FROM films WHERE MATCH('inception')")
        out = json.loads(payload)
        # /sql SELECT renders the search-result shape (golden test_234)
        assert [h["_id"] for h in out["hits"]["hits"]] == ["3"]

    def test_error_unknown_index(self, http):
        status, out = http_json(http, "/json/search", {
            "index": "nope", "query": {"match_all": {}}})
        assert status.startswith("400")
        assert "no such table" in out["error"]

    def test_unknown_endpoint(self, http):
        status, _, _ = http.handle_request("GET", "/whatever", {}, b"")
        assert status.startswith("404")


# ---------------- HTTP over a real socket ----------------

class TestHttpSocket:
    def test_real_socket_roundtrip(self, catalog):
        import requests

        srv = HttpServer(catalog, port=0)
        loop = asyncio.new_event_loop()
        started = threading.Event()
        port_holder = {}

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(srv.start())
            port_holder["port"] = srv._server.sockets[0].getsockname()[1]
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10)
        port = port_holder["port"]
        resp = requests.post(
            f"http://127.0.0.1:{port}/json/search",
            json={"index": "films", "query": {"match": {"title": "matrix"}}},
            timeout=10)
        assert resp.status_code == 200
        assert resp.json()["hits"]["total"] == 2
        loop.call_soon_threadsafe(loop.stop)


# ---------------- MySQL wire over a real socket ----------------

class TestMysqlWire:
    @pytest.fixture(scope="class")
    def server_port(self, catalog):
        srv = MysqlServer(catalog, port=0)
        loop = asyncio.new_event_loop()
        started = threading.Event()
        holder = {}

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(srv.start())
            holder["port"] = srv._server.sockets[0].getsockname()[1]
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10)
        yield holder["port"]
        loop.call_soon_threadsafe(loop.stop)

    def test_select_over_wire(self, server_port):
        c = MiniMysqlClient("127.0.0.1", server_port)
        try:
            out = c.query("SELECT id, title, year FROM films "
                          "WHERE MATCH('matrix') ORDER BY year ASC")
            assert out.get("error") is None
            assert out["columns"] == ["id", "title", "year"]
            assert [r[0] for r in out["rows"]] == ["1", "2"]
            assert out["rows"][0][1] == "The Matrix"
        finally:
            c.close()

    def test_handshake_probe_over_wire(self, server_port):
        # what mysql CLI / connectors send right after connecting
        c = MiniMysqlClient("127.0.0.1", server_port)
        try:
            out = c.query("select @@version_comment limit 1")
            assert out.get("error") is None
            assert out["rows"] == [["manticoresearch-tpu"]]
        finally:
            c.close()

    def test_insert_and_show_meta(self, server_port):
        c = MiniMysqlClient("127.0.0.1", server_port)
        try:
            out = c.query("INSERT INTO films (id, title, plot, year, rating)"
                          " VALUES (50, 'Arrival', 'aliens language', 2016,"
                          " 7.9)")
            assert out.get("ok")
            out = c.query("SELECT id FROM films WHERE MATCH('arrival')")
            assert out["rows"] == [["50"]]
            out = c.query("SHOW META")
            meta = dict((r[0], r[1]) for r in out["rows"])
            assert meta["total_found"] == "1"
            c.query("DELETE FROM films WHERE id = 50")
        finally:
            c.close()

    def test_error_over_wire(self, server_port):
        c = MiniMysqlClient("127.0.0.1", server_port)
        try:
            out = c.query("SELECT FROM nothing")
            assert "error" in out
        finally:
            c.close()

    def test_ping(self, server_port):
        c = MiniMysqlClient("127.0.0.1", server_port)
        try:
            c.seq = 255
            c._send_packet(b"\x0e")
            assert c._read_packet()[0] == 0x00
        finally:
            c.close()


class TestMysqlTlsCompress:
    """TLS upgrade + compressed protocol (searchdssl.cpp:524,
    compressed_mysql.cpp:91)."""

    @pytest.fixture(scope="class")
    def tls_port(self, catalog):
        srv = MysqlServer(catalog, port=0, ssl=True)
        loop = asyncio.new_event_loop()
        started = threading.Event()
        holder = {}

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(srv.start())
            holder["port"] = srv._server.sockets[0].getsockname()[1]
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10)
        yield holder["port"]
        loop.call_soon_threadsafe(loop.stop)

    def test_tls_select(self, tls_port):
        c = MiniMysqlClient("127.0.0.1", tls_port, use_ssl=True)
        try:
            out = c.query("SELECT id FROM films WHERE MATCH('matrix') "
                          "ORDER BY id ASC")
            assert out.get("error") is None
            assert [r[0] for r in out["rows"]] == ["1", "2"]
        finally:
            c.close()

    def test_compressed_select(self, tls_port):
        c = MiniMysqlClient("127.0.0.1", tls_port, compress=True)
        try:
            # result set big enough to cross MIN_COMPRESS_LENGTH both ways
            out = c.query("SELECT id, title, year FROM films "
                          "ORDER BY id ASC LIMIT 10")
            assert out.get("error") is None
            assert len(out["rows"]) >= 3
            out = c.query("SHOW META")
            assert out.get("error") is None
        finally:
            c.close()

    def test_tls_plus_compress(self, tls_port):
        c = MiniMysqlClient("127.0.0.1", tls_port, use_ssl=True,
                            compress=True)
        try:
            out = c.query("SELECT id, title FROM films WHERE "
                          "MATCH('matrix') ORDER BY id ASC")
            assert out.get("error") is None
            assert out["rows"][0][1] == "The Matrix"
        finally:
            c.close()

    def test_plain_client_still_works(self, tls_port):
        c = MiniMysqlClient("127.0.0.1", tls_port)
        try:
            out = c.query("SELECT id FROM films ORDER BY id ASC LIMIT 1")
            assert out.get("error") is None
        finally:
            c.close()


class TestCrashQueryDump:
    def test_unexpected_fault_logged_and_served(self, catalog, caplog,
                                                monkeypatch):
        """An unhandled exception inside one statement leaves a crash dump
        (statement + backtrace) in the daemon log and the session keeps
        serving (SphCrashLogger_c, searchd.cpp:17886)."""
        import logging
        from manticoresearch_tpu.exec.session import Session

        sess = Session(catalog)
        orig = Session._dispatch

        def boom(self, st):
            from manticoresearch_tpu.query.sphinxql import SelectStmt
            if isinstance(st, SelectStmt) and "segfault" in repr(st.conds):
                raise RuntimeError("simulated crash")
            return orig(self, st)

        monkeypatch.setattr(Session, "_dispatch", boom)
        with caplog.at_level(logging.ERROR,
                             logger="manticoresearch_tpu.daemon"):
            rs = sess.execute(
                "SELECT id FROM films WHERE MATCH('segfault'); "
                "SELECT id FROM films ORDER BY id ASC LIMIT 1")
        assert rs[0].error and "internal error" in rs[0].error
        assert rs[1].error is None          # the session keeps serving
        joined = "\n".join(r.getMessage() for r in caplog.records)
        assert "CRASH DUMP" in joined
        assert "segfault" in joined and "RuntimeError" in joined


class TestHttpPq:
    def test_pq_http_flow(self, catalog):
        http2 = HttpServer(catalog)
        s, _, payload = http2.handle_request(
            "POST", "/sql", {},
            b"query=CREATE TABLE IF NOT EXISTS alerts (content text) type='pq'")
        assert s.startswith("200"), payload
        s, out = http_json(http2, "/json/pq/alerts/doc",
                           {"query": {"ql": "matrix | replicant"}})
        assert out["created"] is True
        qid = out["_id"]
        s, out = http_json(http2, "/json/pq/alerts/search", {
            "query": {"percolate": {"documents": [
                {"content": "the matrix has you"},
                {"content": "nothing here"},
            ]}}})
        assert out["hits"]["total"] == 1
        hit = out["hits"]["hits"][0]
        assert hit["_id"] == qid
        assert hit["fields"]["_percolator_document_slot"] == [1]


class TestMysqlMultiResult:
    def test_facet_multi_result(self, catalog):
        import asyncio, threading
        from manticoresearch_tpu.server.mysql import MysqlServer
        srv = MysqlServer(catalog, port=0)
        loop = asyncio.new_event_loop()
        started = threading.Event()
        holder = {}

        def run():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(srv.start())
            holder["port"] = srv._server.sockets[0].getsockname()[1]
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(10)
        c = MiniMysqlClient("127.0.0.1", holder["port"])
        try:
            # first result set of a FACET query; server flags MORE_RESULTS
            # and the facet's result set follows on the wire
            out, facet = c.query_all(
                "SELECT id FROM films WHERE MATCH('matrix') FACET year")
            assert out.get("error") is None
            assert len(out["rows"]) == 2
            assert facet["columns"][0] == "year"
            assert sorted(r[0] for r in facet["rows"]) == ["1999", "2003"]
        finally:
            c.sock.close()
        loop.call_soon_threadsafe(loop.stop)


class TestClientHandshakeCompat:
    def test_sysvar_selects(self):
        from manticoresearch_tpu.exec.session import Catalog, Session
        s = Session(Catalog())
        r = s.execute("SELECT @@version_comment LIMIT 1")[0]
        assert r.error is None and r.rows == [("manticoresearch-tpu",)]
        r = s.execute("SELECT @@max_allowed_packet, @@version")[0]
        assert r.error is None and r.rows[0][0] == 8388608
        r = s.execute("SELECT DATABASE(), USER(), CONNECTION_ID()")[0]
        assert r.error is None and r.rows == [("Manticore", "root", 1)]
        r = s.execute("SELECT @@session.autocommit")[0]
        assert r.error is None and r.rows == [(1,)]


class TestRotationAndThreads:
    def _save_plain(self, path, tag):
        from manticoresearch_tpu.index.builder import IndexBuilder
        from manticoresearch_tpu.index.storage import save_packed
        from manticoresearch_tpu.schema import Schema
        b = IndexBuilder(Schema(fields=["content"], attrs=[]))
        b.add_documents([dict(id=i, content=f"{tag} words {i}")
                         for i in range(1, 6)])
        save_packed(b.build(), path)

    def test_catalog_rotate_pickup_and_swap(self, tmp_path):
        import os
        from manticoresearch_tpu.exec.searcher import SearchQuery
        from manticoresearch_tpu.exec.session import Catalog
        dd = str(tmp_path / "data")
        cat = Catalog(dd)
        # first rotation: a brand-new table arrives as t1.new
        self._save_plain(os.path.join(dd, "t1.new"), "alpha")
        assert cat.rotate() == ["t1"]
        t = cat.get("t1")
        assert t.search(SearchQuery(match="alpha")).total_found == 5
        assert os.path.isdir(os.path.join(dd, "t1"))
        assert not os.path.isdir(os.path.join(dd, "t1.new"))
        # second rotation: replacement index swaps in atomically
        self._save_plain(os.path.join(dd, "t1.new"), "beta")
        assert cat.rotate() == ["t1"]
        t = cat.get("t1")
        assert t.search(SearchQuery(match="beta")).total_found == 5
        assert t.search(SearchQuery(match="alpha")).total_found == 0
        # no .new dirs -> no-op
        assert cat.rotate() == []

    def test_reload_tables_and_import_sql(self, tmp_path):
        import os
        from manticoresearch_tpu.exec.session import Catalog, Session
        dd = str(tmp_path / "data")
        cat = Catalog(dd)
        sess = Session(cat)
        self._save_plain(os.path.join(dd, "t2.new"), "gamma")
        (r,) = sess.execute("RELOAD TABLES")
        assert r.error is None
        rows = sess.execute("SELECT id FROM t2 WHERE MATCH('gamma')")[0]
        assert len(rows.rows) == 5
        # IMPORT TABLE from a path outside the data dir
        src = str(tmp_path / "ext_idx")
        self._save_plain(src, "delta")
        (r2,) = sess.execute(f"IMPORT TABLE imp FROM '{src}'")
        assert r2.error is None, r2.error
        rows2 = sess.execute("SELECT id FROM imp WHERE MATCH('delta')")[0]
        assert len(rows2.rows) == 5
        sess.close()

    def test_show_threads_live_registry(self):
        from manticoresearch_tpu.exec.session import Catalog, Session
        cat = Catalog()
        s1 = Session(cat, proto="mysql", host="1.2.3.4:5")
        s2 = Session(cat, proto="http")
        try:
            (r,) = s1.execute("SHOW THREADS")
            assert r.error is None
            tids = [row[0] for row in r.rows]
            assert str(s1.tid) in tids and str(s2.tid) in tids
            me = next(row for row in r.rows if row[0] == str(s1.tid))
            assert me[2] == "mysql" and me[3] == "1.2.3.4:5"
            assert "SHOW THREADS" in me[-1]
        finally:
            s1.close()
            s2.close()


class TestWatchdog:
    def test_restarts_crashed_daemon(self, tmp_path):
        """Watchdog relaunches the child after an abnormal exit and
        forwards TERM (SetWatchDog semantics)."""
        import os
        import signal
        import subprocess
        import sys
        import textwrap
        import time
        # stand-in child that crashes once then serves until TERM
        mod = tmp_path / "fakechild.py"
        marker = tmp_path / "starts.txt"
        mod.write_text(textwrap.dedent(f"""
            import os, signal, sys, time
            with open({str(marker)!r}, 'a') as f:
                f.write('x')
            n = len(open({str(marker)!r}).read())
            if n == 1:
                sys.exit(3)           # first run: crash
            signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
            while True:
                time.sleep(0.1)
        """))
        from manticoresearch_tpu.server import daemon as D
        import threading
        argv = ["--data-dir", str(tmp_path / "d")]
        orig = [sys.executable, "-m", "manticoresearch_tpu.server.daemon"]
        # patch the child command to our stand-in
        real_popen = subprocess.Popen
        spawned = []

        def fake_popen(cmd, **kw):
            p = real_popen([sys.executable, str(mod)], **kw)
            spawned.append(p)
            return p
        subprocess.Popen = fake_popen
        try:
            th = threading.Thread(target=D.run_watchdog, args=(argv,),
                                  daemon=True)
            th.start()
            t0 = time.time()
            # generous window: the restart backoff is 1s but a loaded
            # host can stretch child startup considerably
            while time.time() - t0 < 60:
                if marker.exists() and len(marker.read_text()) >= 2:
                    break
                time.sleep(0.05)
            assert len(marker.read_text()) >= 2   # crashed + restarted
        finally:
            subprocess.Popen = real_popen
            for p in spawned:           # reap the surviving stand-in
                if p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        p.kill()


class TestGlobalVars:
    def test_set_global_persists(self, tmp_path):
        from manticoresearch_tpu.exec.session import Catalog, Session
        dd = str(tmp_path / "g")
        cat = Catalog(dd)
        s = Session(cat)
        (r,) = s.execute("SET GLOBAL query_log_min_msec = 250")
        assert r.error is None
        s.close()
        cat2 = Catalog(dd)
        assert cat2.globals.get("query_log_min_msec") == 250


class TestKlistTarget:
    def test_rotated_killlist_suppresses_target_rows(self, tmp_path):
        """klist_target (ApplyKillListsTo, searchd.cpp:15926): rotating in
        a delta index kills the superseded rows of the main table."""
        import json
        import os
        from manticoresearch_tpu.exec.searcher import SearchQuery
        from manticoresearch_tpu.exec.session import Catalog
        from manticoresearch_tpu.index.builder import IndexBuilder
        from manticoresearch_tpu.index.storage import save_packed
        from manticoresearch_tpu.schema import Schema

        dd = str(tmp_path / "data")
        cat = Catalog(dd)

        def save(path, docs, killlist=None, target=""):
            b = IndexBuilder(Schema(fields=["content"], attrs=[]))
            b.add_documents(docs)
            save_packed(b.build(), path)
            if killlist is not None:
                with open(os.path.join(path, "killlist.json"), "w") as f:
                    json.dump({"ids": killlist, "target": target}, f)

        save(os.path.join(dd, "main.new"),
             [dict(id=i, content=f"old row {i}") for i in (1, 2, 3, 4)])
        assert cat.rotate() == ["main"]
        assert cat.get("main").search(
            SearchQuery(match="old")).total_found == 4

        # delta carries rows 2,3 (updated) + a kill list naming them
        save(os.path.join(dd, "delta.new"),
             [dict(id=i, content=f"new row {i}") for i in (2, 3)],
             killlist=[2, 3], target="main:kl")
        assert cat.rotate() == ["delta"]
        assert cat.get("main").search(
            SearchQuery(match="old")).total_found == 2
        assert {m.docid for m in cat.get("main").search(
            SearchQuery(match="old")).matches} == {1, 4}
        assert cat.get("delta").search(
            SearchQuery(match="new")).total_found == 2

        # :id mode kills by the delta's own docids
        save(os.path.join(dd, "delta.new"),
             [dict(id=4, content="new row 4")], killlist=[],
             target="main:id")
        assert cat.rotate() == ["delta"]
        assert {m.docid for m in cat.get("main").search(
            SearchQuery(match="old")).matches} == {1}
