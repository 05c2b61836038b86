"""Multi-master cluster replication: total-order write-set certification.

Behavioral model: the reference's Galera-based clusters
(/root/reference/src/searchdreplication.cpp: per-cluster total-order
certification of ReplicationCommand_e write sets, searchdreplication.h:87;
JOIN/CREATE/DELETE/ALTER CLUSTER statements, searchdsql.h; `cluster:table`
write routing, HandleCmdReplicate searchdreplication.h:30).

Redesign (no wsrep library): a deterministic SEQUENCER — the
cluster's creator — assigns every write set a global sequence number and
serves the ordered log to all members. Every member, including the write's
originator and the sequencer itself, applies records strictly in sequence
order through the same WAL-replay path (RtIndex.apply_binlog_record), so
any two conflicting write sets certify identically on every node: the one
sequenced first wins everywhere, exactly like first-committer-wins
certification. Writes block until the originator has applied its own
record (wsrep certify-then-apply semantics).

Wire protocol (JSON lines over TCP, one connection per request/stream):
  {"op":"submit","cluster":c,"table":t,"rec":{...}} -> {"seq":N}
  {"op":"subscribe","cluster":c,"from":N} -> stream of
        {"seq":N,"table":t,"rec":{...}}
  {"op":"state","cluster":c} -> {"seq":N,"tables":{name:{schema,options}},
                                 "sequencer":"host:port"}
  {"op":"sst","cluster":c,"table":t} -> snapshot file blocks (same framing
        as server/repl.py) + {"seq":N}
"""
from __future__ import annotations

import asyncio
import json
import os
import threading
import time


class ClusterError(ValueError):
    pass


class ClusterService:
    """Per-daemon listener serving the cluster protocol (both roles: the
    sequencer answers submit/subscribe/state/sst; members answer state for
    discovery)."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 9313):
        self.catalog = catalog
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- lifecycle (thread-owned event loop: usable from sync sessions) --
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._started.wait(5)

    def _run(self) -> None:
        async def main():
            self._loop = asyncio.get_running_loop()
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self._started.set()
            async with self._server:
                await self._server.serve_forever()
        try:
            asyncio.run(main())
        except asyncio.CancelledError:
            pass

    def stop(self) -> None:
        for cl in list(self.catalog.clusters.values()):
            cl.stop()
        if self._loop:
            # cancel every task (serve_forever + open subscriber
            # handlers) — `async with server` waits for handlers on
            # exit, so closing the listener alone leaves the thread
            # (and the bound socket) alive
            def _shutdown():
                if self._server:
                    self._server.close()
                for t in asyncio.all_tasks(self._loop):
                    t.cancel()
            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread:
            self._thread.join(5)

    # -- protocol ---------------------------------------------------------
    async def _handle(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            msg = json.loads(line)
            op = msg.get("op")
            cl = self.catalog.clusters.get(msg.get("cluster", ""))
            if cl is None:
                writer.write(b'{"error":"unknown cluster"}\n')
                await writer.drain()
                return
            if op == "submit":
                if not cl.is_sequencer:
                    writer.write(json.dumps(
                        {"error": "not the sequencer",
                         "sequencer": cl.sequencer}).encode() + b"\n")
                else:
                    seq = cl.sequence(msg["table"], msg["rec"])
                    writer.write(json.dumps({"seq": seq}).encode() + b"\n")
                await writer.drain()
            elif op == "subscribe":
                await self._serve_log(cl, int(msg.get("from", 0)), writer)
            elif op == "state":
                writer.write(json.dumps(cl.state()).encode() + b"\n")
                await writer.drain()
            elif op == "sst":
                await self._serve_sst(cl, msg["table"], writer)
            else:
                writer.write(b'{"error":"bad op"}\n')
                await writer.drain()
        except (ConnectionError, json.JSONDecodeError, OSError,
                KeyError, ClusterError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _serve_log(self, cl: "Cluster", start: int, writer) -> None:
        """Stream the ordered log from `start`, then tail it."""
        pos = start
        while True:
            batch = cl.log_slice(pos)
            for seq, table, rec in batch:
                writer.write(json.dumps(
                    {"seq": seq, "table": table, "rec": rec},
                    ensure_ascii=False).encode() + b"\n")
                pos = seq
            await writer.drain()
            if not batch:
                await asyncio.sleep(0.05)

    async def _serve_sst(self, cl: "Cluster", tname: str, writer) -> None:
        t = self.catalog.get(tname)
        seq = cl.applied

        def _prep():
            from ..index.storage import save_rt_snapshot
            save_rt_snapshot(t)
            files = []
            for root, _dirs, names in os.walk(t.data_dir):
                for nm in names:
                    if nm == "binlog.jsonl":
                        continue
                    p = os.path.join(root, nm)
                    files.append((os.path.relpath(p, t.data_dir), p))
            return files

        files = await asyncio.get_running_loop().run_in_executor(None, _prep)
        writer.write(json.dumps(
            {"sst": {"files": len(files), "seq": seq}}).encode() + b"\n")
        for rel, p in files:
            data = open(p, "rb").read()
            writer.write(json.dumps(
                {"file": rel, "size": len(data)}).encode() + b"\n")
            writer.write(data)
            await writer.drain()


class Cluster:
    """One cluster membership on one daemon (ReplicationCluster_t analog,
    searchdreplication.h:87)."""

    def __init__(self, name: str, catalog, service: ClusterService,
                 sequencer: str | None = None):
        self.name = name
        self.catalog = catalog
        self.service = service
        # None = this node created the cluster and sequences it
        self.sequencer = sequencer or service.address
        self.tables: set[str] = set()
        self.applied = 0                  # last locally-applied seq
        # per-table SST floor: a joiner's snapshots are taken per table
        # while the log advances, so overlap records must not be replayed
        # into tables already past them (ADVICE r3)
        self.table_floor: dict[str, int] = {}
        self.error: str | None = None
        self._log: list[tuple[int, str, dict]] = []   # sequencer-side
        self._lock = threading.Lock()
        self._applied_cv = threading.Condition()
        self._stop = threading.Event()
        self._applier: threading.Thread | None = None
        self.error: str | None = None
        self.state_name = "synced"

    @property
    def is_sequencer(self) -> bool:
        return self.sequencer == self.service.address

    # -- sequencer role ---------------------------------------------------
    def sequence(self, table: str, rec: dict) -> int:
        with self._lock:
            seq = len(self._log) + 1
            self._log.append((seq, table, rec))
        return seq

    def log_slice(self, after: int, limit: int = 256):
        with self._lock:
            return self._log[after:after + limit]

    def state(self) -> dict:
        tabs = {}
        for nm in sorted(self.tables):
            t = self.catalog.tables.get(nm)
            if t is not None:
                tabs[nm] = {"schema": t.schema.to_json(),
                            "options": dict(getattr(t, "options", {}))}
        return {"seq": (len(self._log) if self.is_sequencer
                        else self.applied),
                "tables": tabs, "sequencer": self.sequencer,
                "name": self.name}

    # -- member role ------------------------------------------------------
    def start_applier(self) -> None:
        self._applier = threading.Thread(target=self._apply_loop,
                                         daemon=True)
        self._applier.start()

    def stop(self) -> None:
        self._stop.set()

    def _apply_one_safe(self, seq: int, table: str, rec: dict) -> None:
        try:
            self._apply_one(seq, table, rec)
        except Exception as e:  # noqa: BLE001 — applier must survive
            self.error = f"apply seq {seq} on '{table}': {e}"
            with self._applied_cv:
                if self.applied < seq:
                    self.applied = seq
                self._applied_cv.notify_all()

    def _apply_one(self, seq: int, table: str, rec: dict) -> None:
        if rec.get("op") == "cluster_add":
            from ..schema import Schema
            self.tables.add(table)
            if table not in self.catalog.tables:
                self.catalog.create(table, Schema.from_json(rec["schema"]),
                                    options=rec.get("options") or {})
            with self._applied_cv:
                self.applied = seq
                self._applied_cv.notify_all()
            return
        t = self.catalog.tables.get(table)
        if t is not None and seq <= self.table_floor.get(table, 0):
            t = None                       # SST already contains this seq
        if t is not None:
            t._binlog_write(rec)           # persist first (WAL)
            saved = t._binlog
            t._binlog = None               # apply without double-logging
            try:
                t.apply_binlog_record(rec)
            finally:
                t._binlog = saved
        with self._applied_cv:
            self.applied = seq
            self._applied_cv.notify_all()

    def _apply_loop(self) -> None:
        if self.is_sequencer:
            while not self._stop.is_set():
                batch = self.log_slice(self.applied)
                if not batch:
                    time.sleep(0.02)
                    continue
                for seq, table, rec in batch:
                    self._apply_one_safe(seq, table, rec)
            return
        # remote member: subscribe to the sequencer's log
        asyncio.run(self._subscribe_loop())

    async def _subscribe_loop(self) -> None:
        host, port = self.sequencer.rsplit(":", 1)
        while not self._stop.is_set():
            try:
                reader, writer = await asyncio.open_connection(
                    host, int(port))
                writer.write(json.dumps(
                    {"op": "subscribe", "cluster": self.name,
                     "from": self.applied}).encode() + b"\n")
                await writer.drain()
                while not self._stop.is_set():
                    try:
                        line = await asyncio.wait_for(reader.readline(),
                                                      timeout=0.25)
                    except asyncio.TimeoutError:
                        continue
                    if not line:
                        break
                    msg = json.loads(line)
                    if "error" in msg:
                        self.error = msg["error"]
                        return
                    self._apply_one_safe(msg["seq"], msg["table"],
                                         msg["rec"])
                writer.close()
            except (ConnectionError, OSError) as e:
                self.error = str(e)
                await asyncio.sleep(0.2)

    # -- write path (HandleCmdReplicate analog) ---------------------------
    def replicate(self, table: str, rec: dict, timeout: float = 10.0
                  ) -> int:
        """Submit a write set for total-order certification and block
        until it has been applied LOCALLY in order (certify-then-apply).
        Returns the assigned sequence number."""
        if table not in self.tables:
            raise ClusterError(
                f"table '{table}' is not in cluster '{self.name}'")
        if self.is_sequencer:
            seq = self.sequence(table, rec)
        else:
            seq = self._submit_remote(table, rec)
        deadline = time.monotonic() + timeout
        with self._applied_cv:
            while self.applied < seq:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ClusterError("replication timeout")
                self._applied_cv.wait(left)
        return seq

    def _submit_remote(self, table: str, rec: dict) -> int:
        host, port = self.sequencer.rsplit(":", 1)

        async def go():
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(json.dumps(
                {"op": "submit", "cluster": self.name, "table": table,
                 "rec": rec}, ensure_ascii=False).encode() + b"\n")
            await writer.drain()
            resp = json.loads(await reader.readline())
            writer.close()
            return resp
        resp = asyncio.run(go())
        if "error" in resp:
            raise ClusterError(resp["error"])
        return int(resp["seq"])

    def wait_applied(self, seq: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._applied_cv:
            while self.applied < seq:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._applied_cv.wait(left)
        return True


def create_cluster(catalog, service: ClusterService, name: str) -> Cluster:
    """CREATE CLUSTER: this node becomes the sequencer."""
    if name in catalog.clusters:
        raise ClusterError(f"cluster '{name}' already exists")
    cl = Cluster(name, catalog, service)
    catalog.clusters[name] = cl
    cl.start_applier()
    return cl


def join_cluster(catalog, service: ClusterService, name: str,
                 at: str) -> Cluster:
    """JOIN CLUSTER name AT 'host:port': fetch the member state, create
    missing tables, SST each table from the donor, then subscribe to the
    log from the snapshot position (SST + IST catch-up,
    searchdreplication.cpp donor logic)."""
    host, port = at.rsplit(":", 1)

    async def fetch_state():
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(json.dumps(
            {"op": "state", "cluster": name}).encode() + b"\n")
        await writer.drain()
        st = json.loads(await reader.readline())
        writer.close()
        return st

    st = asyncio.run(fetch_state())
    if "error" in st:
        raise ClusterError(st["error"])
    cl = Cluster(name, catalog, service, sequencer=st["sequencer"])
    cl.tables = set(st["tables"])
    min_seq = int(st["seq"])
    from ..schema import Schema
    for tname, meta in st["tables"].items():
        if tname not in catalog.tables:
            catalog.create(tname, Schema.from_json(meta["schema"]),
                           options=meta.get("options") or {})
        seq = _sst_table(catalog.get(tname), name, host, int(port))
        cl.table_floor[tname] = seq
        min_seq = min(min_seq, seq)
    cl.applied = min_seq
    catalog.clusters[name] = cl
    cl.start_applier()
    return cl


def _sst_table(t, cluster: str, host: str, port: int) -> int:
    async def go():
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(json.dumps(
            {"op": "sst", "cluster": cluster,
             "table": t.name}).encode() + b"\n")
        await writer.drain()
        head = json.loads(await reader.readline())
        if "error" in head:
            raise ClusterError(head["error"])
        base = t.data_dir
        if not base:
            raise ClusterError("SST needs a data_dir on the joiner")
        os.makedirs(base, exist_ok=True)
        for _ in range(int(head["sst"]["files"])):
            meta = json.loads(await reader.readline())
            # donor-supplied names must stay under the joiner's data_dir
            fname = str(meta["file"])
            if os.path.isabs(fname) or ".." in fname.split(os.sep):
                raise ClusterError(f"SST: unsafe file name {fname!r}")
            dst = os.path.join(base, fname)
            if not os.path.realpath(dst).startswith(
                    os.path.realpath(base) + os.sep):
                raise ClusterError(f"SST: file escapes data_dir: {fname!r}")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            size = int(meta["size"])
            with open(dst, "wb") as f:
                while size > 0:
                    chunk = await reader.read(min(size, 1 << 20))
                    if not chunk:
                        raise ConnectionError("SST stream truncated")
                    f.write(chunk)
                    size -= len(chunk)
        writer.close()
        return int(head["sst"]["seq"])

    seq = asyncio.run(go())
    from ..index.storage import load_rt_snapshot
    load_rt_snapshot(t)
    t.generation += 1
    return seq
