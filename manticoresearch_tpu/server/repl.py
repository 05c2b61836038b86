"""Replication: WAL (binlog) shipping between nodes.

Behavioral model: the reference replicates RT/PQ write sets between
cluster nodes (searchdreplication.cpp: Galera total-order certification of
ReplicationCommand_e records; new nodes catch up via SST/IST). This
redesign is a simpler primary->replica log stream, Raft-style: the
primary serves each table's binlog over TCP from a requested offset and
then tails it; the replica applies records through the same code path as
startup WAL replay (RtIndex.apply_binlog_record) and persists them in its
own binlog, so a replica restart resumes from its local offset.

Protocol (JSON lines over TCP):
  client -> {"table": "t1", "offset": N}\n
  client -> {"table": "t1", "sst": true}\n         (snapshot state transfer)
  server -> {"sst": {"files": K, "seq": N}}\n      (then K file blocks:
            {"file": relpath, "size": n}\n + n raw bytes each)
  server -> {"seq": N, "rec": {...}}\n             (one per WAL record)
            {"error": "..."}\n                     (then closes)
The stream stays open; new records are shipped as they are written
(file-tail polling — no daemon hooks needed).

SST (searchdreplication.cpp SST/IST donor role): a joining replica with
no local state requests a full snapshot; the donor checkpoints segments
(save_rt_snapshot), streams the snapshot files, and resumes the WAL
stream from the binlog position counted BEFORE the checkpoint — a write
racing the checkpoint may be both in the snapshot and in the stream,
which is safe because commit/update/truncate application is idempotent
(REPLACE-style kills precede adds).
"""
from __future__ import annotations

import asyncio
import json
import os
import threading


class ReplicationServer:
    """Primary side: serves table binlogs (runs next to the daemon)."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 9312,
                 poll_interval: float = 0.1):
        self.catalog = catalog
        self.host = host
        self.port = port
        self.poll = poll_interval
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            req = json.loads(line)
            table = self.catalog.get(str(req["table"]))
            path = table._binlog_path
            if not path:
                writer.write(json.dumps(
                    {"error": "table has no binlog (no data_dir)"}
                ).encode() + b"\n")
                await writer.drain()
                return
            seq = int(req.get("offset", 0))
            if req.get("sst"):
                seq = await self._send_sst(writer, table, path)
            pos = 0
            skipped = 0
            while True:
                # tail the binlog file from the last byte position
                if os.path.exists(path):
                    with open(path, "r", encoding="utf-8") as f:
                        f.seek(pos)
                        for line in f:
                            if not line.endswith("\n"):
                                break  # torn tail; re-read next poll
                            pos += len(line.encode("utf-8"))
                            if not line.strip():
                                continue
                            if skipped < seq:
                                skipped += 1
                                continue
                            writer.write(json.dumps(
                                {"seq": skipped, "rec": json.loads(line)}
                            ).encode() + b"\n")
                            skipped += 1
                    await writer.drain()
                await asyncio.sleep(self.poll)
        except (ConnectionError, asyncio.IncompleteReadError,
                json.JSONDecodeError, ValueError, KeyError) as e:
            try:
                writer.write(json.dumps({"error": str(e)}).encode() + b"\n")
                await writer.drain()
            except ConnectionError:
                pass
        finally:
            writer.close()

    async def _send_sst(self, writer, table, binlog_path) -> int:
        """Donor side of the snapshot transfer; returns the WAL seq the
        stream resumes from."""
        def _prep():
            seq0 = 0
            if os.path.exists(binlog_path):
                with open(binlog_path, "r", encoding="utf-8") as f:
                    seq0 = sum(1 for ln in f if ln.strip()
                               and ln.endswith("\n"))
            from ..index.storage import save_rt_snapshot
            save_rt_snapshot(table)
            files = []
            base = table.data_dir
            for root, _dirs, names in os.walk(base):
                for nm in sorted(names):
                    full = os.path.join(root, nm)
                    rel = os.path.relpath(full, base)
                    if rel == os.path.basename(binlog_path) or \
                            rel.endswith(".tmp"):
                        continue
                    files.append((rel, full, os.path.getsize(full)))
            return seq0, files

        seq0, files = await asyncio.to_thread(_prep)
        writer.write(json.dumps(
            {"sst": {"files": len(files), "seq": seq0}}).encode() + b"\n")
        for rel, full, size in files:
            writer.write(json.dumps(
                {"file": rel, "size": size}).encode() + b"\n")
            with open(full, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    writer.write(chunk)
                    await writer.drain()
        await writer.drain()
        return seq0


class Replica:
    """Follower side: subscribes one table to a primary and applies the
    stream. Runs on a background thread with its own event loop."""

    def __init__(self, table, host: str, port: int, sst: bool = False):
        self.table = table
        self.host = host
        self.port = port
        self.sst = sst             # request a full snapshot on join
        self.applied = 0           # records applied (== next offset)
        self.error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        asyncio.run(self._pull())

    def _apply(self, rec: dict) -> None:
        t = self.table
        t._binlog_write(rec)               # persist locally first
        saved = t._binlog
        t._binlog = None                   # apply without double-logging
        try:
            t.apply_binlog_record(rec)
        finally:
            t._binlog = saved
        self.applied += 1

    async def _receive_sst(self, reader, header: dict) -> None:
        """Joiner side: install the snapshot files, then load them as the
        table's state. Requires the replica table to have a data_dir."""
        base = self.table.data_dir
        if not base:
            raise ValueError("SST needs a data_dir on the replica table")
        os.makedirs(base, exist_ok=True)
        for _ in range(int(header["files"])):
            meta = json.loads(await reader.readline())
            dst = os.path.join(base, meta["file"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            size = int(meta["size"])
            with open(dst, "wb") as f:
                while size > 0:
                    chunk = await reader.read(min(size, 1 << 20))
                    if not chunk:
                        raise ConnectionError("SST stream truncated")
                    f.write(chunk)
                    size -= len(chunk)
        from ..index.storage import load_rt_snapshot
        load_rt_snapshot(self.table)
        self.table.generation += 1
        self.applied = int(header["seq"])

    async def _pull(self) -> None:
        try:
            reader, writer = await asyncio.open_connection(
                self.host, self.port)
            want_sst = self.sst and self.applied == 0 \
                and not self.table.segments
            writer.write(json.dumps(
                {"table": self.table.name, "offset": self.applied,
                 "sst": want_sst}
            ).encode() + b"\n")
            await writer.drain()
            if want_sst:
                first = json.loads(await reader.readline())
                if "error" in first:
                    self.error = first["error"]
                    return
                await self._receive_sst(reader, first["sst"])
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
                    break
                self._apply(msg["rec"])
            writer.close()
        except (ConnectionError, OSError, json.JSONDecodeError) as e:
            self.error = str(e)

    def wait_for(self, n_records: int, timeout: float = 10.0) -> bool:
        """Block until n_records have been applied (test/ops helper)."""
        import time
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if self.error:
                return False
            if self.applied >= n_records:
                return True
            time.sleep(0.02)
        return False
