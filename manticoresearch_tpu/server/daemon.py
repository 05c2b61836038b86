"""searchd analog: one process serving MySQL-wire SphinxQL + HTTP JSON.

Usage:
    python -m manticoresearch_tpu.server.daemon \
        --data-dir ./data --listen-mysql 9306 --listen-http 9308

Behavioral model: the reference daemon's listener set (searchd.cpp main:
mysql41 + http + sphinx-api listeners on one net loop). Periodic tasks
(taskflush*, sphinxrt auto-flush) map to asyncio background tasks.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import signal
import threading

from ..exec.session import Catalog
from .http import HttpServer
from .mysql import MysqlServer


class Daemon:
    def __init__(self, data_dir: str | None = None,
                 mysql_port: int = 9306, http_port: int = 9308,
                 host: str = "127.0.0.1", flush_period: float = 60.0,
                 config=None, repl_port: int | None = None,
                 agent_port: int | None = None,
                 api_port: int | None = None,
                 ping_interval: float = 5.0):
        self.catalog = Catalog(data_dir)
        if config is not None:
            self._apply_config(config)
        self.mysql = MysqlServer(self.catalog, host, mysql_port)
        self.http = HttpServer(self.catalog, host, http_port)
        self.repl = None
        if repl_port is not None:
            from .repl import ReplicationServer
            self.repl = ReplicationServer(self.catalog, host, repl_port)
        self.agent = None
        if agent_port is not None:
            from .agent import AgentServer
            self.agent = AgentServer(self.catalog, host, agent_port)
        self.api = None
        if api_port is not None:
            from .api import ApiServer
            self.api = ApiServer(self.catalog, host, api_port)
        self.flush_period = flush_period
        self.ping_interval = ping_interval
        # set once every listener is bound; stop() ends run() from any
        # thread (the daemon may run on a thread of a larger process)
        self.ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None

    def listening_ports(self) -> dict[str, int]:
        """Bound ports of the MySQL and HTTP listeners (port 0 in the
        constructor picks free ones)."""
        return {name: srv._server.sockets[0].getsockname()[1]
                for name, srv in (("mysql", self.mysql), ("http", self.http))}

    def stop(self) -> None:
        """Ask run() to shut down; safe to call from another thread."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)

    def _apply_config(self, cfg) -> None:
        """Register config-declared indexes (rt: create if missing; plain:
        load from path; pq: create)."""
        from ..index.rt import rt_from_packed
        from ..index.storage import load_packed

        for name, ic in cfg.indexes.items():
            if name in self.catalog.tables:
                continue
            if ic.type == "plain":
                if not ic.path:
                    continue
                packed = load_packed(ic.path)
                self.catalog.tables[name] = rt_from_packed(name, packed)
                self.catalog._save_manifest()
            elif ic.type in ("pq", "percolate"):
                self.catalog.create(name, ic.schema, "percolate")
            else:
                t = self.catalog.create(name, ic.schema)
                t.tok_settings = ic.tokenizer
                t.dict_settings = ic.dict

    async def _periodic_flush(self) -> None:
        """rt_flush_period analog (taskflushmutable/taskflushbinlog)."""
        while True:
            await asyncio.sleep(self.flush_period)
            for t in list(self.catalog.tables.values()):
                try:
                    if t.data_dir:
                        t.flush()
                except Exception:  # noqa: BLE001 — keep the daemon alive
                    pass

    async def _periodic_optimize(self) -> None:
        """auto_optimize analog (manticore auto-OPTIMIZE task): tables
        whose segment count crosses 2x the progressive-merge limit get an
        OPTIMIZE pass in the background."""
        while True:
            await asyncio.sleep(max(self.flush_period * 2, 30.0))
            for t in list(self.catalog.tables.values()):
                segs = getattr(t, "segments", None)
                limit = getattr(t, "MERGE_SEGMENT_LIMIT", 0)
                if segs is not None and limit and len(segs) > 2 * limit:
                    try:
                        await asyncio.to_thread(t.optimize)
                    except Exception:  # noqa: BLE001 — keep serving
                        pass

    async def _periodic_ping(self) -> None:
        """Agent dashboard ping (taskping.cpp:119): keeps mirror liveness
        fresh so HA strategies avoid dead hosts before a query pays the
        timeout."""
        from ..exec.distributed import DistributedTable
        from .agent import agent_ping
        while True:
            await asyncio.sleep(self.ping_interval)
            loop = asyncio.get_running_loop()
            for t in list(self.catalog.tables.values()):
                if not isinstance(t, DistributedTable):
                    continue
                for m in t.all_mirrors():
                    try:
                        await loop.run_in_executor(None, agent_ping, m)
                    except Exception:  # noqa: BLE001 — ping must not kill
                        pass

    async def run(self) -> None:
        await self.mysql.start()
        await self.http.start()
        if self.repl is not None:
            await self.repl.start()
        if self.agent is not None:
            await self.agent.start()
        if self.api is not None:
            await self.api.start()
        pinger = asyncio.create_task(self._periodic_ping())
        flusher = asyncio.create_task(self._periodic_flush())
        optimizer = asyncio.create_task(self._periodic_optimize())
        stop = self._stop = asyncio.Event()
        loop = self._loop = asyncio.get_running_loop()
        # signal handlers exist only on the main thread (RuntimeError
        # elsewhere); a daemon on another thread is ended by stop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass
        # SIGHUP -> rotation pickup (CheckRotate, searchd.cpp:17476):
        # swap in <name>.new index dirs written by `indexer --rotate`
        try:
            loop.add_signal_handler(signal.SIGHUP, self.catalog.rotate)
        except (NotImplementedError, AttributeError, RuntimeError):
            pass
        pidfile = None
        if self.catalog.data_dir:
            pidfile = os.path.join(self.catalog.data_dir, "searchd.pid")
            with open(pidfile, "w") as f:
                f.write(str(os.getpid()))
        self.ready.set()
        await stop.wait()
        if pidfile:
            try:
                os.unlink(pidfile)
            except OSError:
                pass
        flusher.cancel()
        pinger.cancel()
        optimizer.cancel()
        await self.mysql.stop()
        await self.http.stop()
        if self.agent is not None:
            await self.agent.stop()
        if self.api is not None:
            await self.api.stop()
        for t in self.catalog.tables.values():
            if t.data_dir:
                t.flush()


def run_watchdog(argv: list[str]) -> None:
    """Supervisor process (SetWatchDog, searchd.cpp:17886): fork the real
    daemon as a child, restart it on abnormal exit with backoff, forward
    TERM/INT/HUP. The child runs with faulthandler enabled so a crash
    leaves a traceback in <data-dir>/crash.log before the restart."""
    import subprocess
    import sys
    import time as _t

    child_argv = [sys.executable, "-m", "manticoresearch_tpu.server.daemon"
                  ] + [a for a in argv if a != "--watchdog"]
    stop = {"flag": False}
    child = {"proc": None}

    def fwd(signum, _frame):
        if signum in (signal.SIGTERM, signal.SIGINT):
            stop["flag"] = True
        if child["proc"] and child["proc"].poll() is None:
            child["proc"].send_signal(signum)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            signal.signal(sig, fwd)
    except ValueError:
        pass        # not the main thread (tests): no signal forwarding

    backoff = 1.0
    while not stop["flag"]:
        env = dict(os.environ, PYTHONFAULTHANDLER="1")
        t0 = _t.time()
        child["proc"] = subprocess.Popen(child_argv, env=env)
        rc = child["proc"].wait()
        if stop["flag"] or rc == 0:
            break
        print(f"watchdog: daemon died rc={rc}; restarting in "
              f"{backoff:.0f}s", flush=True)
        _t.sleep(backoff)
        backoff = 1.0 if _t.time() - t0 > 60 else min(backoff * 2, 30.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="manticoresearch-tpu daemon")
    ap.add_argument("--config", default=None, help="TOML config file")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--listen-mysql", type=int, default=9306)
    ap.add_argument("--listen-http", type=int, default=9308)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--rt-flush-period", type=float, default=60.0)
    ap.add_argument("--listen-repl", type=int, default=None,
                    help="serve binlog replication streams on this port")
    ap.add_argument("--listen-agent", type=int, default=None,
                    help="serve the master<->agent search protocol "
                         "(distributed tables) on this port")
    ap.add_argument("--listen-api", type=int, default=None,
                    help="serve the legacy SphinxAPI binary protocol "
                         "on this port (classic sphinxapi clients)")
    ap.add_argument("--watchdog", action="store_true",
                    help="run under a supervisor that restarts the "
                         "daemon on crashes (SetWatchDog analog)")
    args = ap.parse_args(argv)
    if args.watchdog:
        import sys
        run_watchdog(argv if argv is not None else sys.argv[1:])
        return
    # the watchdog parent above never touches JAX: only this process
    # holds the card
    from ..compile_cache import configure_compile_cache
    configure_compile_cache()
    # crash log: a hard fault leaves a traceback next to the data
    # (CrashLogger/sphBacktrace analog, searchd.cpp crash handler)
    import faulthandler
    if args.data_dir:
        os.makedirs(args.data_dir, exist_ok=True)
        _crash_fh = open(os.path.join(args.data_dir, "crash.log"), "a")
        faulthandler.enable(_crash_fh)
    else:
        faulthandler.enable()
    cfg = None
    if args.config:
        from ..config import load_config
        cfg = load_config(args.config)
        sd = cfg.searchd
        d = Daemon(args.data_dir or sd.data_dir, sd.listen_mysql,
                   sd.listen_http, sd.host, sd.rt_flush_period, config=cfg,
                   repl_port=args.listen_repl, agent_port=args.listen_agent,
                   api_port=args.listen_api)
    else:
        d = Daemon(args.data_dir, args.listen_mysql, args.listen_http,
                   args.host, args.rt_flush_period,
                   repl_port=args.listen_repl, agent_port=args.listen_agent,
                   api_port=args.listen_api)
    asyncio.run(d.run())


if __name__ == "__main__":
    main()
