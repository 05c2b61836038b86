"""SphinxAPI binary protocol: drive ApiServer over a real socket with a
hand-rolled classic client (sphinxapi.py wire format, v.0x121)."""
import asyncio
import struct

import pytest

from manticoresearch_tpu.exec.session import Catalog, Session
from manticoresearch_tpu.server.api import (ApiServer, CMD_KEYWORDS,
                                            CMD_PING, CMD_SEARCH,
                                            CMD_STATUS, SEARCHD_OK,
                                            VER_KEYWORDS, VER_PING,
                                            VER_SEARCH)

def _s(txt):
    b = txt.encode()
    return struct.pack(">L", len(b)) + b


def build_search_body(query, index="*", filters=b"", nfilters=0,
                      sort_mode=0, sort_by="", group_by=""):
    out = b""
    out += struct.pack(">L", 0)                    # flags
    out += struct.pack(">ll", 0, 20)               # offset, limit
    out += struct.pack(">ll", 6, 0)                # mode=EXTENDED2, ranker
    out += struct.pack(">l", sort_mode) + _s(sort_by)
    out += _s(query)
    out += struct.pack(">l", 0)                    # legacy weights
    out += _s(index)
    out += struct.pack(">l", 1)                    # id64
    out += struct.pack(">QQ", 0, 0)                # id range
    out += struct.pack(">l", nfilters) + filters
    out += struct.pack(">L", 0) + _s(group_by)     # group func, group by
    out += struct.pack(">l", 1000)                 # max matches
    out += _s("@count desc")
    out += struct.pack(">lll", 0, 0, 0)            # cutoff, retries
    out += _s("")                                  # distinct
    out += struct.pack(">l", 0)                    # geo
    out += struct.pack(">l", 0)                    # index weights
    out += struct.pack(">L", 0)                    # max query time
    out += struct.pack(">l", 0)                    # field weights
    out += _s("")                                  # comment
    out += struct.pack(">l", 0)                    # overrides
    out += _s("*")                                 # select
    out += _s("") + struct.pack(">LLl", 0, 0, 0)   # outer
    out += struct.pack(">l", 0)                    # filter tree
    # header: master ver (0 = plain client) + query count, like
    # sphinxapi.py RunQueries
    return struct.pack(">lL", 0, 1) + out


class _Reader:
    def __init__(self, b):
        self.b, self.i = b, 0

    def u32(self):
        (v,) = struct.unpack_from(">L", self.b, self.i)
        self.i += 4
        return v

    def i32(self):
        (v,) = struct.unpack_from(">l", self.b, self.i)
        self.i += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from(">Q", self.b, self.i)
        self.i += 8
        return v

    def f32(self):
        (v,) = struct.unpack_from(">f", self.b, self.i)
        self.i += 4
        return v

    def s(self):
        n = self.u32()
        v = self.b[self.i:self.i + n].decode()
        self.i += n
        return v


async def _roundtrip(port, cmd, ver, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    ver_srv = await reader.readexactly(4)
    assert struct.unpack(">L", ver_srv)[0] == 1
    writer.write(struct.pack(">L", 1))
    writer.write(struct.pack(">HHL", cmd, ver, len(body)) + body)
    await writer.drain()
    hdr = await reader.readexactly(8)
    status, rver, length = struct.unpack(">HHL", hdr)
    payload = await reader.readexactly(length)
    writer.close()
    return status, payload


@pytest.fixture(scope="module")
def api_port():
    cat = Catalog()
    sess = Session(cat)
    sess.execute("CREATE TABLE books (title text, content text, "
                 "price integer, score float)")
    for i in range(1, 21):
        extra = "classic" if i % 3 == 0 else "modern"
        sess.execute(
            f"INSERT INTO books (id, title, content, price, score) VALUES "
            f"({i}, 'book {i}', 'story number {i} is {extra} tale', "
            f"{i * 10}, {i * 0.5})")
    sess.close()

    import threading
    started = threading.Event()
    stop = asyncio.Event()
    loop_box: list = []
    port_box: list = []

    def run():
        async def main():
            loop_box.append(asyncio.get_running_loop())
            srv = ApiServer(cat, port=0)
            await srv.start()
            port_box.append(srv._server.sockets[0].getsockname()[1])
            started.set()
            await stop.wait()
            await srv.stop()
        asyncio.run(main())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert started.wait(5)
    yield port_box[0]
    # asyncio.Event is not thread-safe: set it on the server's own loop
    if loop_box:
        loop_box[0].call_soon_threadsafe(stop.set)
    th.join(5)


def test_ping(api_port):
    status, body = asyncio.run(_roundtrip(
        api_port, CMD_PING, VER_PING, struct.pack(">l", 424242)))
    assert status == SEARCHD_OK
    assert struct.unpack(">l", body)[0] == 424242


def test_search_basic(api_port):
    body = build_search_body("classic", index="books")
    status, payload = asyncio.run(_roundtrip(
        api_port, CMD_SEARCH, VER_SEARCH, body))
    assert status == SEARCHD_OK
    r = _Reader(payload)
    assert r.u32() == SEARCHD_OK
    nfields = r.i32()
    fields = [r.s() for _ in range(nfields)]
    assert fields == ["title", "content"]
    nattrs = r.i32()
    attrs = [(r.s(), r.u32()) for _ in range(nattrs)]
    assert ("price", 1) in attrs and ("score", 5) in attrs
    count = r.i32()
    assert r.i32() == 1                      # id64 flag
    ids = []
    for _ in range(count):
        ids.append(r.u64())
        r.i32()                              # weight
        for name, t in attrs:
            if t == 5:
                r.f32()
            elif t == 6:
                r.u64()
            elif t == 7:
                r.s()
            else:
                r.u32()
    # docs 3,6,9,12,15,18 carry 'classic'
    assert ids == [3, 6, 9, 12, 15, 18]
    assert r.i32() == count                  # total
    assert r.u32() == 6                      # total_found
    r.i32()                                  # msec
    nwords = r.i32()
    assert nwords == 1
    assert r.s() == "classic"
    assert r.u32() == 6                      # docs


def test_search_with_range_filter(api_port):
    filt = _s("price") + struct.pack(">L", 1) + struct.pack(">QQ", 50, 120)
    filt += struct.pack(">L", 0)             # exclude=0
    body = build_search_body("classic", index="books", filters=filt,
                             nfilters=1)
    status, payload = asyncio.run(_roundtrip(
        api_port, CMD_SEARCH, VER_SEARCH, body))
    assert status == SEARCHD_OK
    r = _Reader(payload)
    assert r.u32() == SEARCHD_OK
    for _ in range(r.i32()):
        r.s()
    nattrs = r.i32()
    attrs = [(r.s(), r.u32()) for _ in range(nattrs)]
    count = r.i32()
    r.i32()
    ids = []
    for _ in range(count):
        ids.append(r.u64())
        r.i32()
        for name, t in attrs:
            r.f32() if t == 5 else r.u32()
    assert ids == [6, 9, 12]                 # price in [50,120]


def test_keywords(api_port):
    body = _s("Classic tale") + _s("books") + struct.pack(">l", 1)
    body += struct.pack(">llll", 0, 0, 0, 0)
    status, payload = asyncio.run(_roundtrip(
        api_port, CMD_KEYWORDS, VER_KEYWORDS, body))
    assert status == SEARCHD_OK
    r = _Reader(payload)
    n = r.i32()
    words = []
    for _ in range(n):
        raw, norm, qpos = r.s(), r.s(), r.i32()
        docs, hits = r.i32(), r.i32()
        words.append((raw, norm, docs))
    assert words[0][1] == "classic" and words[0][2] == 6
    assert words[1][1] == "tale" and words[1][2] == 20


def test_status(api_port):
    status, payload = asyncio.run(_roundtrip(
        api_port, CMD_STATUS, 0x101, struct.pack(">L", 1)))
    assert status == SEARCHD_OK
    r = _Reader(payload)
    rows, cols = r.i32(), r.i32()
    assert cols == 2 and rows > 0
    pairs = dict((r.s(), r.s()) for _ in range(rows))
    assert "uptime" in pairs
