"""A minimal MySQL-protocol client: just enough of the client side to send
SphinxQL to the daemon and read its answers, including the SSLRequest
upgrade, the compressed framing layer (client side of
netreceive_ql.cpp:848 / compressed_mysql.cpp) and multi-statement results
(FACET answers with several result sets)."""
from __future__ import annotations

import socket
import struct
import zlib

SERVER_MORE_RESULTS_EXISTS = 0x0008


class MysqlProtocolError(RuntimeError):
    pass


class MiniMysqlClient:
    def __init__(self, host, port, use_ssl=False, compress=False,
                 timeout=10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.seq = 0
        self.compressed = False
        self._cseq = 0
        self._cin = b""
        self._handshake(use_ssl, compress)

    def _read_frame_bytes(self, n):
        while len(self._cin) < n:
            head = self._recv_raw(7)
            clen = head[0] | (head[1] << 8) | (head[2] << 16)
            self._cseq = head[3]
            ulen = head[4] | (head[5] << 8) | (head[6] << 16)
            body = self._recv_raw(clen)
            self._cin += zlib.decompress(body) if ulen else body
        out, self._cin = self._cin[:n], self._cin[n:]
        return out

    def _read_packet(self):
        head = self._recv(4)
        length = head[0] | (head[1] << 8) | (head[2] << 16)
        self.seq = head[3]
        return self._recv(length)

    def _recv_raw(self, n):
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("closed")
            out += chunk
        return out

    def _recv(self, n):
        if self.compressed:
            return self._read_frame_bytes(n)
        return self._recv_raw(n)

    def _send_packet(self, payload):
        self.seq = (self.seq + 1) % 256
        pkt = (struct.pack("<I", len(payload))[:3] + bytes([self.seq])
               + payload)
        if not self.compressed:
            self.sock.sendall(pkt)
            return
        self._cseq = (self._cseq + 1) % 256
        if len(pkt) < 50:
            self.sock.sendall(struct.pack("<I", len(pkt))[:3]
                              + bytes([self._cseq]) + b"\x00\x00\x00" + pkt)
        else:
            comp = zlib.compress(pkt)
            self.sock.sendall(struct.pack("<I", len(comp))[:3]
                              + bytes([self._cseq])
                              + struct.pack("<I", len(pkt))[:3] + comp)

    def _handshake(self, use_ssl=False, compress=False):
        greeting = self._read_packet()
        if greeting[0] != 0x0A:
            raise MysqlProtocolError("not a protocol-10 greeting")
        # server caps live after version-z-string + 4B thread id + 8B salt
        # + 1B filler
        p = greeting.index(b"\x00", 1) + 1 + 4 + 8 + 1
        srv_caps = greeting[p] | (greeting[p + 1] << 8)
        caps = 0x0200
        if compress:
            if not srv_caps & 0x0020:
                raise MysqlProtocolError("server did not advertise "
                                         "compression")
            caps |= 0x0020
        if use_ssl:
            if not srv_caps & 0x0800:
                raise MysqlProtocolError("server did not advertise SSL")
            import ssl as _ssl
            # SSLRequest: login-shaped prefix, no credentials
            self._send_packet(struct.pack("<I", caps | 0x0800)
                              + struct.pack("<I", 2**24)
                              + b"\x21" + b"\x00" * 23)
            ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = _ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock)
            caps |= 0x0800
        resp = (struct.pack("<I", caps) + struct.pack("<I", 2**24)
                + b"\x21" + b"\x00" * 23 + b"root\x00" + b"\x00")
        self._send_packet(resp)
        ok = self._read_packet()
        if ok[0] != 0x00:
            raise MysqlProtocolError("login refused")
        if compress:
            # compression starts after the auth OK (netreceive_ql.cpp:870)
            self.compressed = True
            self._cseq = 0

    def _lenenc(self, data, pos):
        b = data[pos]
        if b < 251:
            return b, pos + 1
        if b == 0xFC:
            return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
        if b == 0xFD:
            return (data[pos+1] | data[pos+2] << 8 | data[pos+3] << 16,
                    pos + 4)
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9

    def _read_result(self):
        """One answer: ({"error"} | {"ok", "affected"} |
        {"columns", "rows"}, more_results_follow)."""
        first = self._read_packet()
        if first[0] == 0xFF:
            return {"error": first[9:].decode()}, False
        if first[0] == 0x00:
            affected, pos = self._lenenc(first, 1)
            _insert_id, pos = self._lenenc(first, pos)
            status = struct.unpack_from("<H", first, pos)[0]
            return ({"ok": True, "affected": affected},
                    bool(status & SERVER_MORE_RESULTS_EXISTS))
        ncols, _ = self._lenenc(first, 0)
        cols = []
        for _ in range(ncols):
            pkt = self._read_packet()
            pos = 0
            vals = []
            for _f in range(6):
                ln, pos = self._lenenc(pkt, pos)
                vals.append(pkt[pos:pos + ln])
                pos += ln
            cols.append(vals[4].decode())
        eof = self._read_packet()
        if eof[0] != 0xFE:
            raise MysqlProtocolError("missing EOF after column definitions")
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                status = struct.unpack_from("<H", pkt, 3)[0] \
                    if len(pkt) >= 5 else 0
                break
            pos = 0
            row = []
            for _c in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    ln, pos = self._lenenc(pkt, pos)
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(row)
        return ({"columns": cols, "rows": rows},
                bool(status & SERVER_MORE_RESULTS_EXISTS))

    def query_all(self, sql):
        """Send one statement; return every result set it produced."""
        self.seq = 255
        self._send_packet(b"\x03" + sql.encode())
        out = []
        more = True
        while more:
            res, more = self._read_result()
            out.append(res)
        return out

    def query(self, sql):
        """Send one statement; return its first result set."""
        return self.query_all(sql)[0]

    def close(self):
        try:
            self.seq = 255
            self._send_packet(b"\x01")
        finally:
            self.sock.close()
