"""PostgreSQL and MySQL event sinks speaking the raw wire protocols.

The reference's targets (internal/event/target/postgresql.go, mysql.go)
ride lib/pq / go-sql-driver; here each sink speaks just enough of the
database protocol to CREATE TABLE IF NOT EXISTS once and INSERT one row
per event — no client library dependency, same env-driven configuration
and the "access" row format (event_time, event_data) the reference
defaults to for append-only audit tables.

Auth support: PostgreSQL trust / cleartext / md5 (SCRAM is refused with a
clear error); MySQL mysql_native_password (including the AuthSwitch path
that MySQL 8 uses when the default is caching_sha2_password).
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import threading

from .notify import Target


class _DBTarget(Target):
    """Shared connect/reconnect + one-retry send (same discipline as the
    socket targets in targets.py)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._mu = threading.Lock()

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port), timeout=5)
        s.settimeout(5)
        try:
            self._handshake(s)
            self._ensure_table(s)
        except BaseException:
            s.close()
            raise
        return s

    def _handshake(self, s: socket.socket) -> None:
        raise NotImplementedError

    def _ensure_table(self, s: socket.socket) -> None:
        raise NotImplementedError

    def _insert(self, s: socket.socket, payload: bytes) -> None:
        raise NotImplementedError

    def send(self, record: dict) -> None:
        payload = json.dumps({"Records": [record]}).encode()
        with self._mu:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._insert(self._sock, payload)
            except Exception:
                try:
                    if self._sock is not None:
                        self._sock.close()
                finally:
                    self._sock = None
                self._sock = self._connect()
                self._insert(self._sock, payload)


def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise OSError("connection closed")
        buf += chunk
    return buf


# --------------------------------------------------------------- PostgreSQL


class PostgresTarget(_DBTarget):
    """PostgreSQL wire protocol v3 (StartupMessage / simple Query)."""

    def __init__(self, ident: str, host: str, port: int, user: str,
                 password: str, database: str, table: str):
        super().__init__(host, port)
        self.arn = f"arn:minio:sqs::{ident}:postgresql"
        self.user, self.password, self.database = user, password, database
        self.table = table

    @staticmethod
    def parse_connection_string(cs: str) -> dict:
        """key=value connection string (host=.. port=.. user=.. password=..
        dbname=..), the libpq format the reference accepts."""
        out: dict[str, str] = {}
        for tok in cs.split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                out[k] = v.strip("'\"")
        return out

    def _msg(self, type_: bytes, body: bytes) -> bytes:
        return type_ + struct.pack(">I", len(body) + 4) + body

    def _read_msg(self, s: socket.socket) -> tuple[bytes, bytes]:
        head = _recv_exact(s, 5)
        ln = struct.unpack(">I", head[1:])[0]
        return head[:1], _recv_exact(s, ln - 4)

    def _handshake(self, s: socket.socket) -> None:
        params = (
            b"user\x00" + self.user.encode() + b"\x00"
            b"database\x00" + self.database.encode() + b"\x00\x00"
        )
        body = struct.pack(">I", 196608) + params  # protocol 3.0
        s.sendall(struct.pack(">I", len(body) + 4) + body)
        while True:
            t, payload = self._read_msg(s)
            if t == b"R":
                code = struct.unpack(">I", payload[:4])[0]
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext password
                    s.sendall(self._msg(b"p", self.password.encode() + b"\x00"))
                elif code == 5:  # md5: md5(md5(password+user)+salt)
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        self.password.encode() + self.user.encode()
                    ).hexdigest().encode()
                    outer = hashlib.md5(inner + salt).hexdigest()
                    s.sendall(self._msg(b"p", b"md5" + outer.encode() + b"\x00"))
                else:
                    raise OSError(f"unsupported pg auth method {code} "
                                  "(trust/cleartext/md5 supported)")
            elif t == b"E":
                raise OSError(f"pg startup error: {payload[:120]!r}")
            elif t == b"Z":  # ReadyForQuery
                return
            # ParameterStatus ('S'), BackendKeyData ('K'), notices: skip

    def _query(self, s: socket.socket, sql: str) -> None:
        s.sendall(self._msg(b"Q", sql.encode() + b"\x00"))
        err = None
        while True:
            t, payload = self._read_msg(s)
            if t == b"E":
                err = payload
            elif t == b"Z":
                break
        if err is not None:
            raise OSError(f"pg query error: {err[:160]!r}")

    def _ensure_table(self, s: socket.socket) -> None:
        self._query(
            s,
            f'CREATE TABLE IF NOT EXISTS {self.table} '
            f'(event_time TIMESTAMP WITH TIME ZONE NOT NULL, event_data JSONB)',
        )

    def _insert(self, s: socket.socket, payload: bytes) -> None:
        lit = payload.decode().replace("'", "''")
        self._query(
            s,
            f"INSERT INTO {self.table} (event_time, event_data) "
            f"VALUES (NOW(), '{lit}')",
        )


# ------------------------------------------------------------------- MySQL


class MySQLTarget(_DBTarget):
    """MySQL client/server protocol (HandshakeV10 + COM_QUERY)."""

    def __init__(self, ident: str, host: str, port: int, user: str,
                 password: str, database: str, table: str):
        super().__init__(host, port)
        self.arn = f"arn:minio:sqs::{ident}:mysql"
        self.user, self.password, self.database = user, password, database
        self.table = table

    @staticmethod
    def parse_dsn(dsn: str) -> dict:
        """user:pass@tcp(host:port)/dbname — the go-sql-driver DSN the
        reference's MINIO_NOTIFY_MYSQL_DSN_STRING uses."""
        creds, _, rest = dsn.rpartition("@")
        user, _, password = creds.partition(":")
        host, port, db = "127.0.0.1", 3306, ""
        if rest.startswith("tcp("):
            addr, _, db = rest[4:].partition(")/")
            if ":" in addr:
                host, p = addr.rsplit(":", 1)
                port = int(p)
            else:
                host = addr
        elif "/" in rest:
            addr, _, db = rest.partition("/")
            if ":" in addr:
                host, p = addr.rsplit(":", 1)
                port = int(p)
            elif addr:
                host = addr
        return {"user": user, "password": password, "host": host,
                "port": port, "database": db}

    @staticmethod
    def _native_auth(password: str, salt: bytes) -> bytes:
        if not password:
            return b""
        p1 = hashlib.sha1(password.encode()).digest()
        p2 = hashlib.sha1(p1).digest()
        h = hashlib.sha1(salt + p2).digest()
        return bytes(a ^ b for a, b in zip(p1, h))

    def _read_packet(self, s: socket.socket) -> tuple[int, bytes]:
        head = _recv_exact(s, 4)
        ln = head[0] | (head[1] << 8) | (head[2] << 16)
        return head[3], _recv_exact(s, ln)

    def _send_packet(self, s: socket.socket, seq: int, body: bytes) -> None:
        ln = len(body)
        s.sendall(bytes((ln & 0xFF, (ln >> 8) & 0xFF, (ln >> 16) & 0xFF, seq))
                  + body)

    def _handshake(self, s: socket.socket) -> None:
        seq, greet = self._read_packet(s)
        if greet[:1] == b"\xff":
            raise OSError(f"mysql error on connect: {greet[:120]!r}")
        # HandshakeV10: version(1) server_version(NUL) thread_id(4)
        # auth_data_1(8) filler(1) cap_low(2) charset(1) status(2)
        # cap_high(2) auth_len(1) reserved(10) auth_data_2(max 13)
        i = 1
        i = greet.index(b"\x00", i) + 1
        i += 4
        salt = greet[i:i + 8]
        i += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        rest = greet[i:]
        salt += rest[: max(0, rest.find(b"\x00"))] if b"\x00" in rest else rest[:12]
        salt = salt[:20]
        caps = (
            0x00000200  # PROTOCOL_41
            | 0x00008000  # SECURE_CONNECTION
            | 0x00000008  # CONNECT_WITH_DB
            | 0x00080000  # PLUGIN_AUTH
        )
        auth = self._native_auth(self.password, salt)
        body = (
            struct.pack("<IIB23x", caps, 1 << 24, 45)  # caps, max pkt, utf8mb4
            + self.user.encode() + b"\x00"
            + bytes((len(auth),)) + auth
            + self.database.encode() + b"\x00"
            + b"mysql_native_password\x00"
        )
        self._send_packet(s, seq + 1, body)
        seq, resp = self._read_packet(s)
        if resp[:1] == b"\xfe":  # AuthSwitchRequest
            plugin, _, data = resp[1:].partition(b"\x00")
            if plugin != b"mysql_native_password":
                raise OSError(f"unsupported mysql auth plugin {plugin!r}")
            salt2 = data.rstrip(b"\x00")[:20]
            self._send_packet(s, seq + 1, self._native_auth(self.password, salt2))
            seq, resp = self._read_packet(s)
        if resp[:1] == b"\xff":
            raise OSError(f"mysql auth failed: {resp[:120]!r}")

    def _query(self, s: socket.socket, sql: str) -> None:
        self._send_packet(s, 0, b"\x03" + sql.encode())
        _seq, resp = self._read_packet(s)
        if resp[:1] == b"\xff":
            raise OSError(f"mysql query error: {resp[:160]!r}")

    def _ensure_table(self, s: socket.socket) -> None:
        self._query(
            s,
            f"CREATE TABLE IF NOT EXISTS {self.table} "
            f"(event_time DATETIME NOT NULL, event_data JSON)",
        )

    def _insert(self, s: socket.socket, payload: bytes) -> None:
        lit = payload.decode().replace("\\", "\\\\").replace("'", "\\'")
        self._query(
            s,
            f"INSERT INTO {self.table} (event_time, event_data) "
            f"VALUES (NOW(), '{lit}')",
        )
