"""Dependency-free LDAP v3 client for the LDAP identity backend.

The reference authenticates `AssumeRoleWithLDAPIdentity` callers against
an external directory (MinIO cmd/sts-handlers.go:649,
internal/config/identity/ldap/ldap.go Bind/LookupUserDN): a service
("lookup bind") account searches the user's DN and groups, then the
user's own credentials are verified with a second bind. No LDAP library
ships in this image, so the minimal protocol subset those flows need —
BindRequest/Response, SearchRequest/ResultEntry/Done, UnbindRequest —
is implemented here directly over BER/TCP (RFC 4511), plus an RFC 4515
string-filter compiler for the config's filter templates.

MinIO filter placeholders: %s = login username, %d = the user's full DN.
"""

from __future__ import annotations

import socket
import ssl as ssl_mod
from dataclasses import dataclass, field

# -- BER (subset: definite lengths only, as LDAP requires) -------------------


def ber(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(lb)]) + lb + content


def ber_int(v: int, tag: int = 0x02) -> bytes:
    if v == 0:
        return bytes([tag, 1, 0])
    out = v.to_bytes((v.bit_length() // 8) + 1, "big")  # extra sign byte ok
    while len(out) > 1 and out[0] == 0 and out[1] < 0x80:
        out = out[1:]
    return bytes([tag, len(out)]) + out


def ber_str(s: str | bytes, tag: int = 0x04) -> bytes:
    return ber(tag, s.encode() if isinstance(s, str) else s)


def ber_seq(*parts: bytes, tag: int = 0x30) -> bytes:
    return ber(tag, b"".join(parts))


class BERReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def tlv(self) -> tuple[int, bytes]:
        tag = self.data[self.pos]
        self.pos += 1
        first = self.data[self.pos]
        self.pos += 1
        if first < 0x80:
            ln = first
        else:
            nb = first & 0x7F
            ln = int.from_bytes(self.data[self.pos : self.pos + nb], "big")
            self.pos += nb
        val = self.data[self.pos : self.pos + ln]
        self.pos += ln
        return tag, val

    def int_(self) -> int:
        tag, v = self.tlv()
        return int.from_bytes(v, "big", signed=True)


# -- RFC 4515 filter string -> BER filter ------------------------------------


def compile_filter(expr: str) -> bytes:
    expr = expr.strip()
    out, pos = _compile_filter(expr, 0)
    if pos != len(expr):
        raise ValueError(f"trailing filter garbage: {expr[pos:]!r}")
    return out


def _compile_filter(s: str, pos: int) -> tuple[bytes, int]:
    if s[pos] != "(":
        raise ValueError(f"filter must open with ( at {pos}")
    pos += 1
    c = s[pos]
    if c in "&|":
        tag = 0xA0 if c == "&" else 0xA1
        pos += 1
        subs = []
        while s[pos] == "(":
            sub, pos = _compile_filter(s, pos)
            subs.append(sub)
        if s[pos] != ")":
            raise ValueError("unterminated and/or filter")
        return ber(tag, b"".join(subs)), pos + 1
    if c == "!":
        sub, pos = _compile_filter(s, pos + 1)
        if s[pos] != ")":
            raise ValueError("unterminated not filter")
        return ber(0xA2, sub), pos + 1
    end = s.index(")", pos)
    body = s[pos:end]
    if "=" not in body:
        raise ValueError(f"bad filter item {body!r}")
    attr, _, val = body.partition("=")
    if val == "*":
        return ber(0x87, attr.encode()), end + 1  # present
    return (
        # RFC 4511 AssertionValues carry raw octets: \xx escapes in the
        # RFC 4515 string form (what _filter_escape emits) decode HERE,
        # not on the directory server
        ber(0xA3, ber_str(attr) + ber_str(_filter_unescape(val))),
        end + 1,
    )


def _filter_unescape(v: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(v):
        if v[i] == "\\":
            if i + 3 > len(v):
                raise ValueError("truncated \\xx escape in filter value")
            out.append(int(v[i + 1 : i + 3], 16))
            i += 3
        else:
            out += v[i].encode()
            i += 1
    return bytes(out)


# -- protocol ----------------------------------------------------------------

BIND_REQ, BIND_RESP = 0x60, 0x61
UNBIND_REQ = 0x42
SEARCH_REQ, SEARCH_ENTRY, SEARCH_DONE = 0x63, 0x64, 0x65
SCOPE_SUBTREE = 2


class LDAPError(Exception):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(f"LDAP result {code}: {msg}")
        self.code = code


class LDAPConn:
    """One LDAP connection; not thread-safe (callers open per-operation)."""

    def __init__(self, addr: str, timeout: float = 10.0, tls: bool = False,
                 tls_skip_verify: bool = False):
        host, _, port = addr.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or (636 if tls else 389))), timeout=timeout
        )
        if tls:
            ctx = ssl_mod.create_default_context()
            if tls_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl_mod.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
        self.msg_id = 0

    def close(self) -> None:
        try:
            self.msg_id += 1
            self.sock.sendall(
                ber_seq(ber_int(self.msg_id), bytes([UNBIND_REQ, 0]))
            )
        except OSError:
            pass
        self.sock.close()

    def _send(self, op: bytes) -> int:
        self.msg_id += 1
        self.sock.sendall(ber_seq(ber_int(self.msg_id), op))
        return self.msg_id

    def _recv_msg(self) -> tuple[int, int, bytes]:
        """-> (msg_id, op_tag, op_content)"""
        hdr = self._read_exact(2)
        first = hdr[1]
        if first < 0x80:
            ln = first
            body = self._read_exact(ln)
        else:
            nb = first & 0x7F
            lb = self._read_exact(nb)
            body = self._read_exact(int.from_bytes(lb, "big"))
        r = BERReader(body)
        mid = r.int_()
        tag, content = r.tlv()
        return mid, tag, content

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise LDAPError(-1, "connection closed")
            out += chunk
        return out

    def bind(self, dn: str, password: str) -> None:
        """Simple bind; raises LDAPError on non-zero result (49 =
        invalidCredentials)."""
        op = ber(
            BIND_REQ,
            ber_int(3) + ber_str(dn) + ber(0x80, password.encode()),
        )
        self._send(op)
        _, tag, content = self._recv_msg()
        if tag != BIND_RESP:
            raise LDAPError(-1, f"unexpected response tag {tag:#x}")
        r = BERReader(content)
        code = r.int_()
        r.tlv()  # matchedDN
        _, diag = r.tlv()
        if code != 0:
            raise LDAPError(code, diag.decode("utf-8", "replace"))

    def search(
        self, base: str, flt: str, attrs: list[str] | None = None
    ) -> list[tuple[str, dict[str, list[str]]]]:
        """Subtree search -> [(dn, {attr: [values]})]."""
        op = ber(
            SEARCH_REQ,
            ber_str(base)
            + ber_int(SCOPE_SUBTREE, 0x0A)
            + ber_int(0, 0x0A)  # neverDerefAliases
            + ber_int(0)  # sizeLimit
            + ber_int(0)  # timeLimit
            + bytes([0x01, 0x01, 0x00])  # typesOnly FALSE
            + compile_filter(flt)
            + ber_seq(*[ber_str(a) for a in (attrs or [])]),
        )
        mid = self._send(op)
        out = []
        while True:
            rid, tag, content = self._recv_msg()
            if rid != mid:
                continue
            if tag == SEARCH_ENTRY:
                r = BERReader(content)
                _, dn = r.tlv()
                attrs_out: dict[str, list[str]] = {}
                if not r.eof():
                    _, attrseq = r.tlv()
                    ar = BERReader(attrseq)
                    while not ar.eof():
                        _, one = ar.tlv()
                        er = BERReader(one)
                        _, name = er.tlv()
                        _, vals = er.tlv()
                        vr = BERReader(vals)
                        vlist = []
                        while not vr.eof():
                            _, v = vr.tlv()
                            vlist.append(v.decode("utf-8", "replace"))
                        attrs_out[name.decode()] = vlist
                out.append((dn.decode(), attrs_out))
            elif tag == SEARCH_DONE:
                r = BERReader(content)
                code = r.int_()
                r.tlv()
                _, diag = r.tlv()
                if code != 0:
                    raise LDAPError(code, diag.decode("utf-8", "replace"))
                return out
            else:
                raise LDAPError(-1, f"unexpected search tag {tag:#x}")


# -- identity backend --------------------------------------------------------


@dataclass
class LDAPIdentity:
    """Mirrors internal/config/identity/ldap Config: a lookup-bind service
    account searches user DN + groups; the user's password is verified by
    a second bind as that DN."""

    server_addr: str = ""
    lookup_bind_dn: str = ""
    lookup_bind_password: str = ""
    user_dn_search_base: str = ""
    user_dn_search_filter: str = ""  # e.g. (uid=%s)
    group_search_base: str = ""
    group_search_filter: str = ""  # e.g. (&(objectclass=groupOfNames)(member=%d))
    tls: bool = False
    tls_skip_verify: bool = False
    extra: dict = field(default_factory=dict)

    @property
    def enabled(self) -> bool:
        return bool(self.server_addr and self.user_dn_search_base)

    def _connect(self) -> LDAPConn:
        return LDAPConn(
            self.server_addr, tls=self.tls, tls_skip_verify=self.tls_skip_verify
        )

    def lookup_user(self, username: str) -> tuple[str, list[str]]:
        """-> (user_dn, group_dns) via the lookup-bind account."""
        conn = self._connect()
        try:
            conn.bind(self.lookup_bind_dn, self.lookup_bind_password)
            flt = self.user_dn_search_filter.replace("%s", _filter_escape(username))
            entries = conn.search(self.user_dn_search_base, flt)
            if not entries:
                raise LDAPError(32, f"User DN not found for {username}")
            if len(entries) > 1:
                raise LDAPError(-1, f"multiple DNs for {username}")
            user_dn = entries[0][0]
            groups: list[str] = []
            if self.group_search_base and self.group_search_filter:
                gflt = self.group_search_filter.replace(
                    "%d", _filter_escape(user_dn)
                ).replace("%s", _filter_escape(username))
                groups = [dn for dn, _ in conn.search(self.group_search_base, gflt)]
            return user_dn, groups
        finally:
            conn.close()

    def bind_user(self, username: str, password: str) -> tuple[str, list[str]]:
        """Full authentication: lookup then verify the user's password.
        -> (user_dn, group_dns); LDAPError(49) on bad credentials."""
        if not password:
            # RFC 4513: empty password is an UNAUTHENTICATED bind, which
            # servers accept — never treat it as a password match
            raise LDAPError(49, "empty password")
        user_dn, groups = self.lookup_user(username)
        conn = self._connect()
        try:
            conn.bind(user_dn, password)
        finally:
            conn.close()
        return user_dn, groups


def _filter_escape(v: str) -> str:
    """RFC 4515 value escaping for filter substitution."""
    out = []
    for ch in v:
        if ch in "*()\\\x00":
            out.append("\\%02x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


def from_config(cfg) -> LDAPIdentity:
    """Build from the identity_ldap config subsystem (server/config_kv.py).
    Like the reference, the connection is TLS unless the operator
    explicitly opts into plaintext with server_insecure=on — one switch,
    no second key that could silently veto it."""
    g = lambda k: cfg.get("identity_ldap", k)  # noqa: E731
    return LDAPIdentity(
        server_addr=g("server_addr"),
        lookup_bind_dn=g("lookup_bind_dn"),
        lookup_bind_password=g("lookup_bind_password"),
        user_dn_search_base=g("user_dn_search_base_dn"),
        user_dn_search_filter=g("user_dn_search_filter"),
        group_search_base=g("group_search_base_dn"),
        group_search_filter=g("group_search_filter"),
        tls=g("server_insecure") != "on",
        tls_skip_verify=g("tls_skip_verify") == "on",
    )
