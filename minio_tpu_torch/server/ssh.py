"""SSH transport (RFC 4253/4252/4254 subset) for the SFTP frontend.

MinIO serves SFTP through golang.org/x/crypto/ssh (cmd/sftp-server.go).
The subset that gateway needs is implemented here on `cryptography`
primitives, byte for byte as the JAX package's server/ssh.py:

* kex  curve25519-sha256 (RFC 8731), host key ssh-ed25519 (RFC 8709)
* ciphers aes256-ctr / aes128-ctr, MAC hmac-sha2-256 (encrypt-and-MAC)
* userauth: password + publickey (ssh-ed25519)
* connection: session channels + subsystem requests with windowed flow
  control (server/sftp.py) — enough for any standard sftp client

Both roles are implemented (the server, and a client that the tests and
``chip_smoke.py`` drive) over blocking sockets; the server runs a thread
per connection so per-packet crypto stays off the asyncio event loop.
`cryptography` is imported at the top: only ``main()``'s ``--sftp`` and
the SFTP gateway import this module, so importing the server pulls in no
optional package.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
import threading

from cryptography.hazmat.primitives.asymmetric import ed25519, x25519
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.serialization import (
    Encoding,
    NoEncryption,
    PrivateFormat,
    PublicFormat,
)

VERSION = b"SSH-2.0-minio_tpu_0.3"

# message numbers (RFC 4250)
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_PK_OK = 60
MSG_GLOBAL_REQUEST = 80
MSG_REQUEST_SUCCESS = 81
MSG_REQUEST_FAILURE = 82
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EXTENDED_DATA = 95
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

KEX_ALGO = b"curve25519-sha256"
HOSTKEY_ALGO = b"ssh-ed25519"
CIPHERS = (b"aes256-ctr", b"aes128-ctr")
MACS = (b"hmac-sha2-256",)


class SSHError(Exception):
    pass


# -- wire primitives ---------------------------------------------------------


def wstr(b: bytes | str) -> bytes:
    if isinstance(b, str):
        b = b.encode()
    return struct.pack(">I", len(b)) + b


def wu32(v: int) -> bytes:
    return struct.pack(">I", v)


def wmpint(v: int) -> bytes:
    if v == 0:
        return wstr(b"")
    b = v.to_bytes((v.bit_length() + 7) // 8, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return wstr(b)


def wnamelist(names) -> bytes:
    return wstr(b",".join(names))


class Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def byte(self) -> int:
        v = self.d[self.p]
        self.p += 1
        return v

    def bool_(self) -> bool:
        return self.byte() != 0

    def u32(self) -> int:
        v = struct.unpack_from(">I", self.d, self.p)[0]
        self.p += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from(">Q", self.d, self.p)[0]
        self.p += 8
        return v

    def str_(self) -> bytes:
        n = self.u32()
        v = self.d[self.p : self.p + n]
        if len(v) != n:
            raise SSHError("truncated string")
        self.p += n
        return v

    def namelist(self) -> list[bytes]:
        s = self.str_()
        return s.split(b",") if s else []

    def rest(self) -> bytes:
        v = self.d[self.p :]
        self.p = len(self.d)
        return v


def ed25519_blob(pub: ed25519.Ed25519PublicKey) -> bytes:
    raw = pub.public_bytes(Encoding.Raw, PublicFormat.Raw)
    return wstr(HOSTKEY_ALGO) + wstr(raw)


def ed25519_sig_blob(sig: bytes) -> bytes:
    return wstr(HOSTKEY_ALGO) + wstr(sig)


# -- transport ---------------------------------------------------------------


class _Direction:
    """One direction's cipher+mac state."""

    def __init__(self, key: bytes, iv: bytes, mac_key: bytes):
        self.enc = Cipher(algorithms.AES(key), modes.CTR(iv))
        self.encryptor = self.enc.encryptor()
        self.mac_key = mac_key
        self.seq = 0


class SSHTransport:
    """One SSH connection endpoint (role 'server' or 'client')."""

    def __init__(self, sock: socket.socket, role: str,
                 host_key: ed25519.Ed25519PrivateKey | None = None):
        self.sock = sock
        self.role = role
        self.host_key = host_key
        self.session_id: bytes | None = None
        self._tx: _Direction | None = None
        self._rx: _Direction | None = None
        self._tx_seq = 0
        self._rx_seq = 0
        self._wlock = threading.Lock()
        self.remote_version = b""
        self.peer_host_key_blob: bytes | None = None

    # -- raw packet layer --------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise SSHError("connection closed")
            out += chunk
        return out

    def send_packet(self, payload: bytes) -> None:
        with self._wlock:
            block = 16 if self._tx else 8
            # padding so total (len+padlen+payload+padding) % block == 0
            overhead = 5
            pad = block - ((overhead + len(payload)) % block)
            if pad < 4:
                pad += block
            body = struct.pack(">IB", 1 + len(payload) + pad, pad) + payload + os.urandom(pad)
            if self._tx is None:
                self.sock.sendall(body)
            else:
                mac = hmac_mod.new(
                    self._tx.mac_key, wu32(self._tx_seq) + body, hashlib.sha256
                ).digest()
                self.sock.sendall(self._tx.encryptor.update(body) + mac)
            self._tx_seq = (self._tx_seq + 1) & 0xFFFFFFFF

    def read_packet(self) -> bytes:
        if self._rx is None:
            hdr = self._read_exact(5)
            plen, pad = struct.unpack(">IB", hdr)
            if plen > 1 << 24:
                raise SSHError("packet too large")
            body = self._read_exact(plen - 1)
            payload = body[: plen - 1 - pad]
        else:
            first = self._rx.encryptor.update(self._read_exact(16))
            plen, pad = struct.unpack(">IB", first[:5])
            if plen > 1 << 24:
                raise SSHError("packet too large")
            remaining = plen + 4 - 16
            rest = self._rx.encryptor.update(self._read_exact(remaining)) if remaining else b""
            mac = self._read_exact(32)
            body = first + rest
            want = hmac_mod.new(
                self._rx.mac_key, wu32(self._rx_seq) + body, hashlib.sha256
            ).digest()
            if not hmac_mod.compare_digest(mac, want):
                raise SSHError("bad packet MAC")
            payload = body[5 : 5 + plen - 1 - pad]
        self._rx_seq = (self._rx_seq + 1) & 0xFFFFFFFF
        return payload

    def read_msg(self) -> tuple[int, Reader]:
        while True:
            p = self.read_packet()
            t = p[0]
            if t in (MSG_IGNORE, MSG_DEBUG):
                continue
            if t == MSG_UNIMPLEMENTED:
                continue
            if t == MSG_DISCONNECT:
                r = Reader(p[1:])
                code = r.u32()
                raise SSHError(f"peer disconnected (code {code})")
            return t, Reader(p[1:])

    # -- handshake ---------------------------------------------------------

    def _exchange_versions(self) -> None:
        self.sock.sendall(VERSION + b"\r\n")
        # read until the SSH- line (clients may send banner-preceding lines
        # only server->client; be lenient anyway)
        buf = b""
        while True:
            c = self.sock.recv(1)
            if not c:
                raise SSHError("closed during version exchange")
            buf += c
            if buf.endswith(b"\n"):
                line = buf.strip()
                if line.startswith(b"SSH-"):
                    self.remote_version = line
                    return
                buf = b""
                if len(line) > 4096:
                    raise SSHError("bad version line")

    def _kexinit_payload(self) -> bytes:
        return (
            bytes([MSG_KEXINIT])
            + os.urandom(16)
            + wnamelist([KEX_ALGO])
            + wnamelist([HOSTKEY_ALGO])
            + wnamelist(CIPHERS)
            + wnamelist(CIPHERS)
            + wnamelist(MACS)
            + wnamelist(MACS)
            + wnamelist([b"none"])
            + wnamelist([b"none"])
            + wnamelist([])
            + wnamelist([])
            + b"\x00"  # first_kex_packet_follows
            + wu32(0)
        )

    @staticmethod
    def _negotiate(client_list: list[bytes], server_list: list[bytes], what: str) -> bytes:
        for c in client_list:
            if c in server_list:
                return c
        raise SSHError(f"no common {what}: {client_list} vs {server_list}")

    def handshake(self) -> None:
        self._exchange_versions()
        my_kexinit = self._kexinit_payload()
        self.send_packet(my_kexinit)
        t, r = self.read_msg()
        if t != MSG_KEXINIT:
            raise SSHError(f"expected KEXINIT, got {t}")
        peer_kexinit = bytes([MSG_KEXINIT]) + r.d
        pr = Reader(r.d)
        pr.p += 16  # cookie
        kex_algos = pr.namelist()
        hostkey_algos = pr.namelist()
        enc_cs = pr.namelist()
        enc_sc = pr.namelist()
        mac_cs = pr.namelist()
        mac_sc = pr.namelist()
        comp_cs = pr.namelist()
        comp_sc = pr.namelist()
        if self.role == "server":
            client_k, server_k = kex_algos, [KEX_ALGO]
            cipher_cs = self._negotiate(enc_cs, list(CIPHERS), "cipher c->s")
            cipher_sc = self._negotiate(enc_sc, list(CIPHERS), "cipher s->c")
            i_c, i_s = peer_kexinit, my_kexinit
        else:
            client_k, server_k = [KEX_ALGO], kex_algos
            cipher_cs = self._negotiate(list(CIPHERS), enc_cs, "cipher c->s")
            cipher_sc = self._negotiate(list(CIPHERS), enc_sc, "cipher s->c")
            i_c, i_s = my_kexinit, peer_kexinit
        self._negotiate(client_k, server_k, "kex")
        # RFC 4253 §7.1: every algorithm slot must negotiate, else a clean
        # disconnect now beats "bad packet MAC" after NEWKEYS
        self._negotiate(mac_cs, list(MACS), "mac c->s")
        self._negotiate(mac_sc, list(MACS), "mac s->c")
        self._negotiate(comp_cs, [b"none"], "compression c->s")
        self._negotiate(comp_sc, [b"none"], "compression s->c")
        if HOSTKEY_ALGO not in (hostkey_algos or [HOSTKEY_ALGO]):
            raise SSHError("no common host key algo")

        if self.role == "server":
            self._kex_server(i_c, i_s, cipher_cs, cipher_sc)
        else:
            self._kex_client(i_c, i_s, cipher_cs, cipher_sc)

    def _kex_server(self, i_c, i_s, cipher_cs, cipher_sc) -> None:
        t, r = self.read_msg()
        if t != MSG_KEX_ECDH_INIT:
            raise SSHError(f"expected ECDH_INIT, got {t}")
        q_c = r.str_()
        eph = x25519.X25519PrivateKey.generate()
        q_s = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        shared = eph.exchange(x25519.X25519PublicKey.from_public_bytes(q_c))
        k = int.from_bytes(shared, "big")
        k_s = ed25519_blob(self.host_key.public_key())
        h = hashlib.sha256(
            wstr(self.remote_version)
            + wstr(VERSION)
            + wstr(i_c)
            + wstr(i_s)
            + wstr(k_s)
            + wstr(q_c)
            + wstr(q_s)
            + wmpint(k)
        ).digest()
        if self.session_id is None:
            self.session_id = h
        sig = self.host_key.sign(h)
        self.send_packet(
            bytes([MSG_KEX_ECDH_REPLY])
            + wstr(k_s)
            + wstr(q_s)
            + wstr(ed25519_sig_blob(sig))
        )
        self._switch_keys(k, h, cipher_cs, cipher_sc)

    def _kex_client(self, i_c, i_s, cipher_cs, cipher_sc) -> None:
        eph = x25519.X25519PrivateKey.generate()
        q_c = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
        self.send_packet(bytes([MSG_KEX_ECDH_INIT]) + wstr(q_c))
        t, r = self.read_msg()
        if t != MSG_KEX_ECDH_REPLY:
            raise SSHError(f"expected ECDH_REPLY, got {t}")
        k_s = r.str_()
        q_s = r.str_()
        sig_blob = r.str_()
        shared = eph.exchange(x25519.X25519PublicKey.from_public_bytes(q_s))
        k = int.from_bytes(shared, "big")
        h = hashlib.sha256(
            wstr(VERSION)
            + wstr(self.remote_version)
            + wstr(i_c)
            + wstr(i_s)
            + wstr(k_s)
            + wstr(q_c)
            + wstr(q_s)
            + wmpint(k)
        ).digest()
        if self.session_id is None:
            self.session_id = h
        kr = Reader(k_s)
        if kr.str_() != HOSTKEY_ALGO:
            raise SSHError("unexpected host key type")
        pub = ed25519.Ed25519PublicKey.from_public_bytes(kr.str_())
        sr = Reader(sig_blob)
        if sr.str_() != HOSTKEY_ALGO:
            raise SSHError("unexpected signature type")
        pub.verify(sr.str_(), h)  # raises InvalidSignature on mismatch
        self.peer_host_key_blob = k_s
        self._switch_keys(k, h, cipher_cs, cipher_sc)

    def _derive(self, k: int, h: bytes, letter: bytes, n: int) -> bytes:
        out = hashlib.sha256(wmpint(k) + h + letter + self.session_id).digest()
        while len(out) < n:
            out += hashlib.sha256(wmpint(k) + h + out).digest()
        return out[:n]

    def _switch_keys(self, k: int, h: bytes, cipher_cs: bytes, cipher_sc: bytes) -> None:
        self.send_packet(bytes([MSG_NEWKEYS]))
        t, _ = self.read_msg()
        if t != MSG_NEWKEYS:
            raise SSHError(f"expected NEWKEYS, got {t}")
        ks_cs = 32 if cipher_cs == b"aes256-ctr" else 16
        ks_sc = 32 if cipher_sc == b"aes256-ctr" else 16
        iv_cs = self._derive(k, h, b"A", 16)
        iv_sc = self._derive(k, h, b"B", 16)
        key_cs = self._derive(k, h, b"C", ks_cs)
        key_sc = self._derive(k, h, b"D", ks_sc)
        mac_cs = self._derive(k, h, b"E", 32)
        mac_sc = self._derive(k, h, b"F", 32)
        cs = _Direction(key_cs, iv_cs, mac_cs)
        sc = _Direction(key_sc, iv_sc, mac_sc)
        if self.role == "server":
            self._rx, self._tx = cs, sc
        else:
            self._rx, self._tx = sc, cs

    def disconnect(self) -> None:
        try:
            self.send_packet(
                bytes([MSG_DISCONNECT]) + wu32(11) + wstr("bye") + wstr("")
            )
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def generate_host_key() -> ed25519.Ed25519PrivateKey:
    return ed25519.Ed25519PrivateKey.generate()


def host_key_to_bytes(key: ed25519.Ed25519PrivateKey) -> bytes:
    return key.private_bytes(Encoding.Raw, PrivateFormat.Raw, NoEncryption())


def host_key_from_bytes(raw: bytes) -> ed25519.Ed25519PrivateKey:
    return ed25519.Ed25519PrivateKey.from_private_bytes(raw)


def publickey_auth_blob(
    session_id: bytes, user: str, algo: bytes, pub_blob: bytes
) -> bytes:
    """The exact bytes a publickey USERAUTH_REQUEST signature covers
    (RFC 4252 §7)."""
    return (
        wstr(session_id)
        + bytes([MSG_USERAUTH_REQUEST])
        + wstr(user)
        + wstr("ssh-connection")
        + wstr("publickey")
        + b"\x01"
        + wstr(algo)
        + wstr(pub_blob)
    )
