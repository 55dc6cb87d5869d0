"""The port's SSH transport (minio_tpu_torch/server/ssh.py) against the JAX
package's (minio_tpu/server/ssh.py): the wire helpers and the key
derivation give the same bytes on seeded inputs, the packet layer frames
and encrypts alike, and each package's client completes the handshake and
the password and publickey userauth with the other package's server, as
the SFTP gateway runs it."""

from __future__ import annotations

import os
import socket
import threading

import numpy as np
import pytest

pytest.importorskip("cryptography")
from cryptography.hazmat.primitives.asymmetric import ed25519  # noqa: E402

import chip_smoke  # noqa: E402  (the port's SFTP client)
import minio_tpu.server.sftp as ref_sftp  # noqa: E402
import minio_tpu.server.ssh as ref_ssh  # noqa: E402
import minio_tpu_torch.server.sftp as port_sftp  # noqa: E402
import minio_tpu_torch.server.ssh as port_ssh  # noqa: E402
import tests.test_sftp as ref_cases  # noqa: E402
from tests.test_torch_s3_api import PORT_ENV  # noqa: E402

SEED = 20261017
PKGS = {"ref": ref_ssh, "port": port_ssh}


def _rng(i: int) -> np.random.Generator:
    return np.random.default_rng(SEED + i)


def _bytes(i: int, n: int) -> bytes:
    return _rng(i).integers(0, 256, n, dtype=np.uint8).tobytes()


# -- wire helpers -------------------------------------------------------------

WSTR = [b"", b"ssh-userauth", "password", "ключ", _bytes(1, 1000), _bytes(2, 70_001)]
WU32 = [0, 1, 255, 1 << 31, (1 << 32) - 1, int(_rng(3).integers(0, 1 << 32))]
WMPINT = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 1 << 255,
          int.from_bytes(_bytes(4, 32), "big"), int.from_bytes(_bytes(5, 32), "big") | 1 << 255]
NAMELISTS = [[], [b"none"], list(ref_ssh.CIPHERS), [b"curve25519-sha256", b"ext-info-c", b"x"]]


@pytest.mark.parametrize("v", WSTR, ids=range(len(WSTR)))
def test_wstr(v):
    assert port_ssh.wstr(v) == ref_ssh.wstr(v)


@pytest.mark.parametrize("v", WU32)
def test_wu32(v):
    assert port_ssh.wu32(v) == ref_ssh.wu32(v)


@pytest.mark.parametrize("v", WMPINT, ids=range(len(WMPINT)))
def test_wmpint(v):
    assert port_ssh.wmpint(v) == ref_ssh.wmpint(v)


@pytest.mark.parametrize("names", NAMELISTS, ids=range(len(NAMELISTS)))
def test_wnamelist(names):
    assert port_ssh.wnamelist(names) == ref_ssh.wnamelist(names)


def _message(seed: int) -> tuple[bytes, list[str]]:
    """A seeded run of typed fields, written with the reference's helpers."""
    rng, out, kinds = _rng(seed), b"", []
    for _ in range(40):
        kind = ["byte", "bool_", "u32", "u64", "str_", "namelist"][int(rng.integers(0, 6))]
        kinds.append(kind)
        if kind in ("byte", "bool_"):
            out += bytes([int(rng.integers(0, 256))])
        elif kind == "u32":
            out += ref_ssh.wu32(int(rng.integers(0, 1 << 32)))
        elif kind == "u64":
            out += int(rng.integers(0, 1 << 63)).to_bytes(8, "big")
        elif kind == "str_":
            out += ref_ssh.wstr(rng.integers(0, 256, int(rng.integers(0, 300)),
                                             dtype=np.uint8).tobytes())
        else:
            out += ref_ssh.wnamelist([b"n%d" % i for i in range(int(rng.integers(0, 4)))])
    return out + b"tail", kinds


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_reader_parses_like_the_reference(seed):
    msg, kinds = _message(seed)
    got = {}
    for name, mod in PKGS.items():
        r = mod.Reader(msg)
        got[name] = [getattr(r, k)() for k in kinds] + [r.rest(), r.p]
    assert got["port"] == got["ref"]
    assert got["port"][-2] == b"tail"


def test_reader_refuses_a_truncated_string_like_the_reference():
    msg = ref_ssh.wu32(10) + b"short"
    for mod in PKGS.values():
        with pytest.raises(mod.SSHError, match="truncated string"):
            mod.Reader(msg).str_()


@pytest.mark.parametrize("letter,n", [(b"A", 16), (b"B", 16), (b"C", 32), (b"D", 16),
                                      (b"E", 32), (b"F", 32), (b"C", 64), (b"A", 100)])
def test_derive(letter, n):
    k = int.from_bytes(_bytes(6, 32), "big")
    h, sid = _bytes(7, 32), _bytes(8, 32)
    out = {}
    for name, mod in PKGS.items():
        tr = mod.SSHTransport(None, "client")
        tr.session_id = sid
        out[name] = tr._derive(k, h, letter, n)
    assert out["port"] == out["ref"] and len(out["port"]) == n


@pytest.mark.parametrize("cookie_seed", [21, 22])
def test_kexinit_payload_with_a_fixed_cookie(monkeypatch, cookie_seed):
    cookie = _bytes(cookie_seed, 16)
    monkeypatch.setattr(os, "urandom", lambda n: cookie[:n])
    port = port_ssh.SSHTransport(None, "server")._kexinit_payload()
    assert port == ref_ssh.SSHTransport(None, "client")._kexinit_payload()
    assert port[1:17] == cookie


def _sent(mod, payload: bytes, keyed: bool) -> bytes:
    """The bytes one send_packet puts on the wire (padding fixed by the
    patched urandom), before keys or under aes256-ctr + hmac-sha2-256."""
    a, b = socket.socketpair()
    try:
        tr = mod.SSHTransport(a, "client")
        if keyed:
            tr._tx = mod._Direction(_bytes(31, 32), _bytes(32, 16), _bytes(33, 32))
            tr._tx_seq = 7
        tr.send_packet(payload)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "aes256-ctr"])
@pytest.mark.parametrize("size", [0, 1, 27, 32_768])
def test_packet_framing(monkeypatch, keyed, size):
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    payload = _bytes(40 + size, size)
    wire = _sent(port_ssh, payload, keyed)
    assert wire == _sent(ref_ssh, payload, keyed)
    # and the reference's receiver reads the port's packet back
    a, b = socket.socketpair()
    try:
        rx = ref_ssh.SSHTransport(b, "server")
        if keyed:
            rx._rx = ref_ssh._Direction(_bytes(31, 32), _bytes(32, 16), _bytes(33, 32))
            rx._rx_seq = 7
        a.sendall(wire)
        assert rx.read_packet() == payload
    finally:
        a.close()
        b.close()


def test_key_blobs_and_the_publickey_signed_bytes():
    key = ed25519.Ed25519PrivateKey.from_private_bytes(_bytes(50, 32))
    raw = port_ssh.host_key_to_bytes(key)
    assert raw == ref_ssh.host_key_to_bytes(key) == _bytes(50, 32)
    pub = port_ssh.host_key_from_bytes(raw).public_key()
    assert port_ssh.ed25519_blob(pub) == ref_ssh.ed25519_blob(pub)
    sig = key.sign(b"x")
    assert port_ssh.ed25519_sig_blob(sig) == ref_ssh.ed25519_sig_blob(sig)
    sid, blob = _bytes(51, 32), ref_ssh.ed25519_blob(pub)
    assert port_ssh.publickey_auth_blob(sid, "minioadmin", b"ssh-ed25519", blob) == \
        ref_ssh.publickey_auth_blob(sid, "minioadmin", b"ssh-ed25519", blob)


# -- handshakes across the packages ------------------------------------------

DIRECTIONS = [("port", "ref"), ("ref", "port")]  # (client, server)


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_transport_handshake_across_packages(client, server):
    host_key = ed25519.Ed25519PrivateKey.from_private_bytes(_bytes(60, 32))
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    srv = PKGS[server].SSHTransport(b, "server", host_key=host_key)
    cli = PKGS[client].SSHTransport(a, "client")
    got, errs = [], []

    def serve():
        try:
            srv.handshake()
            for _ in range(3):
                p = srv.read_packet()
                got.append(p)
                srv.send_packet(p[::-1])
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        cli.handshake()
        sent = [b"\x5e" + _bytes(61, 10), b"\x5e" + _bytes(62, 40_000), b"\x5e"]
        for p in sent:
            cli.send_packet(p)
            assert cli.read_packet() == p[::-1]
        th.join(30)
        assert not th.is_alive() and not errs, errs
        assert got == sent
        assert cli.session_id == srv.session_id and len(cli.session_id) == 32
        assert cli.peer_host_key_blob == ref_ssh.ed25519_blob(host_key.public_key())
        assert cli.remote_version == srv.remote_version == ref_ssh.VERSION
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def gateways(tmp_path_factory):
    """Each package's SFTP gateway on its own server object; ``minioadmin``
    may log in with a password or with ``KEY``."""
    from minio_tpu.server.app import make_server as ref_make
    from minio_tpu_torch.server.app import make_server as port_make

    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        base = tmp_path_factory.mktemp("ssh-gw")
        blob = ref_ssh.ed25519_blob(KEY.public_key())
        srvs = {"ref": ref_make([str(base / "r" / f"d{i}") for i in range(4)]),
                "port": port_make([str(base / "p" / f"d{i}") for i in range(4)])}
        mods = {"ref": ref_sftp, "port": port_sftp}
        gws = {n: mods[n].SFTPGateway(srvs[n], authorized_keys={"minioadmin": {blob}})
               for n in srvs}
        ports = {n: gw.listen("127.0.0.1", 0) for n, gw in gws.items()}
        yield ports
        for n in srvs:
            gws[n].close()
            srvs[n].close()


KEY = ed25519.Ed25519PrivateKey.from_private_bytes(_bytes(70, 32))
STRANGER = ed25519.Ed25519PrivateKey.from_private_bytes(_bytes(71, 32))


def _connect(client: str, port: int, **auth):
    """An SFTP session of ``client``'s package: the reference's test client
    (tests/test_sftp.py) or the port's (chip_smoke.SFTPClient)."""
    if client == "ref":
        return ref_cases.SFTPClient(port, "minioadmin", **auth)
    return chip_smoke.SFTPClient(port, "minioadmin", **auth)


@pytest.mark.parametrize("method", ["password", "publickey"])
@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_userauth_across_packages(gateways, client, server, method):
    auth = {"password": "minioadmin"} if method == "password" else {"key": KEY}
    c = _connect(client, gateways[server], **auth)
    try:
        assert c.realpath(".") == "/"
        assert c.realpath("a/../b/c/") == "/b/c"
    finally:
        c.close()


@pytest.mark.parametrize("refused", ["password", "publickey"])
@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_userauth_refusals_across_packages(gateways, client, server, refused):
    auth = {"password": "not-the-secret"} if refused == "password" else {"key": STRANGER}
    with pytest.raises(PermissionError):
        _connect(client, gateways[server], **auth)
