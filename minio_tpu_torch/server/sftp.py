"""SFTP frontend — the second protocol gateway over the object layer.

Mirrors MinIO's SFTP server (cmd/sftp-server.go: an x/crypto/ssh server
whose handlers drive the ObjectLayer): buckets are top-level directories,
objects are files, IAM credentials authenticate (username = access key,
password = secret key) and the caller's policies govern every operation —
the same checks the S3 API applies. Runs on the SSH transport in
server/ssh.py (SFTP protocol version 3).

Reads are served as ranged reads of an erasure ``ObjectHandle``, so a
degraded object decodes through the device codec (K1 on the card);
writes spool to a temp file and commit as one object PUT on close (SFTP
write offsets are not guaranteed sequential), which encodes through the
dispatcher. Enable with --sftp <port>.
"""

from __future__ import annotations

import io
import posixpath
import socket
import stat as stat_mod
import struct
import threading

from ..erasure import listing, quorum
from .ssh import (
    MSG_CHANNEL_CLOSE,
    MSG_CHANNEL_DATA,
    MSG_CHANNEL_EOF,
    MSG_CHANNEL_OPEN,
    MSG_CHANNEL_OPEN_CONFIRMATION,
    MSG_CHANNEL_OPEN_FAILURE,
    MSG_CHANNEL_REQUEST,
    MSG_CHANNEL_SUCCESS,
    MSG_CHANNEL_WINDOW_ADJUST,
    MSG_SERVICE_ACCEPT,
    MSG_SERVICE_REQUEST,
    MSG_USERAUTH_FAILURE,
    MSG_USERAUTH_REQUEST,
    MSG_USERAUTH_SUCCESS,
    Reader,
    SSHError,
    SSHTransport,
    wstr,
    wu32,
)

# SFTP v3 (draft-ietf-secsh-filexfer-02) packet types
FXP_INIT, FXP_VERSION = 1, 2
FXP_OPEN, FXP_CLOSE, FXP_READ, FXP_WRITE = 3, 4, 5, 6
FXP_LSTAT, FXP_FSTAT, FXP_SETSTAT, FXP_FSETSTAT = 7, 8, 9, 10
FXP_OPENDIR, FXP_READDIR, FXP_REMOVE, FXP_MKDIR, FXP_RMDIR = 11, 12, 13, 14, 15
FXP_REALPATH, FXP_STAT, FXP_RENAME = 16, 17, 18
FXP_STATUS, FXP_HANDLE, FXP_DATA, FXP_NAME, FXP_ATTRS = 101, 102, 103, 104, 105

FX_OK, FX_EOF, FX_NO_SUCH_FILE, FX_PERMISSION_DENIED = 0, 1, 2, 3
FX_FAILURE, FX_BAD_MESSAGE, FX_OP_UNSUPPORTED = 4, 5, 8

PF_READ, PF_WRITE, PF_APPEND, PF_CREAT, PF_TRUNC, PF_EXCL = 1, 2, 4, 8, 16, 32

ATTR_SIZE, ATTR_UIDGID, ATTR_PERMISSIONS, ATTR_ACMODTIME = 0x1, 0x2, 0x4, 0x8


def _attrs(size: int = 0, is_dir: bool = False, mtime: int = 0) -> bytes:
    perms = (stat_mod.S_IFDIR | 0o755) if is_dir else (stat_mod.S_IFREG | 0o644)
    return (
        wu32(ATTR_SIZE | ATTR_PERMISSIONS | ATTR_ACMODTIME)
        + struct.pack(">Q", size)
        + wu32(perms)
        + wu32(mtime)
        + wu32(mtime)
    )


def _skip_attrs(r: Reader) -> None:
    flags = r.u32()
    if flags & ATTR_SIZE:
        r.u64()
    if flags & ATTR_UIDGID:
        r.u32(), r.u32()
    if flags & ATTR_PERMISSIONS:
        r.u32()
    if flags & ATTR_ACMODTIME:
        r.u32(), r.u32()


class _ReadHandle:
    def __init__(self, oi, handle):
        self.oi = oi
        self.handle = handle  # erasure ObjectHandle

    def read(self, off: int, n: int) -> bytes:
        if off >= self.oi.size:
            return b""
        n = min(n, self.oi.size - off)
        return b"".join(self.handle.read(off, n, close_when_done=False))

    def close(self):
        self.handle.close()


class _WriteHandle:
    """Random-offset writes spool to a temp file (memory only while small)
    and commit as one object PUT on close; opening an existing object
    without TRUNC preloads its bytes so append/resume does not zero-fill
    the prefix."""

    def __init__(self, bucket: str, key: str, initial: bytes = b""):
        import tempfile

        self.bucket = bucket
        self.key = key
        self.spool = tempfile.SpooledTemporaryFile(max_size=8 << 20)
        if initial:
            self.spool.write(initial)

    def write(self, off: int, data: bytes) -> None:
        self.spool.seek(off)
        self.spool.write(data)

    def getvalue(self) -> bytes:
        self.spool.seek(0)
        return self.spool.read()

    def size(self) -> int:
        self.spool.seek(0, 2)
        return self.spool.tell()

    def close(self):
        self.spool.close()


class _DirHandle:
    def __init__(self, entries: list[tuple[str, int, bool, int]]):
        self.entries = entries
        self.pos = 0


def load_authorized_keys(path: str | None) -> dict[str, set[bytes]]:
    """Parse an authorized-keys map: one `<access_key> ssh-ed25519 <b64>`
    per line (set MINIO_SFTP_AUTHORIZED_KEYS to the file path)."""
    import base64

    out: dict[str, set[bytes]] = {}
    if not path:
        return out
    try:
        lines = open(path, encoding="utf-8").read().splitlines()
    except OSError:
        return out
    for line in lines:
        parts = line.split()
        if len(parts) >= 3 and parts[1] == "ssh-ed25519":
            try:
                # the base64 field IS the wire blob: string "ssh-ed25519"
                # + string raw-key (standard OpenSSH public key encoding)
                out.setdefault(parts[0], set()).add(base64.b64decode(parts[2]))
            except ValueError:
                continue
    return out


class SFTPGateway:
    """Accept loop + per-connection SSH/SFTP service."""

    def __init__(self, server, host_key=None, authorized_keys=None):
        from . import ssh as sshmod

        self.server = server  # S3Server (store, iam, ...)
        self.host_key = host_key or sshmod.generate_host_key()
        # user -> set of ssh-ed25519 public key blobs trusted for key auth
        # (the reference trusts keys via its user-CA; ours are registered
        # directly, e.g. loaded from MINIO_SFTP_AUTHORIZED_KEYS)
        self.authorized_keys: dict[str, set[bytes]] = {
            u: set(ks) for u, ks in (authorized_keys or {}).items()
        }
        self._sock: socket.socket | None = None
        self._stopped = False

    @property
    def store(self):
        return self.server.store

    def listen(self, host: str, port: int) -> int:
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        return self._sock.getsockname()[1]

    def close(self) -> None:
        self._stopped = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    # -- auth --------------------------------------------------------------

    def _check_password(self, user: str, password: str) -> bool:
        iam = self.server.iam
        secret = iam.lookup_secret(user)
        if secret is None or not password:
            return False
        import hmac as _h

        return _h.compare_digest(secret, password)

    def _allowed(self, user: str, action: str, bucket: str, key: str = "") -> bool:
        """Same decision path as the S3 API (server._authorize): identity
        policies AND bucket policies, so a bucket-policy Deny binds SFTP
        exactly as it binds S3/FTP."""
        from . import s3err

        try:
            self.server._authorize(user, action, bucket, key)
            return True
        except s3err.APIError:
            return False

    # -- SSH connection service -------------------------------------------

    def _serve_conn(self, sock: socket.socket) -> None:
        sock.settimeout(300)
        tr = SSHTransport(sock, "server", host_key=self.host_key)
        sftp_box: list = [None]
        try:
            tr.handshake()
            user = self._userauth(tr)
            if user is None:
                return
            self._connection_loop(tr, user, sftp_box)
        except Exception:  # noqa: BLE001 — per-connection isolation: a bad
            pass  # client must never take down the gateway
        finally:
            # abrupt disconnects must still release read handles (each
            # holds a namespace read lock until closed)
            if sftp_box[0] is not None:
                sftp_box[0].shutdown()
            try:
                sock.close()
            except OSError:
                pass

    def _userauth(self, tr: SSHTransport) -> str | None:
        t, r = tr.read_msg()
        if t != MSG_SERVICE_REQUEST or r.str_() != b"ssh-userauth":
            raise SSHError("expected ssh-userauth service request")
        tr.send_packet(bytes([MSG_SERVICE_ACCEPT]) + wstr("ssh-userauth"))
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric import ed25519

        from . import ssh as sshmod

        for _ in range(8):  # bounded attempts
            t, r = tr.read_msg()
            if t != MSG_USERAUTH_REQUEST:
                raise SSHError(f"expected USERAUTH_REQUEST, got {t}")
            user = r.str_().decode()
            r.str_()  # service
            method = r.str_()
            if method == b"password":
                r.bool_()
                password = r.str_().decode()
                if self._check_password(user, password):
                    tr.send_packet(bytes([MSG_USERAUTH_SUCCESS]))
                    return user
            elif method == b"publickey":
                has_sig = r.bool_()
                algo = r.str_()
                blob = r.str_()
                trusted = (
                    algo == b"ssh-ed25519"
                    and blob in self.authorized_keys.get(user, ())
                )
                if trusted and not has_sig:
                    # probe phase (RFC 4252 §7): tell the client this key
                    # would be accepted
                    tr.send_packet(
                        bytes([sshmod.MSG_USERAUTH_PK_OK]) + wstr(algo) + wstr(blob)
                    )
                    continue
                if trusted and has_sig:
                    sig_blob = r.str_()
                    sr = Reader(sig_blob)
                    try:
                        if sr.str_() != b"ssh-ed25519":
                            raise InvalidSignature
                        kr = Reader(blob)
                        if kr.str_() != b"ssh-ed25519":
                            raise InvalidSignature
                        pub = ed25519.Ed25519PublicKey.from_public_bytes(kr.str_())
                        pub.verify(
                            sr.str_(),
                            sshmod.publickey_auth_blob(
                                tr.session_id, user, algo, blob
                            ),
                        )
                        tr.send_packet(bytes([MSG_USERAUTH_SUCCESS]))
                        return user
                    except (InvalidSignature, SSHError, ValueError):
                        pass
            tr.send_packet(
                bytes([MSG_USERAUTH_FAILURE])
                + wstr(b"password,publickey") + b"\x00"
            )
        return None

    def _connection_loop(self, tr: SSHTransport, user: str, sftp_box: list) -> None:
        sftp: _SFTPSession | None = None
        chan_id = None
        peer_window = 0
        out_max = 32768

        def send_data(data: bytes) -> None:
            nonlocal peer_window
            # window handling: block-free best effort — standard clients
            # grant multi-MB windows up front
            for i in range(0, len(data), out_max):
                chunk = data[i : i + out_max]
                peer_window -= len(chunk)
                tr.send_packet(
                    bytes([MSG_CHANNEL_DATA]) + wu32(chan_id) + wstr(chunk)
                )

        consumed = 0
        while True:
            t, r = tr.read_msg()
            if t == MSG_CHANNEL_OPEN:
                ctype = r.str_()
                sender = r.u32()
                init_win = r.u32()
                r.u32()  # max packet
                if ctype != b"session" or chan_id is not None:
                    tr.send_packet(
                        bytes([MSG_CHANNEL_OPEN_FAILURE])
                        + wu32(sender) + wu32(4) + wstr("only one session") + wstr("")
                    )
                    continue
                chan_id = sender
                peer_window = init_win
                tr.send_packet(
                    bytes([MSG_CHANNEL_OPEN_CONFIRMATION])
                    + wu32(sender) + wu32(0) + wu32(1 << 30) + wu32(out_max)
                )
            elif t == MSG_CHANNEL_REQUEST:
                r.u32()
                rtype = r.str_()
                want_reply = r.bool_()
                ok = rtype == b"subsystem" and r.str_() == b"sftp"
                if ok:
                    sftp = _SFTPSession(self, user, send_data)
                    sftp_box[0] = sftp
                if want_reply:
                    tr.send_packet(
                        bytes([MSG_CHANNEL_SUCCESS if ok else MSG_CHANNEL_FAILURE])
                        + wu32(chan_id)
                    )
            elif t == MSG_CHANNEL_DATA:
                r.u32()
                data = r.str_()
                consumed += len(data)
                if sftp is not None:
                    sftp.feed(data)
                if consumed > 1 << 29:  # replenish our receive window
                    tr.send_packet(
                        bytes([MSG_CHANNEL_WINDOW_ADJUST]) + wu32(chan_id) + wu32(consumed)
                    )
                    consumed = 0
            elif t == MSG_CHANNEL_WINDOW_ADJUST:
                r.u32()
                peer_window += r.u32()
            elif t in (MSG_CHANNEL_EOF, MSG_CHANNEL_CLOSE):
                if sftp is not None:
                    sftp.shutdown()
                if t == MSG_CHANNEL_CLOSE:
                    tr.send_packet(bytes([MSG_CHANNEL_CLOSE]) + wu32(chan_id))
                    return
            else:
                pass  # ignore global requests etc.


class _SFTPSession:
    """SFTP v3 packet handler over one channel."""

    def __init__(self, gw: SFTPGateway, user: str, send):
        self.gw = gw
        self.user = user
        self.send = send
        self.buf = b""
        self.handles: dict[bytes, object] = {}
        self.hseq = 0

    # -- plumbing ----------------------------------------------------------

    def feed(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 4:
            n = struct.unpack(">I", self.buf[:4])[0]
            if len(self.buf) < 4 + n:
                return
            pkt = self.buf[4 : 4 + n]
            self.buf = self.buf[4 + n :]
            self._dispatch(pkt)

    def shutdown(self) -> None:
        for h in list(self.handles.values()):
            try:
                if hasattr(h, "close"):
                    h.close()
            except Exception:  # noqa: BLE001
                pass
        self.handles.clear()

    def _reply(self, payload: bytes) -> None:
        self.send(struct.pack(">I", len(payload)) + payload)

    def _status(self, rid: int, code: int, msg: str = "") -> None:
        self._reply(
            bytes([FXP_STATUS]) + wu32(rid) + wu32(code) + wstr(msg) + wstr("")
        )

    def _new_handle(self, obj) -> bytes:
        self.hseq += 1
        h = b"h%d" % self.hseq
        self.handles[h] = obj
        return h

    # -- path mapping ------------------------------------------------------

    @staticmethod
    def _norm(path: str) -> str:
        p = posixpath.normpath("/" + path.strip())
        return "/" if p in (".", "//") else p

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        parts = path.strip("/").split("/", 1)
        return (parts[0] if parts[0] else ""), (parts[1] if len(parts) > 1 else "")

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, pkt: bytes) -> None:
        t = pkt[0]
        r = Reader(pkt[1:])
        if t == FXP_INIT:
            self._reply(bytes([FXP_VERSION]) + wu32(3))
            return
        rid = r.u32()
        try:
            handler = {
                FXP_REALPATH: self._realpath,
                FXP_STAT: self._stat,
                FXP_LSTAT: self._stat,
                FXP_FSTAT: self._fstat,
                FXP_OPENDIR: self._opendir,
                FXP_READDIR: self._readdir,
                FXP_OPEN: self._open,
                FXP_CLOSE: self._close,
                FXP_READ: self._read,
                FXP_WRITE: self._write,
                FXP_REMOVE: self._remove,
                FXP_MKDIR: self._mkdir,
                FXP_RMDIR: self._rmdir,
                FXP_RENAME: self._rename,
                FXP_SETSTAT: self._setstat,
                FXP_FSETSTAT: self._fsetstat,
            }.get(t)
            if handler is None:
                self._status(rid, FX_OP_UNSUPPORTED, "unsupported")
                return
            handler(rid, r)
        except (quorum.ObjectNotFound, quorum.VersionNotFound, quorum.BucketNotFound):
            self._status(rid, FX_NO_SUCH_FILE, "not found")
        except PermissionError:
            self._status(rid, FX_PERMISSION_DENIED, "access denied")
        except Exception as e:  # noqa: BLE001 — protocol must answer
            self._status(rid, FX_FAILURE, str(e)[:200])

    def _authz(self, action: str, bucket: str, key: str = "") -> None:
        if not self.gw._allowed(self.user, action, bucket, key):
            raise PermissionError(action)

    # -- handlers ----------------------------------------------------------

    def _realpath(self, rid: int, r: Reader) -> None:
        p = self._norm(r.str_().decode())
        self._reply(
            bytes([FXP_NAME]) + wu32(rid) + wu32(1)
            + wstr(p) + wstr(p) + _attrs(is_dir=True)
        )

    def _stat(self, rid: int, r: Reader) -> None:
        p = self._norm(r.str_().decode())
        bucket, key = self._split(p)
        if not bucket:
            self._reply(bytes([FXP_ATTRS]) + wu32(rid) + _attrs(is_dir=True))
            return
        if not key:
            if not self.gw.store.bucket_exists(bucket):
                self._status(rid, FX_NO_SUCH_FILE, "no such bucket")
                return
            self._reply(bytes([FXP_ATTRS]) + wu32(rid) + _attrs(is_dir=True))
            return
        self._authz("s3:GetObject", bucket, key)
        try:
            oi = self.gw.store.get_object_info(bucket, key)
            self._reply(
                bytes([FXP_ATTRS]) + wu32(rid)
                + _attrs(oi.size, False, int(oi.mod_time / 1e9))
            )
            return
        except (quorum.ObjectNotFound, quorum.VersionNotFound):
            pass
        # a prefix with content is a directory
        res = self._list(bucket, key.rstrip("/") + "/", max_keys=1)
        if res.objects or res.prefixes:
            self._reply(bytes([FXP_ATTRS]) + wu32(rid) + _attrs(is_dir=True))
        else:
            self._status(rid, FX_NO_SUCH_FILE, "no such key")

    def _list(self, bucket: str, prefix: str, max_keys: int = 1000,
              delimiter: str = "/", marker: str = ""):
        return listing.list_objects(
            self.gw.store, bucket, prefix=prefix, marker=marker,
            delimiter=delimiter, max_keys=max_keys,
        )

    def _fstat(self, rid: int, r: Reader) -> None:
        h = self.handles.get(r.str_())
        if isinstance(h, _ReadHandle):
            self._reply(
                bytes([FXP_ATTRS]) + wu32(rid)
                + _attrs(h.oi.size, False, int(h.oi.mod_time / 1e9))
            )
        elif isinstance(h, _WriteHandle):
            self._reply(bytes([FXP_ATTRS]) + wu32(rid) + _attrs(h.size()))
        else:
            self._status(rid, FX_BAD_MESSAGE, "bad handle")

    def _opendir(self, rid: int, r: Reader) -> None:
        p = self._norm(r.str_().decode())
        bucket, key = self._split(p)
        entries: list[tuple[str, int, bool, int]] = []
        if not bucket:
            self._authz("s3:ListAllMyBuckets", "*")
            for b in self.gw.store.list_buckets():
                entries.append((b.name, 0, True, b.created // 10**9))
        else:
            self._authz("s3:ListBucket", bucket)
            prefix = key.rstrip("/") + "/" if key else ""
            marker = ""
            while len(entries) < 200_000:  # paginate; bound a runaway dir
                res = self._list(bucket, prefix, marker=marker)
                for o in res.objects:
                    name = o.name[len(prefix):]
                    if name:
                        entries.append((name, o.size, False, int(o.mod_time / 1e9)))
                for pfx in res.prefixes:
                    name = pfx[len(prefix):].rstrip("/")
                    if name:
                        entries.append((name, 0, True, 0))
                if not res.is_truncated:
                    break
                marker = res.next_marker
        self._reply(
            bytes([FXP_HANDLE]) + wu32(rid) + wstr(self._new_handle(_DirHandle(entries)))
        )

    def _readdir(self, rid: int, r: Reader) -> None:
        h = self.handles.get(r.str_())
        if not isinstance(h, _DirHandle):
            self._status(rid, FX_BAD_MESSAGE, "bad handle")
            return
        if h.pos >= len(h.entries):
            self._status(rid, FX_EOF)
            return
        batch = h.entries[h.pos : h.pos + 100]
        h.pos += len(batch)
        out = bytes([FXP_NAME]) + wu32(rid) + wu32(len(batch))
        for name, size, is_dir, mtime in batch:
            longname = "%s %12d %s" % ("drwxr-xr-x" if is_dir else "-rw-r--r--", size, name)
            out += wstr(name) + wstr(longname) + _attrs(size, is_dir, mtime)
        self._reply(out)

    def _open(self, rid: int, r: Reader) -> None:
        p = self._norm(r.str_().decode())
        flags = 0
        try:
            flags = r.u32()
            _skip_attrs(r)
        except (IndexError, SSHError):
            pass
        bucket, key = self._split(p)
        if not bucket or not key:
            self._status(rid, FX_FAILURE, "not a file path")
            return
        if flags & PF_WRITE:
            self._authz("s3:PutObject", bucket, key)
            initial = b""
            exists = False
            try:
                self.gw.store.get_object_info(bucket, key)
                exists = True
            except (quorum.ObjectNotFound, quorum.VersionNotFound):
                pass
            if exists and flags & PF_EXCL:
                self._status(rid, FX_FAILURE, "exists")
                return
            if exists and not flags & PF_TRUNC:
                # append/resume semantics: start from the current bytes,
                # otherwise offset writes would zero-fill the prefix
                self._authz("s3:GetObject", bucket, key)
                _, it = self.gw.store.get_object(bucket, key)
                initial = b"".join(it)
            self._reply(
                bytes([FXP_HANDLE]) + wu32(rid)
                + wstr(self._new_handle(_WriteHandle(bucket, key, initial)))
            )
            return
        self._authz("s3:GetObject", bucket, key)
        oi, handle = self.gw.store.open_object(bucket, key)
        self._reply(
            bytes([FXP_HANDLE]) + wu32(rid)
            + wstr(self._new_handle(_ReadHandle(oi, handle)))
        )

    def _close(self, rid: int, r: Reader) -> None:
        hid = r.str_()
        h = self.handles.pop(hid, None)
        if h is None:
            self._status(rid, FX_BAD_MESSAGE, "bad handle")
            return
        if isinstance(h, _WriteHandle):
            try:
                self.gw.server.put_standard_object(h.bucket, h.key, h.getvalue())
            finally:
                h.close()
        elif isinstance(h, _ReadHandle):
            h.close()
        self._status(rid, FX_OK)

    def _read(self, rid: int, r: Reader) -> None:
        h = self.handles.get(r.str_())
        off = r.u64()
        n = min(r.u32(), 1 << 20)
        if not isinstance(h, _ReadHandle):
            self._status(rid, FX_BAD_MESSAGE, "bad handle")
            return
        data = h.read(off, n)
        if not data:
            self._status(rid, FX_EOF)
        else:
            self._reply(bytes([FXP_DATA]) + wu32(rid) + wstr(data))

    def _write(self, rid: int, r: Reader) -> None:
        h = self.handles.get(r.str_())
        off = r.u64()
        data = r.str_()
        if not isinstance(h, _WriteHandle):
            self._status(rid, FX_BAD_MESSAGE, "bad handle")
            return
        if off + len(data) > 5 << 30:
            self._status(rid, FX_FAILURE, "too large for spooled write")
            return
        h.write(off, data)
        self._status(rid, FX_OK)

    def _remove(self, rid: int, r: Reader) -> None:
        bucket, key = self._split(self._norm(r.str_().decode()))
        if not bucket or not key:
            self._status(rid, FX_FAILURE, "not a file path")
            return
        self._authz("s3:DeleteObject", bucket, key)
        self.gw.store.get_object_info(bucket, key)  # 404 if absent
        self.gw.store.delete_object(bucket, key)
        self._status(rid, FX_OK)

    def _mkdir(self, rid: int, r: Reader) -> None:
        bucket, key = self._split(self._norm(r.str_().decode()))
        if not bucket:
            self._status(rid, FX_FAILURE, "mkdir /: invalid")
            return
        if not key:
            self._authz("s3:CreateBucket", bucket)
            self.gw.store.make_bucket(bucket)
        else:
            self._authz("s3:PutObject", bucket, key)
            self.gw.server.put_standard_object(
                bucket, listing.encode_dir_object(key.rstrip("/") + "/"), b""
            )
        self._status(rid, FX_OK)

    def _rmdir(self, rid: int, r: Reader) -> None:
        bucket, key = self._split(self._norm(r.str_().decode()))
        if not bucket:
            self._status(rid, FX_FAILURE, "rmdir /: invalid")
            return
        if not key:
            self._authz("s3:DeleteBucket", bucket)
            self.gw.store.delete_bucket(bucket)
        else:
            self._authz("s3:DeleteObject", bucket, key)
            try:
                self.gw.store.delete_object(
                    bucket, listing.encode_dir_object(key.rstrip("/") + "/")
                )
            except (quorum.ObjectNotFound, quorum.VersionNotFound):
                pass
        self._status(rid, FX_OK)

    def _rename(self, rid: int, r: Reader) -> None:
        src = self._split(self._norm(r.str_().decode()))
        dst = self._split(self._norm(r.str_().decode()))
        if not all([src[0], src[1], dst[0], dst[1]]):
            self._status(rid, FX_OP_UNSUPPORTED, "bucket rename unsupported")
            return
        self._authz("s3:GetObject", src[0], src[1])
        self._authz("s3:PutObject", dst[0], dst[1])
        self._authz("s3:DeleteObject", src[0], src[1])
        oi, it = self.gw.store.get_object(src[0], src[1])
        data = b"".join(it)
        self.gw.server.put_standard_object(dst[0], dst[1], data, dict(oi.user_defined))
        self.gw.store.delete_object(src[0], src[1])
        self._status(rid, FX_OK)

    def _setstat(self, rid: int, r: Reader) -> None:
        self._status(rid, FX_OK)  # chmod/utime have no object-store meaning

    def _fsetstat(self, rid: int, r: Reader) -> None:
        self._status(rid, FX_OK)
