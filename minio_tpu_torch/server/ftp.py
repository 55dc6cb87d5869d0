"""FTP gateway — the protocol frontend over the object layer.

Mirrors MinIO's FTP server (cmd/ftp-server.go, which drives the
ObjectLayer directly): buckets appear as top-level directories, objects
as files. Auth checks IAM credentials; operations run through the same
store the S3 API uses (store calls on the server's I/O pool, never on the
loop), so policies on the underlying identities still govern data access
and a STOR encodes through the dispatcher like an S3 PUT. Implements the
command subset real clients use: USER/PASS, SYST, PWD, CWD/CDUP, TYPE,
PASV/EPSV, LIST/NLST, RETR, STOR, DELE, MKD, RMD, SIZE, QUIT.

Enable with --ftp <port> on the server CLI (or FTPGateway(server).serve).
"""

from __future__ import annotations

import asyncio
import posixpath

from ..erasure import listing, quorum


class _Session:
    def __init__(self, gw, reader, writer):
        self.gw = gw
        self.reader = reader
        self.writer = writer
        self.user = ""
        self.authed = False
        self.cwd = "/"
        self._pasv_server: asyncio.AbstractServer | None = None
        self._data_ready: asyncio.Future | None = None

    async def send(self, line: str) -> None:
        self.writer.write((line + "\r\n").encode())
        await self.writer.drain()

    # -- path helpers ------------------------------------------------------

    def _resolve(self, arg: str) -> str:
        p = arg if arg.startswith("/") else posixpath.join(self.cwd, arg)
        p = posixpath.normpath(p)
        return "/" if p == "." else p

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        parts = path.strip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
        return bucket, key

    # -- data connection ---------------------------------------------------

    async def open_pasv(self) -> tuple[str, int]:
        await self.close_pasv()
        loop = asyncio.get_running_loop()
        self._data_ready = loop.create_future()

        def on_connect(r, w):
            if self._data_ready and not self._data_ready.done():
                self._data_ready.set_result((r, w))
            else:
                w.close()

        # bind wide, advertise the address the CLIENT already reached us on
        # (advertising 127.0.0.1 would break every remote client)
        self._pasv_server = await asyncio.start_server(
            on_connect, host="0.0.0.0", port=0
        )
        port = self._pasv_server.sockets[0].getsockname()[1]
        local = self.writer.get_extra_info("sockname")
        host = local[0] if local else "127.0.0.1"
        return host, port

    async def data_conn(self):
        if self._data_ready is None:
            return None
        return await asyncio.wait_for(self._data_ready, timeout=15)

    async def close_pasv(self) -> None:
        if self._pasv_server is not None:
            self._pasv_server.close()
            self._pasv_server = None
        self._data_ready = None


class FTPGateway:
    def __init__(self, server):
        self.server = server  # S3Server: store + iam

    @property
    def store(self):
        return self.server.store

    async def serve(self, host: str, port: int) -> asyncio.AbstractServer:
        return await asyncio.start_server(self._handle, host=host, port=port)

    async def _run(self, fn, *a, **kw):
        # the shared I/O pool: store calls must never ride the tiny default
        # executor (see the deadlock-by-pool note in app.py)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self.server._io_pool, lambda: fn(*a, **kw)
        )

    def _allowed(self, s: "_Session", action: str, bucket: str, key: str = "") -> bool:
        """IAM enforcement: FTP identities obey the same policies as S3."""
        from . import s3err

        try:
            self.server._authorize(s.user, action, bucket, key)
            return True
        except s3err.APIError:
            return False

    async def _handle(self, reader, writer) -> None:
        s = _Session(self, reader, writer)
        await s.send("220 minio-tpu FTP gateway ready")
        try:
            while True:
                raw = await reader.readline()
                if not raw:
                    break
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                cmd, _, arg = line.partition(" ")
                cmd = cmd.upper()
                if cmd == "QUIT":
                    await s.send("221 Bye")
                    break
                handler = getattr(self, f"_cmd_{cmd.lower()}", None)
                if handler is None:
                    await s.send("502 Command not implemented")
                    continue
                if cmd not in ("USER", "PASS", "SYST", "FEAT") and not s.authed:
                    await s.send("530 Not logged in")
                    continue
                await handler(s, arg)
        except (ConnectionResetError, asyncio.TimeoutError):
            pass
        finally:
            await s.close_pasv()
            writer.close()

    # -- auth --------------------------------------------------------------

    async def _cmd_user(self, s, arg):
        s.user = arg.strip()
        await s.send("331 Password required")

    async def _cmd_pass(self, s, arg):
        import hmac as _hmac

        secret = self.server.iam.lookup_secret(s.user)
        if secret is not None and _hmac.compare_digest(secret, arg.strip()):
            s.authed = True
            await s.send("230 Login successful")
        else:
            await s.send("530 Login incorrect")

    async def _cmd_syst(self, s, arg):
        await s.send("215 UNIX Type: L8")

    async def _cmd_feat(self, s, arg):
        await s.send("211-Features:")
        await s.send(" EPSV")
        await s.send(" SIZE")
        await s.send("211 End")

    async def _cmd_type(self, s, arg):
        await s.send("200 Type set")

    # -- navigation --------------------------------------------------------

    async def _cmd_pwd(self, s, arg):
        await s.send(f'257 "{s.cwd}" is the current directory')

    async def _cmd_cwd(self, s, arg):
        path = s._resolve(arg)
        bucket, key = s._split(path)
        if path == "/" or (
            bucket
            and await self._run(self.store.bucket_exists, bucket)
        ):
            s.cwd = path
            await s.send("250 Directory changed")
        else:
            await s.send("550 No such directory")

    async def _cmd_cdup(self, s, arg):
        s.cwd = posixpath.dirname(s.cwd.rstrip("/")) or "/"
        await s.send("250 Directory changed")

    # -- passive mode ------------------------------------------------------

    async def _cmd_pasv(self, s, arg):
        host, port = await s.open_pasv()
        h = host.replace(".", ",")
        await s.send(f"227 Entering Passive Mode ({h},{port >> 8},{port & 0xFF})")

    async def _cmd_epsv(self, s, arg):
        _, port = await s.open_pasv()
        await s.send(f"229 Entering Extended Passive Mode (|||{port}|)")

    # -- listing -----------------------------------------------------------

    async def _cmd_list(self, s, arg):
        await self._list(s, arg, long=True)

    async def _cmd_nlst(self, s, arg):
        await self._list(s, arg, long=False)

    async def _list(self, s, arg, long: bool) -> None:
        path = s._resolve(arg) if arg and not arg.startswith("-") else s.cwd
        bucket, key = s._split(path)
        action = "s3:ListBucket" if bucket else "s3:ListAllMyBuckets"
        if not self._allowed(s, action, bucket):
            await s.send("550 Permission denied")
            return
        lines = []
        try:
            if not bucket:
                for b in await self._run(self.store.list_buckets):
                    lines.append(_ls_line(b.name, 0, True) if long else b.name)
            else:
                prefix = key + "/" if key else ""
                res = await self._run(
                    listing.list_objects, self.store, bucket, prefix, "", "/", 1000
                )
                for p in res.prefixes:
                    name = p[len(prefix):].rstrip("/")
                    lines.append(_ls_line(name, 0, True) if long else name)
                for o in res.objects:
                    name = o.name[len(prefix):]
                    lines.append(_ls_line(name, o.size, False) if long else name)
        except quorum.BucketNotFound:
            await s.send("550 No such directory")
            return
        await s.send("150 Here comes the directory listing")
        conn = await s.data_conn()
        if conn is None:
            await s.send("425 Use PASV first")
            return
        _, w = conn
        w.write(("".join(line + "\r\n" for line in lines)).encode())
        await w.drain()
        w.close()
        await s.close_pasv()
        await s.send("226 Directory send OK")

    # -- files -------------------------------------------------------------

    async def _cmd_size(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        if not self._allowed(s, "s3:GetObject", bucket, key):
            await s.send("550 Permission denied")
            return
        try:
            oi = await self._run(self.store.get_object_info, bucket, key)
            await s.send(f"213 {oi.size}")
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 No such file")

    async def _cmd_retr(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        if not self._allowed(s, "s3:GetObject", bucket, key):
            await s.send("550 Permission denied")
            return
        try:
            oi, handle = await self._run(self.store.open_object, bucket, key)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 No such file")
            return
        try:
            await s.send("150 Opening data connection")
            try:
                conn = await s.data_conn()
            except asyncio.TimeoutError:
                conn = None
            if conn is None:
                await s.send("425 Use PASV first")
                return
            _, w = conn
            it = handle.read()
            loop = asyncio.get_running_loop()
            sentinel = object()
            while True:
                chunk = await loop.run_in_executor(
                    self.server._io_pool, lambda: next(it, sentinel)
                )
                if chunk is sentinel:
                    break
                w.write(chunk)
                await w.drain()
            w.close()
            await s.close_pasv()
            await s.send("226 Transfer complete")
        finally:
            # never-started read generators skip their finally on GC; the
            # explicit close releases the namespace read lock immediately
            handle.close()

    MAX_STOR = 1 << 30  # same bound as the S3 PUT body limit

    async def _cmd_stor(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        if not bucket or not key:
            await s.send("553 Bad path")
            return
        if not self._allowed(s, "s3:PutObject", bucket, key):
            await s.send("550 Permission denied")
            return
        await s.send("150 Ok to send data")
        try:
            conn = await s.data_conn()
        except asyncio.TimeoutError:
            conn = None
        if conn is None:
            await s.send("425 Use PASV first")
            return
        r, w = conn
        chunks: list[bytes] = []
        total = 0
        while True:
            chunk = await r.read(1 << 20)
            if not chunk:
                break
            total += len(chunk)
            if total > self.MAX_STOR:
                w.close()
                await s.close_pasv()
                await s.send("552 Exceeded storage allocation")
                return
            chunks.append(chunk)
        w.close()
        await s.close_pasv()
        try:
            await self._run(
                self.server.put_standard_object, bucket, key, b"".join(chunks)
            )
            await s.send("226 Transfer complete")
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 Store failed")

    async def _cmd_dele(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        if not self._allowed(s, "s3:DeleteObject", bucket, key):
            await s.send("550 Permission denied")
            return
        try:
            await self._run(self.store.delete_object, bucket, key)
            await s.send("250 Deleted")
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 No such file")

    async def _cmd_mkd(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        action = "s3:PutObject" if key else "s3:CreateBucket"
        if not self._allowed(s, action, bucket, key):
            await s.send("550 Permission denied")
            return
        try:
            if key:
                await self._run(
                    self.server.put_standard_object, bucket,
                    listing.encode_dir_object(key + "/"), b"",
                )
            else:
                await self._run(self.store.make_bucket, bucket)
            await s.send("257 Created")
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 Create failed")

    async def _cmd_rmd(self, s, arg):
        bucket, key = s._split(s._resolve(arg))
        action = "s3:DeleteObject" if key else "s3:DeleteBucket"
        if not self._allowed(s, action, bucket, key):
            await s.send("550 Permission denied")
            return
        try:
            if key:
                await self._run(
                    self.store.delete_object, bucket,
                    listing.encode_dir_object(key + "/"),
                )
            else:
                await self._run(self.store.delete_bucket, bucket)
            await s.send("250 Removed")
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            await s.send("550 Remove failed")


def _ls_line(name: str, size: int, is_dir: bool) -> str:
    kind = "d" if is_dir else "-"
    return f"{kind}rw-r--r-- 1 minio minio {size:>12} Jan  1 00:00 {name}"
