"""TLS configuration: certs-dir loading, hot reload, process-global state.

The reference terminates HTTPS via a certs directory (public.crt /
private.key, extra CAs under CAs/) with hot reload on file change
(MinIO cmd/common-main.go:942 getTLSConfig,
MinIO internal/certs/certs.go), and uses the same material for
internode TLS.  This module is the equivalent here: one
CertManager owns a single ssl.SSLContext whose cert chain is re-loaded
in place when the files on disk change, so new handshakes pick up
rotated certificates without a restart and without the listener ever
being rebound.

A process-global TLSState mirrors the reference's globalIsTLS: internode
clients (storage REST, lock plane, grid websocket, bootstrap verify) ask
this module for their client-side context instead of threading TLS
config through every constructor.
"""

from __future__ import annotations

import os
import ssl
import threading
import time

CERT_FILE = "public.crt"
KEY_FILE = "private.key"
CA_DIR = "CAs"


def _cert_mtimes(certs_dir: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for name in (CERT_FILE, KEY_FILE):
        p = os.path.join(certs_dir, name)
        try:
            out[name] = os.stat(p).st_mtime
        except OSError:
            pass
    ca_dir = os.path.join(certs_dir, CA_DIR)
    if os.path.isdir(ca_dir):
        for f in sorted(os.listdir(ca_dir)):
            p = os.path.join(ca_dir, f)
            try:
                out[f"{CA_DIR}/{f}"] = os.stat(p).st_mtime
            except OSError:
                pass
    return out


class CertManager:
    """Owns the server-side SSLContext for one certs directory.

    Hot reload: `maybe_reload()` stats the cert files (rate-limited) and,
    when mtimes moved, calls load_cert_chain() on the EXISTING context —
    in-flight connections keep their session, new handshakes get the new
    certificate.  This is the same observable behavior as the reference's
    certs.Manager file-watcher without needing inotify.
    """

    def __init__(self, certs_dir: str, require_client_certs: bool = False):
        self.certs_dir = certs_dir
        self.cert_path = os.path.join(certs_dir, CERT_FILE)
        self.key_path = os.path.join(certs_dir, KEY_FILE)
        self._lock = threading.Lock()
        self._mtimes = _cert_mtimes(certs_dir)
        self._last_check = 0.0
        self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self.ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        self.ctx.load_cert_chain(self.cert_path, self.key_path)
        self._load_client_cas()
        if require_client_certs:
            self.ctx.verify_mode = ssl.CERT_REQUIRED
        else:
            # accept (and verify) a client certificate when one is offered
            # — required for AssumeRoleWithCertificate — but don't demand
            # one from ordinary S3 clients or internode peers
            self.ctx.verify_mode = ssl.CERT_OPTIONAL

    def _load_client_cas(self) -> None:
        ca_dir = os.path.join(self.certs_dir, CA_DIR)
        loaded = False
        if os.path.isdir(ca_dir):
            for f in sorted(os.listdir(ca_dir)):
                p = os.path.join(ca_dir, f)
                if os.path.isfile(p):
                    try:
                        self.ctx.load_verify_locations(cafile=p)
                        loaded = True
                    except ssl.SSLError:
                        pass  # non-PEM junk in CAs/ is skipped, not fatal
        if not loaded:
            # self-signed single-cert deployments: trust our own cert so
            # optional client-cert verification has a root to chain to
            try:
                self.ctx.load_verify_locations(cafile=self.cert_path)
            except ssl.SSLError:
                pass

    def maybe_reload(self, min_interval: float = 1.0) -> bool:
        """Reload the cert chain if files changed. Returns True on reload."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_check < min_interval:
                return False
            self._last_check = now
            current = _cert_mtimes(self.certs_dir)
            if current == self._mtimes:
                return False
            self._mtimes = current
            try:
                self.ctx.load_cert_chain(self.cert_path, self.key_path)
                self._load_client_cas()
                return True
            except (OSError, ssl.SSLError):
                return False  # half-written rotation: keep serving old cert


class TLSState:
    """Process-global TLS posture (the reference's globalIsTLS +
    globalRootCAs): enabled flag, the server CertManager, and the shared
    client-side context internode dialers use."""

    def __init__(self):
        self.enabled = False
        self.manager: CertManager | None = None
        self.certs_dir = ""
        self._client_ctx: ssl.SSLContext | None = None

    def client_context(self) -> ssl.SSLContext | None:
        return self._client_ctx if self.enabled else None

    def enable(self, certs_dir: str) -> CertManager:
        self.manager = CertManager(certs_dir)
        self.certs_dir = certs_dir
        self._build_client_context()
        self.enabled = True
        return self.manager

    def refresh_client_context(self) -> None:
        """Rebuild the internode client trust after a cert rotation —
        deployments anchored on the shared public.crt (no CAs/) would
        otherwise keep dialing peers with the pre-rotation trust until
        restart. Existing connections are untouched; new dials (and every
        reconnect) pick up the fresh context."""
        if self.enabled:
            self._build_client_context()

    def _build_client_context(self) -> None:
        certs_dir = self.certs_dir
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_default_certs()
        ca_dir = os.path.join(certs_dir, CA_DIR)
        if os.path.isdir(ca_dir):
            for f in sorted(os.listdir(ca_dir)):
                p = os.path.join(ca_dir, f)
                if os.path.isfile(p):
                    try:
                        ctx.load_verify_locations(cafile=p)
                    except ssl.SSLError:
                        pass
        # trust our own serving cert: symmetric nodes share a certs dir (or
        # an identically-issued cert), so internode dialing verifies against
        # it even with no CAs/ populated
        try:
            ctx.load_verify_locations(
                cafile=os.path.join(certs_dir, CERT_FILE)
            )
        except ssl.SSLError:
            pass
        self._client_ctx = ctx

    def disable(self) -> None:
        self.enabled = False
        self.manager = None
        self._client_ctx = None


GLOBAL = TLSState()


def tls_enabled() -> bool:
    return GLOBAL.enabled


def scheme() -> str:
    return "https" if GLOBAL.enabled else "http"


def http_connection(host: str, port: int, timeout: float = 30.0):
    """HTTP(S)Connection per the global TLS posture — the one chokepoint
    every internode dialer (storage REST, locks, bootstrap) goes through."""
    import http.client

    ctx = GLOBAL.client_context()
    if ctx is not None:
        return http.client.HTTPSConnection(
            host, port, timeout=timeout, context=ctx
        )
    return http.client.HTTPConnection(host, port, timeout=timeout)


def wrap_client_socket(sock, host: str):
    """TLS-wrap a raw client socket (grid websocket dialer) when enabled."""
    ctx = GLOBAL.client_context()
    if ctx is None:
        return sock
    return ctx.wrap_socket(sock, server_hostname=host)
