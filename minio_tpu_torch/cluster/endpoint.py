"""Endpoint topology: parse server args into local/remote drive endpoints.

Mirrors MinIO cmd/endpoint.go: an endpoint is either a local
path or http(s)://host:port/path; every node gets the identical argument
list and derives which endpoints are its own from its --address.
"""

from __future__ import annotations

import socket
import urllib.parse
from dataclasses import dataclass

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1", ""}


def _is_local_host(host: str, port: int, my_port: int) -> bool:
    if port != my_port:
        return False
    if host in _LOCAL_NAMES:
        return True
    try:
        return host == socket.gethostname() or socket.gethostbyname(host) in (
            "127.0.0.1",
            socket.gethostbyname(socket.gethostname()),
        )
    except OSError:
        return False


@dataclass(frozen=True)
class Endpoint:
    url: str  # original spec
    host: str  # "" for pure path endpoints
    port: int  # 0 for pure path endpoints
    path: str
    is_local: bool

    @property
    def node(self) -> str:
        return f"{self.host}:{self.port}" if self.host else "local"

    def __str__(self) -> str:
        return self.url


def parse_endpoint(spec: str, my_port: int) -> Endpoint:
    if spec.startswith(("http://", "https://")):
        u = urllib.parse.urlsplit(spec)
        host = u.hostname or ""
        port = u.port or 9000
        path = u.path  # keep absolute: it's a filesystem path on that node
        return Endpoint(
            spec, host, port, path, _is_local_host(host, port, my_port)
        )
    return Endpoint(spec, "", 0, spec, True)


def parse_endpoints(specs: list[str], my_port: int) -> list[Endpoint]:
    return [parse_endpoint(s, my_port) for s in specs]


def remote_nodes(endpoints: list[Endpoint]) -> list[str]:
    """Distinct host:port of peers (non-local endpoints)."""
    seen = []
    for e in endpoints:
        if not e.is_local and e.node not in seen:
            seen.append(e.node)
    return seen
