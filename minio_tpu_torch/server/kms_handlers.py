"""KMS API plane: /minio/kms/v1/* — key lifecycle over the configured
backend (builtin keyring or KES).

Mirrors MinIO cmd/kms-router.go + kms-handlers.go: status,
metrics, apis, version, key/create, key/list, key/status, plus
key/delete and key/import (the madmin key-management surface,
MinIO cmd/admin-handlers.go KMSCreateKey/KMSKeyStatus lineage).
Every route is admin-authenticated and per-key authorized (the
reference's checkKMSActionAllowed: policy action + key-id resource).
"""

from __future__ import annotations

import base64
import json
import re

from . import web

from ..crypto.sse import CryptoError
from . import s3err

_KEY_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,79}$")
_PATTERN_RE = re.compile(r"^[A-Za-z0-9_.*?-]{1,80}$")


def _allowed(server, ak: str, action: str, resource: str = "") -> None:
    if not ak or not server.iam.is_allowed(ak, action, resource):
        raise s3err.AccessDenied


def _check_key_name(name: str) -> None:
    """Key names interpolate into backend URLs (KES paths): constrain the
    charset centrally so no backend ever sees path metacharacters."""
    if not _KEY_NAME_RE.match(name):
        raise s3err.InvalidArgument


def _json_resp(payload, status: int = 200) -> web.Response:
    return web.Response(
        body=json.dumps(payload).encode(), status=status,
        content_type="application/json",
    )


async def handle_kms(server, request: web.Request, ak: str, sub: str,
                     body: bytes) -> web.Response:
    """Dispatch /minio/kms/<sub> (sub includes the version prefix)."""
    q = request.rel_url.query
    m = request.method
    # strip the API version ("v1/...") like the reference's kmsAPIVersionPrefix
    parts = sub.split("/", 1)
    op = parts[1] if len(parts) == 2 else ""

    if op == "status" and m == "GET":
        _allowed(server, ak, "kms:Status")
        try:
            # io-pool: KES/MinKMS status probes remote endpoints and must
            # never block the event loop
            return _json_resp(await server._run(server.kms.status))
        except CryptoError as e:
            return _json_resp(
                {"message": str(e), "apiCode": e.api_code}, status=e.status
            )
    if op == "metrics" and m == "GET":
        _allowed(server, ak, "kms:Metrics")
        return _json_resp(server.kms.kms_metrics())
    if op == "apis" and m == "GET":
        _allowed(server, ak, "kms:API")
        return _json_resp([
            {"method": "GET", "path": "/v1/status"},
            {"method": "GET", "path": "/v1/metrics"},
            {"method": "GET", "path": "/v1/apis"},
            {"method": "GET", "path": "/v1/version"},
            {"method": "POST", "path": "/v1/key/create"},
            {"method": "POST", "path": "/v1/key/import"},
            {"method": "GET", "path": "/v1/key/list"},
            {"method": "GET", "path": "/v1/key/status"},
            {"method": "DELETE", "path": "/v1/key/delete"},
        ])
    if op == "version" and m == "GET":
        _allowed(server, ak, "kms:Version")
        return _json_resp({"version": "v1"})

    key_id = q.get("key-id", "")
    try:
        if op == "key/create" and m == "POST":
            _allowed(server, ak, "kms:CreateKey", key_id)
            if not key_id:
                raise s3err.InvalidArgument
            _check_key_name(key_id)
            await server._run(server.kms.create_key, key_id)
            return web.Response(status=200)
        if op == "key/import" and m == "POST":
            _allowed(server, ak, "kms:ImportKey", key_id)
            if not key_id:
                raise s3err.InvalidArgument
            _check_key_name(key_id)
            try:
                material = base64.b64decode(
                    json.loads(body.decode() or "{}").get("bytes", ""),
                    validate=True,
                )
            except (ValueError, UnicodeDecodeError):
                raise s3err.InvalidArgument from None
            await server._run(server.kms.create_key, key_id, material)
            return web.Response(status=200)
        if op == "key/list" and m == "GET":
            _allowed(server, ak, "kms:ListKeys")
            pattern = q.get("pattern", "*") or "*"
            if not _PATTERN_RE.match(pattern):
                raise s3err.InvalidArgument
            names = await server._run(server.kms.list_keys, pattern)
            return _json_resp([{"name": n} for n in names])
        if op == "key/status" and m == "GET":
            _allowed(server, ak, "kms:KeyStatus", key_id)
            if not key_id:
                key_id = server.kms.key_id  # default key, like the reference
            _check_key_name(key_id)
            return _json_resp(await server._run(server.kms.key_status, key_id))
        if op == "key/delete" and m == "DELETE":
            _allowed(server, ak, "kms:DeleteKey", key_id)
            if not key_id:
                raise s3err.InvalidArgument
            _check_key_name(key_id)
            await server._run(server.kms.delete_key, key_id)
            return web.Response(status=200)
    except CryptoError as e:
        # typed mapping: every CryptoError subclass carries its HTTP
        # status + API code (reference internal/kms/errors.go Error)
        return _json_resp(
            {"message": str(e), "apiCode": e.api_code}, status=e.status
        )
    raise s3err.NotImplemented_
