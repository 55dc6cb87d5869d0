"""The port's admin API (``minio_tpu_torch/server/admin.py``) answers as
the JAX package's does.

The same scripted ``/minio/admin/v3/`` requests, signed as root with the
port's ``S3Client`` (madmin-encrypted bodies decrypted), go to the JAX
server and to the port's, each over four drives of its own in this
process. Statuses and JSON bodies must agree once the values that differ by
nature are masked: ids, times, process ids, drive paths and sizes, minted
keys. The sanitizer's status, whose values are each process's own, is
held to the reference's keys at the end.
"""

from __future__ import annotations

import json
import re

import pytest

from tests.test_torch_s3_api import PortServerThread

ENV = {"MINIO_TPU_BACKEND": "numpy", "MINIO_TPU_TORCH_DEVICE": "cpu", "MINIO_TPU_CACHE": "0",
       "MINIO_TPU_SCAN_INTERVAL": "0", "MINIO_COMPRESSION_ENABLE": "off"}
# values that differ between any two servers, whatever their code; the
# fault counters, the dispatcher's stats and the named dynamic timeouts are
# process-wide, so they carry what earlier tests in this process did (a
# test of the reference's qos registers a timeout of its own there)
MASK_KEYS = {"counters", "dispatcher", "dynamicTimeouts", "deploymentID", "uptime", "pid", "time", "accessKey", "secretKey",
             "sessionToken", "expiration", "total", "free", "used", "usedInodes",
             "freeInodes", "startedAt", "lastScan", "lastHeal", "id", "lastUpdate",
             "updatedAt", "createdAt", "queuedAt", "elapsedS", "avgMs", "ewmaMs",
             "usedPct"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from tests.test_s3_api import ServerThread

    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        base = tmp_path_factory.mktemp("admin")
        ref = ServerThread([str(base / f"r{i}") for i in range(4)])
        port = PortServerThread([str(base / f"p{i}") for i in range(4)])
        try:
            yield {"ref": (ref, str(base / "r")), "port": (port, str(base / "p"))}
        finally:
            ref.stop()
            port.stop()


def _mask(v, root: str):
    if isinstance(v, dict):
        return {k: "*" if k in MASK_KEYS else _mask(x, root) for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x, root) for x in v]
    if isinstance(v, str):
        return re.sub(re.escape(root) + r"(\d)", r"<drive\1>", v)
    return v


def _norm(r, root: str):
    body = r.body
    try:
        body = _mask(json.loads(body), root) if body else body
    except ValueError:
        body = re.sub(rb"<RequestId>[^<]*</RequestId>", b"", body)
    return r.status, body


POLICY = {"Version": "2012-10-17",
          "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"],
                         "Resource": ["arn:aws:s3:::adm/*"]}]}


def _script(cli):
    """(name, response) of each step; the same steps on either server."""
    a = cli.admin
    steps = [
        ("info", a("GET", "info")),
        ("storageinfo", a("GET", "storageinfo")),
        ("make-bucket", cli.make_bucket("adm")),
        ("put", cli.put_object("adm", "k1", b"x" * 5000)),
        ("add-user", a("PUT", "add-user", {"accessKey": "alice"},
                       {"secretKey": "alice-secret-1", "status": "enabled"})),
        ("list-users", a("GET", "list-users")),
        ("set-user-status", a("PUT", "set-user-status",
                              {"accessKey": "alice", "status": "disabled"})),
        ("add-policy", a("PUT", "add-canned-policy", {"name": "adm-read"}, POLICY)),
        ("list-policies", a("GET", "list-canned-policies")),
        ("info-policy", a("GET", "info-canned-policy", {"name": "adm-read"})),
        ("attach", a("PUT", "set-user-or-group-policy",
                     {"policyName": "adm-read", "userOrGroup": "alice", "isGroup": "false"})),
        ("group-add", a("PUT", "update-group-members", None,
                        {"group": "readers", "members": ["alice"], "isRemove": False})),
        ("groups", a("GET", "groups")),
        ("group", a("GET", "group", {"group": "readers"})),
        ("svcacct", a("PUT", "add-service-account", None, {"parentUser": "alice"})),
        ("list-svcaccts", a("GET", "list-service-accounts", {"user": "alice"})),
        ("quota-set", a("PUT", "set-bucket-quota", {"bucket": "adm"},
                        {"quota": 1 << 30, "quotatype": "hard"})),
        ("quota-get", a("GET", "get-bucket-quota", {"bucket": "adm"})),
        ("fault-inject", a("POST", "fault/inject", None,
                           {"boundary": "storage", "mode": "error", "target": "nothing-matches",
                            "op": "read_file", "count": 1})),
        ("fault-status", a("GET", "fault/status")),
        ("fault-clear", a("POST", "fault/clear")),
        ("placement-set", a("POST", "placement/set", None,
                            {"bucket": "adm", "prefix": "p/", "mode": "pin", "pools": [0]})),
        ("placement-get", a("GET", "placement/get")),
        ("placement-delete", a("POST", "placement/delete", None,
                               {"bucket": "adm", "prefix": "p/"})),
        ("pools-list", a("GET", "pools/list")),
        ("config-set", a("PUT", "set-config-kv", None,
                         {"subsys": "api", "key": "requests_max", "value": "77"})),
        ("config-get", a("GET", "get-config")),
        ("heal-bucket", a("POST", "heal/adm")),
        ("heal-prefix", a("POST", "heal/adm/k")),
        ("inspect-missing-arg", a("GET", "inspect-data", {"bucket": "adm"})),
        ("remove-from-group", a("PUT", "update-group-members", None,
                                {"group": "readers", "members": ["alice"], "isRemove": True})),
        ("remove-policy", a("DELETE", "remove-canned-policy", {"name": "adm-read"})),
        ("remove-user", a("DELETE", "remove-user", {"accessKey": "alice"})),
        ("list-users-after", a("GET", "list-users")),
        ("unknown-op", a("GET", "no-such-op")),
        ("rebalance-status-wrong-method", a("POST", "pools/rebalance/status")),
    ]
    from minio_tpu_torch.client import S3Client

    stranger = S3Client(f"{cli.host}:{cli.port}", access_key="nobody", secret_key="nothing")
    steps.append(("unsigned-user", stranger.admin("GET", "info")))
    return steps


def test_admin_answers_like_the_reference(servers):
    from minio_tpu_torch.client import S3Client

    got = {}
    for name, (st, root) in servers.items():
        cli = S3Client(f"127.0.0.1:{st.port}")
        got[name] = [(step, _norm(r, root)) for step, r in _script(cli)]
    assert [s for s, _ in got["port"]] == [s for s, _ in got["ref"]]
    for (step, ref), (_, port) in zip(got["ref"], got["port"]):
        assert port == ref, step


@pytest.mark.parametrize("op", ["info", "storageinfo", "datausageinfo", "background-heal/status",
                                "scanner/status", "inflight-requests", "top/locks",
                                "cache/status", "placement/status", "list-jobs",
                                "site-replication/info"])
def test_admin_status_documents_have_the_reference_shape(servers, op):
    """Documents whose values move with time or load: the same status and
    the same keys two levels down (deeper, keys name the requests of the
    last minute, which differ run to run)."""
    from minio_tpu_torch.client import S3Client

    def shape(v, depth=0):
        if isinstance(v, dict):
            return {k: "*" if k in MASK_KEYS else shape(x, depth + 1)
                    for k, x in v.items()} if depth < 2 else "dict"
        if isinstance(v, list):
            return "list"
        return "number" if isinstance(v, (int, float)) and not isinstance(v, bool) else (
            type(v).__name__)

    out = {}
    for name, (st, _) in servers.items():
        r = S3Client(f"127.0.0.1:{st.port}").admin("GET", op)
        out[name] = (r.status, shape(json.loads(r.body)) if r.status == 200 else r.body[:60])
    assert out["port"] == out["ref"]


def test_sanitizer_status_is_refused_by_name(servers):
    """Refused by name until analysis/ came; now answered as the
    reference answers: 200 and the same keys (the values are each
    process's witnesses: this process installed the reference's)."""
    from minio_tpu_torch.client import S3Client

    got = {}
    for name, (st, _) in servers.items():
        r = S3Client(f"127.0.0.1:{st.port}").admin("GET", "sanitizer/status")
        assert r.status == 200, (name, r.body)
        got[name] = json.loads(r.body)
    assert set(got["port"]) == set(got["ref"])
    assert got["port"]["enabled"] == got["ref"]["enabled"]
    assert isinstance(got["port"]["violations"], dict)
    for key in ("witnessedAttrs", "leakClasses", "recent"):
        assert isinstance(got["port"][key], list), key
