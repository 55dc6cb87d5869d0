"""TLS end to end on the port's server: an https listener from a
certs-dir, internode TLS (storage REST, lock and grid planes over a 2-node
cluster), presigned URLs over https, certificate hot reload and mTLS
AssumeRoleWithCertificate: the cases of ``tests/test_tls.py`` against
``python -m minio_tpu_torch.server`` nodes on the CPU. None is left out.
"""

import http.client
import json
import os

import ssl
import time
import urllib.parse
import urllib.request

import pytest

from minio_tpu_torch.client import S3Client
pytest.importorskip("cryptography")  # x509util needs it; skip, don't abort collection
from minio_tpu_torch.crypto import x509util
from tests.test_s3_api import _free_port
from minio_tpu_torch.server.nodes import spawn, stop_all, tail, wait_online
from tests.test_torch_cluster import node_env


def _write_certs(certs_dir, ca_pem, cert_pem, key_pem):
    os.makedirs(os.path.join(certs_dir, "CAs"), exist_ok=True)
    with open(os.path.join(certs_dir, "public.crt"), "wb") as f:
        f.write(cert_pem)
    with open(os.path.join(certs_dir, "private.key"), "wb") as f:
        f.write(key_pem)
    with open(os.path.join(certs_dir, "CAs", "ca.crt"), "wb") as f:
        f.write(ca_pem)


@pytest.fixture(scope="module")
def tls_cluster(tmp_path_factory):
    """Two server processes sharing one erasure set, serving https with a
    test-CA-issued cert; internode traffic (storage REST, locks, grid)
    rides the same TLS material."""
    base = tmp_path_factory.mktemp("tlsdist")
    certs = str(base / "certs")
    ca_pem, ca_key, ca_cert = x509util.generate_ca()
    cert_pem, key_pem = x509util.issue_cert(
        ca_key, ca_cert, "localhost", sans=["127.0.0.1", "localhost"]
    )
    _write_certs(certs, ca_pem, cert_pem, key_pem)
    client_pem, client_key = x509util.issue_cert(
        ca_key, ca_cert, "cert-rw", client=True
    )
    with open(base / "client.crt", "wb") as f:
        f.write(client_pem)
    with open(base / "client.key", "wb") as f:
        f.write(client_key)

    p1, p2 = _free_port(), _free_port()
    specs = [
        f"http://127.0.0.1:{p1}{base}/n1/d1",
        f"http://127.0.0.1:{p1}{base}/n1/d2",
        f"http://127.0.0.1:{p2}{base}/n2/d1",
        f"http://127.0.0.1:{p2}{base}/n2/d2",
    ]

    env = node_env(MINIO_TPU_CERTS_DIR=certs, MINIO_IDENTITY_TLS_ENABLE="on")
    logs = [base / "n1.log", base / "n2.log"]

    procs = [spawn(p1, specs, env, logs[0]), spawn(p2, specs, env, logs[1])]
    ca_file = os.path.join(certs, "CAs", "ca.crt")
    cli1 = S3Client(f"https://127.0.0.1:{p1}", ca_file=ca_file)
    cli2 = S3Client(f"https://127.0.0.1:{p2}", ca_file=ca_file)
    try:
        try:
            wait_online([cli1, cli2], procs, 45)
        except (TimeoutError, RuntimeError):
            for log in logs:
                print(tail(log))
            raise
        yield {
            "cli1": cli1, "cli2": cli2, "ports": (p1, p2), "base": base,
            "certs": certs, "ca_file": ca_file, "procs": procs,
            "ca": (ca_key, ca_cert),
            "client_cert": (str(base / "client.crt"), str(base / "client.key")),
        }
    finally:
        stop_all(procs)


def test_plain_http_refused(tls_cluster):
    """The listener speaks only TLS once certs are configured."""
    p1 = tls_cluster["ports"][0]
    conn = http.client.HTTPConnection("127.0.0.1", p1, timeout=5)
    with pytest.raises((http.client.HTTPException, OSError)):
        conn.request("GET", "/")
        resp = conn.getresponse()
        if resp.status:  # an HTTP reply over a TLS port means no TLS
            raise AssertionError("plain HTTP served on TLS listener")


def test_cross_node_put_get_over_tls(tls_cluster):
    """PUT via node1, GET via node2: object data crosses the internode
    storage plane, which must ride TLS (both nodes https-only)."""
    cli1, cli2 = tls_cluster["cli1"], tls_cluster["cli2"]
    assert cli1.make_bucket("tlsbkt").status == 200
    body = os.urandom(700 * 1024)
    assert cli1.put_object("tlsbkt", "obj", body).status == 200
    r = cli2.get_object("tlsbkt", "obj")
    assert r.status == 200 and r.body == body


def test_presigned_over_https(tls_cluster):
    cli1 = tls_cluster["cli1"]
    cli1.put_object("tlsbkt", "pres", b"presigned-tls")
    url = cli1.presign("GET", "tlsbkt", "pres")
    assert url.startswith("https://")
    ctx = ssl.create_default_context(cafile=tls_cluster["ca_file"])
    with urllib.request.urlopen(url, context=ctx) as resp:
        assert resp.read() == b"presigned-tls"


def test_server_cert_verified_against_ca(tls_cluster):
    """A client that does NOT trust the test CA must fail the handshake —
    proves the listener serves the configured cert, not a default."""
    p1 = tls_cluster["ports"][0]
    strict = ssl.create_default_context()  # system roots only
    conn = http.client.HTTPSConnection("127.0.0.1", p1, timeout=5,
                                       context=strict)
    with pytest.raises(ssl.SSLError):
        conn.request("GET", "/")


def test_sts_assume_role_with_certificate(tls_cluster):
    """mTLS STS: client cert with CN 'cert-rw' + a policy of the same name
    mints temp credentials that then authenticate normal S3 calls."""
    cli1 = tls_cluster["cli1"]
    policy = {
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Action": ["s3:*"],
                       "Resource": ["arn:aws:s3:::*"]}],
    }
    r = cli1.request(
        "PUT", "/minio/admin/v3/add-canned-policy",
        query={"name": "cert-rw"}, body=json.dumps(policy).encode(),
    )
    assert r.status == 200

    p1 = tls_cluster["ports"][0]
    ctx = ssl.create_default_context(cafile=tls_cluster["ca_file"])
    crt, key = tls_cluster["client_cert"]
    ctx.load_cert_chain(crt, key)
    conn = http.client.HTTPSConnection("127.0.0.1", p1, timeout=10,
                                       context=ctx)
    form = urllib.parse.urlencode({
        "Action": "AssumeRoleWithCertificate", "Version": "2011-06-15",
        "DurationSeconds": "900",
    })
    conn.request("POST", "/", body=form.encode(), headers={
        "Content-Type": "application/x-www-form-urlencoded"})
    resp = conn.getresponse()
    body = resp.read().decode()
    assert resp.status == 200, body
    import re

    ak = re.search(r"<AccessKeyId>([^<]+)", body).group(1)
    sk = re.search(r"<SecretAccessKey>([^<]+)", body).group(1)
    tok = re.search(r"<SessionToken>([^<]+)", body).group(1)
    temp = S3Client(
        f"https://127.0.0.1:{p1}", access_key=ak, secret_key=sk,
        ca_file=tls_cluster["ca_file"],
    )
    r = temp.request("PUT", "/certbkt",
                     headers={"x-amz-security-token": tok})
    assert r.status == 200
    r = temp.request("PUT", "/certbkt/obj", body=b"via-mtls-sts",
                     headers={"x-amz-security-token": tok})
    assert r.status == 200


def test_sts_certificate_expiry_capped_at_cert(tls_cluster):
    """Credentials never outlive the client certificate (reference
    sts-handlers.go:917 clamps expiry to cert NotAfter)."""
    ca_key, ca_cert = tls_cluster["ca"]
    base = tls_cluster["base"]
    short_pem, short_key = x509util.issue_cert(
        ca_key, ca_cert, "cert-rw", client=True, days=1
    )
    with open(base / "short.crt", "wb") as f:
        f.write(short_pem)
    with open(base / "short.key", "wb") as f:
        f.write(short_key)
    p1 = tls_cluster["ports"][0]
    ctx = ssl.create_default_context(cafile=tls_cluster["ca_file"])
    ctx.load_cert_chain(str(base / "short.crt"), str(base / "short.key"))
    conn = http.client.HTTPSConnection("127.0.0.1", p1, timeout=10,
                                       context=ctx)
    form = urllib.parse.urlencode({
        "Action": "AssumeRoleWithCertificate", "Version": "2011-06-15",
        "DurationSeconds": "604800",  # 7 days, far beyond the cert's 1
    })
    conn.request("POST", "/", body=form.encode(), headers={
        "Content-Type": "application/x-www-form-urlencoded"})
    resp = conn.getresponse()
    body = resp.read().decode()
    assert resp.status == 200, body
    import re
    from datetime import datetime, timezone

    exp = re.search(r"<Expiration>([^<]+)", body).group(1)
    exp_ts = datetime.strptime(exp, "%Y-%m-%dT%H:%M:%SZ").replace(
        tzinfo=timezone.utc
    ).timestamp()
    assert exp_ts - time.time() < 2 * 24 * 3600  # capped near cert NotAfter


def test_sts_certificate_requires_client_cert(tls_cluster):
    """No client certificate on the connection -> AccessDenied."""
    cli1 = tls_cluster["cli1"]
    p1 = tls_cluster["ports"][0]
    ctx = ssl.create_default_context(cafile=tls_cluster["ca_file"])
    conn = http.client.HTTPSConnection("127.0.0.1", p1, timeout=10,
                                       context=ctx)
    form = urllib.parse.urlencode({
        "Action": "AssumeRoleWithCertificate", "Version": "2011-06-15"})
    conn.request("POST", "/", body=form.encode(), headers={
        "Content-Type": "application/x-www-form-urlencoded"})
    resp = conn.getresponse()
    assert resp.status == 403


def test_sts_certificate_rejects_server_only_eku(tls_cluster):
    """A chain-valid cert whose EKU lacks ClientAuth (server-only) must not
    mint credentials even when its CN matches a policy (reference
    cmd/sts-handlers.go:884-893 rejects non-client-auth EKUs)."""
    cli1 = tls_cluster["cli1"]
    policy = {
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Action": ["s3:*"],
                       "Resource": ["arn:aws:s3:::*"]}],
    }
    r = cli1.request(
        "PUT", "/minio/admin/v3/add-canned-policy",
        query={"name": "cert-rw"}, body=json.dumps(policy).encode(),
    )
    assert r.status == 200
    ca_key, ca_cert = tls_cluster["ca"]
    base = tls_cluster["base"]
    srv_pem, srv_key = x509util.issue_cert(
        ca_key, ca_cert, "cert-rw", server_only=True
    )
    with open(base / "srvonly.crt", "wb") as f:
        f.write(srv_pem)
    with open(base / "srvonly.key", "wb") as f:
        f.write(srv_key)
    p1 = tls_cluster["ports"][0]
    ctx = ssl.create_default_context(cafile=tls_cluster["ca_file"])
    ctx.load_cert_chain(str(base / "srvonly.crt"), str(base / "srvonly.key"))
    conn = http.client.HTTPSConnection("127.0.0.1", p1, timeout=10,
                                       context=ctx)
    form = urllib.parse.urlencode({
        "Action": "AssumeRoleWithCertificate", "Version": "2011-06-15",
        "DurationSeconds": "900",
    })
    # rejection may land at either layer: OpenSSL's server-side purpose
    # check kills the handshake outright, or (if the handshake were
    # permissive) the STS handler's EKU check returns 403 — both mean no
    # credentials were minted
    try:
        conn.request("POST", "/", body=form.encode(), headers={
            "Content-Type": "application/x-www-form-urlencoded"})
        resp = conn.getresponse()
        assert resp.status == 403, resp.read().decode()
    except (ssl.SSLError, ConnectionError):
        pass

    # the handler-level check (reference cmd/sts-handlers.go:884-893) must
    # also hold on its own for a non-client-auth DER
    from cryptography.hazmat.primitives import serialization as _ser
    from cryptography import x509 as _x509

    der = _x509.load_pem_x509_certificate(srv_pem).public_bytes(
        _ser.Encoding.DER)
    assert not x509util.cert_is_client_auth(der)
    client_der = _x509.load_pem_x509_certificate(
        open(tls_cluster["client_cert"][0], "rb").read()
    ).public_bytes(_ser.Encoding.DER)
    assert x509util.cert_is_client_auth(client_der)


def test_cert_hot_reload(tls_cluster):
    """Rotate public.crt/private.key on disk: new handshakes serve the new
    certificate (new serial) without a restart, and the cluster still
    serves objects afterwards."""
    ca_key, ca_cert = tls_cluster["ca"]
    certs = tls_cluster["certs"]
    p1 = tls_cluster["ports"][0]

    def serving_serial():
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        import socket

        with socket.create_connection(("127.0.0.1", p1), timeout=5) as s:
            with ctx.wrap_socket(s, server_hostname="127.0.0.1") as tls:
                return x509util.cert_serial(tls.getpeercert(binary_form=True))

    before = serving_serial()
    new_pem, new_key = x509util.issue_cert(
        ca_key, ca_cert, "localhost", sans=["127.0.0.1", "localhost"]
    )
    with open(os.path.join(certs, "public.crt"), "wb") as f:
        f.write(new_pem)
    with open(os.path.join(certs, "private.key"), "wb") as f:
        f.write(new_key)
    deadline = time.time() + 15
    after = before
    while time.time() < deadline and after == before:
        time.sleep(1.0)
        after = serving_serial()
    assert after != before, "certificate was not hot-reloaded"
    # cluster still healthy on the rotated cert (same CA, so trust holds)
    cli1 = tls_cluster["cli1"]
    r = cli1.get_object("tlsbkt", "obj")
    assert r.status == 200
