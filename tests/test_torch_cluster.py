"""The port's server as operators start it: ``python -m
minio_tpu_torch.server`` processes on one host with one endpoint list.

The cases of ``tests/test_distributed.py`` (cross-node PUT/GET, shards on
both nodes, the bootstrap environment check, profile and trace fan-out,
node-failure tolerance and restart) run against port nodes, then a 4-node
EC 8+8 cluster loses a node's object directories and the admin heal must
bring every file back byte for byte. Nodes run on the CPU
(``MINIO_TPU_TORCH_DEVICE=cpu``, the host plane). ``main()``'s gateway
flags and its named refusals are pinned at the end.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from minio_tpu_torch.client import S3Client
from minio_tpu_torch.server.nodes import spawn, stop_all, tail, wait_online
from tests.test_s3_api import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90  # a node answers GET / within this, or the test fails


def node_env(**extra) -> dict:
    """The environment of a node: this process's without any MINIO_*
    variable (test modules export some at import), then the node's own.
    Every node of a cluster gets the same MINIO_* set, so the bootstrap
    check compares equal environments."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MINIO_") and k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO, MINIO_TPU_TORCH_DEVICE="cpu", MINIO_TPU_BACKEND="numpy",
               MINIO_TPU_SANITIZE="0", MINIO_TPU_SCAN_INTERVAL="0")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("tdist")
    p1, p2 = _free_port(), _free_port()
    # one 4-drive erasure set spanning both nodes: EC 2+2, so one whole
    # node down still reads
    specs = [f"http://127.0.0.1:{p1}{base}/n1/d1", f"http://127.0.0.1:{p1}{base}/n1/d2",
             f"http://127.0.0.1:{p2}{base}/n2/d1", f"http://127.0.0.1:{p2}{base}/n2/d2"]
    env = node_env()
    logs = [base / "n1.log", base / "n2.log"]
    procs = [spawn(p1, specs, env, logs[0]), spawn(p2, specs, env, logs[1])]
    cli1, cli2 = S3Client(f"127.0.0.1:{p1}"), S3Client(f"127.0.0.1:{p2}")
    try:
        try:
            wait_online([cli1, cli2], procs, DEADLINE_S)
        except (TimeoutError, RuntimeError):
            print(tail(logs[0]), tail(logs[1]))
            raise
        yield {"procs": procs, "cli1": cli1, "cli2": cli2, "ports": (p1, p2),
               "base": str(base), "specs": specs, "env": env, "logs": logs}
    finally:
        stop_all(procs)


def test_cross_node_put_get(cluster):
    cli1, cli2 = cluster["cli1"], cluster["cli2"]
    assert cli1.make_bucket("shared").status == 200
    body = os.urandom(512 * 1024)
    assert cli1.put_object("shared", "from-n1", body).status == 200
    g = cli2.get_object("shared", "from-n1")  # shards live on both nodes
    assert g.status == 200 and g.body == body
    assert cli2.put_object("shared", "from-n2", b"n2-data").status == 200
    assert cli1.get_object("shared", "from-n2").body == b"n2-data"


def test_shards_actually_distributed(cluster):
    base = cluster["base"]
    n1 = sum(len(files) for _, _, files in os.walk(f"{base}/n1"))
    n2 = sum(len(files) for _, _, files in os.walk(f"{base}/n2"))
    assert n1 > 0 and n2 > 0, "both nodes must hold shards"


def test_nodes_report_their_device_and_no_config_mismatch(cluster):
    for log in cluster["logs"]:
        text = tail(log, 20000)
        assert "device: host (MINIO_TPU_BACKEND=numpy)" in text, text
        assert "object layer online: 1 pool(s), 4 drives, distributed=True" in text, text
        assert "bootstrap config check" not in text, text


def test_bootstrap_env_mismatch_reported(cluster, tmp_path):
    """A node launched with a divergent MINIO_* environment logs the exact
    difference during bootstrap."""
    p3 = _free_port()
    log = tmp_path / "rogue.log"
    proc = spawn(p3, cluster["specs"], node_env(MINIO_DIVERGENT_SETTING="only-on-this-node"),
                 log)
    try:
        deadline = time.time() + 45
        out = ""
        while time.time() < deadline:
            out = tail(log, 20000)
            if "MINIO_DIVERGENT_SETTING" in out:
                break
            time.sleep(0.5)
        assert "bootstrap config check" in out, out
        assert "MINIO_DIVERGENT_SETTING" in out, out
    finally:
        stop_all([proc])


def test_profile_fans_out_to_peers(cluster):
    r = cluster["cli1"].request("POST", "/minio/admin/v3/profile",
                                query={"profilerType": "cpu", "duration": "0.3"})
    assert r.status == 200, r.body
    nodes = json.loads(r.body)["nodes"]
    peer = f"127.0.0.1:{cluster['ports'][1]}"
    assert "local" in nodes and peer in nodes, nodes.keys()
    assert "cpu" in nodes[peer] and "error" not in nodes[peer]


def test_trace_stream_fans_out_to_peers(cluster):
    """One trace stream on node 1 shows S3 records for requests node 2
    served."""
    import http.client
    import threading

    from minio_tpu_torch.server.signature import sign_request

    p1 = cluster["ports"][0]
    cli2 = cluster["cli2"]
    path = "/minio/admin/v3/trace?type=s3"
    headers = sign_request("GET", f"http://127.0.0.1:{p1}{path}", {}, b"",
                           "minioadmin", "minioadmin")
    conn = http.client.HTTPConnection("127.0.0.1", p1, timeout=20)
    conn.request("GET", path, headers=headers)
    resp = conn.getresponse()
    assert resp.status == 200
    stop = threading.Event()

    def traffic():
        deadline = time.time() + 15  # the first GETs may beat the peer pump
        while not stop.is_set() and time.time() < deadline:
            cli2.get_object("shared", "from-n1")
            time.sleep(0.3)

    t = threading.Thread(target=traffic)
    t.start()
    found = False
    deadline = time.time() + 15
    try:
        while time.time() < deadline:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            if rec.get("type") == "s3" and rec.get("path") == "/shared/from-n1":
                found = True
                break
    finally:
        stop.set()
        t.join()
        conn.close()
    assert found, "node-2 request never appeared in node-1's trace stream"


def test_internode_metrics_count_grid_traffic(cluster):
    r = cluster["cli1"].request("GET", "/minio/metrics/v3/system/network/internode")
    assert r.status == 200, r.body
    vals = {ln.split(" ")[0]: float(ln.split(" ")[-1]) for ln in r.body.decode().splitlines()
            if ln and not ln.startswith("#")}
    assert any(k.startswith("minio_system_network_internode_sent_bytes_total") and v > 0
               for k, v in vals.items()), vals


def test_node_failure_tolerance(cluster):
    cli1 = cluster["cli1"]
    body = os.urandom(300 * 1024)
    assert cli1.put_object("shared", "resilient", body).status == 200
    proc2 = cluster["procs"][1]  # 2 of 4 drives gone; EC 2+2 reads with 2
    proc2.send_signal(signal.SIGKILL)
    proc2.wait()
    time.sleep(0.5)
    g = cli1.get_object("shared", "resilient")
    assert g.status == 200 and g.body == body
    r = cli1.put_object("shared", "needs-quorum", b"x" * 100)  # quorum 3 of 4
    assert r.status in (500, 503), r.status
    cluster["procs"][1] = spawn(cluster["ports"][1], cluster["specs"], cluster["env"],
                                cluster["logs"][1])
    wait_online([cluster["cli2"]], [cluster["procs"][1]], DEADLINE_S)
    time.sleep(0.5)
    assert cli1.put_object("shared", "after-recovery", b"back").status == 200
    assert cluster["cli2"].get_object("shared", "after-recovery").body == b"back"


def _files(root: str) -> dict[str, str]:
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(dp, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def cluster4(tmp_path_factory):
    """MinIO's multi-node multi-drive layout at 4 nodes x 4 drives, one
    erasure set of 16 at EC 8+8."""
    base = tmp_path_factory.mktemp("tdist4")
    ports = [_free_port() for _ in range(4)]
    specs = [f"http://127.0.0.1:{ports[i]}{base}/n{i}/d{j}"
             for i in range(4) for j in range(1, 5)]
    env = node_env(MINIO_STORAGE_CLASS_STANDARD="EC:8")
    logs = [base / f"n{i}.log" for i in range(4)]
    procs = [spawn(ports[i], specs, env, logs[i]) for i in range(4)]
    clis = [S3Client(f"127.0.0.1:{p}") for p in ports]
    try:
        try:
            wait_online(clis, procs, DEADLINE_S)
        except (TimeoutError, RuntimeError):
            print(*(tail(lg) for lg in logs))
            raise
        yield {"procs": procs, "clis": clis, "ports": ports, "specs": specs, "env": env,
               "logs": logs, "base": base}
    finally:
        stop_all(procs)


def test_concurrent_first_requests_on_every_node(cluster4):
    """Each node's first request to a bucket loads its metadata from the
    drives, most of them remote. Requests arriving on every node at once
    must not wait on each other: the reference reads there on the event
    loop, so four nodes doing it together each wait for a peer's blocked
    loop until the grid's timeouts (about two minutes, then 500s)."""
    clis = cluster4["clis"]
    assert clis[0].make_bucket("first").status == 200
    bodies = {f"k{i}": os.urandom((1 << 20) + i) for i in range(8)}
    t0 = time.time()
    with ThreadPoolExecutor(8) as ex:
        codes = list(ex.map(lambda i: clis[i % 4].request(
            "PUT", f"/first/k{i}", body=bodies[f"k{i}"], timeout=30).status, range(8)))
    assert codes == [200] * 8
    assert time.time() - t0 < 20
    for i in range(8):
        assert clis[(i + 1) % 4].get_object("first", f"k{i}").body == bodies[f"k{i}"]


def test_four_node_ec8_node_loss_heal(cluster4):
    """Node 3 is killed and its drives' object directories wiped (a
    replaced server); reads stay whole, a write lands on the 12 drives
    left, and after node 3 comes back the admin heal restores every file
    it held, byte for byte, and gives the new object its shards there."""
    clis, procs, base = cluster4["clis"], cluster4["procs"], cluster4["base"]
    info = json.loads(clis[1].request("GET", "/minio/admin/v3/info").body)
    drives = [d for p in info["pools"] for s in p["sets"] for d in s["drives"]]
    assert len(drives) == 16
    assert len({d.split("/")[2] for d in drives}) == 4
    assert clis[0].make_bucket("heal4").status == 200
    bodies = {f"k{i}": os.urandom(n) for i, n in
              enumerate((3 << 20, (1 << 20) + 17, 200_000))}
    for i, (k, b) in enumerate(bodies.items()):
        assert clis[i % 4].put_object("heal4", k, b).status == 200
    n3 = [str(base / "n3" / f"d{j}" / "heal4") for j in range(1, 5)]
    before = {d: _files(d) for d in n3}
    assert all(before.values())
    procs[3].send_signal(signal.SIGKILL)
    procs[3].wait()
    for d in n3:
        for entry in os.listdir(d):
            shutil.rmtree(os.path.join(d, entry))
    for i, (k, b) in enumerate(bodies.items()):  # 12 of 16 drives read
        g = clis[i % 3].get_object("heal4", k)
        assert g.status == 200 and g.body == b
    late = os.urandom((2 << 20) + 5)
    assert clis[1].put_object("heal4", "while-down", late).status == 200
    procs[3] = spawn(cluster4["ports"][3], cluster4["specs"], cluster4["env"],
                     cluster4["logs"][3])
    wait_online([clis[3]], [procs[3]], DEADLINE_S)
    deadline = time.time() + DEADLINE_S  # node 0's breakers reopen after a cooldown
    while len([d for d in json.loads(clis[0].request(
            "GET", "/minio/admin/v3/storageinfo").body)["disks"] if d["state"] == "ok"]) < 16:
        assert time.time() < deadline, "node 3's drives never came back online at node 0"
        time.sleep(0.5)
    r = clis[0].request("POST", "/minio/admin/v3/heal/heal4", timeout=120)
    assert r.status == 200, r.body
    res = json.loads(r.body)
    assert res["failed"] == 0 and res["scanned"] == 4, res
    after = {d: _files(d) for d in n3}
    for d in n3:
        missing = {f for f in before[d] if after[d].get(f) != before[d][f]}
        assert not missing, (d, sorted(missing))
        assert any(f.startswith("while-down" + os.sep) for f in after[d]), sorted(after[d])
    assert clis[3].get_object("heal4", "while-down").body == late


# -- main()'s gateways and refusals ---------------------------------------------


@pytest.mark.parametrize("flags", [["--ftp"], ["--sftp"], ["--ftp", "--sftp"]])
def test_gateway_flags_start_the_gateways(tmp_path, flags):
    """``--ftp`` / ``--sftp`` start each gateway after bootstrap, on the
    port given, each printing it; the SFTP gateway trusts the keys listed in
    MINIO_SFTP_AUTHORIZED_KEYS. A STOR or an SFTP write reads back."""
    import base64
    import ftplib
    import io

    from cryptography.hazmat.primitives.asymmetric import ed25519

    import chip_smoke
    from minio_tpu_torch.server import ssh
    from minio_tpu_torch.server.nodes import free_ports

    port, fport, sport = free_ports(3)
    gw_ports = {"--ftp": fport, "--sftp": sport}
    key = ed25519.Ed25519PrivateKey.from_private_bytes(bytes(range(32)))
    keys = tmp_path / "authorized_keys"
    keys.write_text("minioadmin ssh-ed25519 "
                    + base64.b64encode(ssh.ed25519_blob(key.public_key())).decode() + "\n")
    log = tmp_path / "node.log"
    argv = [a for f in flags for a in (f, gw_ports[f])]
    proc = spawn(port, [*argv, *[tmp_path / f"d{i}" for i in range(4)]],
                 node_env(MINIO_SFTP_AUTHORIZED_KEYS=str(keys)), log)
    want = [f"{f[2:].upper()} gateway on port {gw_ports[f]}" for f in flags]
    try:
        deadline = time.monotonic() + DEADLINE_S
        lines: list = []
        while not all(w in lines for w in want):
            assert proc.poll() is None and time.monotonic() < deadline, tail(log)
            time.sleep(0.25)
            lines = tail(log, 200_000).splitlines()
        assert [ln for ln in lines if "gateway on port" in ln] == want, lines
        body = bytes(range(256)) * 300
        if "--sftp" in flags:
            c = chip_smoke.SFTPClient(sport, "minioadmin", key=key)
            try:
                assert c.status(c.fx.FXP_MKDIR, ssh.wstr("/gw-sftp") + ssh.wu32(0)) == 0
                c.put("/gw-sftp/obj.bin", body)
                assert c.get("/gw-sftp/obj.bin") == body
            finally:
                c.close()
        if "--ftp" in flags:
            f = ftplib.FTP()
            f.connect("127.0.0.1", fport, timeout=30)
            f.login("minioadmin", "minioadmin")
            try:
                f.mkd("/gw-ftp")
                f.storbinary("STOR /gw-ftp/obj.bin", io.BytesIO(body))
                buf = io.BytesIO()
                f.retrbinary("RETR /gw-ftp/obj.bin", buf.write)
                assert buf.getvalue() == body
            finally:
                f.quit()
    finally:
        stop_all([proc])


@pytest.mark.parametrize("argv,env,needle", [
    ([], {"MINIO_TPU_SANITIZE": "1"}, "sanitizer: access witness armed on"),
])
def test_unported_options_are_refused_by_name(tmp_path, argv, env, needle):
    """main() refused MINIO_TPU_SANITIZE=1 by name until analysis/ came;
    no option is refused now: a node so started serves, sanitized, and
    prints its witnesses."""
    port = _free_port()
    log = tmp_path / "node.log"
    proc = spawn(port, [*argv, *(tmp_path / f"d{i}" for i in range(4))], node_env(**env), log)
    try:
        cli = S3Client(f"127.0.0.1:{port}")
        wait_online([cli], [proc])
        assert cli.make_bucket("sanitized").status == 200
        assert cli.put_object("sanitized", "k", b"v" * 4096).status == 200
        text = log.read_text(errors="replace")
        assert needle in text and "sanitizer: leak witness armed on" in text, text
        r = cli.admin("GET", "sanitizer/status")
        assert r.status == 200 and json.loads(r.body)["enabled"] is True
    finally:
        stop_all([proc])


def test_a_host_without_a_card_refuses_to_start(monkeypatch, tmp_path):
    import torch

    from minio_tpu_torch import device
    from minio_tpu_torch.server import app

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the card-less refusal does not apply")
    for k in ("MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_BACKEND", "MINIO_TPU_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MINIO_TPU_SANITIZE", "0")
    with pytest.raises(SystemExit) as exc:
        app.main(["--address", "127.0.0.1:0", str(tmp_path / "d1")])
    with pytest.raises(RuntimeError) as want:
        device.resolve()
    assert str(exc.value.code) == str(want.value)


def test_pool_with_remote_peers_is_refused(monkeypatch, tmp_path):
    """As in the reference: remote nodes address a node by one endpoint, so
    a worker pool there would split its lock table."""
    from minio_tpu_torch.server import app

    monkeypatch.setenv("MINIO_TPU_SANITIZE", "0")
    monkeypatch.setenv("MINIO_TPU_WORKERS", "2")
    monkeypatch.delenv("MINIO_TPU_WORKER_INDEX", raising=False)
    specs = [f"http://127.0.0.1:{p}{tmp_path}/d" for p in (9101, 9102)]
    with pytest.raises(SystemExit) as exc:
        app.main(["--address", "127.0.0.1:9101", *specs])
    assert "not supported yet" in str(exc.value.code)


def test_pool_supervisor_never_touches_the_device(monkeypatch, tmp_path):
    """The supervisor herds processes and builds no object layer: it must
    not resolve the device (on the card that would open a CUDA context in
    a process that serves nothing)."""
    import torch

    from minio_tpu_torch import device
    from minio_tpu_torch.server import app, worker

    def untouchable(*_a, **_k):
        raise AssertionError("the supervisor touched the device")

    calls = []
    monkeypatch.setattr(device, "resolve", untouchable)
    monkeypatch.setattr(torch.cuda, "is_available", untouchable)
    monkeypatch.setattr(worker, "supervise", lambda *a, **k: calls.append(a) or 0)
    monkeypatch.setenv("MINIO_TPU_SANITIZE", "0")
    monkeypatch.setenv("MINIO_TPU_WORKERS", "2")
    monkeypatch.delenv("MINIO_TPU_WORKER_INDEX", raising=False)
    with pytest.raises(SystemExit) as exc:
        app.main(["--address", "127.0.0.1:9100", str(tmp_path / "d1")])
    assert exc.value.code == 0 and len(calls) == 1


def test_launch_shapes_series_round_trip(monkeypatch):
    """Each node reports its kernel launches by shape on /api/tpu; the
    smoke reads them back to the wrappers' own shape keys, and holds the
    kernels against their plain versions at those shapes."""
    import collections

    import chip_smoke
    from minio_tpu_torch.ops import bitrot_cuda, fused_cuda, rs_cuda
    from minio_tpu_torch.server import metrics

    want = {
        "fused_encode_hash": {("encode", 256, 8, 8, 131072): 4},
        "fused_decode_hash": {("decode", 16, 8, 8, 131072, (0, 1, 2, 3, 8, 9, 10, 11),
                               (4, 5, 6, 7)): 3},
        "hh_chain": {(4096, 87382): 2, (2048, 65536): 1},
        "gf_apply": {(64, 16, 16, 65536, 2): 5},
    }
    monkeypatch.setattr(fused_cuda, "launch_shapes", collections.Counter(
        {**want["fused_encode_hash"], **want["fused_decode_hash"]}))
    monkeypatch.setattr(fused_cuda, "encode_launches", 4)
    monkeypatch.setattr(fused_cuda, "decode_launches", 3)
    monkeypatch.setattr(bitrot_cuda, "launch_shapes", collections.Counter(want["hh_chain"]))
    monkeypatch.setattr(bitrot_cuda, "launches", 3)
    monkeypatch.setattr(rs_cuda, "launch_shapes", collections.Counter(want["gf_apply"]))
    monkeypatch.setattr(rs_cuda, "launches", 5)
    series = {}
    for ln in metrics._g_api_tpu(None):
        if ln and not ln.startswith("#"):
            name, _, value = ln.rpartition(" ")
            series[name] = float(value)
    assert chip_smoke._launch_shapes(series) == want
    for k, per in want.items():
        assert series[f'minio_tpu_kernel_launches_total{{kernel="{k}"}}'] == sum(per.values())
