"""The port's self-measurement plane (``minio_tpu_torch/diag``) against a
live 2-worker pool of ``python -m minio_tpu_torch.server`` on the CPU: the
cases of ``tests/test_diag.py``. Object, drive and net speedtests with
per-node rows over real HTTP, chaos localization (a slow drive or slow
peer visible by name in the matrix), inspect-data bundles, the admin
profile fan-out, the QoS guard, and the /api/diag and /system/selftest
metrics groups, and the healthinfo bundle (which reads the port's knob
registry and runtime sanitizer, ``analysis/``).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zipfile

from tests.test_torch_workers import BUCKET, pool  # noqa: F401 — module-scoped pool


def _admin(cli, method: str, op: str, query: dict | None = None,
           body: bytes = b"", timeout: float = 120.0):
    return cli.request(method, f"/minio/admin/v3/{op}", query=query or {},
                       body=body, timeout=timeout)


def _nodes(resp, what: str) -> dict:
    assert resp.status == 200, f"{what}: HTTP {resp.status}: {resp.body[:300]}"
    doc = json.loads(resp.body)
    nodes = doc.get("nodes", {})
    assert nodes, f"{what}: no node rows"
    for name, row in nodes.items():
        assert "error" not in row, f"{what}: node {name}: {row.get('error')}"
    return nodes


def _inject(cli, rule: dict) -> None:
    r = _admin(cli, "POST", "fault/inject", body=json.dumps(rule).encode())
    assert r.status == 200, r.body


def _clear(cli) -> None:
    assert _admin(cli, "POST", "fault/clear").status == 200


# ---- speedtests over the wire ---------------------------------------------


def test_object_speedtest_autotunes_per_node(pool):
    r = _admin(pool["w0"], "POST", "speedtest",
               query={"size": str(64 * 1024), "ops": "2"}, timeout=300)
    nodes = _nodes(r, "speedtest")
    assert len(nodes) == 2, f"expected both workers, got {sorted(nodes)}"
    for name, row in nodes.items():
        assert row["steps"], f"node {name}: empty ramp"
        knee = row["knee"]
        assert knee["putMiBps"] > 0 and knee["getMiBps"] > 0, (name, knee)
        assert knee["concurrency"] >= 1
        # the ramp doubled from 1 until the knee: steps are the evidence
        assert [s["concurrency"] for s in row["steps"]] == \
            [2 ** i for i in range(len(row["steps"]))]


def test_object_speedtest_pinned_concurrency(pool):
    r = _admin(pool["w1"], "POST", "speedtest",
               query={"size": str(64 * 1024), "ops": "2",
                      "concurrency": "2", "local": "true"}, timeout=300)
    nodes = _nodes(r, "speedtest local")
    (row,) = nodes.values()
    assert [s["concurrency"] for s in row["steps"]] == [2]


def test_drive_speedtest_measures_every_local_drive(pool):
    r = _admin(pool["w0"], "POST", "speedtest/drive",
               query={"sizeMiB": "1", "randCount": "4"}, timeout=300)
    nodes = _nodes(r, "speedtest/drive")
    assert len(nodes) == 2
    for name, row in nodes.items():
        drives = row["drives"]
        # both workers share the node's 8 drives — each measures all 8
        assert len(drives) == 8, (name, [d.get("endpoint") for d in drives])
        for d in drives:
            assert "error" not in d, (name, d)
            assert d["writeMiBps"] > 0 and d["readMiBps"] > 0, d
            assert d["randReadIOPS"] > 0 and d["randWriteIOPS"] > 0, d
            assert "p99Ms" in d["randRead"] and "p99Ms" in d["randWrite"]


def test_netperf_matrix_has_loopback_and_sibling(pool):
    r = _admin(pool["w0"], "POST", "speedtest/net",
               query={"size": str(128 * 1024), "count": "2", "pings": "4"},
               timeout=300)
    nodes = _nodes(r, "speedtest/net")
    assert len(nodes) == 2
    for name, row in nodes.items():
        peers = row["peers"]
        assert "loopback" in peers, (name, sorted(peers))
        # each worker also measures its one sibling
        assert len(peers) >= 2, (name, sorted(peers))
        for peer, cell in peers.items():
            assert "error" not in cell, (name, peer, cell)
            assert cell["throughputMiBps"] > 0, (peer, cell)
            assert cell["rttP50Ms"] >= 0 and cell["rttP99Ms"] >= cell["rttP50Ms"]


# ---- chaos: the matrix must localize the fault by name --------------------


def test_slow_drive_localized_by_name(pool):
    w0 = pool["w0"]
    # learn the real endpoint names first
    r = _admin(w0, "POST", "speedtest/drive",
               query={"sizeMiB": "1", "randCount": "2", "local": "true"},
               timeout=300)
    drives = _nodes(r, "probe")["local"]["drives"]
    target = drives[3]["endpoint"]
    _inject(w0, {"boundary": "diag", "mode": "slow-drive",
                 "target": target, "latency_ms": 500})
    try:
        r = _admin(w0, "POST", "speedtest/drive",
                   query={"sizeMiB": "1", "randCount": "2", "local": "true"},
                   timeout=300)
        rows = _nodes(r, "slow-drive run")["local"]["drives"]
    finally:
        _clear(w0)
    by_ep = {d["endpoint"]: d for d in rows}
    slow = by_ep[target]
    assert slow["randRead"]["p99Ms"] >= 300, (
        f"injected 500ms stall invisible on {target}: {slow}")
    for ep, d in by_ep.items():
        if ep != target:
            assert d["randRead"]["p99Ms"] < 300, (
                f"stall leaked to untargeted drive {ep}: {d}")


def test_slow_peer_localized_by_name(pool):
    w0 = pool["w0"]
    sibling_port = pool["ctrl_base"] + 1
    _inject(w0, {"boundary": "diag", "mode": "slow-peer",
                 "target": str(sibling_port), "latency_ms": 400})
    try:
        r = _admin(w0, "POST", "speedtest/net",
                   query={"size": str(64 * 1024), "count": "2", "pings": "4",
                          "local": "true"}, timeout=300)
        peers = _nodes(r, "slow-peer run")["local"]["peers"]
    finally:
        _clear(w0)
    slow = [cell for peer, cell in peers.items() if str(sibling_port) in peer]
    assert slow, f"sibling row missing: {sorted(peers)}"
    assert slow[0]["rttP50Ms"] >= 300, (
        f"injected 400ms stall invisible on sibling: {slow[0]}")
    assert peers["loopback"]["rttP50Ms"] < 300, (
        f"stall leaked to loopback: {peers['loopback']}")


# ---- QoS guard: speedtest must not starve foreground traffic --------------


def test_foreground_gets_served_during_speedtest(pool):
    w0, shared = pool["w0"], pool["shared"]
    body = os.urandom(64 * 1024)
    assert shared.put_object(BUCKET, "fg-probe", body).status == 200

    bg_err: list = []

    def run_speedtest():
        try:
            r = _admin(w0, "POST", "speedtest",
                       query={"size": str(256 * 1024), "ops": "4",
                              "concurrency": "4", "local": "true"},
                       timeout=300)
            if r.status != 200:
                bg_err.append(r.status)
        except Exception as e:  # noqa: BLE001 — surfaced in the assert
            bg_err.append(e)

    t = threading.Thread(target=run_speedtest)
    t.start()
    lat: list[float] = []
    try:
        deadline = time.time() + 6.0
        while time.time() < deadline and t.is_alive():
            t0 = time.perf_counter()
            g = shared.get_object(BUCKET, "fg-probe")
            lat.append(time.perf_counter() - t0)
            assert g.status == 200 and g.body == body
    finally:
        t.join(timeout=300)
    assert not bg_err, f"background speedtest failed: {bg_err}"
    assert len(lat) >= 3, "foreground loop starved out entirely"
    lat.sort()
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    # generous: the guard is that foreground stays SERVED and bounded,
    # not that it is unaffected (single-core CI runs everything slower)
    assert p99 < 10.0, f"foreground GET p99 {p99:.2f}s under speedtest"


# ---- healthinfo / inspect-data --------------------------------------------


def test_healthinfo_is_refused_by_name(pool):
    """Refused by name until analysis/ came; now the reference's case
    (tests/test_diag.py::test_healthinfo_json_and_zip): the bundle in
    both formats."""
    r = _admin(pool["w0"], "GET", "healthinfo")
    assert r.status == 200, r.body
    info = json.loads(r.body)
    for key in ("time", "version", "hardware", "knobsNonDefault",
                "topology", "storage", "poolFill", "breakers",
                "sanitizer", "faults", "selftest"):
        assert key in info, f"healthinfo missing {key!r}"
    assert info["version"]["minio_tpu"].startswith("minio-tpu/")
    assert info["hardware"]["workerCount"] == 2
    assert len(info["breakers"]) == 8, "one breaker row per drive"
    # earlier tests ran all three speedtests through this process
    assert set(info["selftest"]["last"]) >= {"object", "drive", "net"}
    assert info["selftest"]["runs"]
    # redaction: no credential value may ride the bundle
    for knob in info["knobsNonDefault"]:
        if any(mark in knob["name"].upper()
               for mark in ("PASSWORD", "SECRET", "TOKEN")):
            assert knob["value"] == "*REDACTED*", knob

    r = _admin(pool["w0"], "GET", "healthinfo", query={"format": "zip"})
    assert r.status == 200
    assert r.headers.get("content-type") == "application/zip"
    with zipfile.ZipFile(io.BytesIO(r.body)) as z:
        assert z.namelist() == ["healthinfo.json"]
        inner = json.loads(z.read("healthinfo.json"))
        assert inner["version"] == info["version"]


def test_inspect_data_bundles_xlmeta_with_verdicts(pool):
    shared, w0 = pool["shared"], pool["w0"]
    body = os.urandom(256 * 1024)
    assert shared.put_object(BUCKET, "inspect-me", body).status == 200
    r = _admin(w0, "GET", "inspect-data",
               query={"bucket": BUCKET, "object": "inspect-me"})
    assert r.status == 200, r.body
    with zipfile.ZipFile(io.BytesIO(r.body)) as z:
        names = z.namelist()
        assert "verdicts.json" in names
        metas = [n for n in names if n.endswith("/xl.meta")]
        assert len(metas) == 8, names
        verdicts = json.loads(z.read("verdicts.json"))
    assert verdicts["bucket"] == BUCKET
    assert len(verdicts["drives"]) == 8
    for row in verdicts["drives"]:
        assert row["verdict"] == "ok", row
        assert row["xlMetaBytes"] > 0


def test_inspect_data_requires_bucket_and_object(pool):
    r = _admin(pool["w0"], "GET", "inspect-data", query={"bucket": BUCKET})
    assert r.status == 400


# ---- admin profile fan-out (satellite: cpu/mem/threads per worker) --------


def test_profile_fans_out_per_worker(pool):
    for ptype in ("cpu", "mem", "threads"):
        r = _admin(pool["w0"], "POST", "profile",
                   query={"profilerType": ptype, "duration": "0.3"},
                   timeout=120)
        assert r.status == 200, (ptype, r.body[:300])
        nodes = json.loads(r.body)["nodes"]
        # one section per worker: the local row plus the sibling's
        assert len(nodes) == 2, (ptype, sorted(nodes))
        assert "local" in nodes, (ptype, sorted(nodes))
        for name, row in nodes.items():
            assert "error" not in row, (ptype, name, row)
            assert row.get(ptype), (ptype, name, "empty profile payload")


# ---- metrics: /api/diag + /system/selftest --------------------------------


def _scrape(cli, path: str) -> dict[str, float]:
    r = cli.request("GET", f"/minio/metrics/v3{path}")
    assert r.status == 200
    out: dict[str, float] = {}
    for line in r.body.decode().splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, val = line.rsplit(" ", 1)
        try:
            out[name] = out.get(name, 0.0) + float(val)
        except ValueError:
            pass
    return out


def test_api_diag_series_after_speedtests(pool):
    series = _scrape(pool["shared"], "/api/diag")
    base = {k.split("{", 1)[0] for k in series}
    for name in ("minio_diag_runs_total", "minio_diag_errors_total",
                 "minio_diag_speedtest_put_mibps",
                 "minio_diag_speedtest_get_mibps",
                 "minio_diag_speedtest_knee_concurrency",
                 "minio_diag_drive_write_mibps",
                 "minio_diag_net_mibps",
                 "minio_diag_profile_enabled"):
        assert name in base, f"{name} absent from /api/diag: {sorted(base)}"
    runs = {k: v for k, v in series.items()
            if k.startswith("minio_diag_runs_total")}
    assert sum(runs.values()) > 0, runs
    assert sum(v for k, v in series.items()
               if k.startswith("minio_diag_errors_total")) == 0


def test_continuous_profiler_attribution_series(pool):
    # the pool booted with the knob default (enabled): by now the ~19 Hz
    # sampler has taken samples and classified them by subsystem
    deadline = time.time() + 15.0
    while time.time() < deadline:
        series = _scrape(pool["shared"], "/api/diag")
        samples = sum(v for k, v in series.items()
                      if k.startswith("minio_diag_profile_samples_total"))
        attributed = [k for k in series
                      if k.startswith("minio_diag_profile_thread_samples_total{")]
        if samples > 0 and attributed:
            break
        time.sleep(0.5)
    assert samples > 0, "continuous profiler took no samples"
    assert attributed, "no attributed thread samples"
    labels = "".join(attributed)
    assert 'subsystem="' in labels and 'state="' in labels
    assert sum(v for k, v in series.items()
               if k.startswith("minio_diag_profile_enabled")) > 0


def test_system_selftest_fingerprint_series(pool):
    series = _scrape(pool["shared"], "/system/selftest")
    base = {k.split("{", 1)[0]: v for k, v in series.items()}
    assert base.get("minio_system_selftest_cpu_cores", 0) >= 1
    assert base.get("minio_system_selftest_workers", 0) >= 2
    # earlier tests ran drive + net speedtests: the fingerprint is complete
    assert base.get("minio_system_selftest_drive_write_mibps", 0) > 0
    assert base.get("minio_system_selftest_drive_read_mibps", 0) > 0
    assert base.get("minio_system_selftest_loopback_mibps", 0) > 0
    assert base.get("minio_system_selftest_complete", 0) > 0
