"""diag-smoke: the self-measurement plane end to end, against the port.

Counterpart of the repository's ``scripts/diag_smoke.py``. Brings up a
2-worker SO_REUSEPORT pool of the port's server (``MINIO_TPU_WORKERS=2
python -m minio_tpu_torch.server``, 4 drives), then drives the whole diag
surface over real HTTP:

* quick object speedtest (autotune ramp) + drive speedtest + netperf —
  every request must be a 200 and every node row error-free;
* healthinfo as JSON and as zip (the zip must contain healthinfo.json);
* every series the port's static surface manifest declares under
  ``/api/diag`` (``minio_tpu_torch.analysis.surface`` over
  ``minio_tpu_torch/``) must be present in the live scrape;
* last, the pool's kernel launches by shape, each worker's own
  ``minio_tpu_kernel_launch_shapes_total`` series of ``/api/tpu`` summed,
  printed as one JSON object on a line of its own
  (``diag-smoke: launch shapes {...}``) so that a caller can hold those
  shapes against the kernels' plain versions.

The pool runs on the card unless ``MINIO_TPU_TORCH_DEVICE=cpu`` (or
``MINIO_TPU_BACKEND=numpy``) says otherwise: the device route is the one
under test. Exit status 0 only when all of that holds; the pool is
always stopped. ``make diag-smoke-torch`` runs it.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import zipfile

from ..client import S3Client
from ..server.nodes import free_port_block, spawn, stop_all, tail, wait_online

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = 2
DRIVES = 4
START_S = 180.0


def fail(msg: str) -> None:
    print(f"diag-smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def node_rows(payload: bytes, what: str) -> dict:
    doc = json.loads(payload)
    nodes = doc.get("nodes", {})
    if not nodes:
        fail(f"{what}: no node rows in {doc}")
    for node, row in nodes.items():
        if isinstance(row, dict) and "error" in row:
            fail(f"{what}: node {node} errored: {row['error']}")
    return doc


def declared_diag_series() -> set[str]:
    """Series names the port's static surface manifest declares under
    the /api/diag collector path."""
    from ..analysis import surface

    class _PathsIndex:
        def __init__(self, root: str):
            self.root = root
            self.paths = {}
            for dirpath, _, files in os.walk(root):
                for fn in files:
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        self.paths[os.path.relpath(full, root)] = full

    manifest = surface.extract(_PathsIndex(PKG))
    return {s["name"] for s in manifest["metrics"] if s["group"] == "/api/diag"}


def start_pool(base: str) -> tuple[subprocess.Popen, int, str]:
    """The pool supervisor over DRIVES fresh drives, once every worker
    answers; (process, shared port, log path)."""
    port = free_port_block(WORKERS + 1)
    env = dict(os.environ, MINIO_TPU_WORKERS=str(WORKERS),
               MINIO_TPU_WORKER_PORT_BASE=str(port + 1), MINIO_TPU_SCAN_INTERVAL="30",
               MINIO_COMPRESSION_ENABLE="off")
    for k in ("MINIO_TPU_WORKER_INDEX", "MINIO_TPU_WORKER_COUNT"):
        env.pop(k, None)
    log = os.path.join(base, "pool.log")
    drives = [os.path.join(base, f"d{i}") for i in range(DRIVES)]
    proc = spawn(port, drives, env, log, cwd=os.path.dirname(PKG))
    # every worker, not only the shared port: a request landing on a
    # worker still starting would answer 503
    workers = [S3Client(f"127.0.0.1:{port + 1 + i}") for i in range(WORKERS)]
    try:
        wait_online(workers, [proc], timeout=START_S)
    except (RuntimeError, TimeoutError) as e:
        stop_all([proc])
        fail(f"pool did not come online: {e}\n{tail(log)}")
    return proc, port, log


def stop_pool(proc: subprocess.Popen) -> None:
    """SIGTERM to the supervisor (it stops its workers), then kill the
    session whatever is left of it."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            pass
    stop_all([proc])


def launch_shapes(port: int) -> dict:
    """{series: launches} of the pool's kernel launches by shape, every
    worker's own series (``local=on``) summed."""
    out: dict = {}
    for i in range(WORKERS):
        r = S3Client(f"127.0.0.1:{port + 1 + i}").request(
            "GET", "/minio/metrics/v3/api/tpu", query={"local": "on"})
        if r.status != 200:
            fail(f"worker {i} /api/tpu scrape HTTP {r.status}")
        for line in r.body.decode().splitlines():
            if line.startswith("minio_tpu_kernel_launch_shapes_total{"):
                series, _, value = line.rpartition(" ")
                out[series] = out.get(series, 0) + float(value)
    return out


def run(port: int) -> None:
    cli = S3Client(f"127.0.0.1:{port}")

    def admin(method: str, path: str, query: dict | None = None, timeout: float = 60):
        return cli.request(method, f"/minio/admin/v3/{path}", query=query or {},
                           timeout=timeout)

    if cli.make_bucket("diag-smoke").status != 200:
        fail("make_bucket diag-smoke")

    # -- object speedtest (quick autotune) -------------------------------
    r = admin("POST", "speedtest", {"size": str(64 * 1024), "ops": "2"}, timeout=180)
    if r.status != 200:
        fail(f"speedtest HTTP {r.status}: {r.body[:200]}")
    doc = node_rows(r.body, "speedtest")
    for node, row in doc["nodes"].items():
        knee = row.get("knee", {})
        if not knee.get("putMiBps", 0) > 0:
            fail(f"speedtest: node {node} knee has no PUT throughput: {knee}")
    print(f"diag-smoke: speedtest ok ({len(doc['nodes'])} nodes)", flush=True)

    # -- drive speedtest -------------------------------------------------
    r = admin("POST", "speedtest/drive", {"sizeMiB": "1", "randCount": "4"}, timeout=120)
    if r.status != 200:
        fail(f"speedtest/drive HTTP {r.status}: {r.body[:200]}")
    doc = node_rows(r.body, "speedtest/drive")
    drives = sum(len(row.get("drives", ())) for row in doc["nodes"].values())
    if drives == 0:
        fail("speedtest/drive: no drive rows")
    for row in doc["nodes"].values():
        for d in row.get("drives", ()):
            if "error" in d:
                fail(f"speedtest/drive: drive {d.get('drive')} errored: {d['error']}")
    print(f"diag-smoke: drive speedtest ok ({drives} drive rows)", flush=True)

    # -- netperf matrix --------------------------------------------------
    r = admin("POST", "speedtest/net", {"size": str(256 * 1024), "count": "2", "pings": "4"},
              timeout=120)
    if r.status != 200:
        fail(f"speedtest/net HTTP {r.status}: {r.body[:200]}")
    doc = node_rows(r.body, "speedtest/net")
    for node, row in doc["nodes"].items():
        peers = row.get("peers", {})
        if "loopback" not in peers:
            fail(f"netperf: node {node} has no loopback row: {peers}")
        for peer, cell in peers.items():
            if "error" in cell:
                fail(f"netperf: {node} -> {peer} errored: {cell['error']}")
    print(f"diag-smoke: netperf ok ({len(doc['nodes'])} matrix rows)", flush=True)

    # -- healthinfo: JSON + zip ------------------------------------------
    r = admin("GET", "healthinfo")
    if r.status != 200:
        fail(f"healthinfo HTTP {r.status}: {r.body[:200]}")
    info = json.loads(r.body)
    for key in ("version", "hardware", "topology", "breakers", "sanitizer", "selftest"):
        if key not in info:
            fail(f"healthinfo: missing section {key!r}")
    if not info["selftest"]["last"]:
        fail("healthinfo: selftest.last empty after three speedtests")
    r = admin("GET", "healthinfo", {"format": "zip"})
    if r.status != 200:
        fail(f"healthinfo zip HTTP {r.status}")
    with zipfile.ZipFile(io.BytesIO(r.body)) as z:
        if "healthinfo.json" not in z.namelist():
            fail(f"healthinfo zip entries: {z.namelist()}")
    print("diag-smoke: healthinfo ok (json + zip)", flush=True)

    # -- every declared /api/diag series present in the live scrape ------
    declared = declared_diag_series()
    if not declared:
        fail("static manifest declares no /api/diag series")
    r = cli.request("GET", "/minio/metrics/v3/api/diag")
    if r.status != 200:
        fail(f"/api/diag scrape HTTP {r.status}")
    live = set()
    for line in r.body.decode().splitlines():
        if line.startswith("# TYPE "):
            live.add(line.split()[2])
        elif line and not line.startswith("#") and " " in line:
            live.add(line.rsplit(" ", 1)[0].split("{", 1)[0])
    missing = declared - live
    if missing:
        fail(f"declared /api/diag series absent from live scrape: {sorted(missing)}")
    print(f"diag-smoke: /api/diag scrape ok ({len(declared)} declared series all present)",
          flush=True)
    print(f"diag-smoke: launch shapes {json.dumps(launch_shapes(port))}", flush=True)


def main() -> int:
    base = tempfile.mkdtemp(prefix="diag-smoke-")
    proc = log = None
    try:
        proc, port, log = start_pool(base)
        run(port)
        print("diag-smoke: PASS", flush=True)
        return 0
    except SystemExit:
        if log is not None:
            print(tail(log), file=sys.stderr, flush=True)
        raise
    finally:
        if proc is not None:
            stop_pool(proc)
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
