"""The port's SO_REUSEPORT worker pool (``minio_tpu_torch/server/worker.py``)
behaves like one coherent node: the cases of ``tests/test_workers.py``
against ``python -m minio_tpu_torch.server`` with ``MINIO_TPU_WORKERS=2``
on the CPU (``MINIO_TPU_TORCH_DEVICE=cpu``, the host plane).

- data written through worker A is visible (bytes and ETag) through worker
  B at once, also where B had the old version cached;
- admin fault-inject, cache-clear and placement fan out to every worker;
- /minio/metrics/v3 merges every worker's series (worker="i" labels);
- bitrot + heal and overwrite-under-cached-GET hold with 2 workers;
- the supervisor restarts a crashed worker.

Left out: ``test_bench_load_quick_runs`` (it drives ``benchmarks/
bench_load.py``, a harness of the reference that the port does not have).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import threading
import time

import pytest

from minio_tpu_torch.client import S3Client
from minio_tpu_torch.server.nodes import free_port_block, spawn, stop_all, tail, wait_online
from tests.test_torch_cluster import node_env

BUCKET = "wpool"


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    base = tmp_path_factory.mktemp("wpool")
    # ONE block of three: shared S3 port + both control ports — two
    # independent probes could overlap (each closes its probe sockets
    # before the next one draws)
    port = free_port_block(3)
    ctrl_base = port + 1
    env = node_env(
        MINIO_TPU_WORKERS="2",
        MINIO_TPU_WORKER_PORT_BASE=str(ctrl_base),
        # range-segment tier with a small memory budget + an NVMe tier so
        # the cross-worker invalidation test below covers disk-resident
        # segments too (demotion needs real memory pressure)
        MINIO_TPU_CACHE_MEM_MB="16",
        MINIO_TPU_CACHE_DISK_MB="256",
        MINIO_TPU_CACHE_DISK_DIR=str(base / "segspool"),
    )
    log_path = base / "pool.log"
    proc = spawn(port, [base / f"d{i}" for i in range(8)], env, log_path)
    shared = S3Client(f"127.0.0.1:{port}")
    w0 = S3Client(f"127.0.0.1:{ctrl_base}")
    w1 = S3Client(f"127.0.0.1:{ctrl_base + 1}")
    try:
        try:
            wait_online([w0, w1], [proc], 60)
        except (TimeoutError, RuntimeError):
            print(tail(log_path))
            raise
        assert w0.make_bucket(BUCKET).status == 200
        yield {"proc": proc, "shared": shared, "w0": w0, "w1": w1,
               "port": port, "ctrl_base": ctrl_base, "base": str(base),
               "log": log_path}
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                pass
        stop_all([proc])


def _info(cli) -> dict:
    r = cli.request("GET", "/minio/admin/v3/info")
    assert r.status == 200
    return json.loads(r.body)


def test_worker_identities(pool):
    i0, i1 = _info(pool["w0"]), _info(pool["w1"])
    assert (i0["workerIndex"], i0["workerCount"]) == (0, 2)
    assert (i1["workerIndex"], i1["workerCount"]) == (1, 2)
    assert i0["pid"] != i1["pid"], "workers must be separate processes"


def test_cross_worker_put_get_head(pool):
    w0, w1 = pool["w0"], pool["w1"]
    body = os.urandom(256 * 1024)
    etag = hashlib.md5(body).hexdigest()
    assert w0.put_object(BUCKET, "xw", body).status == 200
    g = w1.get_object(BUCKET, "xw")
    assert g.status == 200 and g.body == body
    assert g.headers["etag"].strip('"') == etag
    h = w1.head_object(BUCKET, "xw")
    assert h.status == 200
    assert h.headers["etag"].strip('"') == etag


def test_cached_get_sees_sibling_overwrite(pool):
    """Worker B serves an object from its cache; an overwrite through
    worker A must invalidate B before the PUT returns (synchronous
    choke-point broadcast) — B's next read returns the new version."""
    w0, w1 = pool["w0"], pool["w1"]
    v1 = b"version-one " * 4096
    assert w0.put_object(BUCKET, "hot", v1).status == 200
    for _ in range(4):  # admission wants repeat reads: B caches v1
        assert w1.get_object(BUCKET, "hot").body == v1
    v2 = b"version-TWO " * 4096
    assert w0.put_object(BUCKET, "hot", v2).status == 200
    g = w1.get_object(BUCKET, "hot")
    assert g.body == v2, "worker B served stale cached bytes"
    assert g.headers["etag"].strip('"') == hashlib.md5(v2).hexdigest()


def test_admin_fault_inject_fans_out(pool):
    w0, w1 = pool["w0"], pool["w1"]
    rule = {"boundary": "storage", "mode": "error", "target": "*",
            "op": "read_file", "count": 0}
    r = w0.request("POST", "/minio/admin/v3/fault/inject",
                   body=json.dumps(rule).encode())
    assert r.status == 200, r.body
    out = json.loads(r.body)
    assert out.get("peers"), "no fan-out rows"
    st1 = json.loads(
        w1.request("GET", "/minio/admin/v3/fault/status").body
    )
    assert len(st1["rules"]) == 1, "rule did not reach the sibling"
    # clear from the OTHER worker clears everywhere
    assert w1.request("POST", "/minio/admin/v3/fault/clear").status == 200
    st0 = json.loads(
        w0.request("GET", "/minio/admin/v3/fault/status").body
    )
    assert st0["rules"] == []


def test_admin_cache_clear_fans_out(pool):
    w0, w1 = pool["w0"], pool["w1"]
    body = b"cacheable " * 1000
    assert w0.put_object(BUCKET, "cc", body).status == 200
    for cli in (w0, w1):
        for _ in range(3):
            assert cli.get_object(BUCKET, "cc").status == 200

    def entries(cli) -> int:
        st = json.loads(
            cli.request("GET", "/minio/admin/v3/cache/status").body
        )
        return st["fileinfo"]["entries"] + st["data"]["entries"]

    assert entries(w0) > 0 and entries(w1) > 0
    r = w0.request("POST", "/minio/admin/v3/cache/clear")
    assert r.status == 200 and "peers" in json.loads(r.body)
    assert entries(w0) == 0
    assert entries(w1) == 0, "sibling cache survived the fan-out clear"


def test_metrics_v3_aggregates_workers(pool):
    text = pool["shared"].request(
        "GET", "/minio/metrics/v3/api/qos"
    ).body.decode()
    assert 'worker="0"' in text and 'worker="1"' in text, (
        "scrape reported one worker's view only"
    )
    assert 'minio_worker_up{worker="0"} 1' in text
    assert 'minio_worker_up{worker="1"} 1' in text
    assert "minio_workers_total 2" in text
    # per-worker qos series exist for both workers
    for w in ("0", "1"):
        assert f'minio_api_qos_inflight{{class="s3",worker="{w}"}}' in text
    # cache + tpu groups aggregate the same way
    cache_text = pool["shared"].request(
        "GET", "/minio/metrics/v3/api/cache"
    ).body.decode()
    assert 'worker="0"' in cache_text and 'worker="1"' in cache_text
    # local=on opts out (what the fan-out itself uses — no recursion)
    local = pool["w0"].request(
        "GET", "/minio/metrics/v3/api/qos", query={"local": "on"}
    ).body.decode()
    assert "worker=" not in local


def test_overwrite_under_cached_get_two_workers(pool):
    """Chaos-coherence schedule, pool edition: continuous GETs on both
    workers while versions advance through alternating writers — every
    read must return a complete, current-or-newer version with a
    matching etag. Zero stale bytes, zero torn reads."""
    w0, w1 = pool["w0"], pool["w1"]
    versions = [bytes([i]) * 65536 for i in range(8)]
    etags = {hashlib.md5(v).hexdigest(): i for i, v in enumerate(versions)}
    assert w0.put_object(BUCKET, "chaos", versions[0]).status == 200
    floor = {"v": 0}  # latest acked version index
    stop = threading.Event()
    errors: list[str] = []

    def reader(cli, name: str) -> None:
        while not stop.is_set():
            lo = floor["v"]  # BEFORE the read: acked by a returned PUT
            g = cli.get_object(BUCKET, "chaos")
            if g.status != 200:
                errors.append(f"{name}: HTTP {g.status}")
                return
            et = g.headers["etag"].strip('"')
            if et not in etags:
                errors.append(f"{name}: unknown etag {et}")
                return
            idx = etags[et]
            if g.body != versions[idx]:
                errors.append(f"{name}: torn read at version {idx}")
                return
            if idx < lo:
                errors.append(
                    f"{name}: STALE read: version {idx} after {lo} acked"
                )
                return

    threads = [
        threading.Thread(target=reader, args=(w0, "reader-w0"), daemon=True),
        threading.Thread(target=reader, args=(w1, "reader-w1"), daemon=True),
    ]
    for t in threads:
        t.start()
    try:
        for i in range(1, len(versions)):
            writer = w0 if i % 2 else w1
            assert writer.put_object(BUCKET, "chaos", versions[i]).status == 200
            floor["v"] = i
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors


def test_bitrot_heal_with_two_workers(pool):
    """Bitrot + heal schedule under the pool: corrupt one shard on disk,
    both workers still serve verified bytes (decode around the bad
    shard); an admin heal through worker 0 repairs it."""
    w0, w1 = pool["w0"], pool["w1"]
    body = os.urandom(512 * 1024)
    assert w0.put_object(BUCKET, "rot", body).status == 200
    # find one shard file and flip bytes in the middle
    victim = None
    for root, _dirs, files in os.walk(pool["base"]):
        if f"{os.sep}{BUCKET}{os.sep}rot" in root:
            for f in files:
                if f.startswith("part."):
                    victim = os.path.join(root, f)
                    break
        if victim:
            break
    assert victim, "no shard file found to corrupt"
    with open(victim, "r+b") as fh:
        fh.seek(os.path.getsize(victim) // 2)
        fh.write(b"\xde\xad\xbe\xef" * 8)
    for name, cli in (("w0", w0), ("w1", w1)):
        g = cli.get_object(BUCKET, "rot")
        assert g.status == 200 and g.body == body, (
            f"{name} served corrupt bytes"
        )
    r = w0.request("POST", f"/minio/admin/v3/heal/{BUCKET}",
                   query={"prefix": "rot"}, timeout=120)
    assert r.status == 200, r.body
    healed = json.loads(r.body)
    assert healed["scanned"] >= 1
    g = w1.get_object(BUCKET, "rot")
    assert g.status == 200 and g.body == body


def test_ranged_segment_cache_cross_worker_invalidation(pool):
    """Range-segment tier coherence across the pool: worker 1 warms its
    segment cache (memory + disk-demoted entries — the fixture's 16 MiB
    budget forces demotion) over a large object, worker 0 overwrites it,
    and worker 1 must serve the NEW bytes/etag immediately — the
    invalidation broadcast covers segment directories and their NVMe
    files like every other tier."""
    w0, w1 = pool["w0"], pool["w1"]
    mib = 1 << 20
    size = 24 * mib  # > the 16 MiB memory budget: part of it demotes
    body = os.urandom(size)
    assert w0.put_object(BUCKET, "rseg", body).status == 200

    def ranged(cli, off):
        r = cli.request(
            "GET", f"/{BUCKET}/rseg",
            headers={"Range": f"bytes={off}-{off + mib - 1}"},
        )
        assert r.status == 206, r.status
        return r.body

    # two passes warm w1 (two-touch admission, then fills)
    for _ in range(2):
        for off in range(0, size, mib):
            assert ranged(w1, off) == body[off : off + mib]
    st = json.loads(
        w1.request("GET", "/minio/admin/v3/cache/status").body
    )
    assert st["segmentsEnabled"] and st["segments"]["fills"] > 0
    assert st["segments"]["disk_entries"] > 0, (
        "expected demoted segments under the 16 MiB budget",
        st["segments"],
    )
    # overwrite THROUGH THE SIBLING: w1's segment directory and its
    # NVMe files must invalidate before w0's PUT returns
    body2 = os.urandom(size)
    etag2 = hashlib.md5(body2).hexdigest()
    assert w0.put_object(BUCKET, "rseg", body2).status == 200
    for off in (0, 8 * mib, size - mib):
        r = w1.request(
            "GET", f"/{BUCKET}/rseg",
            headers={"Range": f"bytes={off}-{off + mib - 1}"},
        )
        assert r.status == 206
        assert r.body == body2[off : off + mib], f"stale bytes at {off}"
        assert r.headers["etag"].strip('"') == etag2, "stale etag"
    st2 = json.loads(
        w1.request("GET", "/minio/admin/v3/cache/status").body
    )
    assert st2["segments"]["invalidations"] > st["segments"]["invalidations"]


def test_placement_rules_roundtrip_across_workers(pool):
    """Acceptance: placement rules set on one worker round-trip through
    the admin fan-out — the sibling serves them immediately (reload
    fan-out, not the MINIO_TPU_PLACEMENT_REFRESH_S TTL)."""
    w0, w1 = pool["w0"], pool["w1"]
    rule = {"bucket": BUCKET, "prefix": "pinned/", "mode": "pin",
            "pools": [0]}
    r = w0.request("POST", "/minio/admin/v3/placement/set",
                   body=json.dumps(rule).encode())
    assert r.status == 200, r.body
    assert json.loads(r.body).get("peers"), "no fan-out rows"
    got = json.loads(w1.request(
        "GET", "/minio/admin/v3/placement/get").body)
    assert [(x["bucket"], x["prefix"], x["mode"], x["pools"])
            for x in got] == [(BUCKET, "pinned/", "pin", [0])], got
    # enforced on PUT through EITHER worker (single pool here: the rule
    # is a no-op decision-wise, but status must count the pin decision)
    assert w1.put_object(BUCKET, "pinned/x", b"p").status == 200
    # delete from the sibling, fan-out clears the origin too
    r = w1.request("POST", "/minio/admin/v3/placement/delete",
                   body=json.dumps({"bucket": BUCKET,
                                    "prefix": "pinned/"}).encode())
    assert r.status == 200 and json.loads(r.body)["removed"] is True
    assert json.loads(w0.request(
        "GET", "/minio/admin/v3/placement/get").body) == []


def test_supervisor_restarts_crashed_worker(pool):
    w1 = pool["w1"]
    pid = _info(w1)["pid"]
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            info = _info(w1)
            if info["pid"] != pid and info["workerIndex"] == 1:
                break
        except Exception:  # noqa: BLE001 — respawning
            pass
        time.sleep(0.3)
    else:
        raise AssertionError("worker 1 was not restarted")
    # the restarted worker serves data written before the crash
    body = os.urandom(4096)
    assert pool["w0"].put_object(BUCKET, "after-crash", body).status == 200
    assert w1.get_object(BUCKET, "after-crash").body == body


def test_qos_budget_divided_across_workers(pool):
    """Each worker's admission caps are the node budget / pool size —
    read from the live pool's aggregated metrics."""
    text = pool["shared"].request(
        "GET", "/minio/metrics/v3/api/qos"
    ).body.decode()
    caps = {}
    for line in text.splitlines():
        if line.startswith('minio_api_qos_max_inflight{class="s3"'):
            worker = line.split('worker="')[1].split('"')[0]
            caps[worker] = int(float(line.rsplit(" ", 1)[1]))
    assert set(caps) == {"0", "1"}
    import multiprocessing

    node_budget = max(256, 32 * multiprocessing.cpu_count())
    assert caps["0"] == caps["1"] == node_budget // 2


def test_pool_stops_cleanly_on_sigterm(pool):
    """Last: SIGTERM reaches both workers through the supervisor, each
    drains (closing its grid connections first, so siblings do not wait on
    each other) and the supervisor exits 0 within 30 s."""
    proc = pool["proc"]
    t0 = time.time()
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(30) == 0
    assert time.time() - t0 < 30
    for cli in (pool["w0"], pool["w1"]):
        with pytest.raises(OSError):
            cli.request("GET", "/", timeout=2)
