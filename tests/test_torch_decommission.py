"""minio_tpu_torch pool decommission and rebalance against the JAX package,
on the CPU.

Objects of both code families (inline, one block, several blocks; user
metadata and a content type) are written by the JAX package into the
first pool of 4 drives (EC 2+2); each package then works on its own copy
of the drives, with a second pool of 4 drives attached:

- a decommission of the first pool, re-PUT in either family: object
  bytes, ETags, user metadata, ``ErasureInfo`` and the ``part.N`` bytes on
  every drive of the second pool are equal between the packages (a re-PUT
  is not byte-identical to its source: ``xl.meta`` carries a new
  modification time and data directory, so it is not compared); the
  checkpoints agree but for their timestamps; the first pool cannot be
  detached online in either package;
- a drain checkpointed by the reference is resumed by the port from its
  cursor, and a cancelled drain restarts and completes;
- a bounded rebalance pass and a continuous rebalance move the same keys
  and report the same counts and spread; keys pinned to the first pool
  are never drained;
- a writer that overwrites an object while it is being moved wins, in
  both packages.

Every comparison is exact.
"""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

from minio_tpu import fault as ref_fault
from minio_tpu.erasure import decommission as ref_decom
from minio_tpu.erasure.pools import ServerPools as RefPools
from minio_tpu.erasure.sets import ErasureSets as RefSets
from minio_tpu.placement.topology import remove_pool as ref_remove_pool
from minio_tpu.storage.xlstorage import XLStorage as RefStorage
from minio_tpu_torch import fault
from minio_tpu_torch.erasure import decommission
from minio_tpu_torch.erasure.pools import ServerPools
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.placement.topology import remove_pool
from minio_tpu_torch.storage.xlstorage import XLStorage

MIB = 1 << 20
DEP = ("0d9e8f7a-6b5c-4d3e-8f1a-2b3c4d5e6f70", "1a2b3c4d-5e6f-4a7b-8c9d-0e1f2a3b4c5d")
OBJECTS = {  # (bucket, key) -> (size, family)
    ("dec-a", "a/inline"): (700, "reedsolomon"),
    ("dec-a", "a/one"): (200_000, "cauchy"),
    ("dec-a", "b/multi"): (2 * MIB + 5, "reedsolomon"),
    ("dec-a", "pin/x"): (150_000, "reedsolomon"),
    ("dec-a", "pin/y"): (90_000, "cauchy"),
    ("dec-b", "c/multi"): (MIB + 333, "cauchy"),
    ("dec-b", "d"): (300_001, "reedsolomon"),
    ("dec-b", "e/small"): (12, "cauchy"),
}
BUCKETS = ("dec-a", "dec-b")
META = {"x-amz-meta-color": "blue", "x-amz-meta-n": "7"}

PKGS = {
    "ref": (RefStorage, RefSets, RefPools, ref_decom, ref_fault, ref_remove_pool),
    "port": (XLStorage, ErasureSets, ServerPools, decommission, fault, remove_pool),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MINIO_TPU_CACHE", "0")  # every GET reads the drives
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    monkeypatch.setenv("MINIO_TPU_EC_FAMILY", "reedsolomon")
    yield
    fault.clear()
    ref_fault.clear()


def _data(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _body(key) -> bytes:
    return _data(list(OBJECTS).index(key), OBJECTS[key][0])


def _drives(root, pool):
    return [os.path.join(str(root), f"p{pool}d{i}") for i in range(4)]


def _store(pkg, root, pools=2):
    storage, sets_cls, pools_cls = PKGS[pkg][:3]
    return pools_cls([sets_cls([[storage(p) for p in _drives(root, i)]], deployment_id=DEP[i],
                               default_parity=2, pool_index=i) for i in range(pools)])


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The first pool, written once by the JAX package, copied per test."""
    root = tmp_path_factory.mktemp("golden")
    prev = os.environ.get("MINIO_TPU_BACKEND")
    os.environ["MINIO_TPU_BACKEND"] = "numpy"  # restored below
    try:
        sp = _store("ref", root, pools=1)
        for b in BUCKETS:
            sp.make_bucket(b)
        for (b, k), (_, fam) in OBJECTS.items():
            sp.put_object(b, k, _body((b, k)), user_defined={**META, "content-type": "text/x-" + k},
                          family=fam)
        for d in _drives(root, 1):  # the second pool's drives, buckets in place
            for b in BUCKETS:
                os.makedirs(os.path.join(d, b))
    finally:
        if prev is None:
            os.environ.pop("MINIO_TPU_BACKEND", None)
        else:
            os.environ["MINIO_TPU_BACKEND"] = prev
    return str(root)


def _copies(golden, tmp_path):
    roots = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    for r in roots.values():
        shutil.copytree(golden, str(r))
    return roots


def _holder(sp, bucket, key):
    for i, p in enumerate(sp.pools):
        try:
            p.get_object_info(bucket, key)
            return i
        except Exception:  # noqa: BLE001 — not in this pool
            continue
    return None


def _objects(pkg, sp, root) -> dict:
    """Everything a re-PUT must keep, per object: the pool that holds it,
    its bytes, ETag, content type, user metadata, and per drive of that
    pool the ErasureInfo and the part.N bytes."""
    storage = PKGS[pkg][0]
    out = {}
    for b, k in OBJECTS:
        pool = _holder(sp, b, k)
        oi, it = sp.get_object(b, k)
        drives = {}
        for i, d in enumerate(_drives(root, pool)):
            parts = {}
            for dp, _, fs in os.walk(os.path.join(d, b, k)):
                parts.update({f: open(os.path.join(dp, f), "rb").read()
                              for f in fs if f.startswith("part.")})
            drives[i] = (dataclasses.asdict(storage(d).read_version(b, k, "").erasure), parts)
        out[(b, k)] = (pool, b"".join(bytes(c) for c in it), oi.etag, oi.content_type,
                       oi.user_defined, drives)
    return out


def _finish(pm, st, timeout=60):
    """``st`` once the drain thread is gone (its checkpoint written)."""
    deadline = time.monotonic() + timeout
    while pm._active and time.monotonic() < deadline:
        time.sleep(0.01)
    return st


def _persisted(dstat) -> dict:
    return {k: v for k, v in dstat.to_persist().items()
            if k not in ("started", "updated", "finished")}


def _empty(root, pool) -> bool:
    return not any(os.listdir(os.path.join(d, b)) for d in _drives(root, pool) for b in BUCKETS)


@pytest.mark.parametrize("family", ["reedsolomon", "cauchy"])
def test_decommission_matches_reference(golden, tmp_path, monkeypatch, family):
    monkeypatch.setenv("MINIO_TPU_EC_FAMILY", family)  # the re-PUTs' write family
    roots = _copies(golden, tmp_path)
    res = {}
    for pkg, root in roots.items():
        decom = PKGS[pkg][3]
        sp = _store(pkg, root)
        pm = decom.PoolManager(sp)
        st = _finish(pm, pm.start_decommission(0))
        assert st.state == "complete" and st.failed == 0 and st.objects_moved == len(OBJECTS)
        assert st.bytes_moved == sum(size for size, _ in OBJECTS.values())
        assert sp.draining == {0}
        assert _empty(root, 0)
        with pytest.raises(ValueError):
            PKGS[pkg][5](sp, 0)  # pool 0 anchors .minio.sys: never detached online
        ckpt = decom.PoolManager(sp).load_checkpoint(0)
        res[pkg] = (_objects(pkg, sp, root), _persisted(ckpt), ckpt)
    assert res["port"][0] == res["ref"][0]
    assert res["port"][1] == res["ref"][1]
    for (b, k), got in res["port"][0].items():
        assert got[0] == 1 and got[1] == _body((b, k)) and got[4]["x-amz-meta-color"] == "blue"
        assert {e["algorithm"] for e, _ in got[5].values()} == {family}
    # each package reads the other's checkpoint document
    ref_sp, port_sp = _store("ref", roots["port"]), _store("port", roots["ref"])
    assert _persisted(decommission.PoolManager(port_sp).load_checkpoint(0)) == res["ref"][1]
    assert _persisted(ref_decom.PoolManager(ref_sp).load_checkpoint(0)) == res["port"][1]
    assert set(res["port"][2].to_persist()) == set(res["ref"][2].to_persist())


def test_checkpoint_written_by_reference_is_resumed_by_port(golden, tmp_path):
    roots = _copies(golden, tmp_path)
    ordered = None
    for pkg, root in roots.items():
        # the reference drains three objects and checkpoints its cursor,
        # as a drain interrupted there would have
        sp = _store("ref", root)
        src, dst = sp.pools
        ordered = [(b.name, raw) for b in src.list_buckets() for raw in src.walk_objects(b.name)]
        moved = sum(ref_decom.PoolManager._move_object(src, dst, b, k) for b, k in ordered[:3])
        ref_decom.PoolManager(sp)._save(ref_decom.DecomStatus(
            0, state="draining", objects_moved=3, bytes_moved=moved,
            last_object="/".join(ordered[2]), started=1.0))
        # resumed by this package from the same drives
        decom = PKGS[pkg][3]
        sp = _store(pkg, root)
        pm = decom.PoolManager(sp)
        st = _finish(pm, pm.start_decommission(0))
        assert (st.state, st.failed, st.objects_moved) == ("complete", 0, len(OBJECTS))
        assert st.started == 1.0  # the resumed drain keeps its start
        assert st.last_object == "/".join(ordered[-1])
        assert _empty(root, 0)
    port, ref = _store("port", roots["port"]), _store("ref", roots["ref"])
    assert _objects("port", port, roots["port"]) == _objects("ref", ref, roots["ref"])
    assert _persisted(decommission.PoolManager(port).load_checkpoint(0)) == \
        _persisted(ref_decom.PoolManager(ref).load_checkpoint(0))


def test_cancelled_drain_restarts_and_completes(golden, tmp_path):
    roots = _copies(golden, tmp_path)
    for pkg, root in roots.items():
        decom, flt = PKGS[pkg][3], PKGS[pkg][4]
        sp = _store(pkg, root)
        pm = decom.PoolManager(sp)
        flt.inject({"boundary": "topology", "mode": "latency", "target": "pool-0", "op": "move",
                    "latency_ms": 40})
        st = pm.start_decommission(0)
        deadline = time.monotonic() + 30
        while st.objects_moved < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        pm.cancel_decommission(0)
        while pm._active and time.monotonic() < deadline:
            time.sleep(0.005)
        first = st.objects_moved
        assert st.state == "canceled" and 2 <= first < len(OBJECTS)
        assert sp.draining == set()  # takes new objects again
        assert decom.PoolManager(sp).load_checkpoint(0).state == "canceled"
        flt.clear()
        st = _finish(pm, pm.start_decommission(0))
        assert (st.state, st.failed) == ("complete", 0)
        assert first + st.objects_moved == len(OBJECTS)  # a restart, not a resume
        assert _empty(root, 0)
    port, ref = _store("port", roots["port"]), _store("ref", roots["ref"])
    assert _objects("port", port, roots["port"]) == _objects("ref", ref, roots["ref"])


def _rebalance(pkg, root, mode):
    decom = PKGS[pkg][3]
    sp = _store(pkg, root)
    sp.placement.set_rule({"bucket": "dec-a", "prefix": "a/", "mode": "pin", "pools": [0]})
    pm = decom.PoolManager(sp)
    spread0 = pm.data_spread_pct(pm.pool_data_usage())
    if mode == "bounded":
        out = pm.start_rebalance(max_objects=100)
    else:
        pm.start_rebalance_continuous(threshold_pct=10.0)
        deadline = time.monotonic() + 60
        while pm.rebalance_status()["state"] == "running" and time.monotonic() < deadline:
            time.sleep(0.01)
        out = {k: v for k, v in pm.rebalance_status().items()
               if k not in ("started", "updated", "throughput_mibps", "eta_s")}
    usage = [{k: u[k] for k in ("pool", "objects", "bytes")} for u in pm.pool_data_usage()]
    return sp, spread0, out, usage


@pytest.mark.parametrize("mode", ["bounded", "continuous"])
def test_rebalance_matches_reference_and_keeps_pins(golden, tmp_path, mode):
    roots = _copies(golden, tmp_path)
    res = {}
    for pkg, root in roots.items():
        sp, spread0, out, usage = _rebalance(pkg, root, mode)
        assert spread0 == 100.0
        assert out["moved"] > 0 and out["failed"] == 0 and out["skipped_pinned"] >= 2
        assert _holder(sp, "dec-a", "a/inline") == _holder(sp, "dec-a", "a/one") == 0
        res[pkg] = (out, usage, {key: _holder(sp, *key) for key in OBJECTS},
                    _objects(pkg, sp, root))
    assert res["port"] == res["ref"]
    if mode == "continuous":
        assert res["port"][0]["state"] == "done"


def test_writer_wins_a_raced_move(golden, tmp_path):
    key = ("dec-a", "b/multi")
    new = _data(99, 400_000)
    roots = _copies(golden, tmp_path)
    seen = {}
    for pkg, root in roots.items():
        decom = PKGS[pkg][3]
        sp = _store(pkg, root)
        src, dst = sp.pools
        staged = dst.put_object

        def put(bucket, raw, data, *a, _src=src, _staged=staged, **kw):
            out = _staged(bucket, raw, data, *a, **kw)
            if (bucket, raw) == key and data != new:
                _src.put_object(bucket, raw, new)  # a writer lands mid-move
            return out

        dst.put_object = put
        # one move alone: the staged copy is withdrawn, the writer's
        # version stays in the source
        assert decom.PoolManager._move_object(src, dst, *key) == 0
        assert _holder(sp, *key) == 0
        oi, it = sp.get_object(*key)
        assert b"".join(bytes(c) for c in it) == new
        # a drain retries the raced object and moves the fresh version
        src.put_object(*key, _body(key))
        pm = decom.PoolManager(sp)
        st = _finish(pm, pm.start_decommission(0))
        assert (st.state, st.failed, st.objects_moved) == ("complete", 0, len(OBJECTS))
        oi, it = sp.get_object(*key)
        seen[pkg] = (_holder(sp, *key), b"".join(bytes(c) for c in it), oi.etag)
        assert _empty(root, 0)
    assert seen["port"] == seen["ref"]
    assert seen["port"][:2] == (1, new)
