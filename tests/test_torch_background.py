"""minio_tpu_torch background durability plane against the JAX package, on
the CPU.

A 16-drive set at EC 8+8 holds a reedsolomon object of four full stripe
blocks (the device heal's minimum), a cauchy object and an inline object,
in two buckets. Each package works on its own copy of the same drives
(formats minted once, so drive identities agree):

- the fresh-drive monitor's drain heal after a drive is wiped, after an
  interrupted drain left its tracker, and after a drive was replaced
  while the server was down, with ``MINIO_TPU_DEVICE_HEAL`` 0 and 1 (1
  sends the port's reedsolomon heal through the fused decode's plain
  version): the refilled drives are byte-identical to each other and to
  the drive before the wipe, ``xl.meta`` and ``format.json`` included;
- a drive refilled by one package reads back through the other;
- MRF: a degraded GET queues the object and the heal workers rebuild the
  lost shards, byte for byte as before;
- the deep-verify scan heals flipped bytes in a parity shard, and both
  packages' ``DataUsage`` snapshots agree;
- ``MRFQueue`` dedupes and stays bounded alike.

The reference always heals on the host; every comparison is exact.
"""

import os
import shutil
import time

import numpy as np
import pytest

from minio_tpu.erasure.background import BackgroundOps as RefBackground
from minio_tpu.erasure.background import MRFQueue as RefMRFQueue
from minio_tpu.erasure.pools import ServerPools as RefPools
from minio_tpu.erasure.set import ErasureSet as RefSet
from minio_tpu.erasure.sets import ErasureSets as RefSets
from minio_tpu.storage import format_erasure as ref_fe
from minio_tpu.storage.xlstorage import XLStorage as RefStorage
from minio_tpu_torch.erasure.background import BackgroundOps, MRFQueue
from minio_tpu_torch.erasure.pools import ServerPools
from minio_tpu_torch.erasure.set import ErasureSet
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.ops import bitrot_torch
from minio_tpu_torch.storage import format_erasure as fe
from minio_tpu_torch.storage.xlstorage import SYS_DIR, XLStorage

MIB = 1 << 20
VICTIM = 5
OBJECTS = {  # (bucket, key) -> (size, family)
    ("bkt-a", "rs/obj"): (4 * MIB + 5, "reedsolomon"),
    ("bkt-a", "cauchy/obj"): (2 * MIB + 3, "cauchy"),
    ("bkt-b", "inline"): (1000, "reedsolomon"),
    ("bkt-b", "rs/two"): (4 * MIB + 77, "reedsolomon"),
}
BUCKETS = ("bkt-a", "bkt-b")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MINIO_TPU_CACHE", "0")  # every GET reads the drives
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    monkeypatch.setenv("MINIO_TPU_DEVICE_HEAL", "0")
    monkeypatch.setenv("MINIO_TPU_DECODE_MIN_SHARDS", "16")


def _data(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _drives(root, n=16):
    return [os.path.join(str(root), f"d{i}") for i in range(n)]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Drives written once by the JAX package (formats minted), copied
    per test."""
    root = tmp_path_factory.mktemp("golden")
    prev = os.environ.get("MINIO_TPU_BACKEND")
    os.environ["MINIO_TPU_BACKEND"] = "numpy"  # restored below
    try:
        disks = [RefStorage(p) for p in _drives(root)]
        _, grouped = ref_fe.init_or_load_formats(disks, 16)
        ref = RefSet(grouped[0], default_parity=8)
        for b in BUCKETS:
            ref.make_bucket(b)
        for i, ((b, k), (size, fam)) in enumerate(OBJECTS.items()):
            ref.put_object(b, k, _data(i, size), family=fam)
    finally:
        if prev is None:
            os.environ.pop("MINIO_TPU_BACKEND", None)
        else:
            os.environ["MINIO_TPU_BACKEND"] = prev
    return str(root)


def _copy(golden, dst) -> list[str]:
    shutil.copytree(golden, str(dst))
    return _drives(dst)


def _tree(drive) -> dict:
    """relative path -> bytes of the user buckets' files and format.json."""
    out = {}
    for sub in (*BUCKETS, os.path.join(SYS_DIR, "format.json")):
        p = os.path.join(drive, sub)
        if os.path.isfile(p):
            out[sub] = open(p, "rb").read()
        for dp, _, fs in os.walk(p):
            for f in fs:
                q = os.path.join(dp, f)
                out[os.path.relpath(q, drive)] = open(q, "rb").read()
    return out


def _read(store, bucket, key) -> bytes:
    _, it = store.get_object(bucket, key)
    return b"".join(bytes(c) for c in it)


PKGS = {
    "ref": (RefStorage, ref_fe, RefSet, RefBackground),
    "port": (XLStorage, fe, ErasureSet, BackgroundOps),
}


def _open(pkg, drives):
    storage, fmt, set_cls, _ = PKGS[pkg]
    disks = [storage(p) for p in drives]
    _, grouped = fmt.init_or_load_formats(disks, 16)
    return set_cls(grouped[0], default_parity=8)


def _drain(pkg, drives, scenario):
    """One package's set over ``drives``, the victim drive lost as
    ``scenario`` says, and one fresh-drive monitor pass. Returns the
    pass's stats."""
    _, fmt, _, bg_cls = PKGS[pkg]
    es = _open(pkg, drives)
    victim = drives[VICTIM]
    if scenario in ("wiped", "replaced"):
        shutil.rmtree(victim)
        os.makedirs(victim)
    if scenario == "replaced":  # the server restarts onto the blank drive
        es = _open(pkg, drives)
        assert es.disks[VICTIM].read_file(SYS_DIR, fmt.HEALING_TRACKER)
    if scenario == "resumed":  # bkt-a was done before the interruption
        shutil.rmtree(os.path.join(victim, "bkt-b"))
        es.disks[VICTIM].create_file(SYS_DIR, fmt.HEALING_TRACKER,
                                     b'{"started": 1.0, "buckets_done": ["bkt-a"]}')
    bg = bg_cls(es, scan_interval=0)
    assert bg.check_fresh_disks() == 1
    assert bg.check_fresh_disks() == 0  # the tracker is gone: nothing to resume
    with pytest.raises(Exception):
        es.disks[VICTIM].read_file(SYS_DIR, fmt.HEALING_TRACKER)
    return bg.stats


@pytest.mark.parametrize("device_heal", ["0", "1"])
@pytest.mark.parametrize("scenario", ["wiped", "resumed", "replaced"])
def test_fresh_drive_drain_heal_matches_reference(golden, tmp_path, monkeypatch, scenario,
                                                  device_heal):
    before = _tree(os.path.join(golden, f"d{VICTIM}"))
    ref_drives, port_drives = _copy(golden, tmp_path / "a"), _copy(golden, tmp_path / "b")
    want = _drain("ref", ref_drives, scenario)
    monkeypatch.setenv("MINIO_TPU_DEVICE_HEAL", device_heal)
    if device_heal == "1":
        monkeypatch.setenv("MINIO_TPU_BACKEND", "torch")  # the port's device route
    fused = bitrot_torch.decode_stats["fused"]
    got = _drain("port", port_drives, scenario)
    assert got == want
    assert got["heals_failed"] == 0 and got["fresh_disks_healed"] == 1
    healed_rs = 2 if scenario != "resumed" else 1  # rs/obj sits in bkt-a
    assert bitrot_torch.decode_stats["fused"] - fused == (healed_rs if device_heal == "1" else 0)
    ref_tree, port_tree = _tree(ref_drives[VICTIM]), _tree(port_drives[VICTIM])
    assert sorted(port_tree) == sorted(before)
    for path, data in before.items():
        assert port_tree[path] == data, path
        assert ref_tree[path] == data, path


@pytest.mark.parametrize("healer", ["port", "ref"])
def test_drained_drive_reads_back_through_the_other_package(golden, tmp_path, healer):
    drives = _copy(golden, tmp_path / "x")
    _drain(healer, drives, "wiped")
    # only the refilled drive and 7 others left: every read needs its shard
    for d in [d for i, d in enumerate(drives) if i != VICTIM][7:]:
        for b, k in OBJECTS:
            shutil.rmtree(os.path.join(d, b, k))
    reader = _open("ref" if healer == "port" else "port", drives)
    for i, ((b, k), (size, _)) in enumerate(OBJECTS.items()):
        assert _read(reader, b, k) == _data(i, size)


@pytest.mark.parametrize("key", [("bkt-a", "rs/obj"), ("bkt-a", "cauchy/obj")])
def test_mrf_heals_after_a_degraded_get(golden, tmp_path, key):
    size = OBJECTS[key][0]
    body = _data(list(OBJECTS).index(key), size)
    trees = {}
    for pkg, sub in (("ref", "a"), ("port", "b")):
        drives = _copy(golden, tmp_path / sub)
        es = _open(pkg, drives)
        before = {i: _tree(d) for i, d in enumerate(drives)}
        bg = PKGS[pkg][3](es, scan_interval=0, heal_workers=1)
        es.on_degraded = bg.mrf.add
        bg.start(scanner=False)
        try:
            for d in drives[:8]:
                shutil.rmtree(os.path.join(d, *key))
            assert _read(es, *key) == body
            deadline = time.monotonic() + 60
            while bg.stats["heals_done"] < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            bg.stop()
            for th in bg._threads:
                th.join(timeout=5)
        assert bg.stats["heals_done"] == 1 and bg.stats["heals_failed"] == 0
        assert len(bg.mrf) == 0
        after = {i: _tree(d) for i, d in enumerate(drives)}
        assert after == before
        trees[pkg] = after
    assert trees["port"] == trees["ref"]


def test_deep_scan_heals_parity_and_usage_agrees(tmp_path):
    """ServerPools over 2 sets of 4 drives (EC 2+2): the scanner probes
    each key's set in every pool; one parity shard of one object has its
    first bytes flipped in both copies."""
    dep = "5b2e7c1a-3d4f-4a8b-9c6d-2e1f0a9b8c7d"

    def rows(root):
        return [[str(tmp_path / root / f"s{s}d{i}") for i in range(4)] for s in range(2)]

    ref = RefPools([RefSets([[RefStorage(p) for p in r] for r in rows("a")], deployment_id=dep,
                            default_parity=2)])
    bodies = {}
    for b in ("deep-a", "deep-b"):
        ref.make_bucket(b)
        for i in range(5):
            bodies[(b, f"k{i}")] = _data(100 + i + len(b), 300_000 + 70_000 * i)
            ref.put_object(b, f"k{i}", bodies[(b, f"k{i}")],
                           family="cauchy" if i % 2 else "reedsolomon")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    key = ("deep-a", "k3")
    pool = ref.pools[0]
    set_idx = pool.sets.index(pool.get_hashed_set(key[1]))
    dist = RefStorage(rows("a")[set_idx][0]).read_version(*key, "").erasure.distribution
    originals = {}
    for root in ("a", "b"):
        drive = rows(root)[set_idx][dist.index(3)]  # erasure index 3: a parity shard
        part = next(os.path.join(dp, "part.1") for dp, _, fs in os.walk(os.path.join(drive, *key))
                    if "part.1" in fs)
        originals[root] = (part, open(part, "rb").read())
        with open(part, "r+b") as fh:
            fh.write(bytes(x ^ 0xFF for x in originals[root][1][:64]))
    port = ServerPools([ErasureSets([[XLStorage(p) for p in r] for r in rows("b")],
                                    deployment_id=dep, default_parity=2)])
    snaps, stats = {}, {}
    for name, store, cls in (("ref", ref, RefBackground), ("port", port, BackgroundOps)):
        bg = cls(store, scan_interval=0, object_sleep=0, deep_verify=True)
        snap = bg.scan_once().snapshot()
        snaps[name] = {k: v for k, v in snap.items() if k != "lastUpdate"}
        stats[name] = bg.stats
    assert snaps["port"] == snaps["ref"]
    assert stats["port"] == stats["ref"]
    assert snaps["port"]["objectsCount"] == 10
    assert snaps["port"]["objectsTotalSize"] == sum(len(v) for v in bodies.values())
    for part, data in originals.values():
        assert open(part, "rb").read() == data
    for (b, k), body in bodies.items():
        assert _read(port, b, k) == body


def test_mrf_queue_dedupes_and_stays_bounded():
    out = {}
    for name, cls in (("ref", RefMRFQueue), ("port", MRFQueue)):
        q = cls(maxsize=3)
        trace = []
        for item in [("b", "x"), ("b", "x"), ("b", "y"), ("c", "x"), ("b", "z"), ("b", "y")]:
            q.add(*item)
            trace.append(len(q))
        trace.append(q.get(0.01))
        q.add("b", "x")  # taken off the queue: may queue again
        q.add("b", "w")
        trace.append(len(q))
        while (item := q.get(0.01)) is not None:
            trace.append(item)
        trace.append(q.get(0.01))
        out[name] = trace
    assert out["port"] == out["ref"]
    assert out["port"][:6] == [1, 1, 2, 3, 3, 3]
