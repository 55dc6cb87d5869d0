"""minio_tpu_torch top-level object layer on the CPU: ``ServerPools`` over
one pool of 2 erasure sets of 4 drives (EC 2+2), for both code families.

- the port alone: PUT, GET, degraded GET, heal (cauchy: the sub-chunk
  partial repair) and a 3-part multipart upload through ``MultipartRouter``;
- drives shared with the JAX package in both directions: what one
  package's ``ServerPools`` wrote is listed, read, degraded-read, healed
  and multipart-completed through the other's, compared by object bytes,
  ETags, ``part.N`` shard files and ``ErasureInfo.algorithm``; a key hashes
  to the same set in both packages.

Host-plane writes use ``MINIO_TPU_BACKEND=numpy``. The cauchy PUT of the
port-writes test runs with ``MINIO_TPU_BACKEND=torch``, so its full blocks
go through the dispatcher, K3's and K2's plain versions. Every comparison
is byte-exact.
"""

import dataclasses
import hashlib
import os
import shutil

import numpy as np
import pytest

from minio_tpu.erasure import coder as ref_coder
from minio_tpu.erasure import listing as ref_listing
from minio_tpu.erasure.multipart import MultipartRouter as RefRouter
from minio_tpu.erasure.pools import ServerPools as RefPools
from minio_tpu.erasure.sets import ErasureSets as RefSets
from minio_tpu.storage.xlstorage import XLStorage as RefStorage
from minio_tpu_torch.erasure import coder, listing
from minio_tpu_torch.erasure.multipart import MultipartRouter
from minio_tpu_torch.erasure.pools import ServerPools
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.parallel import dispatcher
from minio_tpu_torch.storage.xlstorage import XLStorage

MIB = 1 << 20
DEP = "7c3e1b2a-9d4f-4e8a-b6c5-0f1e2d3c4b5a"
FAMILIES = ["cauchy", "reedsolomon"]
BUCKET = "pools"
PART_SIZES = [MIB + 3, MIB + 5, 1000]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MINIO_TPU_CACHE", "0")  # every GET reads the drives
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    monkeypatch.setenv("MINIO_TPU_EC_REPAIR", "1")


def _data(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _drives(root):
    return [[os.path.join(str(root), f"s{s}d{i}") for i in range(4)] for s in range(2)]


def _port(root):
    return ServerPools([ErasureSets([[XLStorage(p) for p in row] for row in _drives(root)],
                                    deployment_id=DEP, default_parity=2)])


def _ref(root):
    return RefPools([RefSets([[RefStorage(p) for p in row] for row in _drives(root)],
                             deployment_id=DEP, default_parity=2)])


def _set_drives(store, root, key):
    pool = store.pools[0]
    return _drives(root)[pool.sets.index(pool.get_hashed_set(key))]


def _read(store, key) -> bytes:
    _, it = store.get_object(BUCKET, key)
    return b"".join(bytes(c) for c in it)


def _files(drive, key) -> dict:
    root = os.path.join(drive, BUCKET, key)
    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            if f.startswith("part."):
                with open(os.path.join(dp, f), "rb") as fh:
                    out[f] = fh.read()
    return out


def _drop(drives, idxs, key):
    for i in idxs:
        shutil.rmtree(os.path.join(drives[i], BUCKET, key), ignore_errors=True)


def _data_drive(store, key, shard=0):
    """Index (within its set) of the drive holding erasure shard ``shard``."""
    dist = store.pools[0].get_hashed_set(key).disks[0].read_version(BUCKET, key, "") \
        .erasure.distribution
    return dist.index(shard + 1)


def _multipart(router, key, parts):
    uid = router.new_upload(BUCKET, key)
    etags = [(i + 1, router.put_part(BUCKET, key, uid, i + 1, p)) for i, p in enumerate(parts)]
    return uid, etags


def _mp_etag(parts) -> str:
    md5s = b"".join(hashlib.md5(p).digest() for p in parts)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"


def _listed(listing_mod, store):
    res = listing_mod.list_objects(store, BUCKET, max_keys=100)
    return sorted((o.name, o.etag, o.size) for o in res.objects)


def test_key_hashes_to_the_same_set_in_both_packages(tmp_path):
    port, ref = _port(tmp_path / "a"), _ref(tmp_path / "b")
    idx = [[s.pools[0].sets.index(s.pools[0].get_hashed_set(f"k/{i}")) for i in range(64)]
           for s in (port, ref)]
    assert idx[0] == idx[1] and set(idx[0]) == {0, 1}


@pytest.mark.parametrize("family", FAMILIES)
def test_port_pools_roundtrip(tmp_path, monkeypatch, family):
    monkeypatch.setenv("MINIO_TPU_EC_FAMILY", family)
    sp = _port(tmp_path)
    sp.make_bucket(BUCKET)
    data = _data(1, 2 * MIB + 5)
    oi = sp.put_object(BUCKET, "obj", data)
    assert oi.etag == hashlib.md5(data).hexdigest()
    assert _read(sp, "obj") == data
    drives = _set_drives(sp, tmp_path, "obj")
    original = [_files(p, "obj") for p in drives]
    assert all(original)
    _drop(drives, [1, 2], "obj")
    assert _read(sp, "obj") == data
    for i in (1, 2):
        assert not _files(drives[i], "obj")
    healed = sp.heal_object(BUCKET, "obj")
    assert len(healed["healed"]) == 2
    assert [_files(p, "obj") for p in drives] == original
    # one data shard lost: the cauchy family repairs it from sub-chunks
    lost = _data_drive(sp, "obj")
    _drop(drives, [lost], "obj")
    before = coder.family_stats_snapshot()[family]
    assert len(sp.heal_object(BUCKET, "obj")["healed"]) == 1
    after = coder.family_stats_snapshot()[family]
    assert _files(drives[lost], "obj") == original[lost]
    ingress = after["heal_ingress_bytes"] - before["heal_ingress_bytes"]
    assert ingress > 0
    if family == "cauchy":
        # (at 2+2 the sub-chunk plan reads as much as two whole shards;
        # the saving shows at 8+8, checked on the card)
        assert after["repair_partial_blocks"] > before["repair_partial_blocks"]
    parts = [_data(10 + i, n) for i, n in enumerate(PART_SIZES)]
    router = MultipartRouter(sp)
    uid, etags = _multipart(router, "mp", parts)
    oi = router.complete(BUCKET, "mp", uid, etags)
    assert oi.etag == _mp_etag(parts) and oi.parts == 3
    assert _read(sp, "mp") == b"".join(parts)
    mp_drives = _set_drives(sp, tmp_path, "mp")
    assert sorted(_files(mp_drives[0], "mp")) == ["part.1", "part.2", "part.3"]
    _drop(mp_drives, [0, 3], "mp")
    assert _read(sp, "mp") == b"".join(parts)
    alg = XLStorage(mp_drives[1]).read_version(BUCKET, "mp", "").erasure.algorithm
    assert alg == family


@pytest.mark.parametrize("family", FAMILIES)
def test_interop_jax_writes_port_reads_heals_completes(tmp_path, monkeypatch, family):
    monkeypatch.setenv("MINIO_TPU_EC_FAMILY", family)
    ref = _ref(tmp_path)
    ref.make_bucket(BUCKET)
    objs = {f"o{i}": _data(20 + i, MIB * (i + 1) + 7 * i) for i in range(3)}
    etags = {k: ref.put_object(BUCKET, k, v).etag for k, v in objs.items()}
    parts = [_data(30 + i, n) for i, n in enumerate(PART_SIZES)]
    uid, part_etags = _multipart(RefRouter(ref), "mp", parts)

    port = _port(tmp_path)
    assert _listed(listing, port) == _listed(ref_listing, ref)
    for k, v in objs.items():
        assert port.get_object_info(BUCKET, k).etag == etags[k]
        assert _read(port, k) == v
    # the upload the JAX package started is completed by the port
    oi = MultipartRouter(port).complete(BUCKET, "mp", uid, part_etags)
    assert oi.etag == _mp_etag(parts)
    assert _read(ref, "mp") == _read(port, "mp") == b"".join(parts)
    for k in list(objs) + ["mp"]:
        drives = _set_drives(port, tmp_path, k)
        original = [_files(p, k) for p in drives]
        lost = _data_drive(port, k)
        _drop(drives, [lost, (lost + 1) % 4], k)
        want = objs.get(k, b"".join(parts))
        assert _read(port, k) == want
        assert len(port.heal_object(BUCKET, k)["healed"]) == 2
        assert [_files(p, k) for p in drives] == original
        _drop(drives, [lost], k)
        before = ref_coder.family_stats_snapshot()[family]
        assert len(ref.heal_object(BUCKET, k)["healed"]) == 1  # and back through the JAX package
        if family == "cauchy":
            after = ref_coder.family_stats_snapshot()[family]
            assert after["repair_partial_blocks"] > before["repair_partial_blocks"]
        assert [_files(p, k) for p in drives] == original
        for p in drives:
            assert XLStorage(p).read_version(BUCKET, k, "").erasure.algorithm == family


@pytest.mark.parametrize("family", FAMILIES)
def test_interop_port_writes_jax_reads_heals_completes(tmp_path, monkeypatch, family):
    monkeypatch.setenv("MINIO_TPU_EC_FAMILY", family)
    port = _port(tmp_path / "p")
    port.make_bucket(BUCKET)
    data = _data(40, 3 * MIB + 11)
    served = sum(d.stats_snapshot()["blocks"] for d in dispatcher._dispatchers.values())
    if family == "cauchy":
        # the device route: 3 full blocks through the dispatcher (K3 + K2)
        monkeypatch.setenv("MINIO_TPU_BACKEND", "torch")
    etag = port.put_object(BUCKET, "obj", data).etag
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    if family == "cauchy":
        assert sum(d.stats_snapshot()["blocks"] for d in dispatcher._dispatchers.values()) \
            == served + 3
    parts = [_data(50 + i, n) for i, n in enumerate(PART_SIZES)]
    uid, part_etags = _multipart(MultipartRouter(port), "mp", parts)
    # the same writes through the JAX package on twin drives
    twin = _ref(tmp_path / "r")
    twin.make_bucket(BUCKET)
    assert twin.put_object(BUCKET, "obj", data).etag == etag
    drives = _set_drives(port, tmp_path / "p", "obj")
    twin_drives = _set_drives(twin, tmp_path / "r", "obj")
    assert drives[0].replace(str(tmp_path / "p"), "") == twin_drives[0].replace(
        str(tmp_path / "r"), "")
    for a, b in zip(drives, twin_drives):
        assert _files(a, "obj") == _files(b, "obj")
        ea = dataclasses.asdict(XLStorage(a).read_version(BUCKET, "obj", "").erasure)
        eb = dataclasses.asdict(RefStorage(b).read_version(BUCKET, "obj", "").erasure)
        assert ea == eb and ea["algorithm"] == family

    ref = _ref(tmp_path / "p")
    assert _listed(ref_listing, ref) == _listed(listing, port)
    assert ref.get_object_info(BUCKET, "obj").etag == etag
    assert _read(ref, "obj") == data
    # the upload the port started is completed by the JAX package
    oi = RefRouter(ref).complete(BUCKET, "mp", uid, part_etags)
    assert oi.etag == _mp_etag(parts)
    assert _read(port, "mp") == b"".join(parts)
    for k, want in (("obj", data), ("mp", b"".join(parts))):
        ds = _set_drives(port, tmp_path / "p", k)
        original = [_files(p, k) for p in ds]
        lost = _data_drive(port, k)
        _drop(ds, [lost, (lost + 2) % 4], k)
        assert _read(ref, k) == want
        assert len(ref.heal_object(BUCKET, k)["healed"]) == 2
        assert [_files(p, k) for p in ds] == original
        _drop(ds, [lost], k)
        assert len(port.heal_object(BUCKET, k)["healed"]) == 1
        assert [_files(p, k) for p in ds] == original
        assert _read(port, k) == want
