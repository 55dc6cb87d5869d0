"""Served traffic on the port's device route: the counterpart of the
reference's ``tests/test_tpu_served.py`` (which skips off a TPU).

The port's S3 server (router, SigV4 auth, erasure set, dispatcher) over 4
drives at EC 2+2 carries concurrent PUTs into the fused encode + hash
(K1), degraded GETs into the fused decode, heals through the device
route, and multipart uploads; the kernel half runs the decode
failure-pattern matrix and the batch-padding edges. The reference's
shapes and assertions, on routes and counters. Here the port runs on its
CPU rung (``MINIO_TPU_BACKEND=torch``, ``MINIO_TPU_TORCH_DEVICE=cpu``: the
kernels' plain versions); ``chip_smoke.py`` runs the same cases on the
card, which is why each case is a plain function of its rig and this
module imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import pytest

N_OBJECTS = 32
OBJ_SIZE = 2 << 20  # 2 full stripe blocks per object on EC 2+2
BUCKET = "tpu-traffic"
RIG_ENV = {
    "MINIO_TPU_BACKEND": "torch",
    "MINIO_TPU_SCAN_INTERVAL": "0",
    # the device-decode floor (64 shards a dispatch) is batching
    # economics, not a correctness gate: at EC 2+2 and 2-block objects,
    # 8 lets degraded GETs reach the fused decode
    "MINIO_TPU_DECODE_MIN_SHARDS": "8",
    "MINIO_COMPRESSION_ENABLE": "off",
}
# (d, p, losses) of the decode matrix (the reference's, ids ec2+2 ...)
DECODE_MATRIX = [
    (2, 2, [(1,), (2,), (1, 2), (0, 3)]),
    (4, 2, [(0,), (5,), (1, 4), (2, 3)]),
    (6, 3, [(0,), (7,), (1, 6), (0, 3, 8), (1, 2, 4)]),
    (8, 8, [(2,), (9,), (0, 8), (1, 2, 3, 4), (0, 2, 9, 11, 13, 15), (0, 1, 2, 3, 4, 5, 6, 7)]),
]
PADDING_EDGES = [15, 17]


def mkdata(i: int) -> bytes:
    return np.random.default_rng(1000 + i).integers(0, 256, size=OBJ_SIZE,
                                                    dtype=np.uint8).tobytes()


def make_rig(base: str) -> dict:
    """The port's server in process over 4 drives under ``base`` (the
    environment set by the caller: RIG_ENV and the device), with its
    bucket made; ``stop_rig`` ends it."""
    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server import web
    from minio_tpu_torch.server.app import make_server

    drives = [os.path.join(base, f"d{i}") for i in range(4)]
    srv = make_server(drives)
    port, stop = web.serve_in_thread(srv.app)
    cli = S3Client(f"127.0.0.1:{port}")
    assert cli.make_bucket(BUCKET).status == 200
    return {"srv": srv, "stop": stop, "cli": cli, "etags": {}, "drives": drives}


def stop_rig(rig: dict) -> None:
    rig["srv"].close()
    rig["stop"]()


def _dispatch_snapshot() -> dict:
    from minio_tpu_torch.parallel.dispatcher import _dispatchers

    ds = list(_dispatchers.values())
    return {"blocks": sum(d.stats["blocks"] for d in ds),
            "fused": sum(d.stats.get("fused", 0) for d in ds),
            "failures": sum(d.stats.get("fused_failures", 0) for d in ds),
            "max_batch": max((d.stats["max_batch"] for d in ds), default=0)}


def concurrent_puts_ride_fused_kernel(rig: dict) -> dict:
    """32 concurrent PUTs: every object lands with the md5 ETag, and the
    dispatcher's counters show the fused kernel carried the stripe blocks,
    batched across requests."""
    cli = rig["cli"]
    before = _dispatch_snapshot()
    results: dict[int, tuple[int, str]] = {}

    def put(i: int):
        r = cli.put_object(BUCKET, f"obj-{i}", mkdata(i))
        results[i] = (r.status, r.headers.get("etag", "").strip('"'))

    threads = [threading.Thread(target=put, args=(i,)) for i in range(N_OBJECTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(N_OBJECTS):
        status, etag = results[i]
        assert status == 200, f"obj-{i} -> {status}"
        want = hashlib.md5(mkdata(i)).hexdigest()
        assert etag == want, f"obj-{i} etag {etag} != md5 {want}"
        rig["etags"][i] = etag
    after = _dispatch_snapshot()
    assert after["blocks"] - before["blocks"] >= N_OBJECTS * 2, after
    assert after["fused"] > before["fused"], f"fused kernel never engaged: {before} -> {after}"
    assert after["failures"] == before["failures"], f"kernel failures: {before} -> {after}"
    # each PUT submits 2 blocks, so a batch of 4 or more spans requests
    assert after["max_batch"] >= 4, f"no cross-request batching: {before} -> {after}"
    return after


def served_get_roundtrip(rig: dict) -> None:
    """Every object reads back byte-identical through the full stack."""
    cli = rig["cli"]
    for i in range(0, N_OBJECTS, 5):
        r = cli.get_object(BUCKET, f"obj-{i}")
        assert r.status == 200
        assert r.body == mkdata(i), f"obj-{i} corrupt"
        assert r.headers.get("etag", "").strip('"') == rig["etags"].get(
            i, hashlib.md5(mkdata(i)).hexdigest())


def degraded_get_rides_decode_kernel(rig: dict) -> dict:
    """One drive's bucket gone: GETs reconstruct through the fused decode
    and return the right bytes."""
    from minio_tpu_torch.ops.bitrot_torch import decode_stats

    cli = rig["cli"]
    victim = os.path.join(rig["drives"][1], BUCKET)
    shutil.rmtree(victim)
    os.mkdir(victim)
    before = dict(decode_stats)
    for i in range(0, N_OBJECTS, 4):
        r = cli.get_object(BUCKET, f"obj-{i}")
        assert r.status == 200 and r.body == mkdata(i), f"degraded obj-{i}"
    assert decode_stats["fused"] > before["fused"], decode_stats
    assert decode_stats["failures"] == before["failures"], decode_stats
    return dict(decode_stats)


def heal_rebuilds_on_device(rig: dict) -> dict:
    """The admin heal rebuilds what the degraded case removed (device heal
    on); reads then survive losing another drive."""
    prev = os.environ.get("MINIO_TPU_DEVICE_HEAL")
    os.environ["MINIO_TPU_DEVICE_HEAL"] = "1"
    try:
        cli = rig["cli"]
        r = cli.request("POST", f"/minio/admin/v3/heal/{BUCKET}")
        assert r.status == 200, r.body
        out = json.loads(r.body)
        assert len(out["healed"]) >= 1 and out["failed"] == 0, out
        other = os.path.join(rig["drives"][2], BUCKET)
        shutil.rmtree(other)
        os.mkdir(other)
        for i in (0, 8, 16):
            g = cli.get_object(BUCKET, f"obj-{i}")
            assert g.status == 200 and g.body == mkdata(i)
        assert cli.request("POST", f"/minio/admin/v3/heal/{BUCKET}").status == 200
        return out
    finally:
        if prev is None:
            os.environ.pop("MINIO_TPU_DEVICE_HEAL", None)
        else:
            os.environ["MINIO_TPU_DEVICE_HEAL"] = prev


def multipart_served_on_device(rig: dict) -> None:
    """Two 5 MiB parts, each its own erasure stream; the whole object
    and a range across the part boundary read back."""
    cli = rig["cli"]
    part_size = 5 << 20
    parts = [np.random.default_rng(7000 + p).integers(0, 256, size=part_size,
                                                      dtype=np.uint8).tobytes()
             for p in range(2)]
    r = cli.request("POST", f"/{BUCKET}/mp-obj", query={"uploads": ""})
    assert r.status == 200
    uid = r.body.decode().split("<UploadId>")[1].split("<")[0]
    etags = []
    for pn, data in enumerate(parts, 1):
        r = cli.request("PUT", f"/{BUCKET}/mp-obj",
                        query={"partNumber": str(pn), "uploadId": uid}, body=data)
        assert r.status == 200, r.body
        etags.append(r.headers.get("etag", "").strip('"'))
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    r = cli.request("POST", f"/{BUCKET}/mp-obj", query={"uploadId": uid}, body=xml.encode())
    assert r.status == 200, r.body
    whole = b"".join(parts)
    g = cli.get_object(BUCKET, "mp-obj")
    assert g.status == 200 and g.body == whole
    lo, hi = part_size - 1000, part_size + 1000
    g = cli.request("GET", f"/{BUCKET}/mp-obj", headers={"Range": f"bytes={lo}-{hi - 1}"})
    assert g.status == 206 and g.body == whole[lo:hi]


def decode_failure_pattern_matrix(d: int, p: int, losses, device) -> None:
    """1..p losses across data/parity mixes through the fused decode (K1)
    at B=16, n = 2 chunks: rebuilt shards byte-identical to the host
    codec, their digests to the host HighwayHash."""
    import torch

    from minio_tpu_torch.ops import fused_cuda
    from minio_tpu_torch.ops.highwayhash import hash256_batch_numpy
    from minio_tpu_torch.ops.rs import get_codec

    b, n = 16, 2 * fused_cuda.CHUNK_BYTES
    rng = np.random.default_rng(d * 100 + p)
    blocks = rng.integers(0, 256, size=(b, d, n), dtype=np.uint8)
    ref = get_codec(d, p)
    full = []
    for bi in range(b):
        shards = ref.split(blocks[bi].tobytes())
        ref.encode(shards)
        full.append(shards)
    for missing in losses:
        assert len(missing) <= p
        present = tuple(i for i in range(d + p) if i not in missing)[:d]
        surv = np.stack([np.stack([full[bi][i] for i in present]) for bi in range(b)])
        rebuilt, digests = fused_cuda.fused_decode_hash(
            torch.from_numpy(surv).to(device), d, p, present, tuple(missing))
        rebuilt, digs = rebuilt.cpu().numpy(), digests.cpu().numpy()
        for bi in range(b):
            for mi, idx in enumerate(missing):
                assert (rebuilt[bi, mi] == full[bi][idx]).all(), \
                    f"d={d} p={p} missing={missing} b={bi} idx={idx}"
            want = hash256_batch_numpy(np.stack([full[bi][i] for i in missing]))
            assert (digs[bi, d:d + len(missing)] == want).all()


def batch_padding_edges(k: int, device) -> None:
    """Batches straddling the 16-block floor (15 pads up, 17 pads to 32)
    keep every real block byte-correct through the dispatcher."""
    from minio_tpu_torch.ops.highwayhash import hash256_batch_numpy
    from minio_tpu_torch.ops.rs import get_codec
    from minio_tpu_torch.ops.rs_torch import get_torch_codec
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    d, p, n = 4, 2, 2 * 1024
    blocks = np.random.default_rng(k).integers(0, 256, size=(k, d, n), dtype=np.uint8)
    disp = DeviceDispatcher(get_torch_codec(d, p, device), n, window_s=0.001)
    shards, digests = disp.encode(blocks)
    assert shards.shape == (k, d + p, n) and digests.shape == (k, d + p, 32)
    assert disp.stats.get("fused_failures", 0) == 0
    assert disp.stats["fused"] >= 1 and disp.stats["pad_blocks"] == -k % 16
    ref = get_codec(d, p)
    for bi in range(k):
        want = ref.split(blocks[bi].tobytes())
        ref.encode(want)
        assert (shards[bi] == want).all(), f"b={bi}"
        assert (digests[bi] == hash256_batch_numpy(want)).all(), f"b={bi}"


# -- the cases on the CPU rung -------------------------------------------------


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in RIG_ENV.items():
            mp.setenv(k, v)
        mp.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
        mp.delenv("MINIO_TPU_DEVICE_HEAL", raising=False)
        r = make_rig(str(tmp_path_factory.mktemp("served")))
        yield r
        stop_rig(r)


def test_concurrent_puts_ride_fused_kernel(rig):
    concurrent_puts_ride_fused_kernel(rig)


def test_served_get_roundtrip(rig):
    served_get_roundtrip(rig)


def test_degraded_get_rides_decode_kernel(rig):
    degraded_get_rides_decode_kernel(rig)


def test_heal_rebuilds_on_device(rig):
    heal_rebuilds_on_device(rig)


def test_multipart_served_on_device(rig):
    multipart_served_on_device(rig)


@pytest.mark.parametrize("d,p,losses", DECODE_MATRIX, ids=["ec2+2", "ec4+2", "ec6+3", "ec8+8"])
def test_decode_failure_pattern_matrix(d, p, losses):
    decode_failure_pattern_matrix(d, p, losses, "cpu")


@pytest.mark.parametrize("k", PADDING_EDGES)
def test_batch_padding_edges(k, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_BACKEND", "torch")
    batch_padding_edges(k, "cpu")


def test_cases_are_the_references():
    """The same seven cases, shapes and parameters as the reference's."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "tests", "test_tpu_served.py"), encoding="utf-8").read()
    tree = ast.parse(src)
    ref_cases = sorted(n.name for n in tree.body
                       if isinstance(n, ast.FunctionDef) and n.name.startswith("test_"))
    here = sorted(n for n, f in globals().items() if n.startswith("test_") and callable(f)
                  and n != "test_cases_are_the_references")
    assert ref_cases == here
    consts = {ast.unparse(n.targets[0]): ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "N_OBJECTS"}
    assert consts == {"N_OBJECTS": N_OBJECTS} and "OBJ_SIZE = 2 << 20" in src
    for d, p, losses in DECODE_MATRIX:
        assert f"({d}, {p}, {losses})".replace(" ", "") in src.replace(" ", "").replace("\n", "")
