"""The port's kernels on a CUDA card, held against their plain versions.

These cases need the card: each launches a hand-written kernel (K1
``ops/fused_cuda.py``, K2 ``ops/bitrot_cuda.py``, K3 ``ops/rs_cuda.py``)
and compares it byte for byte with the wrapper's plain PyTorch version on
the same inputs. Without a card every case skips. The file imports
nothing of the JAX package, so the card's machine, which has no JAX, can
collect it: ``chip_smoke.py`` runs it whole in its suite phase, where a
skip fails the run.
"""

import numpy as np
import pytest
import torch

from minio_tpu_torch.ops import (
    bitrot_cuda, bitrot_torch, cauchy, fused_cuda, rs, rs_cuda, rs_torch)
from minio_tpu_torch.ops.highwayhash import MINIO_KEY, hash256_batch_numpy

pytestmark = pytest.mark.cuda

D, P, B, N = 8, 8, 16, 1024


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Every case here skips without a card: decided when the cases run,
    never as the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run via chip_smoke.py on the H100)")


@pytest.fixture(scope="module")
def encoded():
    """One batch at EC 8+8 encoded by K1's plain version (a CPU tensor)."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(B, D, N), dtype=np.uint8)
    before = fused_cuda.encode_launches
    par, dig = fused_cuda.fused_encode_hash(torch.from_numpy(data), D, P)
    assert fused_cuda.encode_launches == before  # CPU: plain version
    return data, par.numpy(), dig.numpy()


def test_cuda_hash_matches_plain():
    """The chain kernel against the plain version (odd lengths, row counts
    that are not multiples of 8)."""
    for n in (0, 1, 31, 32, 33, 87382):
        x = torch.randint(0, 256, (37, n), dtype=torch.uint8, device="cuda")
        assert torch.equal(bitrot_cuda.hash256_blocks(x).cpu(),
                           bitrot_torch.hash256_blocks_plain(x.cpu()))


@pytest.mark.parametrize("n", [33, 34, 38, 65, 70, 95, 161])
def test_cuda_hash_odd_rows_end_of_buffer(n):
    """Rows of odd length start at every alignment, and the last one ends
    at the last byte of its buffer: the whole-packet loop's look-ahead
    word must not read past a row's end, and the digests must not change."""
    rows = 9
    g = torch.Generator().manual_seed(n)
    host = torch.randint(0, 256, (rows * n,), dtype=torch.uint8, generator=g)
    buf = torch.empty(rows * n, dtype=torch.uint8, device="cuda")
    buf.copy_(host)
    got = bitrot_cuda.hash256_blocks(buf.view(rows, n))
    torch.cuda.synchronize()
    want = bitrot_torch.hash256_blocks_plain(host.view(rows, n))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.cpu().numpy(), hash256_batch_numpy(host.view(rows, n).numpy()))


def test_cuda_k3_matches_plain():
    w = rs_torch.gf_matrix_to_bitplanes(cauchy.composite_parity_matrix(cauchy.get_codec(8, 8)))
    x = torch.randint(0, 256, (4, 8, 2 * 4097), dtype=torch.uint8).cuda()
    got = rs_cuda.gf_apply_cuda(w, x, 8, sub=2)
    assert torch.equal(got, rs_cuda.gf_apply_plain(w, x, 8, sub=2))


def test_cuda_k3_concurrent_launches_of_two_table_sizes():
    """K3 from 8 threads at once on two binary matrices of one core
    instantiation (16-byte entries) whose tables need different shared
    memory above the 48 KiB default (12 and 16 input rows): each launch
    sets the kernel's limit, so the set and the launch go together, and
    every launch succeeds and matches the plain version."""
    import threading

    rng = np.random.default_rng(9)
    cases = []
    for k in (12, 16):
        w = rng.integers(0, 2, size=(8 * 12, 8 * k), dtype=np.int8)
        x = torch.randint(0, 256, (2, k, 4097), dtype=torch.uint8).cuda()
        cases.append((w, x, rs_cuda.gf_apply_plain(w, x.cpu(), 12)))
    errors = []

    def work(i):
        w, x, want = cases[i % 2]
        try:
            outs = [rs_cuda.gf_apply_cuda(w, x, 12) for _ in range(300)]
            torch.cuda.synchronize()
            errors.extend(i for o in outs if not torch.equal(o.cpu(), want))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


@pytest.mark.parametrize("b", [1, 3, 4])
def test_cuda_rs_encode_12_4_takes_k3(b):
    """Reed-Solomon encode on the card at 12+4 (rows of 87,382 bytes, as
    MinIO's default 16-drive set cuts a 1 MiB block) is one K3 launch,
    and its parity and the route's digests are the numpy reference's."""
    d, p, n = 12, 4, 87382
    data = np.random.default_rng(b).integers(0, 256, size=(b, d, n), dtype=np.uint8)
    codec = rs_torch.get_torch_codec(d, p, "cuda")
    before = rs_cuda.launches
    par, dig = bitrot_torch.encode_and_hash(codec, data)
    assert rs_cuda.launches == before + 1
    ref = rs.get_codec(d, p)
    shards = np.concatenate([data, par.cpu().numpy()], axis=1)
    for i in range(b):
        whole = np.concatenate([data[i], np.zeros((p, n), np.uint8)])
        assert np.array_equal(shards[i], ref.encode(whole))
    assert np.array_equal(dig.cpu().numpy(),
                          hash256_batch_numpy(shards.reshape(b * (d + p), n)).reshape(b, d + p, 32))


def test_cuda_fused_matches_plain(encoded):
    data, par, dig = encoded
    gp, gd = fused_cuda.fused_encode_hash(torch.from_numpy(data).cuda(), D, P)
    assert np.array_equal(gp.cpu().numpy(), par)
    assert np.array_equal(gd.cpu().numpy(), dig)


READ_N = [32, 33, 1024, 65536, 87382, 131072]


def _path_launches():
    return dict(bitrot_cuda.core_launches)


@pytest.mark.parametrize("n", READ_N)
def test_cuda_hash_both_read_paths(n):
    """K2 on rows starting at every offset 0-31 of a buffer, one row and
    three back to back: each launch takes the read path its row starts
    give (aligned exactly when all are 16-byte aligned, as
    ``bitrot_cuda.aligned`` says), counts under it, and its digests equal
    the plain version's."""
    g = torch.Generator().manual_seed(n)
    host = torch.randint(0, 256, (32 + 3 * n + 64,), dtype=torch.uint8, generator=g)
    buf = host.cuda()
    got, rows = [], []
    for off in range(32):
        for count in (1, 3):
            view = buf[off: off + count * n].view(count, n)
            path = "aligned" if bitrot_cuda.aligned((view.data_ptr(), count, n)) else "generic"
            assert path == ("aligned" if all((view.data_ptr() + i * n) % 16 == 0
                                             for i in range(count)) else "generic")
            before = _path_launches()
            got.append(bitrot_cuda.hash256_blocks(view))
            after = _path_launches()
            key = ("hh_chain", path)
            assert after.get(key, 0) == before.get(key, 0) + 1
            rows.append(host[off: off + count * n].view(count, n))
    want = bitrot_torch.hash256_blocks_plain(torch.cat(rows))
    assert torch.equal(torch.cat(got).cpu(), want)


@pytest.mark.parametrize("d,p", [(8, 8), (12, 4)])
@pytest.mark.parametrize("b", [1, 16])
def test_cuda_k1_aligned_matches_plain(d, p, b):
    """K1 encode at n = 131,072 on fresh (16-byte aligned) tensors takes
    the aligned read path and matches ``fused_plain`` byte for byte. The
    kernel is launched below the wrapper where the routing gate
    (``supports``: d <= 8) would refuse the shape; the kernel itself takes
    any."""
    n = 131072
    rng = np.random.default_rng(100 * d + b)
    data = torch.from_numpy(rng.integers(0, 256, size=(b, d, n), dtype=np.uint8))
    m = rs.get_codec(d, p).parity_matrix
    before = _path_launches()
    gp, gd = fused_cuda._launch("fused_encode_hash", data.cuda(),
                                fused_cuda._encode_tables(d, p, "cuda:0"), p, MINIO_KEY)
    after = _path_launches()
    key = ("fused_encode_hash", "aligned")
    assert after.get(key, 0) == before.get(key, 0) + 1
    wp, wd = fused_cuda.fused_plain(data, m)
    assert torch.equal(gp.cpu(), wp)
    assert torch.equal(gd.cpu(), wd)


def test_cuda_k1_misaligned_view_takes_generic_path():
    """A K1 encode on a view 8 bytes into its buffer (every shard start
    16-byte misaligned) takes the generic read path, counts there, and
    gives the same bytes as the same data on an aligned tensor, which the
    plain version holds."""
    d, p, b, n = 8, 8, 16, 131072
    rng = np.random.default_rng(77)
    host = torch.from_numpy(rng.integers(0, 256, size=(b, d, n), dtype=np.uint8))
    buf = torch.empty(8 + b * d * n, dtype=torch.uint8, device="cuda")
    view = buf[8:].view(b, d, n)
    view.copy_(host)
    assert view.data_ptr() % 16 == 8
    before = _path_launches()
    gp, gd = fused_cuda.fused_encode_hash(view, d, p)
    after = _path_launches()
    key = ("fused_encode_hash", "generic")
    assert after.get(key, 0) == before.get(key, 0) + 1
    ap, ad = fused_cuda.fused_encode_hash(host.cuda(), d, p)
    assert torch.equal(gp, ap) and torch.equal(gd, ad)
    wp, wd = fused_cuda.fused_plain(host, rs.get_codec(d, p).parity_matrix)
    assert torch.equal(ad.cpu(), wd) and torch.equal(ap.cpu(), wp)


def test_cuda_dispatcher_launches_k1_at_the_batch_size():
    """Three blocks at 8+8 go to K1 as one launch at B = 3 (no pad), and
    the shards and digests are the numpy codec's."""
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    d, p, k, n = 8, 8, 3, 131072
    blocks = np.random.default_rng(3).integers(0, 256, size=(k, d, n), dtype=np.uint8)
    disp = DeviceDispatcher(rs_torch.get_torch_codec(d, p, "cuda"), n, window_s=0.05)
    key = ("encode", k, d, p, n)
    before = fused_cuda.launch_shapes[key]
    shards, digests = disp.submit(blocks).result(timeout=120)
    assert fused_cuda.launch_shapes[key] == before + 1
    want_shards, want_digests = disp._encode_numpy(blocks)
    assert np.array_equal(shards, want_shards) and np.array_equal(digests, want_digests)
    st = disp.stats_snapshot()
    assert st["fused"] == 1 and st["pad_blocks"] == 0


# -- EC:4's route: the batch's shards in one slab at a 32-byte pitch ----------

EC4 = (12, 4)


def _device_ops(trace_path: str) -> list[tuple[str, str]]:
    """(category, name) of every operation on the card in a profiler
    trace, in the categories the benchmark reads (s3bench/devtrace.py)."""
    import json

    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["cat"], e.get("name", "?")) for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.mark.parametrize("b,r", [(1, 12), (3, 12), (2, 4), (3, 1)])
@pytest.mark.parametrize("n", [17, 1000, 87382])
def test_cuda_pitched_copies_round_trip(b, r, n):
    """Rows go from a host array into a slab's rows at the 32-byte pitch
    and back, in one pitched copy each way, with the bytes between the
    rows untouched; a host view whose items are not whole rows apart is
    copied contiguous first."""
    rng = np.random.default_rng(b * r * n)
    host = rng.integers(0, 256, size=(b, r + 2, n), dtype=np.uint8)
    pitch = bitrot_torch.pitch(n)
    slab = torch.full((b, r + 3, pitch), 7, dtype=torch.uint8, device="cuda")
    view = slab[:, 1:r + 1, :n]
    bitrot_cuda.rows_to_card(view, host[:, 1:r + 1])  # items r + 2 rows apart
    back = bitrot_cuda.rows_to_host(view)
    assert back.flags.c_contiguous and np.array_equal(back, host[:, 1:r + 1])
    assert np.array_equal(bitrot_torch.to_numpy(view), host[:, 1:r + 1])
    whole = slab.cpu().numpy()
    assert (whole[:, 0] == 7).all() and (whole[:, r + 1:] == 7).all()
    assert (whole[:, :, n:] == 7).all()
    odd = np.repeat(host, 2, axis=2)[:, :r, ::2]  # bytes 2 apart: not pitched
    bitrot_cuda.rows_to_card(view, odd)
    assert np.array_equal(bitrot_cuda.rows_to_host(view), host[:, :r])


@pytest.mark.parametrize("n", [87382, 87392, 1000, 17])
@pytest.mark.parametrize("b", [1, 2, 4, 16])
def test_cuda_bitplane_route_serves_from_the_slab(b, n):
    """The dispatcher's bit-plane route at 12+4 on the card: the batch's
    parity and digests are the numpy rung's byte for byte, its one K2
    launch counts on the aligned read path, and the four device marks are
    stamped (the ring's ``dispatch.h2d``, ``kernels`` and ``d2h``)."""
    from minio_tpu_torch import obs
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher
    from minio_tpu_torch.server.metrics import TracePubSub

    d, p = EC4
    codec = rs_torch.get_torch_codec(d, p, "cuda")
    assert not fused_cuda.supports(d, p, n)
    blocks = np.random.default_rng(b + n).integers(0, 256, size=(b, d, n), dtype=np.uint8)
    prev = obs.publisher()
    pub = TracePubSub(ring=obs.SpanRing(1024))
    obs.set_publisher(pub)
    try:
        disp = DeviceDispatcher(codec, n, window_s=0.05)
        before = _path_launches()
        shards, digests = disp.submit(blocks).result(timeout=120)
        after = _path_launches()
        import time

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
                sp.name == "dispatch.results" for sp in pub.ring.snapshot()[0]):
            time.sleep(0.01)
        kept = pub.ring.snapshot()[0]
    finally:
        obs.set_publisher(prev)
    want_shards, want_digests = disp._encode_numpy(blocks)
    assert np.array_equal(shards, want_shards) and np.array_equal(digests, want_digests)
    assert after.get(("hh_chain", "aligned"), 0) == before.get(("hh_chain", "aligned"), 0) + 1
    assert after.get(("hh_chain", "generic"), 0) == before.get(("hh_chain", "generic"), 0)
    (batch,) = [sp for sp in kept if sp.name == "dispatch.batch"]
    assert batch.label == "bitplane"
    kids = sorted((sp for sp in kept if sp.parent_id == batch.span_id), key=lambda sp: sp.start_ns)
    assert [sp.name for sp in kids] == ["dispatch.assemble", "dispatch.h2d", "dispatch.kernels",
                                        "dispatch.d2h", "dispatch.results"]


@pytest.mark.parametrize("b", [1, 2, 4])
def test_cuda_slab_batch_runs_only_k3_and_k2(b, tmp_path):
    """One batch of the route as the dispatcher runs it (the copy into the
    slab, K3 and K2, the copies out) puts on the card K3's and K2's
    kernels and nothing else: no cat, no compacting copy kernel; and one
    copy in and two out, which the benchmark's span readers match to the
    batch one to one."""
    from torch.profiler import ProfilerActivity, profile

    d, p = EC4
    codec = rs_torch.get_torch_codec(d, p, "cuda")
    blocks = np.random.default_rng(b).integers(0, 256, size=(b, d, 87382), dtype=np.uint8)

    def batch():
        par, dig = bitrot_torch.encode_and_hash(codec, bitrot_torch.shard_slab(codec, blocks))
        return bitrot_torch.to_numpy(par), bitrot_torch.to_numpy(dig)

    want = batch()  # builds, caches K3's tables and offsets
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = batch()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ops = _device_ops(str(tmp_path / "trace.json"))
    kernels = [name for cat, name in ops if cat == "kernel"]
    assert len(kernels) == 2, kernels
    assert any("gf_core_kernel" in k for k in kernels)
    assert any("hh_ring_kernel<ContigRows>" in k for k in kernels)
    copies = [name for cat, name in ops if cat == "gpu_memcpy"]
    assert sum("HtoD" in c for c in copies) == 1 and sum("DtoH" in c for c in copies) == 2, copies
    assert not [o for o in ops if o[0] == "gpu_memset"]
    assert all(np.array_equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("n", [17, 1000, 87382])
def test_cuda_hash_at_a_pitch_and_back_to_back(n):
    """K2 on the same rows back to back (pitch = n) at every start offset
    0-15, and one pitch apart in a slab: the digests do not change, and
    the slab's rows take the aligned read path."""
    rows = 16
    g = torch.Generator().manual_seed(n)
    host = torch.randint(0, 256, (rows, n), dtype=torch.uint8, generator=g)
    want = bitrot_torch.hash256_blocks_plain(host)
    buf = torch.empty(16 + rows * n, dtype=torch.uint8, device="cuda")
    for off in range(16):
        view = buf[off: off + rows * n].view(rows, n)
        view.copy_(host)
        assert view.stride() == (n, 1)
        assert torch.equal(bitrot_cuda.hash256_blocks(view).cpu(), want)
    slab = torch.zeros((rows, bitrot_torch.pitch(n)), dtype=torch.uint8, device="cuda")
    slab[:, :n] = host
    before = _path_launches()
    assert torch.equal(bitrot_cuda.hash256_blocks(slab[:, :n]).cpu(), want)
    after = _path_launches()
    assert after.get(("hh_chain", "aligned"), 0) == before.get(("hh_chain", "aligned"), 0) + 1


# -- the GF core's small-batch regime -----------------------------------------

def _plan_launches():
    from minio_tpu_torch.ops import gf_cuda

    return dict(gf_cuda.plan_launches)


def _counted(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 7, 8, 64])
def test_cuda_k3_small_batch_into_the_slab(b):
    """EC:4's route at B = 1-8 and 64 (K3 into the shard slab, then K2):
    the parity is ops/rs.py's and the digests the numpy HighwayHash's,
    byte for byte; the GF launch counts under its plan's regime, small
    until 256-thread tiles fill three quarters of the SMs (B = 5 at
    87,382 bytes), wave at B = 64."""
    from minio_tpu_torch.ops import gf_cuda

    d, p, n = 12, 4, 87382
    data = np.random.default_rng(1000 + b).integers(0, 256, size=(b, d, n), dtype=np.uint8)
    codec = rs_torch.get_torch_codec(d, p, "cuda")
    before = _plan_launches()
    par, dig = bitrot_torch.encode_and_hash(codec, bitrot_torch.shard_slab(codec, data))
    regime = gf_cuda.plan(b, d, p, n).regime
    assert _counted(before, _plan_launches()) == {("gf_apply", regime): 1}
    assert regime == ("small" if b < 5 else "wave")
    par = bitrot_torch.to_numpy(par)
    ref = rs.get_codec(d, p)
    shards = np.concatenate([data, par], axis=1)
    for i in range(b):
        assert np.array_equal(shards[i], ref.encode(np.concatenate([data[i], np.zeros(
            (p, n), np.uint8)])))
    assert np.array_equal(bitrot_torch.to_numpy(dig), hash256_batch_numpy(
        shards.reshape(b * (d + p), n)).reshape(b, d + p, 32))


def test_cuda_k3_small_batch_odd_row_starts():
    """The cauchy 12+4 composite at h = 43,691 on one block: the a and b
    halves start at odd addresses, and the rows' last columns are a
    partial tile; the parity is the numpy cauchy codec's."""
    d, p, h = 12, 4, 43691
    w = cauchy.get_torch_codec(d, p, "cuda").w_composite
    x = np.random.default_rng(43).integers(0, 256, size=(1, d, 2 * h), dtype=np.uint8)
    before = _plan_launches()
    out = rs_cuda.gf_apply_cuda(w, torch.from_numpy(x).cuda(), p, sub=2)
    assert _counted(before, _plan_launches()) == {("gf_apply", "small"): 1}
    full = np.concatenate([x[0], np.zeros((p, 2 * h), np.uint8)])
    assert np.array_equal(out[0].cpu().numpy(), cauchy.get_codec(d, p).encode(full)[d:])


@pytest.mark.parametrize("b", [1, 2])
def test_cuda_k1_small_batch_encode(b):
    """K1 encode at 8+8, n = 131,072, B = 1 and 2: its GF launch on the
    small-batch plan at B = 1 and the wave plan at B = 2 (128 tiles);
    parity and digests are the numpy reference's."""
    from minio_tpu_torch.ops import gf_cuda

    d, p, n = 8, 8, 131072
    data = np.random.default_rng(800 + b).integers(0, 256, size=(b, d, n), dtype=np.uint8)
    before = _plan_launches()
    par, dig = fused_cuda.fused_encode_hash(torch.from_numpy(data).cuda(), d, p)
    regime = gf_cuda.plan(b, d, p, n).regime
    assert _counted(before, _plan_launches()) == {("fused_encode_hash", regime): 1}
    assert regime == ("small" if b == 1 else "wave")
    ref = rs.get_codec(d, p)
    shards = np.concatenate([data, par.cpu().numpy()], axis=1)
    for i in range(b):
        assert np.array_equal(shards[i], ref.encode(np.concatenate([data[i], np.zeros(
            (p, n), np.uint8)])))
    assert np.array_equal(dig.cpu().numpy(), hash256_batch_numpy(
        shards.reshape(b * (d + p), n)).reshape(b, d + p, 32))


def test_cuda_k1_small_batch_decode_and_wave():
    """K1 decode of one block at 8+8 with data shards 0, 3 and 5 lost, on
    the small-batch plan, rebuilds them; K1 encode at B = 64 counts wave."""
    d, p, n = 8, 8, 131072
    data = np.random.default_rng(88).integers(0, 256, size=(1, d, n), dtype=np.uint8)
    full = rs.get_codec(d, p).encode(np.concatenate([data[0], np.zeros((p, n), np.uint8)]))
    missing = (0, 3, 5)
    present = tuple(i for i in range(d + p) if i not in missing)[:d]
    before = _plan_launches()
    got, dig = fused_cuda.fused_decode_hash(torch.from_numpy(full[list(present)][None]).cuda(),
                                            d, p, present, missing)
    assert _counted(before, _plan_launches()) == {("fused_decode_hash", "small"): 1}
    assert np.array_equal(got[0].cpu().numpy(), full[list(missing)])
    assert np.array_equal(dig[0].cpu().numpy(), hash256_batch_numpy(
        np.concatenate([full[list(present)], full[list(missing)]])))
    x = torch.randint(0, 256, (64, d, n), dtype=torch.uint8, device="cuda")
    before = _plan_launches()
    gp, _ = fused_cuda.fused_encode_hash(x, d, p)
    assert _counted(before, _plan_launches()) == {("fused_encode_hash", "wave"): 1}
    assert torch.equal(gp[[0, 63]].cpu(), fused_cuda.fused_plain(
        x[[0, 63]].cpu(), rs.get_codec(d, p).parity_matrix)[0])
