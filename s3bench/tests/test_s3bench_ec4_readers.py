"""The readers of the bit-plane route (``ec4.put-1mib``: 12+4, shards of
87,382 bytes; K3's GF product, the rows' cat, K2) on synthetic windows:
the two roofline shares against values worked out by hand, the cases
where they read None, and the span readers matching that route's
batches to the card's operations."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from minio_tpu_torch import obs  # noqa: E402
from minio_tpu_torch.server.metrics import TracePubSub  # noqa: E402
from s3bench import run, spans  # noqa: E402
from s3bench.devtrace import DeviceTrace  # noqa: E402
from test_s3bench_spans import OFF, SLACK, Ring  # noqa: E402

CONFIG = {"env": {"MINIO_STORAGE_CLASS_STANDARD": "EC:4"}, "drives": 16}
MIB = 1 << 20
N = 87_382                 # ceil(1 MiB / 12)
K2 = "void hh_ring_kernel<ContigRows>(ContigRows, long, long, unsigned long, unsigned long)"
K3 = "void gf_core_kernel<4, 16>(GfJob, int)"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<unsigned char>"
HTOD = "Memcpy HtoD (Pageable -> Device)"
DTOH = "Memcpy DtoH (Device -> Pageable)"
READERS = ("put_encode_roofline_pct", "k2_hash_roofline_pct")


def batch_ops(t: float) -> list:
    """One batch on the card from trace time ``t``: its copy in, K3's GF
    product, the cat of the shard rows, K2, and its two copies out
    (parity, digests). Kernel time: 0.06 ms of product and cat, 0.15 ms
    of K2."""
    return [(HTOD, t, 0.0004, "gpu_memcpy"),
            (K3, t + 0.0005, 0.00002, "kernel"),
            (CAT, t + 0.0006, 0.00003, "kernel"),
            (CAT, t + 0.0007, 0.00001, "kernel"),
            (K2, t + 0.0008, 0.00015, "kernel"),
            (DTOH, t + 0.0010, 0.0002, "gpu_memcpy"),
            (DTOH, t + 0.0013, 0.00001, "gpu_memcpy")]


def window(ops, k1=0, k1_decode=0, k3=0, k2=2, blocks=2, sizes=(MIB, MIB)):
    tr = DeviceTrace("")
    tr.t0, tr.window_s, tr.ops = 100.0, 1.0, sorted(ops, key=lambda o: o[1])
    before = {"dispatch": {"blocks": 10}, "k1": {"encode_launches": 5, "decode_launches": 0},
              "k2": {"launches": 7}, "k3": {"launches": 0}}
    after = {"dispatch": {"blocks": 10 + blocks},
             "k1": {"encode_launches": 5 + k1, "decode_launches": k1_decode},
             "k2": {"launches": 7 + k2}, "k3": {"launches": k3}}
    records = [["put", f"o-{i}", 0.1, 0.1, 0.5, 200, s, True] for i, s in enumerate(sizes)]
    records.append(["put", "refused", 0.2, 0.2, 0.6, 503, 0, False])
    return run.Window(CONFIG, before, after, records, tr, 1.0)


def two_batches():
    return batch_ops(100.2 + OFF) + batch_ops(100.6 + OFF)


def test_rooflines_by_hand():
    w = window(two_batches())
    kernels = 2 * (0.00002 + 0.00003 + 0.00001 + 0.00015)
    # per block: 12 rows of 87,382 bytes in; 4 parity rows and 16
    # digests out; 2 x 4 x 12 GF operations a byte of a row and 150 a
    # 32-byte packet of each of the 16 rows (2,731 packets)
    bytes_ = 12 * N + 4 * N + 16 * 32
    ops = 2 * 4 * 12 * N + 16 * 2731 * 150
    least = 2 * max(bytes_ / 3.35e12, ops / 67e12)
    assert run.read_metric("put_encode_roofline_pct", w) == pytest.approx(100 * least / kernels)
    # K2 alone: 16 rows a block, each read once, its digest written once
    row = max((N + 32) / 3.35e12, 2731 * 150 / 67e12)
    assert run.read_metric("k2_hash_roofline_pct", w) == pytest.approx(
        100 * 2 * 16 * row / (2 * 0.00015))


def test_padding_does_not_count():
    """Three blocks that the dispatcher padded to four: the counters
    count three, so the shares do; the card's time is all four's."""
    w3 = window(two_batches(), blocks=3)
    w2 = window(two_batches(), blocks=2)
    for m in READERS:
        assert run.read_metric(m, w3) == pytest.approx(1.5 * run.read_metric(m, w2))


@pytest.mark.parametrize("launched", [{"k1": 1}, {"k3": 2}, {"k2": 0}])
def test_the_yardstick_holds_whichever_kernels_encode(launched):
    """The launch counters do not gate the shares: a fused kernel or K3
    serving the same blocks is read against the same least time."""
    base = window(two_batches())
    w = window(two_batches(), **launched)
    for m in READERS:
        assert run.read_metric(m, w) == pytest.approx(run.read_metric(m, base))


def test_a_decode_or_a_get_in_the_window_reads_none():
    w = window(two_batches(), k1_decode=1)
    assert all(run.read_metric(m, w) is None for m in READERS)
    w = window(two_batches())
    w.records.append(["get", "o-0", 0.3, 0.3, 0.7, 200, MIB, True])
    assert all(run.read_metric(m, w) is None for m in READERS)


@pytest.mark.parametrize("bend", [
    {"sizes": (MIB, MIB // 2)},       # two object sizes: two shard sizes
    {"sizes": (8 * MIB,)},            # an object of eight blocks
    {"sizes": ()},                    # no PUT acknowledged
    {"blocks": 0},                    # no block dispatched
])
def test_windows_the_readers_cannot_count_read_none(bend):
    w = window(two_batches(), **bend)
    assert all(run.read_metric(m, w) is None for m in READERS)


def test_no_trace_or_no_k2_kernel_reads_none():
    w = window(two_batches())
    w.trace = None
    assert all(run.read_metric(m, w) is None for m in READERS)
    # K2 launched by the counters but not one of its kernels in the trace
    no_k2 = [o for o in two_batches() if o[0] != K2]
    assert run.read_metric("k2_hash_roofline_pct", window(no_k2)) is None
    assert run.read_metric("put_encode_roofline_pct", window(no_k2)) is not None


# -- the span readers on the bit-plane route ------------------------------------


@pytest.fixture()
def publish():
    prev = obs.publisher()

    def attach(ring):
        obs.set_publisher(TracePubSub(ring=ring))

    yield attach
    obs.set_publisher(prev)


def bitplane_batch(r, ops, req, t, route="bitplane"):
    """One batch at ring time ``t``: queued 5 ms, the four device marks
    around its copies, as the dispatcher stamps them on the bit-plane
    route, and its operations on the card."""
    r.add("dispatch.queue", t - 0.005, t, req=req)
    b = r.add("dispatch.batch", t, t + 0.004, req=req, label=route)
    r.add("dispatch.assemble", t, t + 0.0005, req=req, parent=b)
    r.add("dispatch.h2d", t + 0.0005, t + 0.0011, req=req, parent=b)
    r.add("dispatch.kernels", t + 0.0011, t + 0.0012, req=req, parent=b)
    # the digests' copy ends 1.86 ms after the batch starts, its host call
    # returns SLACK later
    r.add("dispatch.d2h", t + 0.0012, t + 0.00186 + SLACK, req=req, parent=b)
    r.add("dispatch.results", t + 0.00186 + SLACK, t + 0.004, req=req, parent=b)
    ops += batch_ops(t + 0.0005 + SLACK + OFF)


def test_bitplane_batches_match_their_copies_one_to_one(publish):
    r = Ring()
    ops = []
    for i, t in enumerate((100.2, 100.5, 100.8)):
        bitplane_batch(r, ops, f"R{i}", t)
    publish(r.ring)
    w = window(ops)
    ds = spans.dispatches(w)
    assert [round(d.h2d, 6) for d in ds] == [100.2005, 100.5005, 100.8005]
    for d in ds:
        assert d.lo == pytest.approx(OFF - SLACK) and d.hi == pytest.approx(OFF + SLACK)
        # the batch's copy in opens its device work, its digests' copy closes it
        assert d.dev[1] - d.dev[0] == pytest.approx(0.0013 + 0.00001)
    busy = 3 * (0.0004 + 0.00002 + 0.00003 + 0.00001 + 0.00015 + 0.0002 + 0.00001)
    idle = 1.0 - busy
    assert run.read_metric("idle_dispatcher_pct.put", w) == pytest.approx(
        100 * (3 * 0.004 - busy) / idle)
    assert run.read_metric("idle_upstream_pct.put", w) == pytest.approx(
        100 * (idle - (3 * 0.009 - busy)) / idle)


def test_a_batch_without_device_phases_reads_none(publish):
    """A batch the numpy rung served has no copies and no marks: the
    batches and the card's operations no longer match one to one."""
    r = Ring()
    ops = []
    bitplane_batch(r, ops, "R0", 100.2)
    bitplane_batch(r, ops, "R1", 100.5)
    r.add("dispatch.batch", 100.8, 100.81, req="R2", label="numpy")
    publish(r.ring)
    w = window(ops)
    assert spans.dispatches(w) is None
    assert run.read_metric("idle_upstream_pct.put", w) is None
