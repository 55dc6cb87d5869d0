"""The span readers (s3bench/spans.py and their metric files) on a
synthetic window: a ring filled by hand and a device trace whose clock
runs a known offset ahead of the ring's."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from minio_tpu_torch import obs  # noqa: E402
from minio_tpu_torch.server.metrics import TracePubSub  # noqa: E402
from s3bench import run, spans  # noqa: E402
from s3bench.devtrace import DeviceTrace  # noqa: E402

OFF = 1000.0          # trace clock - ring clock (s)
SLACK = 50e-6         # each copy 50 us inside its host call: the bracket is 100 us wide
CONFIG = {"env": {"MINIO_STORAGE_CLASS_STANDARD": "EC:8"}, "drives": 16}
NEW = ["put_front_ms", "put_body_wait_ms", "put_encode_wait_ms", "put_drives_ms",
       "drive_queue_ms", "idle_upstream_pct.put", "idle_dispatcher_pct.put"]


def ns(t: float) -> int:
    return round(t * 1e9)


class Ring:
    """Spans written into a ring by hand, each with its own id."""

    def __init__(self, capacity=4096):
        self.ring = obs.SpanRing(capacity)
        self.next = 1

    def add(self, name, a, b, req="", parent=0, label="", nbytes=0, queue_ns=0, status=0):
        sid, self.next = self.next, self.next + 1
        self.ring.add(name, label, req, sid, parent, ns(a), ns(b), nbytes, queue_ns, status)
        return sid


def dispatch(r, ops, req, parent, q0, shift, htod_early=0.0, d2h_late=0.0, wander=0.0):
    """One batch at ring time 100.14 + shift: queue, phases, and the card's
    copies and kernel in ``ops`` on the trace's clock. ``htod_early``
    moves the copy in that much before the host issued it, ``d2h_late``
    the copies out's host call that much after their end; ``wander``
    moves the trace's clock by that much for this batch."""
    r.add("dispatch.queue", q0, 100.140 + shift, req=req, parent=parent)
    b = r.add("dispatch.batch", 100.140 + shift, 100.175 + shift, req=req)
    r.add("dispatch.assemble", 100.140 + shift, 100.142 + shift, req=req, parent=b)
    r.add("dispatch.h2d", 100.142 + shift, 100.150 + shift, req=req, parent=b)
    r.add("dispatch.kernels", 100.150 + shift, 100.151 + shift, req=req, parent=b)
    last_dtoh = 100.1682 + shift
    r.add("dispatch.d2h", 100.151 + shift, last_dtoh + SLACK + d2h_late, req=req, parent=b)
    r.add("dispatch.results", 100.16825 + shift, 100.175 + shift, req=req, parent=b)
    h0 = 100.142 + shift + SLACK - htod_early
    off = OFF + wander
    ops += [("Memcpy HtoD (Pageable -> Device)", h0 + off, 100.149 + shift - h0, "gpu_memcpy"),
            ("gf_core_kernel", 100.150 + shift + off, 0.005, "kernel"),
            ("Memcpy DtoH (Device -> Pageable)", 100.160 + shift + off, 0.008, "gpu_memcpy"),
            ("Memcpy DtoH (Device -> Pageable)", 100.1681 + shift + off, 0.0001, "gpu_memcpy")]


def scene(r, wander=0.0, **bends):
    """Two PUTs in the window [100, 101] (and requests that do not
    count), each with one dispatch, the trace's clock ``wander`` ahead
    for the second; returns the trace's operations."""
    ops = []
    # PUT A: 200 ms, of which its object-layer call 170 ms
    a = r.add("s3.request", 100.100, 100.300, req="A", label="PutObject", nbytes=1 << 20,
              status=200)
    pa = r.add("erasure.put_object", 100.120, 100.290, req="A", parent=a)
    r.add("erasure.put.body-wait", 100.121, 100.125, req="A", parent=pa)
    r.add("erasure.put.body-wait", 100.126, 100.127, req="A", parent=pa)
    ea = r.add("erasure.put.encode-wait", 100.130, 100.180, req="A", parent=pa)
    da = r.add("erasure.put.drives", 100.200, 100.280, req="A", parent=pa)
    r.add("storage.create_file", 100.205, 100.250, req="A", parent=da, queue_ns=2_000_000)
    r.add("storage.rename_data", 100.250, 100.270, req="A", parent=da)
    dispatch(r, ops, "A", ea, 100.130, 0.0, **bends)
    # PUT B: 300 ms, of which its object-layer call 280 ms
    b = r.add("s3.request", 100.500, 100.800, req="B", label="PutObject", nbytes=1 << 20,
              status=200)
    pb = r.add("erasure.put_object", 100.510, 100.790, req="B", parent=b)
    eb = r.add("erasure.put.encode-wait", 100.530, 100.600, req="B", parent=pb)
    db = r.add("erasure.put.drives", 100.600, 100.700, req="B", parent=pb)
    r.add("erasure.put.drives", 100.700, 100.750, req="B", parent=pb)
    r.add("storage.create_file", 100.610, 100.650, req="B", parent=db, queue_ns=4_000_000)
    r.add("storage.rename_data", 100.650, 100.690, req="B", parent=db, queue_ns=6_000_000)
    dispatch(r, ops, "B", eb, 100.530, 0.4, wander=wander, **bends)
    # not window PUTs: a GET, a refused PUT, a PUT begun before the window
    r.add("s3.request", 100.050, 100.060, req="C", label="GetObject", status=200)
    d = r.add("s3.request", 100.900, 100.950, req="D", label="PutObject", status=503)
    r.add("erasure.put.drives", 100.910, 100.940, req="D", parent=d)
    e = r.add("s3.request", 99.900, 100.050, req="E", label="PutObject", status=200)
    r.add("erasure.put.drives", 99.950, 100.040, req="E", parent=e)
    return ops


def window(r, ops, t0=100.0, seconds=1.0):
    tr = DeviceTrace("")
    tr.t0, tr.window_s, tr.ops = t0, seconds, sorted(ops, key=lambda o: o[1])
    return run.Window(CONFIG, {}, {}, [], tr, seconds)


@pytest.fixture()
def publish():
    prev = obs.publisher()

    def attach(ring):
        obs.set_publisher(TracePubSub(ring=ring))

    yield attach
    obs.set_publisher(prev)


def test_bracket_recovers_the_offset(publish):
    r = Ring()
    ops = scene(r)
    publish(r.ring)
    ds = spans.dispatches(window(r, ops))
    assert [d.h2d for d in ds] == [pytest.approx(100.142), pytest.approx(100.542)]
    for d in ds:
        assert d.hi - d.lo == pytest.approx(2 * SLACK, abs=1e-9)
        assert (d.lo + d.hi) / 2 == pytest.approx(OFF, abs=1e-9)


@pytest.mark.parametrize("bend", [
    # the trace's clock 5 ms further ahead for the second batch: no one
    # offset lies within both brackets
    {"wander": 0.005},
    # copies out whose host call returns 2 ms after their end: a bracket
    # 2 ms wide
    {"d2h_late": 0.002},
])
def test_clocks_that_wander_leave_the_shares_exact(publish, bend):
    r = Ring()
    ops = scene(r, **bend)
    publish(r.ring)
    w = window(r, ops)
    assert len(spans.dispatches(w)) == 2
    # each batch's copies and kernel lie inside it: the shares are exact
    busy = 2 * (0.00695 + 0.005 + 0.008 + 0.0001)
    idle = 1.0 - busy
    assert run.read_metric("idle_dispatcher_pct.put", w) == pytest.approx(
        100 * (2 * 0.035 - busy) / idle)
    assert run.read_metric("idle_upstream_pct.put", w) == pytest.approx(
        100 * (idle - (2 * 0.045 - busy)) / idle)


def test_per_put_metrics_by_hand(publish):
    r = Ring()
    ops = scene(r)
    publish(r.ring)
    w = window(r, ops)
    got = {m: run.read_metric(m, w) for m in NEW[:5]}
    assert got["put_front_ms"] == pytest.approx((30 + 20) / 2)
    assert got["put_body_wait_ms"] == pytest.approx((5 + 0) / 2)
    assert got["put_encode_wait_ms"] == pytest.approx((50 + 70) / 2)
    assert got["put_drives_ms"] == pytest.approx((80 + 150) / 2)
    assert got["drive_queue_ms"] == pytest.approx((2 + 0 + 4 + 6) / 4)


def test_idle_shares_and_the_time_with_blocks_queued(publish):
    r = Ring()
    ops = scene(r)
    publish(r.ring)
    w = window(r, ops)
    up = run.read_metric("idle_upstream_pct.put", w)
    disp = run.read_metric("idle_dispatcher_pct.put", w)
    # per dispatch the card is busy 6.95 + 5 + 8 + 0.1 ms, all inside its
    # 35 ms batch; its blocks queued 10 ms before it
    busy = 2 * (0.00695 + 0.005 + 0.008 + 0.0001)
    idle = 1.0 - busy
    assert disp == pytest.approx(100 * (2 * 0.035 - busy) / idle)
    assert up == pytest.approx(100 * (idle - (2 * 0.045 - busy)) / idle)
    queued_only = 2 * 0.010
    assert up + disp <= 100
    assert 100 - up - disp == pytest.approx(100 * queued_only / idle)


@pytest.mark.parametrize("bend", [
    # copies that start before the host issued them: the bracket is empty
    {"htod_early": 0.001},
    # copies out that end 1 ms after their calls return: empty too
    {"d2h_late": -0.001},
])
def test_alignment_that_cannot_hold_reads_none(publish, bend):
    r = Ring()
    ops = scene(r, **bend)
    publish(r.ring)
    w = window(r, ops)
    assert spans.dispatches(w) is None
    assert run.read_metric("idle_upstream_pct.put", w) is None
    assert run.read_metric("idle_dispatcher_pct.put", w) is None
    # the per-PUT metrics need no alignment
    assert run.read_metric("put_front_ms", w) == pytest.approx(25)


@pytest.mark.parametrize("extra", [
    # a copy in that no batch issued
    ("Memcpy HtoD (Pageable -> Device)", 100.9 + OFF, 0.001, "gpu_memcpy"),
    # a kernel outside every batch's copies
    ("gf_core_kernel", 100.3 + OFF, 0.001, "kernel"),
])
def test_copies_not_matched_one_to_one_read_none(publish, extra):
    r = Ring()
    ops = scene(r)
    ops.append(extra)
    publish(r.ring)
    w = window(r, ops)
    assert spans.dispatches(w) is None
    assert run.read_metric("idle_upstream_pct.put", w) is None


def test_overwritten_window_reads_none(publish):
    r = Ring(capacity=20)  # the scene writes 34 spans: the window's first are gone
    ops = scene(r)
    publish(r.ring)
    w = window(r, ops)
    assert all(run.read_metric(m, w) is None for m in NEW)


def test_spans_overwritten_long_before_the_window_do_not_count(publish):
    r = Ring(capacity=40)
    for i in range(10):  # 10 old spans and the scene's 34: 4 written over
        r.add("storage.read_version", 90.0 + i, 90.5 + i)
    ops = scene(r)
    publish(r.ring)
    assert r.ring.snapshot()[1] == 4
    w = window(r, ops)
    assert run.read_metric("put_front_ms", w) == pytest.approx(25)


def test_no_trace_or_no_ring_reads_none(publish):
    r = Ring()
    ops = scene(r)
    publish(r.ring)
    cpu = run.Window(CONFIG, {}, {}, [], None, 1.0)
    assert all(run.read_metric(m, cpu) is None for m in NEW)
    # a program that keeps no ring (its publisher has none, or no publisher)
    obs.set_publisher(TracePubSub())
    assert all(run.read_metric(m, window(r, ops)) is None for m in NEW)
    obs.set_publisher(None)
    assert all(run.read_metric(m, window(r, ops)) is None for m in NEW)


def test_open_across_gaps_names_the_spans_and_pools(publish):
    r = Ring()
    ops = scene(r)
    # a drive op on this thread open from A's batch to past B's copy in
    r.add("storage.create_file", 100.150, 100.600, req="A")
    publish(r.ring)
    gaps = spans.open_across_gaps(window(r, ops), top=10)
    # between the copies: after B, between A and B, before A
    last_d2h = 0.1682 + SLACK
    assert [round(g[1], 6) for g in gaps] == [round(1.0 - 0.4 - last_d2h, 6),
                                              round(0.542 - last_d2h, 6), 0.142]
    assert gaps[0][2] == {}
    assert gaps[1][0] == pytest.approx(100 + last_d2h)
    assert gaps[1][2] == {"storage.create_file": {"MainThread": 1}}
