"""The port's span ring (``obs.SpanRing`` on the server's ``TracePubSub``):
bounded, stamped on ``time.monotonic_ns()``, kept without a subscriber,
off with ``MINIO_TPU_TRACE_RING=0``; and the spans a PUT leaves in it on
the dispatcher's route (the device codec on the CPU).

Run as a script, it times what one span costs the host in three states
of the publisher and fills a ring to capacity (``measure``)::

    PYTHONPATH=. python tests/test_torch_trace_ring.py [--spans N] [--capacity C]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest

from minio_tpu_torch import obs
from minio_tpu_torch.server.metrics import TracePubSub, span_ring

PORT_ENV = {
    "MINIO_TPU_BACKEND": "torch",
    "MINIO_TPU_TORCH_DEVICE": "cpu",
    "MINIO_TPU_CACHE": "0",
    "MINIO_TPU_SCAN_INTERVAL": "0",
    "MINIO_COMPRESSION_ENABLE": "off",
    # one full 1 MiB block at EC 8+8: a 128 KiB shard per drive
    "MINIO_STORAGE_CLASS_STANDARD": "EC:8",
}


@pytest.fixture()
def restore_publisher():
    prev = obs.publisher()
    yield
    obs.set_publisher(prev)


def _ring_publisher(capacity=1024):
    pub = TracePubSub(ring=obs.SpanRing(capacity))
    obs.set_publisher(pub)
    return pub


def _drive_span(op):
    """One drive operation's span, opened as ``storage/health.py`` does."""
    with obs.span(obs.TYPE_STORAGE, op, drive="d0", queue_ns=obs.take_queue_ns()) as sp:
        return sp


# -- the ring ----------------------------------------------------------------


@pytest.mark.parametrize("capacity,written", [(5, 3), (5, 5), (5, 13), (4096, 5000)])
def test_ring_is_bounded_and_counts_what_it_overwrote(capacity, written):
    ring = obs.SpanRing(capacity)
    for i in range(written):
        ring.add(f"n{i}", "", "R", i + 1, 0, 10 * i, 10 * i + 5, i, 0, 0)
    kept, over = ring.snapshot()
    assert over == max(0, written - capacity)
    # the newest are kept, oldest first
    assert [s.span_id for s in kept] == list(range(written - len(kept) + 1, written + 1))
    assert len(kept) == min(written, capacity)
    assert kept[-1].bytes == written - 1 and kept[-1].end_ns == 10 * (written - 1) + 5


@pytest.mark.parametrize("capacity", [64 * 1024, 5000])
def test_concurrent_writers_lose_no_span(capacity):
    """Writers take no lock: each next() of the ring's sequence owns its
    slot until the ring wraps past it. 32 threads, a switch interval of a
    microsecond: every span kept exactly once; past capacity, every slot
    full, no span twice and the count overwritten exact (a writer held
    up for a whole lap may put its older span over a newer one)."""
    ring = obs.SpanRing(capacity)
    per, threads = 1500, 32
    start = threading.Barrier(threads)

    def writer(t):
        start.wait(timeout=30)
        for i in range(per):
            ring.add("storage.create_file", "", f"R{t}", t * per + i + 1, t, i, i + 1)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=writer, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(prev)
    kept, over = ring.snapshot()
    total = per * threads
    assert over == max(0, total - capacity)
    assert len(kept) == min(total, capacity)
    assert len({s.seq for s in kept}) == len(kept) and kept[-1].seq == total - 1
    if not over:
        assert sorted(s.span_id for s in kept) == list(range(1, total + 1))
    assert all(s.req_id == f"R{s.parent_id}" for s in kept)


def test_ring_memory_is_bounded_at_capacity():
    ring = obs.SpanRing(8192)
    for i in range(3 * 8192):
        ring.add("storage.create_file", "", "REQ", i, 0, i, i + 1)
    # rows, slots and string tuples: 144 bytes a span, whatever was written
    assert ring.nbytes() == 8192 * 144
    assert ring.snapshot()[1] == 2 * 8192


def test_ring_rejects_no_capacity():
    with pytest.raises(ValueError):
        obs.SpanRing(0)


def test_a_field_that_is_not_a_whole_number_reads_zero(restore_publisher):
    pub = _ring_publisher()
    with obs.span(obs.TYPE_STORAGE, "readfile", bytes="many"):
        pass
    with obs.span(obs.TYPE_STORAGE, "readfile", bytes=3):
        pass
    got = [s.bytes for s in pub.ring.snapshot()[0]]
    assert got == [0, 3]


def test_stamps_parents_and_request_ids_cross_a_context_pool(restore_publisher):
    pub = _ring_publisher()
    pool = obs.ContextPool(max_workers=2, thread_name_prefix="ring-test")
    before = time.monotonic_ns()
    try:
        with obs.request_context("REQ7"):
            with obs.span(obs.TYPE_INTERNAL, "erasure.put.drives", bytes=7) as outer:
                def drive_op():
                    _drive_span("create_file")
                    # a second op of the same task took no worker
                    _drive_span("rename_data")
                    return threading.get_ident()

                worker = pool.submit(drive_op).result()
    finally:
        pool.shutdown()
    after = time.monotonic_ns()
    kept, over = pub.ring.snapshot()
    assert over == 0
    by = {s.name: s for s in kept}
    assert set(by) == {"erasure.put.drives", "storage.create_file", "storage.rename_data"}
    assert all(s.req_id == "REQ7" for s in kept)
    assert by["storage.create_file"].parent_id == outer.span_id
    assert by["storage.rename_data"].parent_id == outer.span_id
    assert by["erasure.put.drives"].parent_id == 0
    assert by["erasure.put.drives"].bytes == 7
    for s in kept:
        assert before <= s.start_ns <= s.end_ns <= after
    assert by["storage.create_file"].thread == worker
    assert by["erasure.put.drives"].thread == threading.get_ident()
    assert 0 <= by["storage.create_file"].queue_ns <= after - before
    assert by["storage.rename_data"].queue_ns == 0


def test_drive_span_with_a_subscriber_streams_its_queue_wait(restore_publisher):
    pub = _ring_publisher()
    sub = pub.subscribe()
    pool = obs.ContextPool(max_workers=1)
    try:
        with obs.request_context("LEAF"):
            with obs.span(obs.TYPE_INTERNAL, "outer") as outer:
                def op():
                    return isinstance(_drive_span("create_file"), obs.Span)

                assert pool.submit(op).result()
    finally:
        pool.shutdown()
        pub.unsubscribe(sub)
    rec = sub.q.get_nowait()
    assert rec["name"] == "create_file" and rec["parentId"] == outer.span_id
    assert rec["drive"] == "d0" and rec["queue_ns"] >= 0
    kept = pub.ring.snapshot()[0]
    assert [s.name for s in kept] == ["storage.create_file", "internal.outer"]
    assert kept[0].queue_ns == rec["queue_ns"]


def test_an_exception_leaves_status_one(restore_publisher):
    pub = _ring_publisher()
    with pytest.raises(KeyError):
        with obs.span(obs.TYPE_STORAGE, "read_version", queue_ns=obs.take_queue_ns()):
            raise KeyError("gone")
    with pytest.raises(KeyError):
        with obs.span(obs.TYPE_INTERNAL, "erasure.put_object"):
            raise KeyError("gone")
    with obs.span(obs.TYPE_S3, "s3.request", status=404):
        pass
    assert [s.status for s in pub.ring.snapshot()[0]] == [1, 1, 404]


def test_ring_only_builds_no_record_and_publishes_nothing(restore_publisher):
    pub = _ring_publisher()
    published = []
    pub.publish = published.append
    with obs.request_context("R"):
        with obs.span(obs.TYPE_STORAGE, "op"):
            pass
    assert published == []
    assert len(pub.ring.snapshot()[0]) == 1
    # with a subscriber the stream record is as before, and the ring keeps the span too
    sub = pub.subscribe()
    del pub.publish
    try:
        with obs.request_context("R2"):
            with obs.span(obs.TYPE_STORAGE, "op", drive="d0"):
                pass
    finally:
        pub.unsubscribe(sub)
    rec = sub.q.get_nowait()
    assert rec["name"] == "op" and rec["reqId"] == "R2" and rec["drive"] == "d0"
    assert rec["durationNs"] >= 0
    assert [s.req_id for s in pub.ring.snapshot()[0]] == ["R", "R2"]


def test_bare_pubsub_keeps_the_noop_contract(restore_publisher):
    pub = TracePubSub()
    assert pub.ring is None
    obs.set_publisher(pub)
    assert obs.span(obs.TYPE_STORAGE, "op", bytes=1) is obs.NOOP_SPAN
    assert not obs.recording() and obs.ring() is None
    sub = pub.subscribe()
    try:
        assert obs.recording() and isinstance(obs.span(obs.TYPE_TPU, "y"), obs.Span)
    finally:
        pub.unsubscribe(sub)
    assert obs.span(obs.TYPE_TPU, "z") is obs.NOOP_SPAN


@pytest.mark.parametrize("value,capacity", [("0", None), ("", None), ("64", 64),
                                            ("bad", 262144)])
def test_ring_knob(monkeypatch, restore_publisher, value, capacity):
    monkeypatch.setenv("MINIO_TPU_TRACE_RING", value)
    ring = span_ring()
    assert (ring.capacity if ring is not None else None) == capacity
    obs.set_publisher(TracePubSub(ring=ring))
    assert (obs.span(obs.TYPE_STORAGE, "op") is obs.NOOP_SPAN) == (capacity is None)


def test_server_pubsub_has_the_default_ring_and_none_at_zero(monkeypatch, restore_publisher):
    from minio_tpu_torch.analysis.knobs import KNOBS
    from minio_tpu_torch.server.app import S3Server

    assert KNOBS["MINIO_TPU_TRACE_RING"].default == "262144"
    monkeypatch.delenv("MINIO_TPU_TRACE_RING", raising=False)
    srv = S3Server()
    try:
        assert srv.trace.ring.capacity == 262144 and obs.recording()
        assert srv.trace.ring.nbytes() == 0  # nothing taken before a span
    finally:
        srv.close()
    monkeypatch.setenv("MINIO_TPU_TRACE_RING", "0")
    srv = S3Server()
    try:
        assert srv.trace.ring is None
        assert obs.span(obs.TYPE_STORAGE, "op") is obs.NOOP_SPAN
    finally:
        srv.close()


def test_span_cost_reports_every_state(restore_publisher):
    prev = obs.publisher()
    got = measure(spans=200, capacity=4096)
    assert obs.publisher() is prev
    states = ("no_ring_ns", "ring_only_ns", "subscriber_ns")
    assert set(got) == {"spans", "capacity", "ring_nbytes", "ring_traced_bytes", *states,
                        *(f"nesting_{k}" for k in states)}
    assert got["ring_nbytes"] == 4096 * 144
    assert got["ring_traced_bytes"] > 0
    assert all(got[k] > 0 for k in states)


# -- the dispatcher ------------------------------------------------------------


def test_dispatcher_queue_and_batch_spans(restore_publisher, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    pub = _ring_publisher()
    disp = DeviceDispatcher(rs_torch.get_torch_codec(4, 2), 1024, window_s=0.01)
    assert "prefetch_blocks" not in disp.stats
    blocks = np.random.default_rng(0).integers(0, 256, (2, 4, 1024), np.uint8)
    with obs.request_context("DQ1"):
        with obs.span(obs.TYPE_INTERNAL, "erasure.put.encode-wait") as wait:
            disp.encode(blocks)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        kept = pub.ring.snapshot()[0]
        if any(s.name == "dispatch.results" for s in kept):
            break
        time.sleep(0.01)
    by = {s.name: s for s in kept}
    q, b = by["dispatch.queue"], by["dispatch.batch"]
    assert q.req_id == "DQ1" and q.parent_id == wait.span_id and q.bytes == blocks.nbytes
    assert q.end_ns == b.start_ns
    assert b.req_id == "DQ1" and b.bytes == blocks.nbytes and b.label == "fused"
    phases = [by[n] for n in ("dispatch.assemble", "dispatch.h2d", "dispatch.kernels",
                              "dispatch.d2h", "dispatch.results")]
    # the fused route (its plain version on the CPU): each phase a child
    # of the batch, in order, inside it
    assert all(p.parent_id == b.span_id for p in phases)
    assert b.start_ns == phases[0].start_ns and phases[-1].end_ns == b.end_ns
    assert all(x.end_ns <= y.start_ns for x, y in zip(phases, phases[1:]))
    assert len({s.thread for s in [b] + phases}) == 1


# -- a PUT through the server ------------------------------------------------------


@pytest.fixture(scope="module")
def port_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        mp.delenv("MINIO_TPU_TRACE_RING", raising=False)
        yield mp


@pytest.fixture(scope="module")
def server(port_env, tmp_path_factory):
    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server import web
    from minio_tpu_torch.server.app import make_server

    prev = obs.publisher()
    base = tmp_path_factory.mktemp("ring-drives")
    srv = make_server([str(base / f"d{i}") for i in range(16)])
    port, stop = web.serve_in_thread(srv.app, port=0)
    cli = S3Client(f"127.0.0.1:{port}")
    assert cli.make_bucket("ringbkt").status == 200
    yield srv, cli
    srv.close()
    stop()
    obs.set_publisher(prev)


def test_put_leaves_one_tree_from_the_front_to_the_drives(server):
    srv, cli = server
    body = os.urandom(1 << 20)
    r = cli.put_object("ringbkt", "one-block", body)
    assert r.status == 200
    rid = r.headers["x-amz-request-id"]
    kept, over = srv.trace.ring.snapshot()
    assert over == 0
    mine = [s for s in kept if s.req_id == rid]
    ids = {s.span_id: s for s in mine}

    def parent(s):
        return ids[s.parent_id].name

    req = next(s for s in mine if s.name == "s3.request")
    assert req.label == "PutObject" and req.status == 200 and req.bytes == len(body)
    assert req.parent_id == 0
    put = next(s for s in mine if s.name == "erasure.put_object")
    assert parent(put) == "s3.request"
    waits = [s for s in mine if s.name == "erasure.put.encode-wait"]
    drives = [s for s in mine if s.name == "erasure.put.drives"]
    assert waits and drives
    assert all(parent(s) == "erasure.put_object" for s in waits + drives)
    ops = [s for s in mine if s.name.startswith("storage.")]
    assert {s.name for s in ops if parent(s) == "erasure.put.drives"} >= {
        "storage.create_file", "storage.rename_data"}
    # 16 shard files and their commits, each on a drive-io worker
    names = {t.ident: t.name for t in threading.enumerate()}
    writes = [s for s in ops if s.name == "storage.create_file"]
    assert len(writes) == 16
    assert all(names.get(s.thread, "").startswith("drive-io") for s in writes)
    assert all(s.queue_ns >= 0 for s in ops)
    # the dispatcher served the block: its queue span under the wait,
    # its batch naming this request alone
    queue = [s for s in mine if s.name == "dispatch.queue"]
    assert len(queue) == 1 and parent(queue[0]) == "erasure.put.encode-wait"
    batch = [s for s in mine if s.name == "dispatch.batch"]
    assert len(batch) == 1 and queue[0].end_ns == batch[0].start_ns
    # every span of the request inside the request
    assert all(req.start_ns <= s.start_ns and s.end_ns <= req.end_ns
               for s in mine if s is not req and not s.name.startswith("dispatch."))


def test_stream_tree_closes_on_a_server_with_a_ring(server):
    """With the ring on and a subscriber on the server's stream, every
    span's parent is a record of the stream: the request's own record
    carries the span id the spans below it name."""
    srv, cli = server
    sub = srv.trace.subscribe()
    try:
        r = cli.put_object("ringbkt", "streamed", os.urandom(1 << 20))
        assert r.status == 200
        deadline = time.monotonic() + 5
        recs = []
        while time.monotonic() < deadline:
            while not sub.q.empty():
                recs.append(sub.q.get_nowait())
            if any(x["type"] == "s3" for x in recs):
                break
            time.sleep(0.01)
    finally:
        srv.trace.unsubscribe(sub)
    rid = r.headers["x-amz-request-id"]
    mine = [x for x in recs if x.get("reqId") == rid]
    top = [x for x in mine if x["type"] == "s3"]
    assert len(top) == 1 and top[0]["spanId"] > 0
    ids = {x["spanId"] for x in mine if "spanId" in x}
    spans = [x for x in mine if "parentId" in x]
    assert {x["name"] for x in spans} >= {"erasure.put_object", "create_file"}
    assert all(x["parentId"] in ids for x in spans)


# -- the host's cost of a span, and the ring's memory -------------------------------


def _drive_ops(n: int) -> None:
    for _ in range(n):
        _drive_span("create_file")


def _nesting(n: int) -> None:
    for _ in range(n):
        with obs.span(obs.TYPE_INTERNAL, "erasure.put.drives"):
            pass


def _per_span_ns(loop, n: int) -> float:
    """ns per span: the least of 5 rounds of ``n`` spans (the others
    carry what else ran on the host's cores)."""
    rounds = []
    with obs.request_context(obs.new_request_id()):
        for _ in range(5):
            t0 = time.perf_counter_ns()
            loop(n)
            rounds.append((time.perf_counter_ns() - t0) / n)
    return min(rounds)


def measure(spans: int = 200_000, capacity: int = 262_144) -> dict:
    """ns per span of a drive operation's span (about three in four of a
    PUT's) and of one that others nest under, with no publisher (the
    shared no-op span), a ring only (the server's default) and one
    subscriber without a ring (the admin trace stream); then a ring of
    ``capacity`` filled with spans of 40 to a request, as a PUT leaves
    them: its own rows (``SpanRing.nbytes``) and everything allocated on
    the way (``tracemalloc``, the request-id strings included)."""
    prev = obs.publisher()
    out: dict = {"spans": spans}
    try:
        for state, pub in (("no_ring", None),
                           ("ring_only", TracePubSub(ring=obs.SpanRing(capacity))),
                           ("subscriber", TracePubSub())):
            sub = None
            if state == "subscriber":
                sub = pub.subscribe()
                sub.q.maxsize = 0  # unbounded: time the publish, not the drops
            obs.set_publisher(pub)
            out[f"{state}_ns"] = _per_span_ns(_drive_ops, spans)
            out[f"nesting_{state}_ns"] = _per_span_ns(_nesting, spans)
            if sub is not None:
                pub.unsubscribe(sub)

        tracemalloc.start()
        base = tracemalloc.get_traced_memory()[0]
        ring = obs.SpanRing(capacity)
        t = time.monotonic_ns()
        for i in range(capacity):
            if i % 40 == 0:
                req = obs.new_request_id()
            ring.add("storage.create_file", "", req, i + 1, i, t, t + 1000, 1 << 20, 500, 0)
        held = tracemalloc.get_traced_memory()[0] - base
        tracemalloc.stop()
        out.update(capacity=capacity, ring_nbytes=ring.nbytes(), ring_traced_bytes=held)
    finally:
        obs.set_publisher(prev)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the host's cost of a span")
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--capacity", type=int, default=262_144)
    args = ap.parse_args()
    print(json.dumps(measure(args.spans, args.capacity)))
