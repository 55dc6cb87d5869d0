"""The program's span ring over the window, beside the card's trace.

The server in the run's process keeps its closed spans in a ring
(``minio_tpu_torch.obs``: ``obs.publisher().ring``), stamped with
``time.monotonic_ns()``, the clock of ``DeviceTrace.t0``. The window's
spans are those that start in ``[trace.t0, trace.t0 + trace.window_s]``.

The trace's operations carry the profiler's own clock. Each batch the
dispatcher served on the fused route is matched, in order, to its copies
on the card: its ``dispatch.h2d`` to its copy in, its ``dispatch.d2h``
to its copies out. A copy cannot start before the host issues it, and a
copy from the card into pageable memory has finished before its host
call returns, so the offset from the ring's clock to the trace's lies in
``[last DtoH end - dispatch.d2h end, HtoD start - dispatch.h2d start]``
for each batch: its bracket. The card's stream runs the batch's kernels
between its copies, so all of a batch's device work lies, on the ring's
clock, inside ``[dispatch.h2d start, dispatch.d2h end]``, whatever the
offset is within the bracket.

That containment is what the idle shares stand on; they need no one
offset for the window. On the H100's host the two clocks wander against
each other by several milliseconds over ten seconds (upper bounds of
one run fell 5 ms and rose again), and a batch's bracket is 0.4-15 ms
wide (the copy out's return waits, likely for the GIL), so no single
offset, nor one per stretch of batches, holds within 1 ms in every run.

Every reader returns None without a trace (the CPU route), without a
ring (a program that keeps none), and where the ring overwrote spans of
the window. The idle readers also return None where the batches and the
card's operations cannot be matched one to one: a batch off the fused
route, copies that do not pair up, an empty bracket, or an operation
outside every batch's copies.
"""

from __future__ import annotations

import bisect
import threading
from collections import namedtuple

# a span is appended when it ends, a dispatch's spans when its batch
# ends: the oldest span kept was appended this soon after its end
APPEND_SLACK_NS = 1_000_000_000


def _ring():
    try:
        from minio_tpu_torch import obs
    except ImportError:
        return None
    return getattr(obs.publisher(), "ring", None)


def window_spans(w):
    """The window's spans (ring clock, ns) and every span the ring kept,
    or None."""
    if w.trace is None or w.trace.window_s <= 0:
        return None
    cached = getattr(w, "_ring_spans", None)
    if cached is not None:
        return cached
    ring = _ring()
    if ring is None:
        return None
    kept, overwritten = ring.snapshot()
    lo = int(w.trace.t0 * 1e9)
    hi = lo + int(w.trace.window_s * 1e9)
    # spans written over were appended before the oldest one kept
    if overwritten and (not kept or kept[0].end_ns + APPEND_SLACK_NS >= lo):
        return None
    win = [s for s in kept if lo <= s.start_ns <= hi]
    w._ring_spans = (win, kept)
    return w._ring_spans


class Dispatch(namedtuple("Dispatch", "h2d d2h dev lo hi")):
    """One batch on the fused route, matched to its copies on the card.
    ``h2d``/``d2h``: the start of its copy in and the end of its copies
    out, on the ring's clock (s); ``dev``: its first copy in's start and last copy out's
    end on the trace's clock (s); ``lo``, ``hi``: its bracket on the
    offset from the ring's clock to the trace's (s)."""


def dispatches(w):
    """The window's batches matched one to one to the card's operations,
    in the order they ran, or None."""
    got = window_spans(w)
    if got is None:
        return None
    win = got[0]
    batches = {s.span_id: s for s in win if s.name == "dispatch.batch"}
    h2d = {s.parent_id: s for s in win if s.name == "dispatch.h2d"}
    d2h = {s.parent_id: s for s in win if s.name == "dispatch.d2h"}
    if not batches or set(h2d) != set(batches) or set(d2h) != set(batches):
        return None
    order = sorted(batches, key=lambda b: h2d[b].start_ns)
    ops = sorted(w.trace.ops, key=lambda o: o[1])
    hops = [o for o in ops if o[3] == "gpu_memcpy" and "HtoD" in o[0]]
    dops = [o for o in ops if o[3] == "gpu_memcpy" and "DtoH" in o[0]]
    n = len(order)
    if not hops or not dops or len(hops) % n or len(dops) % n:
        return None
    ch, cd = len(hops) // n, len(dops) // n
    hi_ns = int(w.trace.t0 * 1e9) + int(w.trace.window_s * 1e9)
    out = []
    for j, b in enumerate(order):
        a, z = h2d[b].start_ns, d2h[b].end_ns
        start = hops[j * ch][1]
        end = max(o[1] + o[2] for o in dops[j * cd:(j + 1) * cd])
        lo, hi = end - z / 1e9, start - a / 1e9
        if lo > hi or z > hi_ns or (out and start < out[-1].dev[1]):
            return None
        out.append(Dispatch(a / 1e9, z / 1e9, (start, end), lo, hi))
    # every operation on the card lies within some batch's copies
    starts = [d.dev[0] for d in out]
    for _, s, dur, _ in ops:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or s + dur > out[i].dev[1]:
            return None
    return out


# -- per PUT -------------------------------------------------------------------

def window_puts(w):
    """{request id: its s3.request span} of the window's PutObject
    requests that answered 200, and {request id: [its spans]}; or None."""
    got = window_spans(w)
    if got is None:
        return None
    win, kept = got
    puts = {s.req_id: s for s in win
            if s.name == "s3.request" and s.label == "PutObject" and s.status == 200}
    tree: dict[str, list] = {r: [] for r in puts}
    for s in kept:
        if s.req_id in tree:
            tree[s.req_id].append(s)
    return puts, tree


def mean_summed_ms(w, name: str):
    """Mean over the window PUTs of the summed time of their ``name``
    spans (ms)."""
    got = window_puts(w)
    if not got or not got[0]:
        return None
    puts, tree = got
    total = sum(s.end_ns - s.start_ns for r in puts for s in tree[r] if s.name == name)
    return total / len(puts) / 1e6


def front_ms(w):
    """Mean self time of the window PUTs' ``s3.request`` (ms): the
    request less the part its ``erasure.put_object`` children cover."""
    got = window_puts(w)
    if not got or not got[0]:
        return None
    puts, tree = got
    total = 0
    for r, req in puts.items():
        kids = [(max(s.start_ns, req.start_ns), min(s.end_ns, req.end_ns)) for s in tree[r]
                if s.name == "erasure.put_object" and s.parent_id == req.span_id]
        total += (req.end_ns - req.start_ns) - _length(_union(kids))
    return total / len(puts) / 1e6


def drive_queue_ms(w):
    """Mean wait for a drive-pool worker of the window PUTs' storage
    spans (ms)."""
    got = window_puts(w)
    if not got:
        return None
    waits = [s.queue_ns for r in got[0] for s in got[1][r] if s.name.startswith("storage.")]
    return sum(waits) / len(waits) / 1e6 if waits else None


# -- the card's idle time --------------------------------------------------------

def idle_shares(w):
    """(upstream %, dispatcher %) of the card's idle time in the traced
    window: no block queued at or served by the dispatcher (no
    ``dispatch.queue`` or ``dispatch.batch`` open), and the dispatcher
    inside a ``dispatch.batch``. The rest of the idle time had blocks
    waiting in the batch window. Every operation on the card lies inside
    its batch's span (``dispatches``), so the card's busy time is all
    inside the batches' union, and each share is a length less the busy
    time. None where the batches and the operations do not match."""
    if dispatches(w) is None:
        return None
    kept = window_spans(w)[1]
    lo, hi = w.trace.t0, w.trace.t0 + w.trace.window_s
    busy = w.trace.busy_s()
    idle = w.trace.window_s - busy
    batch = _length(_clip(_union([(s.start_ns / 1e9, s.end_ns / 1e9) for s in kept
                                  if s.name == "dispatch.batch"]), lo, hi))
    held = _length(_clip(_union([(s.start_ns / 1e9, s.end_ns / 1e9) for s in kept
                                 if s.name in ("dispatch.batch", "dispatch.queue")]), lo, hi))
    if idle <= 0 or batch < busy:
        return None
    return 100.0 * (idle - (held - busy)) / idle, 100.0 * (batch - busy) / idle


def open_across_gaps(w, top: int = 10):
    """The ``top`` longest stretches in which the card was idle for
    certain (ring clock, s): from one batch's copies out to the next
    one's copy in, and before the first and after the last, and for
    each the spans open across all of it, counted by name and by the
    pool of the thread that wrote them: [(start, seconds, {name: {pool:
    n}})]. Each true idle gap holds its stretch, and is longer by at
    most the two batches' brackets. None where ``dispatches`` is."""
    ds = dispatches(w)
    if ds is None:
        return None
    kept = window_spans(w)[1]
    edges = [w.trace.t0] + [x for d in ds for x in (d.h2d, d.d2h)] + \
        [w.trace.t0 + w.trace.window_s]
    gaps = sorted(zip(edges[::2], edges[1::2]), key=lambda g: g[0] - g[1])[:top]
    pools = {t.ident: t.name.rstrip("0123456789_-") for t in threading.enumerate()}
    out = []
    for a, b in gaps:
        names: dict = {}
        for s in kept:
            if s.start_ns / 1e9 <= a and s.end_ns / 1e9 >= b:
                by = names.setdefault(s.name, {})
                pool = pools.get(s.thread, "gone")
                by[pool] = by.get(pool, 0) + 1
        out.append((a, b - a, names))
    return out


# -- intervals (sorted, disjoint lists of (start, end)) ----------------------------

def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def _clip(ivs, lo, hi):
    """``ivs`` cut to ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in ivs if b > lo and a < hi]
