"""ContextPool — a ThreadPoolExecutor that propagates contextvars.

``loop.run_in_executor`` and plain ``ThreadPoolExecutor.submit`` run the
callable in the worker's own (empty) context, which would drop the trace
request id (and any other contextvar, e.g. the QoS background marker for
code that submits from a background thread) at every thread hop. This
pool snapshots the submitter's context and runs the task inside it —
``contextvars.copy_context`` is an O(1) HAMT copy, so the idle-path cost
is negligible. While spans are kept, each task also carries its submit
time, and the first span of the task reads how long it waited for a
worker (``obs.take_queue_ns``: the ``queue_ns`` of storage spans).
"""

from __future__ import annotations

import contextvars
import time
from concurrent.futures import ThreadPoolExecutor

from . import trace


def _stamped(t_submit: int, fn, args, kwargs):
    trace._QUEUED.set([time.monotonic_ns() - t_submit])
    return fn(*args, **kwargs)


class ContextPool(ThreadPoolExecutor):
    def submit(self, fn, /, *args, **kwargs):
        ctx = contextvars.copy_context()
        if trace.recording():
            return super().submit(
                ctx.run, _stamped, time.monotonic_ns(), fn, args, kwargs
            )
        return super().submit(ctx.run, fn, *args, **kwargs)
