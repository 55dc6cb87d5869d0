"""obs — span tracing from S3 entry to TPU kernel.

The deep-tracing plane mirroring the reference's multi-type tracer
(MinIO cmd/http-tracer.go + internal/pubsub): a per-request
trace context (the generated ``x-amz-request-id``) rides a contextvar
from ``app.py:_entry`` through QoS admission, erasure object ops, the
TPU batch dispatcher, per-disk storage calls, and the background
heal/scanner planes. Every layer publishes typed records through the
server's ``TracePubSub``, whose ``SpanRing`` (``MINIO_TPU_TRACE_RING``)
also keeps the newest closed spans in memory without a subscriber; with
neither nothing allocates (``span()`` returns a shared no-op singleton).

Spans are opened ONLY via the context-manager API::

    with obs.span(obs.TYPE_STORAGE, "readfile", drive=ep) as sp:
        ...
        sp.set(bytes=n)

(the ``span`` miniovet rule enforces this — an orphaned start with no
``finally`` would leak the contextvar token and corrupt the tree).
"""

from .trace import (  # noqa: F401
    NOOP_SPAN,
    TRACE_TYPES,
    TYPE_DIAG,
    TYPE_FAULT,
    TYPE_HEAL,
    TYPE_INTERNAL,
    TYPE_PLACEMENT,
    TYPE_REBALANCE,
    TYPE_S3,
    TYPE_SANITIZER,
    TYPE_SCANNER,
    TYPE_STORAGE,
    TYPE_TPU,
    Span,
    SpanRing,
    active,
    bind_context,
    current_context,
    current_request_id,
    new_request_id,
    next_span_id,
    publish,
    publisher,
    recording,
    request_context,
    ring,
    set_publisher,
    set_request,
    span,
    take_queue_ns,
)
from .filters import TraceFilter, parse_duration  # noqa: F401
from .pool import ContextPool  # noqa: F401
