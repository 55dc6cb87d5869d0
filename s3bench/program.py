"""The system under test: minio_tpu_torch's S3 server in this process.

Everything the benchmark takes from the program goes through here: the
server (``server.app.make_server`` on ``server.web.serve_in_thread``, as
the port's own tests and smoke start it) and the program's counters,
read as one snapshot at each edge of the window. Nothing here imports
the JAX package.
"""

from __future__ import annotations

import os

MIB = 1 << 20


def start(drives: list[str]):
    """Build the object layer over ``drives`` and serve it on an
    ephemeral port of 127.0.0.1. Returns (server, port, stop)."""
    from minio_tpu_torch.server import app, web

    srv = app.make_server(drives)
    # the read buffer the server's own entry point gives its front
    bufsize = int(os.environ.get("MINIO_TPU_HTTP_READBUF", str(4 * MIB)))
    port, web_stop = web.serve_in_thread(srv.app, port=0, read_bufsize=bufsize)

    def stop():
        srv.close()
        web_stop()

    return srv, port, stop


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from minio_tpu_torch.ops import _build

    _build.load()


def counters(srv) -> dict:
    """One snapshot of the program's own counters."""
    from minio_tpu_torch.ops import bitrot_cuda, fused_cuda, rs_cuda
    from minio_tpu_torch.parallel import dispatcher

    m = srv.metrics
    with m._mu:
        requests = dict(m.requests_total)
        ttfb = dict(m.ttfb_seconds)
    return {
        "requests_total": requests,
        "ttfb_seconds": ttfb,
        "dispatch": {k: v for k, v in dispatcher.aggregate_stats().items()
                     if not isinstance(v, list)},
        "k1": {"encode_launches": fused_cuda.encode_launches,
               "decode_launches": fused_cuda.decode_launches,
               "shapes": [[list(k), n] for k, n in fused_cuda.launch_shapes.items()]},
        "k2": {"launches": bitrot_cuda.launches},
        "k3": {"launches": rs_cuda.launches},
    }
