"""miniovet — project-specific static analysis for minio_tpu_torch.

The reference MinIO tree gates every commit behind ``go vet`` +
staticcheck; this package is the Python/JAX equivalent, tuned to the
bug classes this reproduction actually hits:

- ``blocking``        blocking calls (time.sleep, requests, sync I/O,
                      subprocess) inside ``async def`` stall the event
                      loop that serves every S3 request.
- ``cancellation``    broad ``except`` in async code that can swallow
                      ``asyncio.CancelledError`` — client disconnects
                      must propagate, not get logged as errors.
- ``hostsync``        host↔device syncs (np.asarray, float(), item(),
                      block_until_ready, jax.device_get) in the TPU hot
                      path outside whitelisted batch-boundary points.
- ``gf-dtype``        GF(2^8) tables / stripe buffers that are not
                      uint8, and Pallas block shapes off the (8, 128)
                      TPU tile.
- ``lock-discipline`` ``await`` while holding a sync threading lock,
                      and namespace-lock acquires with no try/finally
                      release.
- ``knob``            every MINIO_* env var read must be declared in
                      the central registry (analysis/knobs.py), from
                      which minio_tpu_torch/docs/CONFIG.md is generated; declared
                      defaults must match the read site.
- ``span``            obs trace spans may only be opened via the
                      context-manager API (``with obs.span(...)``);
                      an orphaned start would leak the trace context
                      token on any non-finally exit path.
- ``retry-discipline`` ad-hoc retry loops (``time.sleep`` pacing a loop
                      around a network/storage call whose failures it
                      swallows) outside ``fault/retry.py`` — all
                      retries ride the shared policy (backoff, jitter,
                      idempotency classes tuned in one place).

Run it as ``python -m minio_tpu_torch.analysis [paths] [--strict]`` (see
__main__.py) or ``make check``; tier-1 enforces a clean tree via
tests/test_analysis.py. Per-line escape hatch::

    something_flagged()  # miniovet: ignore[rule] -- reason

This module imports nothing heavy (no jax, no numpy): the gate must be
runnable in any environment that can parse the source.
"""

from .core import (  # noqa: F401
    ALL_RULES,
    Finding,
    analyze_file,
    analyze_paths,
    analyze_source,
    iter_python_files,
)

__all__ = [
    "ALL_RULES",
    "Finding",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
]
