"""Healthinfo bundle + inspect-data (reference cmd/admin-handlers.go
HealthInfoHandler / InspectDataHandler).

``build_healthinfo`` assembles ONE diagnostic document from planes that
already exist — versions, knobs whose env value differs from the
declared default (secret-looking values redacted), topology, pool fill,
circuit-breaker states, the runtime sanitizer's violation ring, fault
counters, and the last self-measurement results — so "attach your
healthinfo" is one request, not a support-ticket scavenger hunt. The
admin op serves it as JSON or as a zip (``?format=zip``), the wire shape
`mc support diag` expects.

``inspect_data`` is the per-object deep dive: the raw ``xl.meta`` from
every drive holding the object plus a per-drive bitrot verdict
(streaming ``verify_file``, the heal scanner's own check), zipped — the
ROADMAP parity-gap item for `mc admin inspect`.
"""

from __future__ import annotations

import io
import json
import os
import platform
import sys
import time
import zipfile

from .. import fault, obs

# env names carrying credentials never leave the process un-redacted
_SECRET_MARKERS = ("PASSWORD", "SECRET", "_KEY", "TOKEN")


def _redact(name: str, value: str) -> str:
    if any(m in name.upper() for m in _SECRET_MARKERS):
        return "*REDACTED*"
    return value


def non_default_knobs() -> list[dict]:
    """Every declared knob whose env value is set and differs from its
    declared default — the config surface an operator actually changed.
    Prefix families report each instantiated member."""
    from ..analysis import knobs as knobreg

    out: list[dict] = []
    env = os.environ
    for k in knobreg._ALL:
        if k.prefix:
            for name in sorted(env):
                if name.startswith(k.name):
                    out.append({"name": name, "value": _redact(name, env[name]),
                                "default": k.default})
            continue
        v = env.get(k.name)
        if v is not None and v != k.default:
            out.append({"name": k.name, "value": _redact(k.name, v),
                        "default": k.default})
    return out


def build_healthinfo(server) -> dict:
    """The one-document diagnostic bundle."""
    from ..analysis import sanitizer
    from ..storage.health import HealthCheckedDisk
    from ..server.admin import server_info_payload, storage_info_payload
    from . import last_results, stats

    with obs.span(obs.TYPE_DIAG, "healthinfo"):
        breakers = []
        for d in getattr(server.store, "disks", []):
            if isinstance(d, HealthCheckedDisk):
                breakers.append(d.health())
        pool_fill = {}
        pm = getattr(server, "pool_mgr", None)
        if pm is not None:
            try:
                pool_fill = pm.pool_usage()
            except Exception as e:  # noqa: BLE001 — partial bundle beats none
                pool_fill = {"error": str(e)}
        return {
            "time": time.time(),
            "version": {
                "minio_tpu": "minio-tpu/0.1.0",
                "python": sys.version.split()[0],
                "platform": platform.platform(),
            },
            "hardware": {
                "cpuCores": os.cpu_count() or 1,
                "workerIndex": getattr(server, "worker_index", 0),
                "workerCount": getattr(server, "worker_count", 1),
            },
            "knobsNonDefault": non_default_knobs(),
            "topology": server_info_payload(server),
            "storage": storage_info_payload(server),
            "poolFill": pool_fill,
            "breakers": breakers,
            "sanitizer": sanitizer.status(),
            "faults": fault.status(),
            "selftest": {"last": last_results(), **stats()},
        }


def healthinfo_zip(info: dict) -> bytes:
    """The bundle as a one-entry zip (healthinfo.json), the `mc support
    diag` wire shape."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("healthinfo.json", json.dumps(info, indent=2))
    return buf.getvalue()


def _safe_name(endpoint: str) -> str:
    return "".join(c if c.isalnum() or c in "-._" else "_"
                   for c in str(endpoint))


def inspect_data(server, bucket: str, obj: str) -> bytes:
    """Zip of the object's raw per-drive ``xl.meta`` plus a
    ``verdicts.json`` with one streaming-bitrot verdict per drive —
    "ok", or the exact error that drive's shards fail with."""
    verdicts: list[dict] = []
    buf = io.BytesIO()
    with obs.span(obs.TYPE_DIAG, "inspect-data", bucket=bucket, object=obj):
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for i, d in enumerate(server.store.disks):
                ep = str(getattr(d, "endpoint", f"drive-{i}"))
                row: dict = {"drive": ep}
                try:
                    raw = d.read_file(bucket, f"{obj}/xl.meta")
                    z.writestr(f"{i:02d}-{_safe_name(ep)}/xl.meta", raw)
                    row["xlMetaBytes"] = len(raw)
                except Exception as e:  # noqa: BLE001 — absent shard is a verdict
                    row["verdict"] = f"no xl.meta: {e}"
                    verdicts.append(row)
                    continue
                try:
                    fi = d.read_version(bucket, obj)
                    d.verify_file(bucket, obj, fi)
                    row["verdict"] = "ok"
                except Exception as e:  # noqa: BLE001 — bitrot IS the verdict
                    row["verdict"] = f"{type(e).__name__}: {e}"
                verdicts.append(row)
            z.writestr("verdicts.json", json.dumps(
                {"bucket": bucket, "object": obj, "drives": verdicts},
                indent=2,
            ))
    return buf.getvalue()
