"""Storage-boundary fault injection.

``FaultInjectedDisk`` is the runtime chaos wrapper: a ``StorageAPI``
proxy that consults the fault registry per call and applies the matched
rule (error / latency / bitrot / torn-write / enospc). It sits UNDER
``HealthCheckedDisk`` in the server's drive stack
(``HealthCheckedDisk(FaultInjectedDisk(drive))``) so injected faults hit
the same circuit-breaker and latency accounting real faults do — the
point of the exercise is proving the hardening, not bypassing it.

``FaultyDisk`` is the deterministic test fixture (the analogue of the
reference's badDisk hook, cmd/erasure-encode_test.go:32-48), hoisted out
of tests/test_fault_injection.py so the fault-injection suite and the
chaos harness share one implementation.
"""

from __future__ import annotations

from ..storage import errors
from ..storage.health import _WRAPPED
from ..storage.interface import StorageAPI
from . import registry

# ops whose returned payload a bitrot rule may corrupt
_READ_OPS = frozenset({"read_file"})
# ops a torn-write rule truncates mid-write before failing
_WRITE_OPS = frozenset({"create_file", "append_file"})


class FaultInjectedDisk(StorageAPI):
    """Registry-driven fault proxy around any StorageAPI. Free (one
    module-global read per op) while no storage rules are armed."""

    def __init__(self, inner: StorageAPI):
        self._inner = inner

    @property
    def endpoint(self) -> str:  # type: ignore[override]
        return self._inner.endpoint

    @property
    def disk_id(self) -> str:  # type: ignore[override]
        return getattr(self._inner, "disk_id", "")

    @disk_id.setter
    def disk_id(self, v: str) -> None:
        self._inner.disk_id = v

    def local_path(self, volume: str, path: str) -> str | None:
        # pure path math; the native plane's direct preads bypass fault
        # injection by design (chaos runs force the Python read path)
        return self._inner.local_path(volume, path)

    @staticmethod
    def _modes_for(name: str) -> tuple[str, ...]:
        """Fault modes this op can actually express — check() must not
        consume a rule's count/hits on an op its mode cannot affect
        (bitrot needs a read payload, torn-write a write payload)."""
        modes = ["error", "latency", "enospc"]
        if name in _READ_OPS:
            modes.append("bitrot")
        if name in _WRITE_OPS:
            modes.append("torn-write")
        return tuple(modes)

    def walk_dir(self, volume, base=""):
        rule = registry.check(
            "storage", self.endpoint, "walk_dir",
            modes=self._modes_for("walk_dir"),
        )
        if rule is not None:
            self._pre(rule, "walk_dir", (), {})
        yield from self._inner.walk_dir(volume, base)

    def _pre(self, rule, name: str, a, kw):
        """Apply a rule before the inner call; may raise or stall."""
        if rule.mode == "latency":
            registry.sleep_latency(rule)
            return
        if rule.mode == "enospc":
            raise errors.DiskFull(f"{self.endpoint}: injected ENOSPC")
        if rule.mode == "torn-write":
            if name in _WRITE_OPS and len(a) >= 3 and (
                isinstance(a[2], (bytes, bytearray, memoryview))
                or isinstance(a[2], (list, tuple))
            ):
                # writev vectors (zero-copy shard frames) tear the same
                # way a flat payload does: half the joined bytes land
                payload = a[2]
                if isinstance(payload, (list, tuple)):
                    payload = b"".join(bytes(p) for p in payload)
                data = bytes(payload)
                try:
                    # half the payload lands, then the drive "dies":
                    # the staged shard file is torn, not merely absent
                    getattr(self._inner, name)(a[0], a[1], data[: len(data) // 2])
                except Exception:  # noqa: BLE001 — the tear is the fault
                    pass
            raise OSError(f"{self.endpoint}: injected torn write")
        if rule.mode == "error":
            raise OSError(f"{self.endpoint}: injected fault")
        # bitrot applies post-call

    def _call(self, name: str, *a, **kw):
        rule = registry.check(
            "storage", self.endpoint, name, modes=self._modes_for(name)
        )
        if rule is None:
            return getattr(self._inner, name)(*a, **kw)
        self._pre(rule, name, a, kw)
        out = getattr(self._inner, name)(*a, **kw)
        if rule.mode == "bitrot" and name in _READ_OPS and out:
            buf = bytearray(out)
            buf[rule.rng.randrange(len(buf))] ^= 0xFF
            return bytes(buf)
        return out


def _make_method(name):
    def method(self, *a, **kw):
        return self._call(name, *a, **kw)

    method.__name__ = name
    return method


for _name in _WRAPPED:
    if _name not in ("walk_dir",):
        setattr(FaultInjectedDisk, _name, _make_method(_name))

FaultInjectedDisk.__abstractmethods__ = frozenset()


class FaultyDisk:
    """Wraps a real drive; fails the ops named in `fail_ops`. With
    `fail_after` > 0 the first N calls of each op succeed first (models a
    drive dying mid-stream, like the reference's badDisk hook)."""

    def __init__(self, inner, fail_ops=(), fail_after=0, exc=None):
        self._inner = inner
        self.fail_ops = set(fail_ops)
        self.fail_after = fail_after
        self.exc = exc or OSError("injected fault")
        self.calls: dict[str, int] = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def wrapper(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            if name in self.fail_ops and self.calls[name] > self.fail_after:
                raise self.exc
            return attr(*a, **kw)

        return wrapper
