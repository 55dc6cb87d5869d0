"""Object + drive speedtests (reference cmd/perf-tests.go selfSpeedTest,
cmd/speedtest.go driveSpeedTest).

The object speedtest drives the REAL serving path — dispatcher, erasure
coder, storage plane — under ``qos.background_context()`` so its stripe
blocks ride the dispatcher's background lane and a speedtest can never
starve foreground traffic. Concurrency autotunes: the ramp doubles the
client count until aggregate throughput stops improving by
``KNEE_GAIN`` (the reference's speedTest loop does the same with
``autotune``), and the knee step is reported as the node's capacity.

The drive speedtest bypasses the object layer entirely: sequential
write/read of one large file plus random 4 KiB reads and small-file
writes per drive, with latency percentiles — the per-drive numbers that
make `/system/drive/latency` anomalies actionable. A ``diag/slow-drive``
fault rule stalls the targeted drive INSIDE the timed sections, so the
chaos test can assert the matrix localizes the slow drive by name.
"""

from __future__ import annotations

import os
import random
import time
import uuid

from .. import fault, obs
from ..qos import background_context

SCRATCH_VOL = ".minio.sys"

# autotune: stop ramping when doubling concurrency gains < 5% aggregate
# throughput (the previous step is the knee), hard ceiling via knob
KNEE_GAIN = 1.05
RAMP_CEILING_KNOB = "MINIO_TPU_DIAG_MAX_CONCURRENCY"


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def _lat_ms(xs: list[float]) -> dict:
    return {
        "p50Ms": round(_pct(xs, 0.50) * 1e3, 3),
        "p99Ms": round(_pct(xs, 0.99) * 1e3, 3),
    }


# -- drive speedtest --------------------------------------------------------


def _one_drive(d, payload: bytes, rand_count: int, rng: random.Random) -> dict:
    """Sequential + random read/write numbers for one drive. The
    slow-drive fault rule is consulted per phase and its stall applied
    inside the timing window — an injected fault must be VISIBLE in the
    published matrix, that is the whole point."""
    run_id = uuid.uuid4().hex[:8]
    path = f"diag-speedtest/{run_id}.bin"
    small = os.urandom(4096)
    out: dict = {"endpoint": str(d.endpoint)}

    def stall(op: str) -> None:
        rule = fault.check("diag", str(d.endpoint), op, modes=("slow-drive",))
        if rule is not None:
            fault.sleep_latency(rule)

    try:
        t0 = time.perf_counter()
        stall("seq-write")
        d.create_file(SCRATCH_VOL, path, payload)
        wdt = time.perf_counter() - t0
        t0 = time.perf_counter()
        stall("seq-read")
        got = d.read_file(SCRATCH_VOL, path)
        rdt = time.perf_counter() - t0

        # random 4 KiB reads at seeded offsets within the sequential file
        rand_lat: list[float] = []
        span = max(len(payload) - 4096, 1)
        t0 = time.perf_counter()
        for _ in range(rand_count):
            off = rng.randrange(span)
            t1 = time.perf_counter()
            stall("rand-read")
            d.read_file(SCRATCH_VOL, path, offset=off, length=4096)
            rand_lat.append(time.perf_counter() - t1)
        rr_dt = time.perf_counter() - t0

        # random small writes: distinct 4 KiB files (the storage API is
        # whole-file create; in-place overwrite is not a drive op here)
        wr_lat: list[float] = []
        t0 = time.perf_counter()
        for i in range(rand_count):
            t1 = time.perf_counter()
            stall("rand-write")
            d.create_file(SCRATCH_VOL, f"diag-speedtest/{run_id}-{i}.s", small)
            wr_lat.append(time.perf_counter() - t1)
        rw_dt = time.perf_counter() - t0

        out.update({
            "writeMiBps": round(len(payload) / 2**20 / max(wdt, 1e-9), 1),
            "readMiBps": round(len(got) / 2**20 / max(rdt, 1e-9), 1),
            "randReadIOPS": round(rand_count / max(rr_dt, 1e-9), 1),
            "randWriteIOPS": round(rand_count / max(rw_dt, 1e-9), 1),
            "randRead": _lat_ms(rand_lat),
            "randWrite": _lat_ms(wr_lat),
        })
    except Exception as e:  # noqa: BLE001 — a broken drive is a row
        out["error"] = str(e)
    finally:
        try:
            d.delete(SCRATCH_VOL, f"diag-speedtest/{run_id}.bin")
            for i in range(rand_count):
                d.delete(SCRATCH_VOL, f"diag-speedtest/{run_id}-{i}.s")
        except Exception:  # noqa: BLE001 — scratch cleanup best-effort
            pass
    return out


def drive_speedtest(server, size_mb: int = 4, rand_count: int = 16) -> dict:
    """Per-drive sequential+random perf for every local drive. Remote
    drives are skipped — each node measures its OWN drives and the admin
    fan-out assembles the cluster matrix."""
    from . import record

    payload = os.urandom(max(1, min(size_mb, 64)) << 20)
    drives = []
    with obs.span(obs.TYPE_DIAG, "drive-speedtest",
                  drives=len(server.store.disks)):
        for i, d in enumerate(server.store.disks):
            if d.local_path(SCRATCH_VOL, "") is None:
                continue  # a peer's drive: its node measures it
            drives.append(_one_drive(d, payload, rand_count,
                                     random.Random(0xD1A6 + i)))
    result = {"sizeMiB": len(payload) >> 20, "randCount": rand_count,
              "drives": drives}
    record("drive", result)
    return result


# -- object speedtest -------------------------------------------------------


def _step(server, concurrency: int, size: int, ops: int) -> dict:
    """One ramp step: `concurrency` closed-loop workers, each PUTting
    then GETting `ops` objects of `size` bytes through the full object
    path. Worker threads start from a fresh contextvar context, so each
    re-enters background_context() itself."""
    from concurrent.futures import ThreadPoolExecutor

    payload = os.urandom(size)
    run_id = uuid.uuid4().hex[:8]
    put_lat: list[list[float]] = [[] for _ in range(concurrency)]
    get_lat: list[list[float]] = [[] for _ in range(concurrency)]

    def put_worker(w: int) -> None:
        with background_context():
            for i in range(ops):
                t0 = time.perf_counter()
                server.store.put_object(
                    SCRATCH_VOL, f"diag-speedtest/{run_id}-{w}-{i}", payload
                )
                put_lat[w].append(time.perf_counter() - t0)

    def get_worker(w: int) -> None:
        with background_context():
            for i in range(ops):
                t0 = time.perf_counter()
                _, it = server.store.get_object(
                    SCRATCH_VOL, f"diag-speedtest/{run_id}-{w}-{i}"
                )
                for _ in it:
                    pass
                get_lat[w].append(time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_worker, range(concurrency)))
        put_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(pool.map(get_worker, range(concurrency)))
        get_dt = time.perf_counter() - t0
        for w in range(concurrency):
            for i in range(ops):
                try:
                    server.store.delete_object(
                        SCRATCH_VOL, f"diag-speedtest/{run_id}-{w}-{i}"
                    )
                except Exception:  # noqa: BLE001 — scratch cleanup
                    pass

    total_mib = size * ops * concurrency / 2**20
    puts = [x for lat in put_lat for x in lat]
    gets = [x for lat in get_lat for x in lat]
    return {
        "concurrency": concurrency,
        "putMiBps": round(total_mib / max(put_dt, 1e-9), 1),
        "getMiBps": round(total_mib / max(get_dt, 1e-9), 1),
        "put": _lat_ms(puts),
        "get": _lat_ms(gets),
    }


def object_speedtest(server, size: int = 1 << 20, ops: int = 4,
                     concurrency: int = 0) -> dict:
    """Autotuning PUT+GET speedtest through the real erasure path.
    ``concurrency`` pins a single step; 0 ramps 1, 2, 4, ... until the
    aggregate GET+PUT throughput stops improving by KNEE_GAIN (or the
    MINIO_TPU_DIAG_MAX_CONCURRENCY ceiling), and the best step is the
    knee — this node's measured capacity."""
    from . import record

    ceiling = max(1, int(os.environ.get(RAMP_CEILING_KNOB, "32")))
    steps: list[dict] = []
    with obs.span(obs.TYPE_DIAG, "object-speedtest", size=size, ops=ops):
        if concurrency > 0:
            steps.append(_step(server, concurrency, size, ops))
        else:
            c = 1
            while c <= ceiling:
                steps.append(_step(server, c, size, ops))
                if len(steps) >= 2:
                    prev = steps[-2]
                    cur = steps[-1]
                    gain = (cur["putMiBps"] + cur["getMiBps"]) / max(
                        prev["putMiBps"] + prev["getMiBps"], 1e-9
                    )
                    if gain < KNEE_GAIN:
                        break  # past the knee: the ramp stopped paying
                c *= 2
    knee = max(steps, key=lambda s: s["putMiBps"] + s["getMiBps"])
    result = {
        "objectSize": size,
        "opsPerClient": ops,
        "steps": steps,
        "knee": knee,
    }
    record("object", result)
    return result
