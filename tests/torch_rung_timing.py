"""Where the CPU rung's time goes in two reference cases that carry a
wall-clock limit: ``test_cache_segments.py::
test_concurrent_overwrites_and_heals_never_serve_stale`` (4 readers of
ranged cached GETs of a 2 MiB object while the main thread overwrites it
4 times and heals a wiped drive after each) and ``test_lock_refresh.py::
test_streaming_put_aborts_on_lock_loss`` (a streamed PUT of 1 MiB chunks
that must abort within 20 s of losing its lock).

Both run on 4 drives (EC 2+2), so each 1 MiB stripe block is one device
dispatch of 2 x 524,288-byte shards. On the port the script times:

- ``dispatch``: one such dispatch through the dispatcher (backend
  ``torch``);
- ``coherence``: the coherence case's schedule step by step (each PUT,
  each heal) with its readers running and with them stopped, the
  readers' loop counts, and beside each step the seconds the main thread
  spent waiting for its namespace write lock (``DRWMutex.lock``: a
  writer or healer held back by the readers' read locks shows there).
  Each step is printed to stderr as it ends; the schedule stops after the
  step that passes ``--budget`` seconds. ``--dump-after S`` writes every
  thread's stack to stderr after S seconds;
- ``--convoy-packets P``: instead, the plain torch HighwayHash
  (``bitrot_torch``, K1's and K2's plain version: about 150 small torch
  operations a 32-byte packet, each of which gives the GIL up and takes
  it back) over 4 rows of P packets in the main thread, while 0, 1 and 4
  of the case's readers run on its rig. The hash takes no lock, so what
  the readers add to it is their hold on the GIL.

Run it from the repository root::

    MINIO_TPU_TORCH_DEVICE=cpu python tests/torch_rung_timing.py --backend torch
    python tests/torch_rung_timing.py --backend numpy
    python tests/torch_rung_timing.py --backend numpy --convoy-packets 64

``--backend torch`` is the port's device route (the CPU rung when
``MINIO_TPU_TORCH_DEVICE=cpu``), ``numpy`` the host plane the reference
suites set for themselves. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import shutil
import sys
import tempfile
import threading
import time

MIB = 1 << 20
SIZE = 2 * MIB

# the segment cache as the coherence case's suite sets it (its autouse fixture)
CACHE_ENV = {
    "MINIO_TPU_CACHE": "1",
    "MINIO_TPU_CACHE_SEGMENTS": "1",
    "MINIO_TPU_CACHE_OBJECT_MAX": str(256 * 1024),
    "MINIO_TPU_CACHE_ADMIT_TOUCHES": "2",
    "MINIO_TPU_CACHE_MEM_MB": "256",
    "MINIO_TPU_CACHE_DISK_MB": "0",
    "MINIO_TPU_CACHE_PREFETCH_SEGMENTS": "0",
}


def time_dispatch() -> float:
    import numpy as np

    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import get_dispatcher

    disp = get_dispatcher(rs_torch.get_torch_codec(2, 2), MIB // 2)
    block = np.random.default_rng(0).integers(0, 256, (1, 2, MIB // 2), dtype=np.uint8)
    t0 = time.perf_counter()
    disp.encode(block)
    return time.perf_counter() - t0


def rig(root: str, t: dict):
    """The case's rig: 4 drives, its first version PUT and read twice (the
    cache admits on the second touch)."""
    from minio_tpu_torch.erasure.set import ErasureSet
    from minio_tpu_torch.storage.xlstorage import XLStorage

    es = ErasureSet([XLStorage(os.path.join(root, f"d{i}")) for i in range(4)])
    es.make_bucket("sb")
    t0 = time.perf_counter()
    es.put_object("sb", "chaos", bytes([1]) * SIZE)
    t["put0"] = time.perf_counter() - t0
    for _ in range(2):
        for off in range(0, SIZE, MIB):
            _, h = es.open_object("sb", "chaos", "", ("abs", off, off + MIB - 1))
            b"".join(bytes(c) for c in h.read(off, MIB))
    return es


@contextlib.contextmanager
def readers(es, n: int):
    """The case's readers: ranged cached GETs of one half of the object,
    each checked by ``set`` over its 1 MiB. Yields their loop counts."""
    stop = threading.Event()
    loops = [0] * n

    def reader(rid: int) -> None:
        while not stop.is_set():
            try:
                off = (rid % 2) * MIB
                _, h = es.open_object("sb", "chaos", "", ("abs", off, off + MIB - 1))
                d = b"".join(bytes(c) for c in h.read(off, MIB))
            except Exception:  # noqa: BLE001 — raced a delete window, as the case allows
                continue
            set(d)
            loops[rid] += 1

    threads = [threading.Thread(target=reader, args=(i,), daemon=True) for i in range(n)]
    for th in threads:
        th.start()
    try:
        yield loops
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)


def coherence(root: str, n: int, budget: float) -> dict:
    """The coherence case's schedule, timed (its body, with clocks)."""
    from minio_tpu_torch.cluster.locks import DRWMutex

    main = threading.current_thread()
    waited = [0.0]
    lock = DRWMutex.lock

    def timed_lock(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return lock(self, *a, **kw)
        finally:
            if threading.current_thread() is main:
                waited[0] += time.perf_counter() - t0

    t: dict = {}

    def done(step: str, t0: float) -> None:
        t[step] = time.perf_counter() - t0
        t[f"{step}_lock_wait"] = waited[0]
        print(f"readers={n} {step}: {t[step]:.2f} s, write-lock wait {waited[0]:.4f} s",
              file=sys.stderr, flush=True)

    DRWMutex.lock = timed_lock
    try:
        es = rig(root, t)
        with readers(es, n) as loops:
            t_all = time.perf_counter()
            for v in range(2, 6):
                waited[0] = 0.0
                t0 = time.perf_counter()
                es.put_object("sb", "chaos", bytes([v]) * SIZE)
                done(f"put{v - 1}", t0)
                shutil.rmtree(os.path.join(root, "d0", "sb", "chaos"), ignore_errors=True)
                waited[0] = 0.0
                t0 = time.perf_counter()
                es.heal_object("sb", "chaos")
                done(f"heal{v - 1}", t0)
                time.sleep(0.05)
                if time.perf_counter() - t_all > budget:
                    break
            t["schedule"] = time.perf_counter() - t_all
        t["reader_loops"] = loops
    finally:
        DRWMutex.lock = lock
    return t


def convoy(root: str, packets: int) -> dict:
    """Seconds of one plain hash of [4, 32 * packets] with 0, 1 and 4 of
    the case's readers running."""
    import torch

    from minio_tpu_torch.ops.bitrot_torch import hash256_blocks_plain

    rows = torch.randint(0, 256, (4, 32 * packets), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    out: dict = {"packets": packets, "rows": 4}
    es = rig(root, {})
    for n in (0, 1, 4):
        with readers(es, n):
            t0 = time.perf_counter()
            hash256_blocks_plain(rows)
            out[f"readers={n}"] = time.perf_counter() - t0
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("torch", "numpy"), default="torch")
    ap.add_argument("--readers", type=int, nargs="+", default=[4, 0])
    ap.add_argument("--dump-after", type=float, default=0.0)
    ap.add_argument("--budget", type=float, default=600.0)
    ap.add_argument("--convoy-packets", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ["MINIO_TPU_BACKEND"] = args.backend
    os.environ.update(CACHE_ENV)
    out: dict = {"backend": args.backend,
                 "device": os.environ.get("MINIO_TPU_TORCH_DEVICE", "cuda"),
                 "switch_interval_s": sys.getswitchinterval()}
    if args.dump_after:
        faulthandler.dump_traceback_later(args.dump_after, exit=False)
    with tempfile.TemporaryDirectory() as root:
        os.environ["MINIO_TPU_CACHE_DISK_DIR"] = os.path.join(root, "spool")
        if args.convoy_packets:
            out["convoy"] = convoy(root, args.convoy_packets)
        else:
            if args.backend == "torch":
                out["dispatch_2+2_1MiB_s"] = time_dispatch()
            for n in args.readers:
                out[f"readers={n}"] = coherence(os.path.join(root, f"r{n}"), n, args.budget)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
