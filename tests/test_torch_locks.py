"""The port's lock table: a waiting writer is not starved by readers that
keep coming (``minio_tpu_torch/cluster/locks.py``)."""

import threading
import time

from minio_tpu_torch.cluster.locks import DRWMutex, LocalLocker


def test_waiting_writer_outlasts_the_readers_draining():
    """The writer's marker survives the last reader's unlock: the next
    reader yields, and the writer's next poll takes the lock."""
    lk = LocalLocker()
    assert lk.rlock("b/o", "r1")
    assert not lk.lock("b/o", "w")  # parks the waiting-writer marker
    assert lk.runlock("b/o", "r1")  # the last reader leaves
    assert not lk.rlock("b/o", "r2")  # a new reader yields to the writer
    assert lk.lock("b/o", "w")
    assert lk.unlock("b/o", "w")
    assert lk.stats() == {}


def test_readers_drain_without_a_writer():
    """With no writer waiting, the last reader's unlock drops the entry."""
    lk = LocalLocker()
    assert lk.rlock("b/o", "r1") and lk.rlock("b/o", "r2")
    assert lk.runlock("b/o", "r1") and lk.runlock("b/o", "r2")
    assert lk.stats() == {}


def test_writer_takes_the_lock_under_a_stream_of_readers():
    """Four readers re-taking the read lock as soon as they drop it (the
    chaos suite's degraded GETs beside a heal) leave the writer a turn
    well inside its deadline."""
    lockers = [LocalLocker()]
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            m = DRWMutex(lockers, "b/o")
            if m.rlock(5.0):
                time.sleep(0.005)
                m.runlock()

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        w = DRWMutex(lockers, "b/o")
        t0 = time.monotonic()
        assert w.lock(5.0), "the writer starved behind the readers"
        waited = time.monotonic() - t0
        w.unlock()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert waited < 2.0, waited
