"""The life of a run's processes.

A run makes itself the child subreaper of everything it starts
(``PR_SET_CHILD_SUBREAPER``), so a grandchild whose parent dies is
re-parented to the run and not to init. Every child marks itself with
``PR_SET_PDEATHSIG=SIGKILL`` as its first act (``child_init``). On every
way out (normal end, exception, SIGTERM, SIGINT, SIGHUP, the run's own
deadline) ``Run.finish`` does the same steps in the same order: stop the
load generators, run the registered stops (the server), then SIGKILL and
wait on every remaining descendant until none is left. Only then does
the caller print and leave with ``os._exit``, so no thread of the program
can keep the process alive.
"""

from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import sys
import threading
import time

PR_SET_PDEATHSIG = 1
PR_SET_CHILD_SUBREAPER = 36
PARENT_ENV = "S3BENCH_PARENT_PID"
STOP_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)


def _prctl(option: int, arg: int) -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(option, arg, 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl({option}, {arg}): {os.strerror(err)}")


def child_init() -> None:
    """First act of every child: die with the parent. If the parent is
    already gone (the signal would never come), leave at once."""
    _prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    want = os.environ.get(PARENT_ENV)
    if want is not None and os.getppid() != int(want):
        os._exit(70)


class Stopped(BaseException):
    """Raised in the main thread by a stop signal or the run's deadline."""


def _children(pid: int) -> list[int]:
    out: list[int] = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for t in tasks:
        try:
            with open(f"/proc/{pid}/task/{t}/children") as f:
                out += [int(x) for x in f.read().split()]
        except OSError:
            continue
    return out


def descendants(pid: int | None = None) -> list[int]:
    """Every live descendant of ``pid`` (default: this process)."""
    seen: list[int] = []
    todo = [os.getpid() if pid is None else pid]
    while todo:
        for c in _children(todo.pop()):
            if c not in seen:
                seen.append(c)
                todo.append(c)
    return seen


def reap_all(timeout_s: float = 30.0) -> list[int]:
    """SIGKILL and wait on every descendant until none is left. Returns
    the pids still there at the timeout (empty when all were reaped)."""
    end = time.monotonic() + timeout_s
    while True:
        left = descendants()
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        while True:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid == 0:
                break
        if not left and not descendants():
            return []
        if time.monotonic() > end:
            return descendants()
        time.sleep(0.02)


class Run:
    """One run's processes, stops and deadline. ``install`` makes this
    process the subreaper and routes stop signals and the deadline into
    ``Stopped`` in the main thread; ``finish`` tears everything down."""

    def __init__(self):
        self.children: list[subprocess.Popen] = []
        self.stops: list = []  # callables, run in order by finish
        self._finishing = False
        self._deadline: float | None = None

    def install(self) -> None:
        _prctl(PR_SET_CHILD_SUBREAPER, 1)
        for s in STOP_SIGNALS:
            signal.signal(s, self._on_signal)
        signal.signal(signal.SIGALRM, self._on_signal)

    def _on_signal(self, signum, frame):
        if not self._finishing:
            raise Stopped(signal.Signals(signum).name)

    def set_deadline(self, seconds: float) -> None:
        """Stop the run (SIGALRM into the main thread) ``seconds`` from
        now. A watchdog thread ends the process if the main thread does
        not get out within a further 60 s."""
        self._deadline = time.monotonic() + seconds
        signal.setitimer(signal.ITIMER_REAL, seconds)
        threading.Thread(target=self._watchdog, name="s3bench-watchdog", daemon=True).start()

    def _watchdog(self) -> None:
        deadline = self._deadline
        while time.monotonic() < deadline + 60:
            time.sleep(1)
            if self._deadline != deadline:
                return
        print("s3bench: the run did not stop after its deadline; ending it", file=sys.stderr,
              flush=True)
        reap_all(10)
        os._exit(3)

    def spawn(self, argv: list[str], **kw) -> subprocess.Popen:
        """Start a child from the main thread (the death signal follows
        the thread that forked). The child must call ``child_init``."""
        env = dict(kw.pop("env", None) or os.environ)
        env[PARENT_ENV] = str(os.getpid())
        proc = subprocess.Popen(argv, env=env, **kw)
        self.children.append(proc)
        return proc

    def finish(self) -> list[int]:
        """Stop the generators, run the stops, reap every descendant.
        Returns the pids that could not be reaped."""
        self._finishing = True
        signal.setitimer(signal.ITIMER_REAL, 0)
        for s in STOP_SIGNALS:
            signal.signal(s, signal.SIG_IGN)
        for proc in self.children:
            if proc.poll() is None:
                proc.terminate()
        for proc in self.children:
            try:
                proc.wait(5)
            except subprocess.TimeoutExpired:
                proc.kill()
        for stop in self.stops:
            try:
                stop()
            except Exception as e:  # noqa: BLE001 — teardown goes on
                print(f"s3bench: stop {stop!r} failed: {e!r}", file=sys.stderr, flush=True)
        self._deadline = None
        return reap_all()
