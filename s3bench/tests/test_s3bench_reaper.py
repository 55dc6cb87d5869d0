"""Every process a run starts is gone when the run ends: at its normal
end, on SIGTERM in the window, and at its own deadline; non-daemon
threads and a grandchild in a session of its own included."""

import json
import os
import signal
import subprocess
import sys
import time
import uuid

import pytest

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "s3bench_stub_run.py")


def marked(marker: str) -> list[int]:
    """Live processes whose environment carries the marker."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                env = f.read()
            with open(f"/proc/{name}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if marker.encode() in env and state != "Z":
            out.append(int(name))
    return out


def wait_gone(marker: str, seconds: float) -> list[int]:
    end = time.monotonic() + seconds
    while (left := marked(marker)) and time.monotonic() < end:
        time.sleep(0.1)
    return left


@pytest.mark.parametrize("how", ["end", "SIGTERM", "SIGALRM"])
def test_run_leaves_no_process(how):
    marker = f"s3bench-{uuid.uuid4()}"
    env = {**os.environ, "S3BENCH_TEST_MARKER": marker}
    window, deadline = {"end": (2, 60), "SIGTERM": (60, 60), "SIGALRM": (60, 3)}[how]
    proc = subprocess.Popen([sys.executable, STUB, str(window), str(deadline)], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "window"
        time.sleep(1.0)  # the generator and its grandchild are up
        assert len(marked(marker)) >= 3
        if how == "SIGTERM":
            proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0
        line = json.loads(out.strip().splitlines()[-1])
        assert line == {"left": [], "how": how}
        assert wait_gone(marker, 10) == []
    finally:
        if proc.poll() is None:
            proc.kill()
        for pid in marked(marker):
            os.kill(pid, signal.SIGKILL)
