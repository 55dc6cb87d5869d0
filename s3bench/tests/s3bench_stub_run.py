"""A stub run for the reaper test: the harness's lifecycle around a
generator that misbehaves. The generator starts a grandchild in a
session of its own and leaves a non-daemon thread; the run itself leaves
a non-daemon thread too.

    python3 s3bench_stub_run.py <window_s> <deadline_s>

Prints one JSON line ``{"left": [...], "how": ...}`` and leaves with
``os._exit``. Every process it starts carries ``S3BENCH_TEST_MARKER``.
"""

import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from s3bench import lifecycle  # noqa: E402


def generator() -> None:
    lifecycle.child_init()
    subprocess.Popen([sys.executable, "-c", "import time; time.sleep(1000)"],
                     start_new_session=True)
    threading.Thread(target=time.sleep, args=(1000,)).start()
    time.sleep(1000)


def main() -> None:
    window, deadline = float(sys.argv[1]), float(sys.argv[2])
    run = lifecycle.Run()
    run.install()
    run.set_deadline(deadline)
    how = "end"
    try:
        run.spawn([sys.executable, os.path.abspath(__file__), "generator"])
        threading.Thread(target=time.sleep, args=(1000,)).start()
        print("window", flush=True)
        time.sleep(window)
    except lifecycle.Stopped as e:
        how = str(e)
    finally:
        left = run.finish()
    print(json.dumps({"left": left, "how": how}), flush=True)
    os._exit(0)


if __name__ == "__main__":
    generator() if sys.argv[1:] == ["generator"] else main()
