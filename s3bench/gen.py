"""A load generator: one child process of a run.

Started by the run before its window (``python3 -m s3bench.gen``), it
imports nothing of the program. It reads its job as one JSON object on
standard input, sends its share of the traffic through the frozen SigV4
client, and writes one JSON object with a record of every request to
standard output when its work is done. Times are seconds from the
window's start (``t0``, on the machine-wide monotonic clock):

    [op, key, due, sent, done, status, bytes, check]

``done`` is null for a request that got no answer. ``check`` is whether
the returned ETag is the MD5 of the body sent.
"""

from __future__ import annotations

import hashlib
import json
import sys
import threading
import time

from s3bench import lifecycle, sigv4, traffic


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _send(job: dict, key: str, req: sigv4.Request, due: float, t0: float,
          body_md5: str) -> list:
    sent = time.monotonic() - t0
    try:
        status, headers, _ = sigv4.send(job["port"], req, timeout=job["request_timeout_s"])
    except OSError as e:
        print(f"s3bench.gen: put {key}: {e!r}", file=sys.stderr, flush=True)
        return ["put", key, due, sent, None, -1, 0, None]
    done = time.monotonic() - t0
    check = status == 200 and headers.get("etag", "").strip('"') == body_md5
    return ["put", key, due, sent, done, status, len(req.body), check]


def closed_loop(job: dict) -> list:
    """Clients that each PUT their next fresh object when the last is
    answered, until the window closes; answers still due are awaited.
    Client c's j-th object is object c + j * clients, at most
    ``max_objects`` in all."""
    t0, host, end = job["t0"], f"127.0.0.1:{job['port']}", job["t0"] + job["seconds"]
    out: list = []
    lock = threading.Lock()
    headers = {"x-amz-storage-class": job["storage_class"]}

    def client(cid: int):
        mine = []
        i = cid
        _sleep_until(t0)
        while time.monotonic() < end and i < job["max_objects"]:
            key = traffic.object_key("put", job["seed"], i)
            data = traffic.body(job["seed"], i, job["object_bytes"])
            req = sigv4.Request(host, "PUT", f"/{job['bucket']}/{key}", data, headers=headers)
            mine.append(_send(job, key, req, time.monotonic() - t0, t0,
                              hashlib.md5(data).hexdigest()))
            i += job["clients_total"]
        with lock:
            out.extend(mine)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in job["clients"]]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def main() -> None:
    lifecycle.child_init()
    job = json.loads(sys.stdin.read())
    records = closed_loop(job)
    sys.stdout.write(json.dumps({"records": records}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
