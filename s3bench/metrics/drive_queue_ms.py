"""Wait for a worker of the drive pool (ms): the mean ``queue_ns`` of the
``storage.<op>`` spans of the window's PutObject requests answered 200
(submit to the worker's start, ``obs.ContextPool``). From the program's
span ring (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    return spans.drive_queue_ms(w)
