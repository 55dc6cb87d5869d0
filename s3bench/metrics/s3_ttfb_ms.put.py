"""The S3 front's mean time to first byte of PutObject over the window
(ms), from the server's own counters (server/metrics.py)."""


def read(w):
    n = w.delta("requests_total", "PutObject")
    return w.delta("ttfb_seconds", "PutObject") / n * 1e3 if n else None
