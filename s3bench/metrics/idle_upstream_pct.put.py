"""Share of the card's idle time in the traced window in which no block
of any request was queued at or served by the dispatcher (%): no
``dispatch.queue`` or ``dispatch.batch`` span open, so the requests were
in the S3 front, the object layer or the drives. The program's span
ring on the trace's clock (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    got = spans.idle_shares(w)
    return None if got is None else got[0]
