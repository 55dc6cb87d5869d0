"""Share of the card's idle time in the traced window in which the
dispatcher thread was inside a ``dispatch.batch`` (%): assembling,
staging or handing results back while nothing ran on the card. The
program's span ring on the trace's clock (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    got = spans.idle_shares(w)
    return None if got is None else got[1]
