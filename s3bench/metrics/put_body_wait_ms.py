"""Time per PUT the object layer waited for the body (ms): the mean over
the window's PutObject requests answered 200 of their summed
``erasure.put.body-wait`` spans (the streaming PUT blocked on the body
pump's queue; 0 where the body came buffered). From the program's span
ring (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    return spans.mean_summed_ms(w, "erasure.put.body-wait")
