"""Time per PUT the object layer waited on its drives (ms): the mean over
the window's PutObject requests answered 200 of their summed
``erasure.put.drives`` spans (each fan-out from submit to join: shard
files, the commit). From the program's span ring (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    return spans.mean_summed_ms(w, "erasure.put.drives")
