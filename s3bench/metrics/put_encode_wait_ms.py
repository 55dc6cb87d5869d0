"""Time per PUT the object layer waited on the dispatcher (ms): the mean
over the window's PutObject requests answered 200 of their summed
``erasure.put.encode-wait`` spans (queue, batch window, copies, kernels,
results). From the program's span ring (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    return spans.mean_summed_ms(w, "erasure.put.encode-wait")
