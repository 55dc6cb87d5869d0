"""The PUT encode route's share of its roofline over the window (%): the
least time of the stripe blocks the dispatcher encoded, counted as
``roofline.k1`` counts a fused encode + hash (d data rows of n bytes
in, p parity rows and d + p digests out, the GF products and the hash of
every row), over the device time of every kernel in the trace. Where K1
refuses the shape (d > 8) the route is K3's GF product (ops/rs_cuda.py)
and the chain kernel K2 (ops/bitrot_cuda.py); whichever kernels serve
it, it is read on this yardstick. Read only where the card did nothing
but encode and hash PUT blocks (s3bench/blocks.py)."""

from s3bench import blocks, roofline


def read(w):
    got = blocks.encode_window(w)
    busy = w.trace.kernel_s() if got else 0.0
    if busy <= 0:
        return None
    n, real = got
    return 100.0 * roofline.k1(real, w.d, w.p, n) / busy
