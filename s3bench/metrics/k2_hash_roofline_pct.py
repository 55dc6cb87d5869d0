"""K2's share of its roofline over the window (%): the least time of the
HighwayHash-256 of the d + p rows of n bytes of every stripe block the
dispatcher encoded, each row read once and its 32-byte digest written
once (s3bench/roofline.py), over the device time of K2's kernel, the
hash core on ``ContigRows`` (ops/bitrot_cuda.py, csrc/hh_chain.cu). Read
only where K2 ran and the card did nothing but encode and hash PUT
blocks (s3bench/blocks.py)."""

from s3bench import blocks, roofline


def read(w):
    got = blocks.encode_window(w)
    busy = w.trace.kernel_s("hh_ring_kernel<ContigRows>") if got else 0.0
    if busy <= 0:
        return None
    n, real = got
    row = roofline.bound_s(n, roofline.DIGEST,
                           roofline.packets(n) * roofline.HASH_OPS_PER_PACKET)
    return 100.0 * real * (w.d + w.p) * row / busy
