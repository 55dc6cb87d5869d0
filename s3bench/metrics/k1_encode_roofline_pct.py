"""K1 encode's share of its roofline over the window (%): the least time
of the blocks it encoded (s3bench/roofline.py, from each launch's shape,
scaled to the blocks that were not padding) over the device time of K1's
two kernels in the trace (its GF core and its hash core on
``FusedRows``). Read only where K1 encode is their only user in the
window: no K1 decode or K3 launch."""

from s3bench import roofline


def read(w):
    if w.trace is None or w.delta("k1", "encode_launches") <= 0:
        return None
    if w.delta("k1", "decode_launches") or w.delta("k3", "launches"):
        return None
    shapes = {k: n for k, n in w.shapes("k1").items() if k[0] == "encode"}
    launched = sum(k[1] * n for k, n in shapes.items())
    # blocks that were not padding: the dispatcher's, as far as K1 took them
    real = min(w.delta("dispatch", "blocks"), launched)
    least = sum(roofline.k1(k[1] * n, k[2], k[3], k[4]) for k, n in shapes.items())
    busy = w.trace.kernel_s("gf_core_kernel", "hh_ring_kernel<FusedRows>")
    if not launched or busy <= 0:
        return None
    return 100.0 * least * real / launched / busy
