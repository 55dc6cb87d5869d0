"""The stripe blocks a window's PUTs sent to the card, for the readers
that count the card's work per block."""

from __future__ import annotations

from s3bench import reference


def encode_window(w):
    """(n, blocks) of a traced window in which the card only encoded and
    hashed PUT blocks, whichever kernels did it: n a block's shard size,
    ceil(object bytes / d), where every request in the window was a PUT
    and every one acknowledged wrote an object of one size and at most
    one stripe block; blocks the window's change in ``dispatch.blocks``
    (padding not counted). None without a trace, where K1 decoded, where
    the window served another request than a PUT, or where its objects
    differ in size or span blocks."""
    if w.trace is None or w.delta("k1", "decode_launches"):
        return None
    if any(r[0] != "put" for r in w.records):
        return None
    sizes = {r[6] for r in w.records if r[5] == 200}
    real = w.delta("dispatch", "blocks")
    if len(sizes) != 1 or not 0 < min(sizes) <= reference.BLOCK_SIZE or real <= 0:
        return None
    return reference.shard_size(sizes.pop(), w.d), real
