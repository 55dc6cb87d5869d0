"""Traffic from a mix's parameters and the run's seed.

One generator reads every mix (``s3bench/traffic/<mix>.json``). The seed
makes the bodies and names the objects; it never changes how much work
there is: every seed of a mix gets the same object sizes and clients.
"""

from __future__ import annotations

import math

import numpy as np

STREAM_BODY = 1       # body of object i: PCG64([seed, STREAM_BODY, i])
STREAM_SAMPLE = 4     # the objects whose shard files the check reads
STREAM_LOST = 5       # the drives lost while the check reads them back


def rng(seed: int, stream: int, i: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([seed, stream, i]))


def body(seed: int, i: int, size: int) -> bytes:
    """The bytes of object ``i`` of a run."""
    words = np.random.PCG64([seed, STREAM_BODY, i]).random_raw(-(-size // 8))
    return words.astype("<u8").tobytes()[:size]


def object_key(prefix: str, seed: int, i: int) -> str:
    return f"{prefix}-{seed}-{i:06d}"


def shard_bytes(object_bytes: int, d: int, p: int) -> int:
    """Bytes an object of this size writes to the set's drives: every
    stripe block's d + p shards and their digests."""
    full, tail = divmod(object_bytes, 1 << 20)
    out = full * (d + p) * (-(-(1 << 20) // d) + 32)
    if tail:
        out += (d + p) * (-(-tail // d) + 32)
    return out


def check_budget(mix: dict, d: int, p: int) -> int:
    """Bytes the run writes to disk at most (warm-up and the window's
    PUTs); raises when it is over the mix's cap."""
    objects = mix["warm_puts"] + mix["max_objects"]
    total = objects * shard_bytes(mix["object_bytes"], d, p)
    if total > mix["max_written_bytes"]:
        raise ValueError(f"the run would write {total} bytes, over the mix's "
                         f"max_written_bytes {mix['max_written_bytes']}")
    return total


def sample(seed: int, population: list, k: int) -> list:
    """k items of ``population`` drawn from the seed, in their order."""
    if len(population) <= k:
        return list(population)
    idx = rng(seed, STREAM_SAMPLE).choice(len(population), size=k, replace=False)
    return [population[i] for i in sorted(idx.tolist())]


def lost_drives(seed: int, drives: int, p: int) -> list[int]:
    """The p drives, drawn from the seed, that the check takes away."""
    return sorted(rng(seed, STREAM_LOST).choice(drives, size=p, replace=False).tolist())


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, nearest rank."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100 * len(s)))
    return s[k - 1]
