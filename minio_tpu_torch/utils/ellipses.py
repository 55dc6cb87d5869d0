"""Ellipses endpoint patterns: 'disk{1...8}' -> disk1..disk8.

Mirrors the reference's endpoint-ellipses expansion
(MinIO cmd/endpoint-ellipses.go via minio/pkg/ellipses): patterns
like http://host{1...4}/disk{1...8} expand to the cross product, and the
total drive count determines the set layout.
"""

from __future__ import annotations

import re

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")


def has_ellipses(s: str) -> bool:
    return bool(_ELLIPSIS.search(s))


def expand(pattern: str) -> list[str]:
    """Expand every {a...b} range in the pattern (cross product)."""
    m = _ELLIPSIS.search(pattern)
    if not m:
        return [pattern]
    lo, hi = int(m.group(1)), int(m.group(2))
    if hi < lo:
        raise ValueError(f"invalid ellipsis range in {pattern!r}")
    width = len(m.group(1)) if m.group(1).startswith("0") else 0
    out = []
    for i in range(lo, hi + 1):
        token = str(i).zfill(width) if width else str(i)
        out.extend(expand(pattern[: m.start()] + token + pattern[m.end() :]))
    return out


# set sizes the layout solver may pick, largest preferred
# (reference setSizes, cmd/endpoint-ellipses.go)
SET_SIZES = [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1]


def possible_set_counts(count: int) -> list[int]:
    # single-drive standalone is a special mode; otherwise sets are >= 2
    # drives (the reference rejects layouts it can't stripe, setSizes {2..16})
    if count == 1:
        return [1]
    return [s for s in SET_SIZES if s >= 2 and count % s == 0]


def choose_set_size(drive_count: int, requested: int = 0) -> int:
    """Largest divisor of drive_count in [1..16] (or the requested one)."""
    if requested:
        if drive_count % requested:
            raise ValueError(
                f"requested set size {requested} does not divide {drive_count}"
            )
        return requested
    sizes = possible_set_counts(drive_count)
    if not sizes:
        raise ValueError(f"no valid erasure set size for {drive_count} drives")
    return sizes[0]
