"""``cache-discipline``: cache state mutates only through the choke point.

The caching layer's coherence guarantee (docs/CACHING.md) rests on one
invariant: every mutation of cached state flows through the
``SetCache`` choke-point API (``invalidate_object`` /
``invalidate_prefix`` / ``invalidate_bucket`` / ``bump_epoch`` /
``clear``) so that local invalidation, listing-tier invalidation, and
the cross-node broadcast always happen together. A direct dict/LRU
write from erasure or server code — ``es.cache._fi[k] = v``,
``obj.cache._fi.pop(k)``, a bare ``_MC_MEM[ck] = ...`` — silently skips
the broadcast and turns into a stale serve on some other node.

This rule flags, outside the cache subsystem's own modules:

- any attribute access reaching into cache internals (``.cache._x``);
- calls to non-choke-point mutating methods through ``.cache.`` (e.g.
  ``.cache.clear()`` is allowed, ``.cache._fi.clear()`` is not);
- subscript writes/deletes into the listing metacache's ``_MC_MEM``.

Read-side APIs (``fileinfo``, ``data_get``, ``data_put``,
``data_admit``, ``snapshot``, and the segment tier's ``segment_open`` /
``segment_admit`` / ``segment_put`` / ``segment_observe``) are allowed —
they ARE the cache's public surface and maintain their own bookkeeping.
The segment cache's disk files and directories
(``segment.SegmentCache``) count as cache state like any LRU: erasure/
server code must never touch ``segment_cache()`` internals directly.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, dotted_name, rule

# modules that OWN cache state: the cache package itself plus the listing
# metacache (erasure/listing.py hosts the listing tier's storage)
_EXEMPT_RELPATHS = ("erasure/listing.py",)
_EXEMPT_PREFIXES = ("cache/",)

# the public SetCache surface callable from erasure/server code
_ALLOWED_API = frozenset({
    # choke-point mutations
    "invalidate_object", "invalidate_prefix", "invalidate_bucket",
    "bump_epoch", "clear",
    # read side + fills (their bookkeeping is internal to the cache)
    "fileinfo", "data_get", "data_put", "data_admit", "snapshot",
    # range-segment tier (cache/segment.py storage, same discipline:
    # lookups/fills only — segment/disk-tier REMOVAL is reachable solely
    # through the choke points above, so the broadcast plane always sees
    # it)
    "segment_open", "segment_admit", "segment_put", "segment_observe",
})

_METACACHE_STATE = frozenset({"_MC_MEM", "_MC_STATS"})

# process-wide cache singletons (cache/core.py data_cache(),
# cache/segment.py segment_cache()): outside the cache package only the
# read-only snapshot surface may be touched — every mutating method
# (drop_where, put, demote, ...) is choke-point-internal
_CACHE_FACTORIES = frozenset({"data_cache", "segment_cache"})
_FACTORY_ALLOWED = frozenset({"snapshot"})


def _exempt(relpath: str) -> bool:
    return relpath in _EXEMPT_RELPATHS or any(
        relpath.startswith(p) for p in _EXEMPT_PREFIXES
    )


def _cache_chain(node: ast.AST) -> list[str] | None:
    """Attribute segments after the first ``cache`` hop of a dotted
    chain, e.g. ``es.cache._fi.pop`` -> ["_fi", "pop"]; None when the
    chain never crosses a ``cache`` attribute/name."""
    name = dotted_name(node)
    if not name:
        return None
    parts = name.split(".")
    for i, seg in enumerate(parts[:-1]):
        if seg == "cache" and i > 0:  # attribute hop, not a module import
            return parts[i + 1:]
    return None


@rule("cache-discipline")
def check_cache_discipline(tree: ast.AST, ctx) -> Iterator[Finding]:
    if _exempt(ctx.relpath):
        return []
    findings: list[Finding] = []

    def flag(node: ast.AST, what: str) -> None:
        findings.append(
            Finding(
                ctx.path, node.lineno, "cache-discipline",
                f"{what}: cache state mutates only via the SetCache "
                "choke-point API (invalidate_object/invalidate_prefix/"
                "invalidate_bucket/bump_epoch/clear) so invalidation, "
                "the listing tier, and the cross-node broadcast stay "
                "atomic — see docs/CACHING.md",
            )
        )

    for node in ast.walk(tree):
        # es.cache.<private> — reaching into internals at all
        if isinstance(node, ast.Attribute):
            chain = _cache_chain(node)
            if chain and chain[0].startswith("_"):
                flag(node, f"access to cache internal `{'.'.join(chain)}`")
        # es.cache.<method>(...) with a non-API method
        if isinstance(node, ast.Call):
            chain = _cache_chain(node.func)
            if chain and len(chain) == 1 and chain[0] not in _ALLOWED_API:
                flag(node, f"call to non-choke-point `cache.{chain[0]}()`")
        # data_cache()/segment_cache() singleton reached directly: only
        # the read-only snapshot surface is public outside cache/
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Call):
            base = dotted_name(node.value.func) or ""
            if (
                base.split(".")[-1] in _CACHE_FACTORIES
                and node.attr not in _FACTORY_ALLOWED
            ):
                flag(node, f"access to `{base}().{node.attr}`")
        # direct writes into the listing metacache's module state
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AugAssign)
                else node.targets
            )
            for t in targets:
                if isinstance(t, ast.Subscript):
                    base = dotted_name(t.value) or ""
                    if base.split(".")[-1] in _METACACHE_STATE:
                        flag(node, f"direct write into `{base}`")
                    chain = _cache_chain(t.value)
                    if chain is not None:
                        flag(node, "subscript write through `.cache.`")
    return findings
