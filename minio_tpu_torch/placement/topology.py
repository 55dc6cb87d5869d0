"""Live topology orchestration: attach/detach pools on a running server.

``expand_pool`` is the online half of what ``make_object_layer`` does at
boot for one spec: expand the ellipses pattern, wrap each drive in the
fault-injection + health stack, mint (or adopt) ``format.json``, build an
``ErasureSets`` sharing the server's namespace-lock plane, replay the
existing buckets onto it (buckets exist on every pool), and publish it
into ``ServerPools.pools``. Everything downstream picks the new sets up
without a restart by construction: per-set caches are created in
``ErasureSet.__init__``, coherence broadcasts address (pool, set) indexes
by iterating the live pool list, metrics/admin walk ``store.pools``, and
the multipart router resolves pool indexes per call.

``remove_pool`` detaches a fully-decommissioned pool. Its sets become
unreferenced, so their cache entries turn into dead-set entries the
process-wide data cache reclaims first under budget pressure — and can
never serve again (every lookup re-checks the owning-set weakref).

Scope: single-process topologies (plus test rigs embedding ServerPools
directly). SO_REUSEPORT worker pools and distributed deployments refuse
online expansion at the admin layer — every process would need the new
pool at the same moment, which takes the coordinated restart path.
"""

from __future__ import annotations

import time

from .. import obs
from ..storage.xlstorage import XLStorage
from .policy import emit


def expand_pool(store, spec: str, set_size: int = 0,
                on_degraded=None) -> dict:
    """Attach one new pool (an ellipses drive spec) to a live
    ``ServerPools``. Returns a summary dict; raises ValueError on a spec
    that expands to something un-attachable."""
    from ..fault.storage import FaultInjectedDisk
    from ..storage.format_erasure import init_or_load_formats
    from ..storage.health import HealthCheckedDisk
    from ..storage.offline import OfflineDisk
    from ..utils import ellipses

    t0 = time.monotonic()
    paths = ellipses.expand(spec) if ellipses.has_ellipses(spec) else [spec]
    if any("://" in p for p in paths):
        raise ValueError(
            "online expansion takes local drive paths; remote endpoints "
            "need the coordinated-restart path"
        )
    disks = [
        HealthCheckedDisk(FaultInjectedDisk(XLStorage(p, endpoint=p)))
        for p in paths
    ]
    size = ellipses.choose_set_size(len(disks), set_size)
    dep_id, grouped = init_or_load_formats(disks, size, allow_mint=True)
    grouped = [
        [d if d is not None else OfflineDisk() for d in row]
        for row in grouped
    ]
    from ..erasure.sets import ErasureSets

    pool_idx = len(store.pools)
    new_pool = ErasureSets(
        grouped, dep_id, pool_index=pool_idx,
        ns_lock=store.pools[0].sets[0].ns,
    )
    # buckets exist on every pool: replay the current bucket set so
    # listings/deletes keep broadcasting cleanly and rebalance can move
    # objects in immediately
    for b in store.pools[0].list_buckets():
        new_pool.make_bucket(b.name)
    if on_degraded is not None:
        for s in new_pool.sets:
            s.on_degraded = on_degraded
    # atomic swap, not append: readers mid-iteration keep the old list
    store.pools = store.pools + [new_pool]
    out = {
        "pool": pool_idx,
        "drives": [d.endpoint for d in new_pool.disks],
        "sets": len(new_pool.sets),
        "setDriveCount": size,
        "deploymentID": dep_id,
        "tookMs": round((time.monotonic() - t0) * 1e3, 1),
    }
    emit(obs.TYPE_PLACEMENT, "topology.expand", **out)
    return out


def remove_pool(store, pool_idx: int) -> dict:
    """Detach a drained pool from a live ``ServerPools``. The caller
    (admin layer) verifies the pool was decommissioned to completion —
    this only enforces the structural invariants."""
    if not 0 < pool_idx < len(store.pools):
        raise ValueError(
            "can only remove an attached pool other than pool 0 "
            "(pool 0 anchors the system namespace)"
        )
    victim = store.pools[pool_idx]
    remaining = [p for i, p in enumerate(store.pools) if i != pool_idx]
    # pool_index is baked into each set at construction and addressed by
    # coherence broadcasts; re-stamp the survivors' indexes to match
    # their new positions in the list
    for i, p in enumerate(remaining):
        p.pool_index = i
        for s in p.sets:
            s.pool_index = i
    store.pools = remaining
    # draining markers address pool indexes: drop the removed pool's and
    # shift the survivors' to their new positions
    draining = getattr(store, "draining", None)
    if draining is not None:
        shifted = {
            i - 1 if i > pool_idx else i
            for i in draining if i != pool_idx
        }
        draining.clear()
        draining.update(shifted)
    # placement rules address pools by index too: re-key them (rules
    # naming ONLY the removed pool drop — better the weighted default
    # than a pin silently re-aimed at a different physical pool)
    placement = getattr(store, "placement", None)
    if placement is not None:
        placement.reindex_after_remove(pool_idx)
    out = {
        "pool": pool_idx,
        "drives": [d.endpoint for d in victim.disks],
        "remainingPools": len(remaining),
    }
    emit(obs.TYPE_PLACEMENT, "topology.remove", **out)
    return out
