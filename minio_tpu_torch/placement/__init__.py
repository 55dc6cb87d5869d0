"""placement — the elastic-topology subsystem.

Two halves:

- ``policy.py``: the placement policy engine. Per-bucket/per-prefix
  rules (``pin`` a prefix to one pool, ``spread`` it across a pool set,
  weight-by-free-space for everything unruled) persisted under
  ``.minio.sys/placement/rules.json``, consulted by
  ``ServerPools.put_object`` and multipart ``new_upload`` in place of
  the bare most-free-pool heuristic, and honored by rebalance (a pinned
  prefix is never drained off its pool).
- ``topology.py``: the live topology orchestrator. ``expand_pool``
  attaches a freshly-minted pool to a RUNNING server (format mint, set
  registration, cache/lock planes pick the new sets up without a
  restart); ``remove_pool`` detaches a fully-decommissioned pool so its
  sets' cache entries become dead-set-reclaimable.

Rebalance/decommission themselves live in ``erasure/decommission.py``
(they predate this package) but are placement-aware through the policy
engine and run on the QoS background lane.
"""

from .policy import PlacementPolicy, PlacementRule, placement_enabled  # noqa: F401
from .topology import expand_pool, remove_pool  # noqa: F401
