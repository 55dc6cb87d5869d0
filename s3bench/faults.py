"""Faults planted in the program, and the control, for the tests that show
the comparison fails them. The benchmark's own runs plant nothing.

``--fault control`` runs the program with the configuration's
``control_env`` from the start: the deployment's guarantee broken (a
lower parity than the configuration states), while the reference keeps
the stated one. The other faults wrap the program's write path, under
the device route and the host route alike:

- ``state-unchanged``: a PUT is acknowledged but its shards are never
  committed.
- ``half-batch``: half of the blocks coded are left out (their parity
  zero).
- ``answer-altered``: one byte of each coded batch's output flipped where
  it is produced.
"""

from __future__ import annotations

import itertools
import os

FAULTS = ("control", "state-unchanged", "half-batch", "answer-altered")


def plant(name: str, config: dict) -> None:
    """Plant fault ``name`` in the write path."""
    if not name:
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name == "control":
        os.environ.update(config["control_env"])
        return
    from minio_tpu_torch.erasure import coder
    from minio_tpu_torch.storage import xlstorage

    if name == "state-unchanged":
        xlstorage.XLStorage.rename_data = lambda self, *a, **kw: None
        return
    encode = coder.ErasureCoder._encode_full_blocks
    counter = itertools.count()

    if name == "half-batch":
        def encoded(self, blocks):
            shards, digests = encode(self, blocks)
            shards = shards.copy()
            for b in range(shards.shape[0]):
                if next(counter) % 2:
                    shards[b, self.d:] = 0
            return shards, digests
    else:
        def encoded(self, blocks):
            shards, digests = encode(self, blocks)
            shards = shards.copy()
            shards[0, self.d, 0] ^= 1
            return shards, digests
    coder.ErasureCoder._encode_full_blocks = encoded
