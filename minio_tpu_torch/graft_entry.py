"""The port's entry points: a one-step check on the card, and the
multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py``, function for
function. The pipeline is the erasure and integrity plane: RS(d+p)
encode as the bit-plane product, then the HighwayHash-256 bitrot digest
of every shard (K2, ``csrc/hh_chain.cu`` through
``ops/bitrot_cuda.hash256_blocks``). Concurrent requests' stripe blocks
are independent, so the devices share the request batch, one block
each, and an all-reduce sums the blocks processed: the reference's
``shard_map`` + ``psum`` over its "requests" mesh axis.

    python -m minio_tpu_torch.graft_entry [n]   # the dry run on n ranks
                                                # (default: every card, else 8)

``entry()`` runs on the card unless ``MINIO_TPU_TORCH_DEVICE=cpu`` or
``device=`` asks for another. ``dryrun_multichip(n)`` runs one process a
rank under ``torch.distributed``: ``nccl`` with rank r on ``cuda:r``
where n cards are visible; where fewer are (and the CPU was not asked
for), it says so and runs on n CPU ranks with ``gloo``, as the reference
re-runs itself on a virtual CPU mesh. Nothing falls back: a failed
build, a failed process-group init or a rank that dies fails the call.
"""

from __future__ import annotations

import functools
import os
import sys
import time

D, P = 8, 8                 # production EC 8+8 (a 16-drive set)
N = (1 << 20) // D          # a 1 MiB stripe block -> 128 KiB shards
SEED = 0
# (missing data shards, survivor indices): 1 data shard lost; 2 data
# shards with mixed parity; all data rebuilt from parity alone
PATTERNS = [
    ((0,), tuple(range(1, D + 1))),
    ((1, 5), (0, 2, 3, 4, 6, 7, 8, 12)),
    (tuple(range(D)), tuple(range(D, D + P))),
]
TIMEOUT_S = 900.0           # the reference's limit on its CPU-mesh re-run


def entry(device=None):
    """(fn, example_args): one encode + hash step of the pipeline at EC
    4+2 on ``device`` (default: the card). ``fn(blocks)`` returns (parity
    [B, 2, n], digests [B, 6, 32]) as tensors there; its first call on the
    card builds the kernels (``ops/_build.py``)."""
    import numpy as np

    from .ops.bitrot_torch import encode_and_hash
    from .ops.rs_torch import get_torch_codec

    example = np.arange(2 * 4 * 1024, dtype=np.uint8).reshape(2, 4, 1024)
    return functools.partial(encode_and_hash, get_torch_codec(4, 2, device)), (example,)


def _blocks(world: int):
    """The dry run's input: one 1 MiB stripe block a rank, from SEED."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return rng.integers(0, 256, size=(world, D, N), dtype=np.uint8)


def _check(blocks, parity, digests, rebuilt: list, total: int) -> None:
    """Rank 0's checks: block 0's parity and digests against the host
    codec and HighwayHash, every rank's rebuilt shards against its input,
    and the reduced block count."""
    import numpy as np

    from .ops.highwayhash import hash256_batch_numpy
    from .ops.rs import get_codec

    ref = get_codec(D, P)
    want = ref.split(blocks[0].tobytes())
    ref.encode(want)
    np.testing.assert_array_equal(parity, want[D:])
    np.testing.assert_array_equal(digests, hash256_batch_numpy(want))
    for (missing, _present), got in zip(PATTERNS, rebuilt):
        for mi, idx in enumerate(missing):
            np.testing.assert_array_equal(got[:, mi], blocks[:, idx],
                                          err_msg=f"pattern missing={missing} shard {idx}")
    assert total == len(blocks), f"reduced block count {total} != {len(blocks)}"


def _rank(rank: int, world: int, kind: str, init_method: str, results) -> None:
    """One rank of the dry run: encode and hash its block, rebuild the
    three patterns, all-reduce its block count; rank 0 gathers the
    rebuilt shards and checks them (``_check``). Puts its K2 launches by
    shape, and rank 0 its seconds, on ``results``."""
    import torch
    import torch.distributed as dist

    from .ops import bitrot_cuda
    from .ops.bitrot_torch import encode_and_hash, to_numpy
    from .ops.rs_torch import get_torch_codec

    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)  # one core a rank, as one virtual device
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        blocks = _blocks(world)
        codec = get_torch_codec(D, P, dev)
        t0 = time.perf_counter()
        x = codec.as_tensor(blocks[rank:rank + 1])
        parity, digests = encode_and_hash(codec, x)
        shards = torch.cat([x, parity], dim=1)
        rebuilt = [codec.reconstruct_blocks(shards[:, list(present)], present, missing)
                   for missing, present in PATTERNS]
        total = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
        dist.all_reduce(total)
        gathered = []
        for r in rebuilt:
            parts = [torch.empty_like(r) for _ in range(world)]
            dist.all_gather(parts, r.contiguous())
            gathered.append(to_numpy(torch.cat(parts)))
        out = {"rank": rank, "launches": dict(bitrot_cuda.launch_shapes)}
        if rank == 0:
            _check(blocks, to_numpy(parity)[0], to_numpy(digests)[0], gathered,
                   int(total.item()))
            out["seconds"] = time.perf_counter() - t0
            out["parity"] = (world, *parity.shape[1:])
            out["digests"] = (world, *digests.shape[1:])
        results.put(out)
    finally:
        dist.destroy_process_group()


def _launch(world: int, kind: str, target=_rank, timeout_s: float = TIMEOUT_S) -> list:
    """Run ``target(rank, world, kind, init_method, results)`` in ``world``
    spawned processes; returns what they put on ``results``. A rank that
    raises or dies, or a run past ``timeout_s``, raises here."""
    import torch.multiprocessing as mp

    from .server.nodes import free_ports

    results = mp.get_context("spawn").SimpleQueue()
    init_method = f"tcp://127.0.0.1:{free_ports(1)[0]}"
    ctx = mp.start_processes(target, args=(world, kind, init_method, results), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"dryrun_multichip: {world} ranks timed out ({timeout_s:.0f} s)")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    while not results.empty():
        out.append(results.get())
    if len(out) != world:
        raise RuntimeError(f"dryrun_multichip: {len(out)} of {world} ranks reported")
    return sorted(out, key=lambda r: r["rank"])


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = TIMEOUT_S) -> dict:
    """The production-shape dry run on ``n_devices`` ranks (module
    docstring): EC 8+8, one 1 MiB stripe block a rank, three erasure
    patterns through the rebuild, the block count all-reduced. Prints the
    reference's OK line with the backend taken, and returns {"backend",
    "world", "seconds" (rank 0's, process start excluded), "launches"
    (K2's on every rank, by shape)}."""
    import torch

    from .device import ENV

    kind = torch.device(device if device is not None else os.environ.get(ENV, "cuda")).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            print(f"dryrun_multichip: {have} cards visible for {n_devices} ranks; running on "
                  f"{n_devices} CPU ranks (gloo)", file=sys.stderr, flush=True)
            kind = "cpu"
        else:
            from .ops import _build

            _build.load()  # built once here, not by every rank at once
    elif kind != "cpu":
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, not {kind}")
    backend = "nccl" if kind == "cuda" else "gloo"
    ranks = _launch(n_devices, kind, timeout_s=timeout_s)
    launches: dict = {}
    for r in ranks:
        for shape, c in r["launches"].items():
            launches[shape] = launches.get(shape, 0) + c
    r0 = ranks[0]
    print(f"dryrun_multichip OK: {n_devices} devices ({backend}), EC {D}+{P}, "
          f"{n_devices} x 1 MiB blocks, {len(PATTERNS)} erasure patterns, "
          f"parity {r0['parity']}, digests {r0['digests']}", flush=True)
    return {"backend": backend, "world": n_devices, "seconds": r0["seconds"],
            "launches": launches}


def main(argv: list[str]) -> int:
    """``[n]``: the dry run on n ranks; by default one a visible card, or
    the reference's 8 where there is none or the CPU is asked for."""
    import torch

    from .device import ENV

    on_cards = os.environ.get(ENV, "cuda").startswith("cuda") and torch.cuda.is_available()
    cards = torch.cuda.device_count() if on_cards else 0
    dryrun_multichip(int(argv[0]) if argv else cards or 8)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
