#!/usr/bin/env python3
"""Chip smoke of minio_tpu_torch: the port's main path on one CUDA card.

    python3 chip_smoke.py            # everything, as a deployment check
    python3 chip_smoke.py --kernels  # build + kernel-vs-plain only
    python3 chip_smoke.py --gf       # build + the GF core's small-batch table only

Phases (any failure raises and the script exits non-zero):

1. Build every kernel from ``minio_tpu_torch/csrc`` with nvcc (sm_90a),
   print the card's name and power limit.
2. The object layer on 16 local drive directories (1 MiB stripe blocks,
   64 MiB objects): 8 concurrent PUTs at EC 8+8, GETs, one lone PUT;
   degraded GETs with 8 drives' object directories deleted; a device
   heal; one lone and 4 concurrent PUTs and GETs at EC 12+4 (read cache
   off, so every GET reads the drives). Launch counts (and the shapes of
   the launches) are zeroed just before and read just after this phase;
   the kernels must have carried it and the degradation ladder must show
   no fault.
3. The cauchy storage class through the top-level object layer:
   ``ServerPools`` over one pool of 2 erasure sets of 16 drives (32 local
   drive directories), ``MINIO_TPU_EC_FAMILY=cauchy``: 8 concurrent
   64 MiB PUTs at EC 8+8 and their GETs; a 64 MiB multipart upload of 4
   concurrent 16 MiB parts through ``MultipartRouter``; a degraded GET
   with 8 drives' object directories deleted (cauchy decode runs on the
   host, as in the reference); a partial-repair heal of one lost data
   shard; 4 concurrent 64 MiB PUTs and GETs at EC 12+4. Its own launch
   counts are zeroed just before it and read just after: K3 must have
   carried both geometries and K2 their digests, with no fault.
4. The durability plane, after MinIO's operator procedures ("Expand a
   MinIO Deployment", "Decommission a Server Pool", "Recover after Drive
   Failure"): one pool of 16 drives at EC 8+8 holds 8 reedsolomon and 4
   cauchy objects of 64 MiB and 16 inline objects (1-128 KiB); a second
   pool of 16 drives is attached (``placement.topology.expand_pool``) and
   the first drained (``PoolManager.start_decommission``) on the
   dispatcher's background lane while 4 cauchy PUTs of 64 MiB arrive in
   the foreground. The drain must end ``complete`` with nothing failed
   and every object moved, K1 encode, K3 and K2 must have launched, the
   background lane must have carried every moved stripe block with no
   foreground block deferred behind it; the drained pool is then left
   out of a restarted deployment (``remove_pool`` refuses pool 0, which
   anchors the system namespace). On the remaining pool: one drive wiped
   and refilled by the fresh-drive monitor four times, in turns through
   the device heal (K1 decode) and the native plane (device, native,
   native, device), each refill byte-identical to the drive as it was; a
   degraded GET whose MRF heal the heal workers complete; a deep-verify
   scan that heals flipped parity bytes and reports every bucket's usage.
   Counts are zeroed just before the drain and read at the end of the
   phase.
5. The S3 front: ``make_server`` over one set of 16 drives, served by an
   ``AppRunner`` / ``TCPSite`` pair of the port's stdlib HTTP front on
   127.0.0.1, with MinIO's documented storage classes STANDARD = EC:8
   (reedsolomon 8+8) and REDUCED_REDUNDANCY = EC:8 in the cauchy family.
   Through the port's ``S3Client`` (SigV4 over the socket): 8 concurrent
   64 MiB STANDARD PUTs (streamed bodies) and their GETs; 4 concurrent
   64 MiB REDUCED_REDUNDANCY PUTs and their GETs; a multipart upload of 4
   concurrent 16 MiB parts; a ranged GET; a degraded GET after the 8
   drives holding one object's data shards lose it (K1 decode); an ILM
   transition of a 64 MiB object to a second port server acting as the
   warm tier, read back through the first; a scrape of the metrics plane,
   whose dispatcher series must equal the dispatcher's own aggregate.
   Every ETag and md5 is checked; K1 encode and decode, K3 and K2 must all
   have launched, and no dispatcher fault counter may move. Counts are
   zeroed just before the first PUT and read just after the scrape.
6. The server as operators start it, after MinIO's "Deploy MinIO:
   Multi-Node Multi-Drive": 4 `python -m minio_tpu_torch.server`
   processes on 127.0.0.1, 4 drives each, one erasure set of 16, with
   phase 5's storage classes and the device heal; beside it one node of
   16 drives as a pool of 2 workers. All serve on the card. Admin info
   from two nodes (4 servers, 16 drives online); 8 concurrent 64 MiB
   STANDARD PUTs, 2 through each node, each read back through another
   node, and one through each pool worker; 2 REDUCED_REDUNDANCY PUTs; two
   16 MiB overwrites of one key through two nodes (every node reads one
   whole body); node 3 SIGKILLed and its drives' object directories
   wiped; degraded GETs (K1 decode) and a PUT on the 12 drives left; node
   3 restarted and, once its drives are online again at node 0, the
   admin heal of the bucket, after which every file node 3 held must be
   back byte for byte; the admin object speedtest across the nodes;
   scrapes of every node (device dispatches and kernel launches where it
   took PUTs, no fault counter moved, grid traffic); SIGTERM, on which
   every process exits 0. The nodes start with their counts at zero and
   report them on `/minio/metrics/v3/api/tpu`, in all and by shape
   (``minio_tpu_kernel_launch_shapes_total``); node 3's are read just
   before it is killed. Any failure prints the tail of that node's log.
7. The alternate frontends, after MinIO's "File Transfer Protocol
   (FTP/SFTP)": one `python -m minio_tpu_torch.server --ftp F --sftp S`
   process over 16 drives on the card, STANDARD = EC:8, one ed25519 key
   in MINIO_SFTP_AUTHORIZED_KEYS, the server's default read cache.
   Through SFTP (the port's SSH client role and ``SFTPClient`` below,
   32 KiB requests 16 deep): password and publickey auth (a wrong
   password and an unlisted key refused), mkdir of a bucket, 4 concurrent
   sessions each writing one 64 MiB file (K1 encode on close), each read
   back through SFTP and through S3 (md5 equal to the ETag), stat,
   readdir, rename, remove. Through ``ftplib``: 4 concurrent 64 MiB STORs
   (K1 encode), their RETRs, LIST, DELE. A degraded read: an object no
   read has touched loses its directory on the 8 drives that hold its
   data shards, then SFTP and FTP RETR read it back (K1 decode; the
   launches each took are printed). The console page unauthenticated with
   the reference's headers. The node's counts (zero at its start, read
   from its scrape just after): K1 encode and decode launched, no fault
   counter moved; SIGTERM, exit 0.
8. The sanitized node: phase 5's deployment (16 drives, STANDARD = EC:8,
   REDUCED_REDUNDANCY = EC:8 cauchy, read cache off) as one `python -m
   minio_tpu_torch.server` process on the card with the project's runtime
   sanitizer on (MINIO_TPU_SANITIZE=1, stall threshold 0.5 s): the
   lock-order witness against the port's generated
   ``minio_tpu_torch/docs/LOCK_ORDER.md``, the access witness on the
   attributes of its ``CONCURRENCY.md``, the leak witness, the loop-stall
   watchdog. A signed admin trace stream (``type=sanitizer,s3``) collects
   the witnesses' records with their stacks. Through the port's
   ``S3Client``: 4 concurrent 64 MiB STANDARD PUTs (K1 encode) and their
   GETs, 2 REDUCED_REDUNDANCY PUTs (K3 + K2) and their GETs, a multipart
   upload of 4 x 16 MiB, a degraded GET after the 8 drives holding one
   object's data shards lose it (K1 decode); every md5 equal to its ETag.
   Then the node's scrapes of ``/api/sanitizer`` and ``/api/tpu``, admin
   ``sanitizer/status`` and ``healthinfo``. It fails unless the
   sanitizer is on, its static lock ranks equal the generated table's,
   it witnesses attributes, the leak witness is armed on ObjectHandle,
   the status agrees with the scrape, no lock-order, access, leak or
   lease violation was counted, K1 encode and decode, K3 and K2 launched
   in the node (zero at its start) with no fault counter moved, no loop
   stall's innermost package frame lies in code the port added (each
   stall is printed with its frames), and the node exits 0 on SIGTERM.
9. The last modules and the reference's served traffic: the port's graft
   entry (``minio_tpu_torch/graft_entry.py``), its one-step check (one
   encode + hash call at EC 4+2 on the card, held against the host codec
   and HighwayHash: K2 at 12 rows of 1 KiB) and its multi-device dry run
   on every visible card (``nccl``, one process a rank, EC 8+8, one 1 MiB
   block a rank, three erasure patterns rebuilt, the block count
   all-reduced: K2 at 16 rows of 128 KiB a rank, reported by the ranks);
   the served-traffic cases of ``tests/test_torch_served.py`` at the
   reference's shapes (``tests/test_tpu_served.py``: the port's S3 server
   in process over 4 drives at EC 2+2, 32 concurrent 2 MiB PUTs through
   the fused encode, GETs, degraded GETs through the fused decode, an
   admin heal with the device heal on, a 2 x 5 MiB multipart upload; the
   K1 decode matrix at B=16 over 4 geometries and 19 loss patterns, and
   the dispatcher's padding edges at 15 and 17 blocks); and
   ``python -m minio_tpu_torch.scripts.diag_smoke`` against a 2-worker
   pool on the card, which must exit 0. Counts are zeroed just before the
   one-step check and read after the padding edges, the dry run's ranks'
   added, and the pool's (its workers' scrapes, which the diag smoke
   prints by shape before it stops the pool).
10. The reference's data-path suites on the card: the cases of the JAX
   package's own suites whose work reaches the kernels, run as the
   reference wrote them through ``tests/test_torch_suites.py`` (its
   imports pointed at the port, its fixtures applied by pytest, the
   repository's ``tests/conftest.py`` left out: it imports the JAX
   package) on the card's route, ``MINIO_TPU_BACKEND=torch`` on
   ``cuda``: the batching core (``test_dispatcher``, both cases: 8
   concurrent submissions must share dispatches, ``blocks >= 17``,
   ``max_batch >= 4``), the dispatcher's QoS lanes (``test_qos``'s 5
   dispatch cases), the second code family's cases whose objects carry
   full 1 MiB stripe blocks (``test_cauchy``), its encode identity held
   against K3 itself and its family obs record (which sets the numpy
   backend itself), and the segment cache's (``test_cache_segments``,
   the coherence case under 4 readers first); then the port's card-only
   cases (``tests/test_torch_card.py``, all of it: each kernel against
   its plain version), the degradation ladder under injected device
   faults (``test_chaos``'s ladder and slow-batch cases, the port's
   versions), the erasure set, whole-file bitrot, multipart and the
   metadata cache's cases whose objects carry full stripe blocks,
   ``test_fault_injection``'s degraded reads and ``test_chaos``'s hedged
   read and drive-failure storm, the streaming PUT and the zero-copy
   arenas (their device-route variants), and the repair plane. Each
   case's seconds and its launches by kernel and shape are printed;
   counts are zeroed just before the first case and read after the last.
   It fails if a case fails, skips or does not run, or launches no kernel
   (but the two in ``SUITE_IDLE``); K1 encode and decode, K3 and K2 must
   have launched; no dispatcher the cases reached may have moved a fault
   counter, except those the ladder case built, which must show its walk
   (two device faults or more, one demotion, a probe, a promotion, no
   fused-kernel failure) with K1 at 4+2, B=2, n=1,024 launched twice or
   more, the base encode and the batch after the promotion (a ``ladder``
   line prints their counters and the seconds from the faults clearing to
   the promotion); and no ``minio_tpu`` module may be imported at the end.
11. Hold each kernel against its plain PyTorch version on the card, byte
   for byte, at every shape phases 2-10 launched it at, and a sample
   against the numpy reference codec; time both with CUDA events (K1's
   plain version gives its outputs for all K1 shapes from one call, its
   time going to a loop over a row's packets whatever the rows, and is
   timed alone at each K1 kernel's main shape). Also,
   untimed: K1 decode for three loss patterns (1 data shard; 2 data +
   mixed parity; all data rebuilt from parity), K2 at odd lengths and on
   rows starting at every offset 0-15 (n = 31, 32, 33, 65,536, 87,382),
   K3 on binary matrices that no GF matrix maps to (1, 2, 3, 8 and 17
   output rows), at odd lengths and at every row offset 0-15. Timed
   besides: K1's GF launch alone at each K1 shape (with its byte bound and
   the bit-plane product on the same matrix as its library yardstick), K3
   and K1's GF launch at their largest main-path shape on all-zero input
   against random input (``gf_conflict_ratio``: zero input reads one
   table entry in every lane, so no bank conflict), the GF core at every
   K1 and K3 main-path shape on grids of 1, 2, 4, 8 and 64 waves of
   resident blocks (``gf_waves``), K2 on a single chain
   (rows=1, n=131,072), the per-chain floor, and two alignment pairs: K2
   on 8,192 rows of 65,536, of 43,691 and of 43,680 bytes (aligned rows,
   rows at odd addresses, and aligned rows of the odd rows' whole-packet
   length), whose time per packet round the script compares; K2 on the 16
   shards of one EC:4 block (n = 87,382), back to back and at the shard
   slab's 32-byte pitch (87,392), ns a round each; K3 at the
   8x24 composite, B=256, on rows at odd addresses (h = 43,691) and on
   16-byte aligned rows (h = 43,696). The GF core at the benchmark
   cells' launches (``gf_small_batch``: K3 into EC:4's shard slab at
   B = 1, 2, 4; K1's GF launch at 8+8, B = 1, 2) and at B = 16-256, each
   on the plan the package picks and on the 256-thread plan without the
   small-batch regime, byte for byte between the two, beside the byte
   bound. With ``--kernels`` phases 2-10 are skipped and the main path's
   shapes are taken from ``DEFAULT_SHAPES``; with ``--gf`` only the
   build and ``gf_small_batch`` run (a package without the regime times
   its own plan alone, so a parent checkout can run this script).

Prints the dispatcher stats, one ``s3_phase`` JSON line (per-step
seconds, bytes, launches and shapes, dispatcher stats, the scraped
series), one ``cluster_phase`` line (per-step seconds, each node's
dispatches, blocks, launches and fault counters, the heal, the speedtest
rows, exit codes), one ``gateway_phase`` line (per-step seconds, bytes
by protocol, the node's launches by shape and dispatcher counts, the K1
decode launches of each degraded read, the console's headers, the exit
code), one ``sanitizer_phase`` line (per-step seconds, phase 5's beside
them and both as MiB/s, the witness counts, violations, the scrape, the
loop stalls with their frames, launches by shape), one ``graft_phase``
line (per-step seconds, the dry run's backend, world and seconds, its
ranks' K2 launches, the diag pool's launches by shape, the diag smoke's
last line, launches by shape), one ``ladder`` line and one
``suite_phase`` line (each case's seconds and launches by shape, the
dispatchers' counters, the ladder's), K2's
device time per
packet round, the hash
core's SASS instructions per round of each read path (aligned and
generic) in K1's and K2's instantiation, split by pipe (integer ALU, FMA,
LSU; ``cuobjdump``, where the toolkit has it), the GF core's registers
and spills per instantiation (``nvcc -Xptxas -v``; more registers than
``gf_cuda.registers`` allows, or a spill, fails), ``gf_conflict_ratio``,
``gf_waves``, one ``kernels`` JSON line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Kernel
times are medians of 7 samples of 5 back-to-back calls each. Needs one
CUDA card; without one (or without the package beside it) it exits
non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
DEV = "cuda:0"
MIB = 1 << 20

# H100 SXM published peaks (dense): HBM rate, and float32 outside the
# tensor cores as the rate for the kernels' integer operations
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
# 64-bit integer operations per 32-byte HighwayHash packet round (4 lanes
# x (adds, 32x32 multiply, xors) + 4 zipper merges), each counted once
HASH_OPS_PER_PACKET = 150


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def bound(read_b: int, write_b: int, ops: float) -> tuple[float, str]:
    t_bytes = (read_b + write_b) / HBM_BYTES_S * 1e3
    t_ops = ops / ALU_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int = 7, warm: int = 1, inner: int = 1) -> float:
    """Median CUDA-event time of one fn() call over reps samples, after
    warm-up. A sample times ``inner`` calls back to back and divides, so
    that the host's submission of the first call is not counted as device
    time more than once (kernels take ``inner=5``)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def timed_once(torch, fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


# SASS opcodes by the pipe of an SM sub-partition that executes them: the
# integer ALU and the FMA pipe's integer multiply-adds are 16 lanes wide
# each on the H100, so each takes two cycles a warp instruction
SASS_PIPES = {
    "alu": ("IADD3", "LOP3", "PRMT", "SHF", "ISETP", "LEA", "SEL", "IMNMX", "IABS", "FLO",
            "POPC", "BMSK", "PLOP3", "SGXT", "BREV"),
    "fma": ("IMAD", "FFMA", "FMUL", "FADD", "IDP"),
    "lsu": ("LDS", "LDG", "LD.", "STS", "STG", "ST.", "ATOM", "RED", "SHFL", "LDSM"),
}


def sass_op(text: str) -> str:
    """The opcode of one SASS instruction, past any predicate."""
    return text.split()[1] if text.startswith("@") else text.split()[0]


def sass_pipe(text: str) -> str:
    """The pipe of one SASS instruction (``SASS_PIPES``), "other" for the
    rest (moves, branches, barriers)."""
    op = sass_op(text)
    for pipe, prefixes in SASS_PIPES.items():
        if any(op == x or op.startswith(x + ".") or (x.endswith(".") and op.startswith(x))
               for x in prefixes):
            return pipe
    return "other"


def sass_per_round(so: str, kernel: str):
    """Instructions per packet round of the hash core's hot loops, read
    from ``cuobjdump -sass`` of the library ``so``, in the function whose
    name holds ``kernel``: for each read path, the smallest loop (a
    backward branch and its target) that reads shared memory, waits on no
    barrier and holds 8 or more 32x32->64 products (``IMAD.WIDE.U32`` with
    no addend, 4 a round: 2 lanes x 2). The aligned path's loop reads with
    ``LDS.128``, the generic path's with 4-byte ``LDS``. Per round: all
    instructions and those of each pipe (``SASS_PIPES``), beside the
    opcodes of "other". None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    import collections
    import re

    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120).stdout
    loops: dict[str, tuple] = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ins = [(int(a, 16), t.strip())
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        for addr, text in ins:
            br = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if not br or int(br.group(1), 16) > addr:
                continue
            body = [t for a, t in ins if int(br.group(1), 16) <= a <= addr]
            ops = [sass_op(t) for t in body]
            products = sum(op == "IMAD.WIDE.U32" and t.rstrip().endswith("RZ")
                           for op, t in zip(ops, body))
            if any(op.startswith("SYNCS") for op in ops) or products < 8 or products % 4:
                continue
            if not any(op.startswith("LDS") for op in ops):
                continue
            path = "aligned" if any(op.startswith("LDS.128") for op in ops) else "generic"
            if path not in loops or len(body) < len(loops[path][1]):
                loops[path] = (name, body, products // 4)
    if not loops:
        return None
    res = {}
    for path, (name, body, rounds) in sorted(loops.items()):
        pipes = collections.Counter(sass_pipe(t) for t in body)
        other = collections.Counter(sass_op(t).split(".")[0] for t in body
                                    if sass_pipe(t) == "other")
        res[path] = {"kernel": name, "loop_instructions": len(body), "rounds": rounds,
                     "per_round": len(body) / rounds,
                     **{f"{p}_per_round": pipes[p] / rounds for p in (*SASS_PIPES, "other")},
                     "other_ops": dict(other)}
    return res


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item()) if got.numel() else 0


# the shapes the main path gives each kernel, for ``--kernels`` runs
# (no object phase to read them from): the dispatcher's cap of 4,096
# shards is 256 blocks at 8+8, and one 1 MiB PUT at a time is one block
# (the benchmark's cell); degraded GETs decode 8-block windows with all 8
# data shards rebuilt from parity; EC 12+4 PUTs hash
# 64 and 256 blocks of 16 shards of 87,382 bytes (and the graft entry's
# dry run one 8+8 block of 16 shards of 128 KiB a rank, its one-step
# check 2 blocks of 6 shards of 1 KiB); cauchy PUTs apply the
# [2p, 2d] composite to 256 blocks' a/b halves (K3 keys: B, 2d, 2p, h,
# sub-chunks) and hash their 2 x 16 sub-chunks per block
DEFAULT_SHAPES = {
    "fused_encode_hash": [("encode", 256, 8, 8, 131072), ("encode", 1, 8, 8, 131072)],
    "fused_decode_hash": [("decode", 8, 8, 8, 131072, tuple(range(8, 16)), tuple(range(8)))],
    "hh_chain": [(1024, -(-MIB // 12)), (4096, -(-MIB // 12)), (8192, 65536),
                 (8192, -(-MIB // 12) // 2), (16, MIB // 8), (12, 1024)],
    "gf_apply": [(256, 16, 16, 65536, 2), (256, 24, 8, -(-MIB // 12) // 2, 2)],
}
# K3's alignment pair: the cauchy 12+4 sub-chunk length (rows at odd
# addresses) and the nearest length whose rows are all 16-byte aligned
K3_PAIR = (-(-MIB // 12) // 2, 43696)
# a fixed deployment id for the cauchy phase's ServerPools: the set each
# key hashes to depends on it
DEPLOYMENT_ID = "3f1c2b7a-5e4d-4c3b-9a2f-1e0d9c8b7a65"
# the loss patterns of the multi-device graft drive, as (missing, present)
# at 8+8: 1 data shard; 2 data + mixed parity; all data from parity
LOSS_PATTERNS = [
    ((0,), tuple(range(1, 9))),
    ((1, 5), (0, 2, 3, 4, 6, 7, 8, 12)),
    (tuple(range(8)), tuple(range(8, 16))),
]


def k1_bound(b: int, d: int, r: int, n: int) -> tuple[float, str]:
    """d input rows in; r output rows and d + r digests out; the GF
    apply's multiply-add per output byte and input row, and the hash of
    d + r rows."""
    return bound(b * d * n, b * r * n + b * (d + r) * 32,
                 b * (d + r) * (n // 32) * HASH_OPS_PER_PACKET + 2 * b * r * d * n)


def k1_case(torch, mods, g, key) -> dict:
    """K1 at one main-path shape: its inputs, GF matrix and launch."""
    fc, rs, rt = mods["fc"], mods["rs"], mods["rt"]
    dev = torch.device(DEV)
    if key[0] == "encode":
        _, b, d, p, n = key
        x = torch.randint(0, 256, (b, d, n), dtype=torch.uint8, device=dev, generator=g)
        return {"key": key, "x": x, "m": rs.get_codec(d, p).parity_matrix, "want_out": None,
                "run": lambda: fc.fused_encode_hash(x, d, p)}
    _, b, d, p, n, present, missing = key
    data = torch.randint(0, 256, (b, d, n), dtype=torch.uint8, device=dev, generator=g)
    full = torch.cat([data, rt.get_torch_codec(d, p, dev).encode_blocks(data)], dim=1)
    x = full[:, list(present)].contiguous()
    return {"key": key, "x": x, "m": fc.decode_matrix(d, p, present, missing),
            "want_out": full[:, list(missing)],
            "run": lambda: fc.fused_decode_hash(x, d, p, present, missing)}


def k1_plain(torch, mods, cases) -> list:
    """The plain version's (out, digests) for every case: each one's GF
    product, then one HighwayHash call per shard length over all the
    cases' shards of that length, whose time goes to its loop over the
    packets of a row, whatever the rows."""
    import numpy as np

    rt, bt = mods["rt"], mods["bt"]
    outs, rows = [], []
    for c in cases:
        x, m = c["x"], c["m"]
        w = torch.from_numpy(rt.gf_matrix_to_bitplanes(m).astype(np.float32)).to(x.device)
        outs.append(rt.gf_apply_bits(w, x, m.shape[0]))
        rows.append(torch.cat([x, outs[-1]], dim=1).reshape(-1, x.shape[2]))
    digs: list = [None] * len(cases)
    for n in sorted({r.shape[1] for r in rows}):
        idx = [i for i, r in enumerate(rows) if r.shape[1] == n]
        parts = bt.hash256_blocks_plain(torch.cat([rows[i] for i in idx]))
        for i, dg in zip(idx, parts.split([len(rows[i]) for i in idx])):
            digs[i] = dg
    return [(o, dg.reshape(o.shape[0], -1, 32)) for o, dg in zip(outs, digs)]


def check_k1(torch, mods, case, plain, timed: bool, time_plain: bool = False) -> dict:
    """K1 at one case: kernel vs its plain version's outputs (``plain``)
    on the same inputs, byte for byte, a sample against the numpy
    reference, and (if timed) CUDA-event times of the kernel, its GF
    launch alone and the library's GF product; with ``time_plain`` one
    call of the plain version alone too, held to the same outputs."""
    import numpy as np

    fc, rt, hh = mods["fc"], mods["rt"], mods["hh"]
    key, x, m, run = case["key"], case["x"], case["m"], case["run"]
    b, d, n = x.shape
    r = m.shape[0]
    out, dig = run()
    torch.cuda.synchronize()
    pout, pdig = plain
    err = max(max_abs_err(torch, out, pout), max_abs_err(torch, dig, pdig))
    if case["want_out"] is not None and not torch.equal(out, case["want_out"]):
        fail(f"K1 {shape_name(key)}: rebuilt shards differ from the originals")
    for bi in (0, b - 1):
        want = mods["gf"].gf_matvec_blocks(m, x[bi].cpu().numpy())
        if not (want == out[bi].cpu().numpy()).all():
            fail(f"K1 {shape_name(key)}: output rows differ from numpy GF at block {bi}")
        shards = np.concatenate([x[bi].cpu().numpy(), want])
        if not (hh.hash256_batch_numpy(shards) == dig[bi].cpu().numpy()).all():
            fail(f"K1 {shape_name(key)}: digests differ from numpy HighwayHash at block {bi}")
    res = {"max_abs_err": err}
    plain_ms = None
    if time_plain:
        (pout, pdig), plain_ms = timed_once(torch, lambda: fc.fused_plain(x, m))
        if not (torch.equal(pout, plain[0]) and torch.equal(pdig, plain[1])):
            fail(f"K1 {shape_name(key)}: the plain version alone differs from its batched call")
    if timed:
        # K1's first launch alone (fused_gf_apply), on the same tables
        p = key[3]
        tables = (fc._encode_tables(d, p, str(x.device)) if key[0] == "encode"
                  else fc._decode_tables(d, p, key[5], key[6], str(x.device)))
        gf_only = lambda: fc.gf_apply_only(x, tables, r)  # noqa: E731
        if not torch.equal(gf_only(), out):
            fail(f"K1 {shape_name(key)}: the GF launch alone differs from the fused output")
        bms, by = k1_bound(b, d, r, n)
        wf = torch.from_numpy(rt.gf_matrix_to_bitplanes(m).astype(np.float32)).to(x.device)
        res.update(ms=cuda_ms(torch, run, inner=5), plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   gf_ms=cuda_ms(torch, gf_only, inner=5),
                   gf_bound_ms=bound(b * d * n, b * r * n, 2 * b * r * d * n)[0],
                   gf_library_ms=cuda_ms(torch, lambda: rt.gf_apply_bits(wf, x, r), reps=5))
    return res


def check_k2(torch, mods, g, rows: int, n: int, timed: bool, pitch: int = 0) -> dict:
    """K2 on ``rows`` rows of n bytes, back to back or one ``pitch`` apart."""
    bc, bt, hh = mods["bc"], mods["bt"], mods["hh"]
    y = torch.randint(0, 256, (rows, pitch or n), dtype=torch.uint8, device=torch.device(DEV),
                      generator=g)[:, :n]
    got = bc.hash256_blocks(y)
    torch.cuda.synchronize()
    want, plain_ms = timed_once(torch, lambda: bt.hash256_blocks_plain(y))
    err = max_abs_err(torch, got, want)
    idx = sorted({i for i in (0, 1, rows - 1) if 0 <= i < rows})
    if idx and not (hh.hash256_batch_numpy(y[idx].cpu().numpy()) == got[idx].cpu().numpy()).all():
        fail(f"K2 digests differ from numpy HighwayHash at rows={rows} n={n}")
    res = {"max_abs_err": err}
    if timed:
        bms, by = bound(rows * n, rows * 32, rows * -(-n // 32) * HASH_OPS_PER_PACKET)
        res.update(ms=cuda_ms(torch, lambda: bc.hash256_blocks(y), inner=5), plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by)
    return res


def check_k2_offsets(torch, mods, g, n: int, rows: int = 4) -> dict:
    """K2 untimed on rows of n bytes starting at each offset 0-15 from a
    16-byte boundary, each placement's last row ending at its buffer's
    last byte; byte for byte against the plain version, which runs once
    over all placements' rows, and a sample against numpy."""
    bc, bt, hh = mods["bc"], mods["bt"], mods["hh"]
    dev = torch.device(DEV)
    xs, got = [], []
    for off in range(16):
        buf = torch.randint(0, 256, (off + rows * n,), dtype=torch.uint8, device=dev, generator=g)
        xs.append(buf[off:].view(rows, n))
        got.append(bc.hash256_blocks(xs[-1]))
    if sorted(x.data_ptr() % 16 for x in xs) != list(range(16)):
        fail(f"K2 offsets n={n}: rows did not start at every offset 0-15")
    torch.cuda.synchronize()
    got = torch.cat(got)
    err = max_abs_err(torch, got, bt.hash256_blocks_plain(torch.cat(xs)))
    sample = torch.cat([xs[0][:1], xs[15][-1:]]).cpu().numpy()
    if not (hh.hash256_batch_numpy(sample) == got[[0, 16 * rows - 1]].cpu().numpy()).all():
        fail(f"K2 offsets n={n}: digests differ from numpy HighwayHash")
    return {"max_abs_err": err}


def check_k3(torch, mods, g, key, timed: bool) -> dict:
    """K3 at one main-path shape (B, 2d, 2p, h, sub): the cauchy composite
    applied to [B, d, 2h] data, in place on the sub-chunks (sub = 2, the
    codec's ``encode_blocks``) or to the explicit [B, 2d, h] a/b rows
    (sub = 1, ``cauchy.encode_kernel``), kernel vs its plain version on
    the same inputs, byte for byte, a sample against the numpy cauchy
    codec, and (if timed) CUDA-event times of both and of the library
    product (``rs_torch.gf_apply_bits`` on the explicit composite)."""
    import numpy as np

    k3, ca, rt = mods["k3"], mods["cauchy"], mods["rt"]
    b, kc, r, h, sub = key
    if sub not in (1, 2) or kc % 2 or r % 2:
        fail(f"K3 main-path shape {key} is not a cauchy composite")
    d, p = kc // 2, r // 2
    dev = torch.device(DEV)
    w = ca.get_torch_codec(d, p, DEV).w_composite
    x = torch.randint(0, 256, (b, d, 2 * h), dtype=torch.uint8, device=dev, generator=g)
    u = x.reshape(b, d, 2, h).transpose(1, 2).reshape(b, kc, h).contiguous()
    inp, rows = (x, p) if sub == 2 else (u, r)
    run = lambda: k3.gf_apply_cuda(w, inp, rows, sub=sub)  # noqa: E731
    plain = lambda: k3.gf_apply_plain(w, inp, rows, sub=sub)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    err = max_abs_err(torch, out, plain())
    if sub == 1:  # the a/b parity rows back in the shards' layout
        out = out.reshape(b, 2, p, h).transpose(1, 2).reshape(b, p, 2 * h)
    ref = ca.get_codec(d, p)
    for bi in (0, b - 1):
        full = np.zeros((d + p, 2 * h), dtype=np.uint8)
        full[:d] = x[bi].cpu().numpy()
        if not (ref.encode(full)[d:] == out[bi].cpu().numpy()).all():
            fail(f"K3 {shape_name(key)}: parity differs from the numpy cauchy codec at block {bi}")
    res = {"max_abs_err": err}
    if timed:
        bms, by = bound(b * kc * h, b * r * h, b * r * kc * h)
        wf = torch.from_numpy(w.astype(np.float32)).to(dev)
        res.update(ms=cuda_ms(torch, run, inner=5), plain_ms=cuda_ms(torch, plain, reps=5),
                   bound_ms=bms, bound_by=by,
                   library_ms=cuda_ms(torch, lambda: rt.gf_apply_bits(wf, u, r), reps=5))
    return res


def check_k3_binary(torch, mods, g, k: int, r: int, n: int) -> dict:
    """K3 untimed on a random [8r, 8k] binary matrix that is the image of
    no GF matrix, rows of n bytes starting at each offset 0-15 from a
    16-byte boundary (the last placement ends at its buffer's last byte)."""
    import numpy as np

    k3 = mods["k3"]
    w = np.random.default_rng(n * 131 + k * 7 + r).integers(0, 2, size=(8 * r, 8 * k))
    w = w.astype(np.int8)
    w[0, :8] = 1  # block (0, 0) maps byte 1 to 0xff and bytes 2..128 to 0:
    w[1:8, :8] = 0  # no GF(2^8) multiplication does that
    buf = torch.randint(0, 256, (3 * k * n + 15,), dtype=torch.uint8, device=torch.device(DEV),
                        generator=g)
    if buf.data_ptr() % 16:
        fail("K3 offsets: the buffer does not start on a 16-byte boundary")
    err = 0
    for off in range(16):
        x = buf[off: off + 3 * k * n].view(3, k, n)
        err = max(err, max_abs_err(torch, k3.gf_apply_cuda(w, x, r), k3.gf_apply_plain(w, x, r)))
    return {"max_abs_err": err}


def shape_name(key) -> str:
    if isinstance(key[0], str):
        s = f"{key[0]} B={key[1]} {key[2]}+{key[3]} n={key[4]}"
        return s + (f" missing={list(key[6])}" if key[0] == "decode" else "")
    if len(key) == 5:
        return f"B={key[0]} {key[1]}x{key[2]} composite n={key[3]} sub={key[4]}"
    return f"rows={key[0]} n={key[1]}"


def shape_weight(key) -> int:
    """Bytes hashed per launch: B (d + r) n for K1, B n for K2; bytes
    moved, B (k + r) n, for K3."""
    if isinstance(key[0], str):
        r = key[3] if key[0] == "encode" else len(key[6])
        return key[1] * (key[2] + r) * key[4]
    if len(key) == 5:
        return key[0] * (key[1] + key[2]) * key[3]
    return key[0] * key[1]


def gf_conflict_ratio(torch, mods, shapes: dict) -> dict:
    """K3 and K1's GF launch at their largest main-path shape, timed on
    all-zero input (every lane reads table entry 0: a broadcast, no bank
    conflict) and on random input; the ratio of the two times is what the
    shared-memory bank conflicts of the lookups cost."""
    k3, fc, ca = mods["k3"], mods["fc"], mods["cauchy"]
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def zero_vs_random(key, size, run) -> dict:
        ms = {}
        for name in ("zero", "random"):
            x = torch.randint(0, 256, size, dtype=torch.uint8, device=dev, generator=g)
            if name == "zero":
                x.zero_()
            ms[name] = cuda_ms(torch, lambda: run(x), inner=5)
        return {"shape": shape_name(key), "zero_ms": ms["zero"], "random_ms": ms["random"],
                "ratio": ms["random"] / ms["zero"]}

    key = max(shapes["gf_apply"], key=shape_weight)
    b, kc, r, h, _ = key
    w = ca.get_torch_codec(kc // 2, r // 2, DEV).w_composite
    out = {"gf_apply": zero_vs_random(key, (b, kc // 2, 2 * h),
                                      lambda x: k3.gf_apply_cuda(w, x, r // 2, sub=2))}
    key = max([*shapes["fused_encode_hash"], *shapes["fused_decode_hash"]], key=shape_weight)
    _, b, d, p, n = key[:5]
    if key[0] == "encode":
        tables, r = fc._encode_tables(d, p, DEV), p
    else:
        tables, r = fc._decode_tables(d, p, key[5], key[6], DEV), len(key[6])
    out["fused_gf_apply"] = zero_vs_random(key, (b, d, n),
                                           lambda x: fc.gf_apply_only(x, tables, r))
    return out


def gf_waves(torch, mods, shapes: dict) -> list:
    """The GF core at each K3 and K1 shape of ``shapes``, timed on grids of
    1, 2, 4, 8 and 64 waves of resident blocks (``gf_cuda.plan``'s
    ``waves``; the plan takes 1 on whole column tiles, else
    ``gf_cuda.UNEVEN_WAVES``). Every shape goes
    through K1's GF entry point on contiguous rows (K3's composite rows
    as [B, 2k, h]), with the tables its wrapper builds."""
    import numpy as np

    k3, fc, ca, gc = mods["k3"], mods["fc"], mods["cauchy"], mods["gc"]
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = []
    for key in sorted(shapes["gf_apply"], key=shape_weight, reverse=True):
        b, kc, r, h, _ = key
        w = np.asarray(ca.get_torch_codec(kc // 2, r // 2, DEV).w_composite)
        tables = torch.from_numpy(gc.wide_tables(k3.bitplane_tables(w))).to(dev)
        out.append((key, (b, kc, h), tables, r))
    for key in sorted([*shapes["fused_encode_hash"], *shapes["fused_decode_hash"]],
                      key=shape_weight, reverse=True):
        _, b, d, p, n = key[:5]
        if key[0] == "encode":
            tables, r = fc._encode_tables(d, p, DEV), p
        else:
            tables, r = fc._decode_tables(d, p, key[5], key[6], DEV), len(key[6])
        out.append((key, (b, d, n), tables, r))
    res = []
    for key, size, tables, r in out:
        x = torch.randint(0, 256, size, dtype=torch.uint8, device=dev, generator=g)
        ms = {w: cuda_ms(torch, lambda: fc.gf_apply_only(x, tables, r, waves=w), inner=5)
              for w in (1, 2, 4, 8, 64)}
        res.append({"shape": shape_name(key), "tiles": gc.plan(size[0], size[1], r, size[2]).tiles,
                    "ms_by_waves": ms})
    return res


# the GF core's launches in the benchmark's cells (K3 into EC:4's shard
# slab, 12+4 at n = 87,382; K1's GF launch, 8+8 at n = 131,072), at the
# few blocks a launch they carry; and at B = 16-256, where the plan must
# not move: K1 encode, the slab, the cauchy composites (16x16 at
# h = 65,536; 8x24 at h = 43,691, rows at odd addresses)
GF_CELL_SHAPES = ([("slab", b, 12, 4, -(-MIB // 12)) for b in (1, 2, 4)]
                  + [("k1", b, 8, 8, 131072) for b in (1, 2)])
GF_LARGE_SHAPES = ([("k1", b, 8, 8, 131072) for b in (16, 64, 256)]
                   + [("slab", b, 12, 4, -(-MIB // 12)) for b in (16, 64, 256)]
                   + [("cauchy", b, 16, 16, 65536) for b in (16, 256)]
                   + [("cauchy", b, 24, 8, -(-MIB // 12) // 2) for b in (64, 256)])


def queued_ms(torch, fn, reps: int = 7, inner: int = 20) -> float:
    """Median CUDA-event time of one fn() call, its ``inner`` calls queued
    behind a device sleep so that they run back to back: for kernels of a
    few microseconds, shorter than the host's submission of a call, which
    ``cuda_ms`` would time instead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device cycles: the host queues meanwhile
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def kernel_us(torch, fn, name: str, calls: int = 20):
    """Median device duration in microseconds of the kernels whose name
    holds ``name`` over ``calls`` calls of fn, from a torch.profiler trace
    (what the benchmark's traced runs read); None where the trace has
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    durs = [e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and name in e.get("name", "")]
    return statistics.median(durs) if durs else None


def gf_small_batch(torch, mods) -> list:
    """The GF core at ``GF_CELL_SHAPES`` and ``GF_LARGE_SHAPES`` ((route,
    B, k, r, n): k -> r rows of n bytes, the composite's for the cauchy
    rows), CUDA-event medians of queued calls (``queued_ms``) and the
    profiler's median kernel duration (``kernel_us``) on the plan the
    package picks and, where its plan takes ``small``, on the 256-thread
    plan without the small-batch regime; byte for byte between the two and against the
    plain version at the first and last item. K3's routes go through
    ``rs_cuda.gf_apply_cuda`` (the slab's rows at its 32-byte pitch, the
    parity written in place; the cauchy a/b halves in place), K1's
    through ``fused_cuda.gf_apply_only``."""
    import contextlib
    import functools
    import inspect

    import numpy as np

    k3, fc, gc, rt, bt, ca = (mods[m] for m in ("k3", "fc", "gc", "rt", "bt", "cauchy"))
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    forced = "small" in inspect.signature(gc.plan).parameters

    @contextlib.contextmanager
    def k3_plan(small):
        # rs_cuda reads gf_cuda.plan at each call
        orig = gc.plan
        if small is not None:
            gc.plan = functools.partial(orig, small=small)
        try:
            yield
        finally:
            gc.plan = orig

    res = []
    for shape in GF_CELL_SHAPES + GF_LARGE_SHAPES:
        route, b, k, r, n = shape
        if route == "k1":
            x = torch.randint(0, 256, (b, k, n), dtype=torch.uint8, device=dev, generator=g)
            tables = fc._encode_tables(k, r, DEV)
            m = mods["rs"].get_codec(k, r).parity_matrix
            w = torch.from_numpy(rt.gf_matrix_to_bitplanes(m).astype(np.float32)).to(dev)

            def run(small, x=x, tables=tables, r=r):
                return (fc.gf_apply_only(x, tables, r, small=small) if small is not None
                        else fc.gf_apply_only(x, tables, r))

            def plain(i, x=x, w=w, r=r):
                return rt.gf_apply_bits(w, x[i:i + 1], r)[0]
        elif route == "slab":
            codec = rt.get_torch_codec(k, r, DEV)
            slab = bt.shard_slab(codec, torch.randint(0, 256, (b, k, n), dtype=torch.uint8,
                                                      device=dev, generator=g))
            wb = codec.w_encode

            def run(small, slab=slab, wb=wb, r=r):
                with k3_plan(small):
                    k3.gf_apply_cuda(wb, slab.data, r, out=slab.parity)
                return slab.parity

            def plain(i, slab=slab, wb=wb, r=r):
                return k3.gf_apply_plain(wb, slab.data[i:i + 1], r)[0]
        else:  # the cauchy composite on [B, k/2, 2n] shards' a/b halves
            wb = ca.get_torch_codec(k // 2, r // 2, DEV).w_composite
            x = torch.randint(0, 256, (b, k // 2, 2 * n), dtype=torch.uint8, device=dev,
                              generator=g)

            def run(small, x=x, wb=wb, r=r):
                with k3_plan(small):
                    return k3.gf_apply_cuda(wb, x, r // 2, sub=2)

            def plain(i, x=x, wb=wb, r=r):
                return k3.gf_apply_plain(wb, x[i:i + 1], r // 2, sub=2)[0]
        row = {"shape": f"{route} B={b} {k}->{r} n={n}",
               "bound_ms": bound(b * k * n, b * r * n, 2 * b * r * k * n)[0]}
        plans = {"plan": None, "wave_plan": False} if forced else {"plan": None}
        outs = {}
        for name, small in plans.items():
            outs[name] = run(small).clone()
            p = gc.plan(b, k, r, n, small=small) if small is not None else gc.plan(b, k, r, n)
            row[name] = {"threads": p.threads, "grid": p.grid, "tiles": p.tiles,
                         "ms": queued_ms(torch, lambda s=small: run(s)),
                         "kernel_us": kernel_us(torch, lambda s=small: run(s), "gf_core_kernel")}
        if forced and not torch.equal(outs["plan"], outs["wave_plan"]):
            fail(f"GF core {row['shape']}: the small-batch and wave plans differ")
        for i in (0, b - 1):
            if not torch.equal(outs["plan"][i], plain(i)):
                fail(f"GF core {row['shape']}: differs from the plain version at item {i}")
        if forced:
            row["wave_over_plan"] = row["wave_plan"]["ms"] / row["plan"]["ms"]
        print(f"gf_small_batch {row['shape']}: plan {row['plan']['threads']}x"
              f"{row['plan']['grid']} ms={row['plan']['ms']:.5f}"
              f" kernel_us={row['plan']['kernel_us']}"
              + (f" wave_plan ms={row['wave_plan']['ms']:.5f}"
                 f" kernel_us={row['wave_plan']['kernel_us']}" if forced else "")
              + f" bound_ms={row['bound_ms']:.5f}", flush=True)
        res.append(row)
    return res


def gf_core_registers(logs: dict) -> dict:
    """Registers and spills of each GF core instantiation (gf_core_kernel<E,
    C, Small>; Small absent in a package without the small-batch regime)
    in each library, read from ptxas's verbose output of this run's build;
    None for a library that this process did not build."""
    import re

    res = {}
    for lib in ("gf_apply", "fused_encode_hash"):
        log = logs.get(lib)
        if log is None:
            res[lib] = None
            continue
        res[lib] = []
        for chunk in log.split("Compiling entry function '")[1:]:
            name = chunk.split("'", 1)[0]
            ec = re.search(r"gf_core_kernelILi(\d+)ELi(\d+)E(?:Lb(\d)E)?", name)
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            if ec and regs:
                res[lib].append({"entry": int(ec.group(1)), "cols": int(ec.group(2)),
                                 "small": ec.group(3) == "1",
                                 "registers": int(regs.group(1)),
                                 "spill_stores": int(spill.group(1)) if spill else None,
                                 "spill_loads": int(spill.group(2)) if spill else None})
    return res


def kernel_phase(torch, mods, shapes: dict) -> dict:
    """Every kernel at every shape the main path gave it (``shapes``:
    kernel -> {shape key: launches}), plus the single chain, the
    alignment pair, the loss patterns, and K2's odd lengths and row
    offsets. Returns, per kernel, the shape that moved the most bytes on
    the main path (its times go into the ``kernels`` line) and the
    per-shape results."""
    g = torch.Generator(device=torch.device(DEV)).manual_seed(SEED)
    res: dict = {}
    order = {name: sorted(per.items(), key=lambda kv: -(kv[1] or 1) * shape_weight(kv[0]))
             for name, per in shapes.items()}
    # K1: every case's inputs first (the main path's shapes, then the loss
    # patterns), and its plain version's outputs for all of them from one
    # call; the plain version is timed alone at each K1 kernel's main shape
    loss = [("decode", 16, 8, 8, 131072, present, missing) for missing, present in LOSS_PATTERNS]
    cases = [k1_case(torch, mods, g, key) for key in
             [k for name in ("fused_encode_hash", "fused_decode_hash") for k, _ in order[name]]
             + loss]
    k1 = list(zip(cases, k1_plain(torch, mods, cases)))[::-1]  # popped in order, then freed
    del cases
    checks = {"fused_encode_hash": lambda key, main: check_k1(torch, mods, *k1.pop(), True, main),
              "fused_decode_hash": lambda key, main: check_k1(torch, mods, *k1.pop(), True, main),
              "hh_chain": lambda key, main: check_k2(torch, mods, g, key[0], key[1], timed=True),
              "gf_apply": lambda key, main: check_k3(torch, mods, g, key, timed=True)}
    for name, check in checks.items():
        per = []
        for key, launches in order[name]:
            r = check(key, not per)
            r.update(shape=shape_name(key), launches=launches)
            per.append(r)
            print(f"{name} {r['shape']}: launches={launches} err={r['max_abs_err']} "
                  f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f}"
                  + (f" plain_ms={r['plain_ms']:.1f}" if r["plain_ms"] is not None else "")
                  + (f" library_ms={r['library_ms']:.4f}" if "library_ms" in r else "")
                  + (f" gf_ms={r['gf_ms']:.4f} gf_bound_ms={r['gf_bound_ms']:.4f}"
                     f" gf_library_ms={r['gf_library_ms']:.4f}" if "gf_ms" in r else ""),
                  flush=True)
        res[name] = {"main": per[0], "shapes": per}
    # the three loss patterns at the degraded GETs' batch: byte-exact, not
    # timed
    extra = [("fused_decode_hash", shape_name(key), check_k1(torch, mods, *k1.pop(), False))
             for key in loss]

    # one chain alone: the per-chain floor that no batch can beat
    r = check_k2(torch, mods, g, 1, 131072, timed=True)
    r.update(shape="single chain: rows=1 n=131072", launches=None)
    res["hh_chain"]["shapes"].append(r)
    print(f"hh_chain {r['shape']}: err={r['max_abs_err']} ms={r['ms']:.4f} "
          f"plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f}", flush=True)
    # the alignment pair, whatever shapes the batching gave this run:
    # 16-byte aligned rows (cauchy 8+8 sub-chunks) and rows at odd
    # addresses (cauchy 12+4), 8,192 of each; and aligned rows of the odd
    # rows' whole-packet length, which tells length from alignment
    for n in (65536, -(-MIB // 12) // 2, (-(-MIB // 12) // 2) & ~31):
        r = check_k2(torch, mods, g, 8192, n, timed=True)
        r.update(shape=f"alignment pair: rows=8192 n={n}", launches=None)
        res["hh_chain"]["shapes"].append(r)
        print(f"hh_chain {r['shape']}: err={r['max_abs_err']} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f}", flush=True)

    # the EC:4 route's 16 shards of a 1 MiB block (12+4, n = 87,382): back
    # to back, as the cat laid them (generic read path), and at the shard
    # slab's 32-byte pitch (aligned path)
    n = -(-MIB // 12)
    for pitch in (n, mods["bt"].pitch(n)):
        r = check_k2(torch, mods, g, 16, n, timed=True, pitch=pitch)
        r.update(shape=f"slab pair: rows=16 pitch={pitch} n={n}", launches=None)
        res["hh_chain"]["shapes"].append(r)
        print(f"hh_chain {r['shape']}: err={r['max_abs_err']} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f}", flush=True)

    # K3's alignment pair: the 8x24 composite at B=256 on the main path's
    # rows at odd addresses (h = 43,691) and on 16-byte aligned rows of
    # nearly the same length (h = 43,696)
    for h in K3_PAIR:
        r = check_k3(torch, mods, g, (256, 24, 8, h, 2), timed=True)
        r.update(shape=f"alignment pair: {shape_name((256, 24, 8, h, 2))}", launches=None)
        res["gf_apply"]["shapes"].append(r)
        print(f"gf_apply {r['shape']}: err={r['max_abs_err']} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f}", flush=True)

    # K2 at odd lengths (rows starting at every alignment, the last
    # ending at its buffer's last byte): byte-exact, not timed
    for nn in (0, 1, 31, 32, 33, 34, 38, 65, 95):
        extra.append(("hh_chain", f"rows=1000 n={nn}", check_k2(torch, mods, g, 1000, nn, False)))
    for nn in (31, 32, 33, 65536, 87382):
        extra.append(("hh_chain", f"rows=4 n={nn} offsets 0-15",
                      check_k2_offsets(torch, mods, g, nn)))
    for nn in (1, 15, 17, 511, 43691, 65536):
        for k, r in ((5, 1), (5, 2), (5, 3), (24, 8), (7, 17)):
            extra.append(("gf_apply", f"binary {8 * r}x{8 * k} B=3 n={nn} offsets 0-15",
                          check_k3_binary(torch, mods, g, k, r, nn)))
    for name, shape, r in extra:
        res[name]["shapes"].append(dict(r, shape=shape, launches=None))
        print(f"{name} {shape}: err={r['max_abs_err']}", flush=True)
    for name, v in res.items():
        err = max(r["max_abs_err"] for r in v["shapes"])
        v["max_abs_err"] = err
        if err != 0:
            fail(f"{name}: kernel and plain version disagree (max_abs_err={err})")
    return res


def _zero_counts(mods) -> None:
    fc, bc, k3 = mods["fc"], mods["bc"], mods["k3"]
    fc.encode_launches = fc.decode_launches = bc.launches = k3.launches = 0
    for c in (fc.launch_shapes, bc.launch_shapes, k3.launch_shapes):
        c.clear()


def _counts(mods) -> tuple[dict, dict]:
    fc, bc, k3 = mods["fc"], mods["bc"], mods["k3"]
    launches = {"fused_encode_hash": fc.encode_launches, "fused_decode_hash": fc.decode_launches,
                "hh_chain": bc.launches, "gf_apply": k3.launches}
    shapes = {
        "fused_encode_hash": {k: v for k, v in fc.launch_shapes.items() if k[0] == "encode"},
        "fused_decode_hash": {k: v for k, v in fc.launch_shapes.items() if k[0] == "decode"},
        "hh_chain": dict(bc.launch_shapes), "gf_apply": dict(k3.launch_shapes),
    }
    return launches, shapes


def object_phase(torch, mods, root: str) -> dict:
    import numpy as np

    from minio_tpu_torch.erasure.set import ErasureSet
    from minio_tpu_torch.parallel import dispatcher
    from minio_tpu_torch.storage.xlstorage import XLStorage

    fc, bc, bt = mods["fc"], mods["bc"], mods["bt"]
    drives = [os.path.join(root, f"d{i}") for i in range(16)]
    es = ErasureSet([XLStorage(p) for p in drives], default_parity=8)
    es.make_bucket("smoke")
    rng = np.random.default_rng(SEED)
    t: dict = {}

    def get_md5(key):
        _, it = es.get_object("smoke", key)
        h = hashlib.md5()
        for c in it:
            h.update(c)
        return h.hexdigest()

    objs88 = {f"ec88-{i}": rng.integers(0, 256, 64 * MIB, dtype=np.uint8).tobytes()
              for i in range(8)}
    objs124 = {f"ec124-{i}": rng.integers(0, 256, 64 * MIB, dtype=np.uint8).tobytes()
               for i in range(4)}
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**objs88, **objs124}.items()}

    _zero_counts(mods)  # counts zeroed just before the main path runs
    for k in bt.decode_stats:
        bt.decode_stats[k] = 0
    t0 = time.perf_counter()
    run_all(lambda k: es.put_object("smoke", k, objs88[k]), list(objs88))
    t["put_8+8_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in objs88:
        if get_md5(k) != md5[k]:
            fail(f"GET {k}: md5 mismatch")
    t["get_8+8_s"] = time.perf_counter() - t0
    enc_after_put = fc.encode_launches
    # one PUT alone: the launches a single 64 MiB object costs
    before = fc.encode_launches
    es.put_object("smoke", "ec88-lone", objs88["ec88-0"])
    lone = {"8+8 K1 encode": fc.encode_launches - before}
    if get_md5("ec88-lone") != md5["ec88-0"]:
        fail("GET ec88-lone: md5 mismatch")

    for i in range(8):
        for k in objs88:
            shutil.rmtree(os.path.join(drives[i], "smoke", k), ignore_errors=True)
    t0 = time.perf_counter()
    for k in objs88:
        _, it = es.get_object("smoke", k)
        if b"".join(it) != objs88[k]:
            fail(f"degraded GET {k}: bytes differ")
    t["degraded_get_8+8_s"] = time.perf_counter() - t0
    if fc.decode_launches == 0:
        fail("degraded GETs launched no fused decode kernel")

    os.environ["MINIO_TPU_DEVICE_HEAL"] = "1"
    t0 = time.perf_counter()
    dec_before = fc.decode_launches
    healed = es.heal_object("smoke", "ec88-0")
    t["heal_8+8_s"] = time.perf_counter() - t0
    if len(healed["healed"]) != 8 or fc.decode_launches == dec_before:
        fail(f"device heal did not rebuild 8 drives through K1: {healed}")
    # only the healed shards plus 0 of the others: drop the untouched half
    for i in range(8, 16):
        shutil.rmtree(os.path.join(drives[i], "smoke", "ec88-0"), ignore_errors=True)
    if get_md5("ec88-0") != md5["ec88-0"]:
        fail("healed object does not read back from its healed shards")

    before = bc.launches
    es.put_object("smoke", "ec124-lone", objs124["ec124-0"], parity=4)
    lone["12+4 K2"] = bc.launches - before
    if get_md5("ec124-lone") != md5["ec124-0"]:
        fail("GET ec124-lone: md5 mismatch")
    t0 = time.perf_counter()
    run_all(lambda k: es.put_object("smoke", k, objs124[k], parity=4), list(objs124))
    t["put_12+4_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in objs124:
        if get_md5(k) != md5[k]:
            fail(f"GET {k}: md5 mismatch")
    t["get_12+4_s"] = time.perf_counter() - t0
    launches, shapes = _counts(mods)
    if enc_after_put == 0 or bc.launches == 0:
        fail(f"main path missed a kernel: {launches}")

    stats = {f"{k[0]}+{k[1]}": d.stats_snapshot() for k, d in dispatcher._dispatchers.items()}
    s88 = stats.get("8+8")
    if s88 is None or s88["fused"] < s88["dispatches"] or s88["dispatches"] == 0:
        fail(f"8+8 dispatches not all fused: {s88}")
    for shape, st in stats.items():
        for key in ("fused_failures", "device_faults", "numpy_blocks"):
            if st[key]:
                fail(f"dispatcher {shape}: {key}={st[key]}")
    if bt.decode_stats["failures"]:
        fail(f"decode failures: {bt.decode_stats}")
    return {"launches": launches, "shapes": shapes, "lone_put_launches": lone, "stats": stats,
            "decode_stats": dict(bt.decode_stats), "seconds": t,
            "total_bytes": 64 * MIB * (len(objs88) + len(objs124) + 2)}


def run_all(fn, items) -> None:
    """fn(item) for every item on its own thread; re-raises the first error."""
    errs = []

    def one(it):
        try:
            fn(it)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    th = [threading.Thread(target=one, args=(it,)) for it in items]
    for x in th:
        x.start()
    for x in th:
        x.join()
    if errs:
        raise errs[0]


def cauchy_phase(torch, mods, root: str) -> dict:
    """The cauchy storage class through ServerPools -> ErasureSets ->
    ErasureSet on 32 drive directories (2 sets of 16), with multipart,
    degraded GET and partial-repair heal (module docstring, phase 3)."""
    import numpy as np

    from minio_tpu_torch.erasure import coder
    from minio_tpu_torch.erasure.multipart import MultipartRouter
    from minio_tpu_torch.erasure.pools import ServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.parallel import dispatcher
    from minio_tpu_torch.storage.xlstorage import XLStorage

    k3, bc = mods["k3"], mods["bc"]
    bucket = "cauchy"
    os.environ["MINIO_TPU_EC_FAMILY"] = "cauchy"  # the storage class of every write below
    drives = [[os.path.join(root, f"s{s}d{i}") for i in range(16)] for s in range(2)]
    sp = ServerPools([ErasureSets([[XLStorage(p) for p in row] for row in drives],
                                  deployment_id=DEPLOYMENT_ID, default_parity=8)])
    sp.make_bucket(bucket)
    rng = np.random.default_rng(SEED + 1)
    objs88 = {f"c88-{i}": rng.integers(0, 256, 64 * MIB, dtype=np.uint8).tobytes()
              for i in range(8)}
    objs124 = {f"c124-{i}": rng.integers(0, 256, 64 * MIB, dtype=np.uint8).tobytes()
               for i in range(4)}
    parts = [rng.integers(0, 256, 16 * MIB, dtype=np.uint8).tobytes() for _ in range(4)]
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**objs88, **objs124}.items()}
    md5["c88-mp"] = hashlib.md5(b"".join(parts)).hexdigest()
    t: dict = {}

    def get_md5(key):
        _, it = sp.get_object(bucket, key)
        h = hashlib.md5()
        for c in it:
            h.update(c)
        return h.hexdigest()

    def set_drives(key):
        pool = sp.pools[0]
        return drives[pool.sets.index(pool.get_hashed_set(key))]

    def part_file(drive, key) -> bytes:
        for dp, _, fs in os.walk(os.path.join(drive, bucket, key)):
            if "part.1" in fs:
                with open(os.path.join(dp, "part.1"), "rb") as fh:
                    return fh.read()
        return b""

    fam0 = coder.family_stats_snapshot()["cauchy"]
    disp0 = {k: d.stats_snapshot() for k, d in dispatcher._dispatchers.items()}
    _zero_counts(mods)  # counts zeroed just before this path runs
    t0 = time.perf_counter()
    run_all(lambda k: sp.put_object(bucket, k, objs88[k]), list(objs88))
    t["put_8+8_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in objs88:
        if get_md5(k) != md5[k]:
            fail(f"cauchy GET {k}: md5 mismatch")
    t["get_8+8_s"] = time.perf_counter() - t0
    before = (k3.launches, bc.launches)
    sp.put_object(bucket, "c88-lone", objs88["c88-0"])
    lone = {"8+8 cauchy K3": k3.launches - before[0], "8+8 cauchy K2": bc.launches - before[1]}
    if get_md5("c88-lone") != md5["c88-0"]:
        fail("cauchy GET c88-lone: md5 mismatch")

    # multipart: 4 parts of 16 MiB uploaded concurrently, then completed
    router = MultipartRouter(sp)
    uid = router.new_upload(bucket, "c88-mp")
    etags: list = [None] * len(parts)
    t0 = time.perf_counter()
    run_all(lambda i: etags.__setitem__(i, (i + 1, router.put_part(bucket, "c88-mp", uid, i + 1,
                                                                   parts[i]))),
            range(len(parts)))
    oi = router.complete(bucket, "c88-mp", uid, etags)
    t["multipart_4x16MiB_s"] = time.perf_counter() - t0
    want = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in parts)).hexdigest() + "-4"
    if oi.etag != want or sp.get_object_info(bucket, "c88-mp").etag != want:
        fail(f"multipart ETag {oi.etag} != {want}")
    if get_md5("c88-mp") != md5["c88-mp"]:
        fail("cauchy GET c88-mp: md5 mismatch")

    # degraded GET: 8 of the 16 drives lose the object (host decode)
    ds = set_drives("c88-2")
    for d in ds[:8]:
        shutil.rmtree(os.path.join(d, bucket, "c88-2"), ignore_errors=True)
    t0 = time.perf_counter()
    _, it = sp.get_object(bucket, "c88-2")
    if b"".join(it) != objs88["c88-2"]:
        fail("cauchy degraded GET c88-2: bytes differ")
    t["degraded_get_8+8_s"] = time.perf_counter() - t0

    # partial repair: the drive holding data shard 0 of another object
    ds = set_drives("c88-3")
    dist = XLStorage(ds[0]).read_version(bucket, "c88-3", "").erasure.distribution
    lost = ds[dist.index(1)]
    original = part_file(lost, "c88-3")
    shutil.rmtree(os.path.join(lost, bucket, "c88-3"))
    f0 = coder.family_stats_snapshot()["cauchy"]
    t0 = time.perf_counter()
    healed = sp.heal_object(bucket, "c88-3")
    t["heal_1_shard_8+8_s"] = time.perf_counter() - t0
    f1 = coder.family_stats_snapshot()["cauchy"]
    repair = {k: f1[k] - f0[k] for k in ("repair_partial_blocks", "heal_ingress_bytes")}
    repair["full_read_bytes"] = 8 * len(original)
    if len(healed["healed"]) != 1 or part_file(lost, "c88-3") != original:
        fail(f"cauchy heal did not rebuild the lost shard file: {healed}")
    if repair["repair_partial_blocks"] <= 0 or not \
            0 < repair["heal_ingress_bytes"] < repair["full_read_bytes"]:
        fail(f"cauchy heal did not take the partial repair: {repair}")
    if get_md5("c88-3") != md5["c88-3"]:
        fail("cauchy GET c88-3 after heal: md5 mismatch")

    t0 = time.perf_counter()
    run_all(lambda k: sp.put_object(bucket, k, objs124[k], parity=4), list(objs124))
    t["put_12+4_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in objs124:
        if get_md5(k) != md5[k]:
            fail(f"cauchy GET {k}: md5 mismatch")
    t["get_12+4_s"] = time.perf_counter() - t0
    launches, shapes = _counts(mods)  # counts read just after
    geoms = {(key[1], key[2]) for key in shapes["gf_apply"]}
    if not {(16, 16), (24, 8)} <= geoms or bc.launches == 0:
        fail(f"cauchy path missed a kernel or a geometry: {launches} {shapes['gf_apply']}")

    fam = {k: v - fam0[k] for k, v in coder.family_stats_snapshot()["cauchy"].items()}
    stats = {}
    for key, d in dispatcher._dispatchers.items():
        st, st0 = d.stats_snapshot(), disp0.get(key)
        for f in ("fused_failures", "device_faults", "numpy_blocks"):
            if st[f]:
                fail(f"dispatcher {key[0]}+{key[1]}: {f}={st[f]}")
        stats[f"{key[0]}+{key[1]}"] = {
            f: st[f] - (st0[f] if st0 else 0)
            for f in ("dispatches", "blocks", "fused", "device_s", "host_s", "queue_wait_s",
                      "pad_blocks")}
    served = sum(v["blocks"] for v in stats.values())
    if fam["encode_blocks"] != served or served == 0:
        fail(f"cauchy encode_blocks {fam['encode_blocks']} != blocks served on the device {served}")
    return {"launches": launches, "shapes": shapes, "lone_put_launches": lone,
            "stats": stats, "family_stats": fam, "repair": repair, "seconds": t,
            "total_bytes": 64 * MIB * (len(objs88) + len(objs124) + 2)}


# the durability phase's deployment (MinIO's operator procedures "Expand a
# MinIO Deployment", "Decommission a Server Pool", "Recover after Drive
# Failure"): 64 MiB objects written to the first pool, 4 more PUT while it
# drains, and small objects on the inline path (1 KiB to 128 KiB)
DUR_RS, DUR_CAUCHY, DUR_FG, DUR_SMALL = 8, 4, 4, 16
BLOCK = 1 << 20  # the erasure layer's stripe block (MinIO's blockSizeV2)


def _user_files(drive: str, buckets) -> dict:
    """relative path -> bytes of every file under the user buckets of one
    drive directory (``part.N`` shard files and ``xl.meta``)."""
    out = {}
    for b in buckets:
        for dp, _, fs in os.walk(os.path.join(drive, b)):
            for f in fs:
                p = os.path.join(dp, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, drive)] = fh.read()
    return out


def durability_phase(torch, mods, root: str) -> dict:
    """The durability plane on the card (module docstring, phase 4):
    expand + decommission on the dispatcher's background lane, a replaced
    drive refilled through the device heal and the native plane, the MRF
    heal after a degraded read, and a deep-verify scan."""
    import numpy as np

    from minio_tpu_torch.erasure.background import BackgroundOps
    from minio_tpu_torch.erasure.decommission import PoolManager
    from minio_tpu_torch.erasure.pools import ServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.parallel import dispatcher
    from minio_tpu_torch.placement.topology import expand_pool, remove_pool
    from minio_tpu_torch.storage.format_erasure import init_or_load_formats
    from minio_tpu_torch.storage.xlstorage import XLStorage

    fc = mods["fc"]
    t_phase = time.perf_counter()
    big, small = "durable", "inline"
    old = [os.path.join(root, f"p0d{i}") for i in range(16)]
    new = [os.path.join(root, f"p1d{i}") for i in range(16)]
    sp = ServerPools([ErasureSets([[XLStorage(p) for p in old]], deployment_id=DEPLOYMENT_ID,
                                  default_parity=8)])
    for b in (big, small):
        sp.make_bucket(b)
    rng = np.random.default_rng(SEED + 4)
    rs_keys = [f"rs-{i}" for i in range(DUR_RS)]
    ca_keys = [f"cauchy-{i}" for i in range(DUR_CAUCHY)]
    fg_keys = [f"fg-{i}" for i in range(DUR_FG)]
    bodies = {k: rng.bytes(64 * MIB) for k in rs_keys + ca_keys + fg_keys}
    sizes = [1024 * (1 + 127 * i // (DUR_SMALL - 1)) for i in range(DUR_SMALL)]
    smalls = {f"s-{i}": rng.bytes(n) for i, n in enumerate(sizes)}
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**bodies, **smalls}.items()}
    t: dict = {}

    def get_md5(store, bucket, key):
        _, it = store.get_object(bucket, key)
        h = hashlib.md5()
        for c in it:
            h.update(c)
        return h.hexdigest()

    # 1. one pool, both families (switched per batch of writes) and the
    # inline path
    for fam, keys in (("reedsolomon", rs_keys), ("cauchy", ca_keys)):
        os.environ["MINIO_TPU_EC_FAMILY"] = fam
        run_all(lambda k: sp.put_object(big, k, bodies[k]), keys)
    os.environ["MINIO_TPU_EC_FAMILY"] = "reedsolomon"
    for k, v in smalls.items():
        sp.put_object(small, k, v)
    algos = {k: XLStorage(old[0]).read_version(big, k, "").erasure.algorithm
             for k in rs_keys + ca_keys}
    if sorted(set(algos.values())) != ["cauchy", "reedsolomon"]:
        fail(f"the first pool does not hold both families: {algos}")
    in_pool0 = len(rs_keys) + len(ca_keys) + len(smalls)

    # 2. attach a second pool of 16 drives at EC 8+8 (expand_pool takes
    # the set width's default parity, 4 for 16 drives), then drain the
    # first one on the background lane while 4 cauchy PUTs arrive in the
    # foreground. Re-PUTs take the deployment's write family
    # (MINIO_TPU_EC_FAMILY, reedsolomon here), as in the reference.
    expand_pool(sp, os.path.join(root, "p1d{0...15}"))
    for s in sp.pools[1].sets:
        s.default_parity = 8
    disp0 = {k: d.stats_snapshot() for k, d in dispatcher._dispatchers.items()}
    _zero_counts(mods)  # counts zeroed just before this path runs
    pm = PoolManager(sp)
    t0 = time.perf_counter()
    st = pm.start_decommission(0)
    run_all(lambda k: sp.put_object(big, k, bodies[k], family="cauchy"), fg_keys)
    t["foreground_put_4x64MiB_during_drain_s"] = time.perf_counter() - t0
    deadline = time.monotonic() + 900
    while st.state == "draining" and time.monotonic() < deadline:
        time.sleep(0.02)
    t["drain_s"] = time.perf_counter() - t0
    drain_launches, _ = _counts(mods)
    if st.state != "complete" or st.failed or st.objects_moved != in_pool0:
        left = [(b.name, raw) for b in sp.pools[0].list_buckets()
                for raw in sp.pools[0].walk_objects(b.name)]
        why = ""
        if left:
            try:  # the first failing object, moved again so its error shows
                PoolManager._move_object(sp.pools[0], sp.pools[1], *left[0])
            except Exception as e:  # noqa: BLE001 — reported below
                why = f"{type(e).__name__}: {e}"
        fail(f"decommission ended {st.state!r}, failed={st.failed}, moved {st.objects_moved} of "
             f"{in_pool0}, error={st.error!r}; first failing object {left[:1]} {why}")
    for name in ("fused_encode_hash", "gf_apply", "hh_chain"):
        if not drain_launches[name]:
            fail(f"no {name} launch during the drain: {drain_launches}")
    lanes = {}
    for key, d in dispatcher._dispatchers.items():
        s1, s0 = d.stats_snapshot(), disp0.get(key)
        for f in ("fused_failures", "device_faults", "numpy_blocks"):
            if s1[f]:
                fail(f"dispatcher {key[0]}+{key[1]}: {f}={s1[f]}")
        lanes[f"{key[0]}+{key[1]}"] = dict(
            {f: s1[f] - (s0[f] if s0 else 0) for f in ("dispatches", "blocks", "fg_blocks",
                                                      "bg_blocks", "bg_forced")},
            bg_batch_max=s1["bg_batch_max"], fg_deferred_behind_bg=s1["fg_deferred_behind_bg"])
    moved_blocks = (len(rs_keys) + len(ca_keys)) * (64 * MIB // BLOCK)
    l88 = lanes.get("8+8", {})
    if l88.get("bg_blocks", 0) < moved_blocks or any(
            v["fg_deferred_behind_bg"] for v in lanes.values()):
        fail(f"background lane: bg_blocks {l88.get('bg_blocks')} < {moved_blocks} or a "
             f"foreground block waited behind background ones: {lanes}")
    for b in (big, small):
        for d in old:
            if os.listdir(os.path.join(d, b)):
                fail(f"{d}/{b} still holds {os.listdir(os.path.join(d, b))[:3]} after the drain")
    # the first pool anchors .minio.sys and cannot be detached online, in
    # the reference as here; the documented procedure's last step is a
    # restart without the drained pool
    try:
        remove_pool(sp, 0)
    except ValueError:
        pass
    else:
        fail("remove_pool detached pool 0, which anchors the system namespace")
    disks = [XLStorage(p) for p in new]
    dep, grouped = init_or_load_formats(disks, 16, allow_mint=False)
    sp = ServerPools([ErasureSets(grouped, dep, default_parity=8)])
    for d in old:
        shutil.rmtree(d)
    t0 = time.perf_counter()
    for k in bodies:
        if get_md5(sp, big, k) != md5[k]:
            fail(f"GET {k} after the drain: md5 mismatch")
    for k in smalls:
        if get_md5(sp, small, k) != md5[k]:
            fail(f"GET {k} after the drain: md5 mismatch")
    t["get_all_after_removal_s"] = time.perf_counter() - t0
    es = sp.pools[0].sets[0]

    # 3. a drive replaced (wiped: rm -rf of its root, then mkdir) and
    # refilled by the fresh-drive monitor, through the device heal (K1
    # decode for the RS objects) and through the native plane, in turns
    # (device, native, native, device) so that the two routes' times are
    # compared within one run; every refill byte-identical to the drive
    # as it was, xl.meta included
    victim = new[3]
    keep = _user_files(victim, (big, small))
    heal_s, heal_k1 = {"device": [], "native": []}, {"device": [], "native": []}
    for route in ("device", "native", "native", "device"):
        os.environ["MINIO_TPU_DEVICE_HEAL"] = "1" if route == "device" else "0"
        shutil.rmtree(victim)
        os.makedirs(victim)
        dec0 = fc.decode_launches
        bg = BackgroundOps(sp, scan_interval=0)
        t0 = time.perf_counter()
        healed = bg.check_fresh_disks()
        heal_s[route].append(time.perf_counter() - t0)
        heal_k1[route].append(fc.decode_launches - dec0)
        if healed != 1 or bg.stats.get("heals_failed", 0):
            fail(f"fresh-drive heal ({route}) returned {healed}: {bg.stats}")
        files = _user_files(victim, (big, small))
        if set(files) != set(keep):
            fail(f"fresh-drive heal ({route}) left other files than the drive held: "
                 f"{sorted(set(files) ^ set(keep))[:4]}")
        bad = [p for p, v in files.items() if keep[p] != v]
        if bad:
            fail(f"fresh-drive heal ({route}) wrote other bytes than the drive held: {bad[:4]}")
    if not all(heal_k1["device"]) or any(heal_k1["native"]):
        fail(f"K1 decode launches of the fresh-drive heals: {heal_k1}")

    # 4. MRF: a degraded read queues the object, a heal worker rebuilds it
    os.environ["MINIO_TPU_DEVICE_HEAL"] = "1"
    bg = BackgroundOps(sp, scan_interval=0)
    for p in sp.pools:
        for s in p.sets:
            s.on_degraded = bg.mrf.add
    bg.start(scanner=False)
    key = rs_keys[1]
    for d in new[:8]:
        shutil.rmtree(os.path.join(d, big, key))
    t0 = time.perf_counter()
    try:
        if get_md5(sp, big, key) != md5[key]:
            fail(f"degraded GET {key}: md5 mismatch")
        deadline = time.monotonic() + 120
        while bg.stats["heals_done"] < 1 and not bg.stats["heals_failed"] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        t["mrf_degraded_get_and_heal_s"] = time.perf_counter() - t0
    finally:
        bg.stop()
        for th in bg._threads:
            th.join(timeout=5)
    fi, metas, _, _ = es._quorum_fileinfo(big, key, "", read_data=True)
    back = len(es._shard_sources(fi, metas))
    if bg.stats["heals_done"] < 1 or bg.stats["heals_failed"] or back != 16:
        fail(f"MRF heal of {key}: {bg.stats}, {back} of 16 shards")
    if _user_files(victim, (big, small)) != keep:
        fail(f"the MRF heal of {key} wrote other bytes than the drive held")
    mrf = dict(bg.stats)

    # 5. deep scan: the first bytes of one parity shard's part.1 flipped
    key = rs_keys[2]
    dist = XLStorage(new[0]).read_version(big, key, "").erasure.distribution
    pdrive = new[dist.index(9)]  # erasure index 9: the first parity shard
    part = next(os.path.join(dp, "part.1") for dp, _, fs in os.walk(os.path.join(pdrive, big, key))
                if "part.1" in fs)
    with open(part, "rb") as fh:
        orig = fh.read()
    with open(part, "r+b") as fh:
        fh.write(bytes(b ^ 0xFF for b in orig[:64]))
    bg = BackgroundOps(sp, scan_interval=0, object_sleep=0, deep_verify=True)
    t0 = time.perf_counter()
    snap = bg.scan_once().snapshot()
    t["deep_scan_s"] = time.perf_counter() - t0
    with open(part, "rb") as fh:
        if fh.read() != orig:
            fail(f"deep scan did not heal the corrupted parity shard of {key}")
    want = {big: (len(bodies), 64 * MIB * len(bodies)), small: (len(smalls), sum(sizes))}
    got = {b: (u["objects"], u["size"]) for b, u in snap["bucketsUsage"].items()}
    if got != want or snap["objectsCount"] != len(bodies) + len(smalls):
        fail(f"scanner usage {got} != {want}")
    if bg.stats["heals_failed"]:
        fail(f"deep scan: {bg.stats}")

    launches, shapes = _counts(mods)  # counts read just after
    t["phase_s"] = time.perf_counter() - t_phase
    return {"launches": launches, "shapes": shapes, "drain_launches": drain_launches,
            "decommission": {k: v for k, v in st.to_persist().items()
                             if k not in ("started", "updated", "finished")},
            "lanes": lanes, "fresh_drive_heal_s": heal_s, "fresh_drive_heal_k1_decode": heal_k1,
            "mrf": mrf, "deep_scan": dict(bg.stats), "usage": {b: list(v) for b, v in got.items()},
            "seconds": t}


def serve_in_thread(srv) -> tuple[int, object]:
    """Serve ``srv`` (an S3Server) on 127.0.0.1 through the port's HTTP
    front (``web.serve_in_thread``). Returns (port, stop)."""
    from minio_tpu_torch.server import web

    port, web_stop = web.serve_in_thread(srv.app, read_bufsize=4 * MIB)

    def stop():
        srv.close()
        web_stop()

    return port, stop


# the S3 phase's deployment: MinIO's documented storage classes on one
# set of 16 drives, STANDARD at EC:8 (reedsolomon 8+8) and
# REDUCED_REDUNDANCY at EC:8 in the cauchy family
S3_ENV = {
    "MINIO_STORAGE_CLASS_STANDARD": "EC:8",
    "MINIO_STORAGE_CLASS_RRS": "EC:8",
    "MINIO_TPU_EC_FAMILY_RRS": "cauchy",
    "MINIO_TPU_CACHE": "0",
    "MINIO_TPU_SCAN_INTERVAL": "0",
}
S3_STD, S3_RRS, S3_PARTS = 8, 4, 4
TRANSITION_NOW = (
    "<LifecycleConfiguration><Rule><ID>to-warm</ID><Status>Enabled</Status>"
    "<Filter><Prefix>cold/</Prefix></Filter>"
    "<Transition><Days>0</Days><StorageClass>WARM</StorageClass></Transition>"
    "</Rule></LifecycleConfiguration>"
)


def _prom_value(text: str, series: str) -> float:
    """The value of one series (name and labels as exposed) in a scrape."""
    for ln in text.splitlines():
        name, _, value = ln.rpartition(" ")
        if name == series:
            return float(value)
    fail(f"metrics scrape has no series {series}")


def s3_phase(torch, mods, root: str) -> dict:
    """The S3 front on the card (module docstring, phase 5): signed S3
    requests over a socket into the port's S3Server (``make_server`` on
    the stdlib HTTP front), its object layer and the dispatcher."""
    import numpy as np

    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.ilm.tier import Tier
    from minio_tpu_torch.parallel import dispatcher
    from minio_tpu_torch.server import app as appmod
    from minio_tpu_torch.storage.xlstorage import XLStorage

    fc = mods["fc"]
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in S3_ENV}
    os.environ.update(S3_ENV)
    stops = []
    try:
        drives = [os.path.join(root, f"d{i}") for i in range(16)]
        warm_drives = [os.path.join(root, f"w{i}") for i in range(16)]
        srv = appmod.make_server(drives)
        port, stop = serve_in_thread(srv)
        stops.append(stop)
        cli = S3Client(f"127.0.0.1:{port}")
        bucket, cold = "s3smoke", "s3cold"
        for b in (bucket, cold):
            r = cli.make_bucket(b)
            if r.status != 200:
                fail(f"make_bucket {b}: {r.status} {r.body[:200]!r}")
        rng = np.random.default_rng(SEED + 5)
        std = {f"std-{i}": rng.bytes(64 * MIB) for i in range(S3_STD)}
        rrs = {f"rrs-{i}": rng.bytes(64 * MIB) for i in range(S3_RRS)}
        parts = [rng.bytes(16 * MIB) for _ in range(S3_PARTS)]
        cold_body = rng.bytes(64 * MIB)
        md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**std, **rrs}.items()}
        t: dict = {}
        moved = {"put": 0, "get": 0}

        def put(key, body, cls, unsigned):
            r = cli.request("PUT", f"/{bucket}/{key}", body=body, unsigned_payload=unsigned,
                            headers={"x-amz-storage-class": cls}, timeout=600)
            if r.status != 200 or r.headers.get("etag", "").strip('"') != md5[key]:
                fail(f"PUT {key} ({cls}): {r.status} etag {r.headers.get('etag')} "
                     f"!= {md5[key]} {r.body[:200]!r}")
            moved["put"] += len(body)

        def get_check(key, want_md5, b=bucket):
            r = cli.request("GET", f"/{b}/{key}", timeout=600)
            if r.status != 200 or hashlib.md5(r.body).hexdigest() != want_md5:
                fail(f"GET {b}/{key}: {r.status}, md5 mismatch")
            moved["get"] += len(r.body)

        def layout(key, b=bucket):
            e = XLStorage(drives[0]).read_version(b, key, "").erasure
            return e.algorithm, e.data_blocks, e.parity_blocks, e.distribution

        disp0 = {k: d.stats_snapshot() for k, d in dispatcher._dispatchers.items()}
        _zero_counts(mods)  # counts zeroed just before this path runs

        # 1. STANDARD (reedsolomon 8+8, K1 encode): 8 concurrent PUTs that
        # stream their bodies (UNSIGNED-PAYLOAD), then a GET of each
        t0 = time.perf_counter()
        run_all(lambda k: put(k, std[k], "STANDARD", True), list(std))
        t["put_standard_8x64MiB_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_all(lambda k: get_check(k, md5[k]), list(std))
        t["get_standard_8x64MiB_s"] = time.perf_counter() - t0
        if srv.streaming_puts < S3_STD:
            fail(f"{srv.streaming_puts} of {S3_STD} STANDARD PUTs streamed their bodies")
        if layout("std-0")[:3] != ("reedsolomon", 8, 8):
            fail(f"STANDARD object layout {layout('std-0')[:3]}, want reedsolomon 8+8")

        # 2. REDUCED_REDUNDANCY (cauchy 8+8, K3 + K2): 4 concurrent PUTs
        # with signed payloads (the buffered path), then a GET of each
        t0 = time.perf_counter()
        run_all(lambda k: put(k, rrs[k], "REDUCED_REDUNDANCY", False), list(rrs))
        t["put_rrs_4x64MiB_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_all(lambda k: get_check(k, md5[k]), list(rrs))
        t["get_rrs_4x64MiB_s"] = time.perf_counter() - t0
        if layout("rrs-0")[:3] != ("cauchy", 8, 8):
            fail(f"REDUCED_REDUNDANCY object layout {layout('rrs-0')[:3]}, want cauchy 8+8")

        # 3. multipart: 4 parts of 16 MiB uploaded concurrently, completed
        t0 = time.perf_counter()
        r = cli.request("POST", f"/{bucket}/mp", query={"uploads": ""})
        uid = r.body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
        etags: list = [None] * S3_PARTS

        def put_part(i):
            r = cli.request("PUT", f"/{bucket}/mp", body=parts[i], timeout=600,
                            query={"partNumber": str(i + 1), "uploadId": uid})
            if r.status != 200:
                fail(f"upload part {i + 1}: {r.status} {r.body[:200]!r}")
            etags[i] = r.headers["etag"]
            moved["put"] += len(parts[i])

        run_all(put_part, range(S3_PARTS))
        xml = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags)) + "</CompleteMultipartUpload>"
        r = cli.request("POST", f"/{bucket}/mp", query={"uploadId": uid}, body=xml.encode(),
                        timeout=600)
        t["multipart_4x16MiB_s"] = time.perf_counter() - t0
        want = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in parts)).hexdigest()
        got = next((el.text.strip('"') for el in r.xml().iter() if el.tag.endswith("ETag")),
                   None) if r.status == 200 else None
        if got != f"{want}-{S3_PARTS}":
            fail(f"multipart complete: {r.status} ETag {got!r} != {want}-{S3_PARTS}")
        get_check("mp", hashlib.md5(b"".join(parts)).hexdigest())

        # 4. a ranged GET across stripe blocks
        lo, hi = 1_000_003, 1_000_003 + 33 * MIB - 1
        t0 = time.perf_counter()
        r = cli.request("GET", f"/{bucket}/std-1", headers={"Range": f"bytes={lo}-{hi}"})
        t["ranged_get_33MiB_s"] = time.perf_counter() - t0
        if r.status != 206 or r.body != std["std-1"][lo:hi + 1] or \
                r.headers.get("content-range") != f"bytes {lo}-{hi}/{64 * MIB}":
            fail(f"ranged GET: {r.status} {r.headers.get('content-range')}")
        moved["get"] += len(r.body)

        # 5. degraded GET: the 8 drives holding std-2's data shards lose
        # its object directory; the server rebuilds through K1 decode
        dist = layout("std-2")[3]
        for i, d in enumerate(drives):
            if dist[i] <= 8:
                shutil.rmtree(os.path.join(d, bucket, "std-2"))
        dec0 = fc.decode_launches
        t0 = time.perf_counter()
        get_check("std-2", md5["std-2"])
        t["degraded_get_64MiB_s"] = time.perf_counter() - t0
        if fc.decode_launches == dec0:
            fail("the degraded GET through the server launched no K1 decode")

        # 6. ILM transition to a second port server acting as the warm
        # tier (configured in-process), then a read-through GET
        warm = appmod.make_server(warm_drives)
        wport, wstop = serve_in_thread(warm)
        stops.append(wstop)
        wcli = S3Client(f"127.0.0.1:{wport}")
        if wcli.make_bucket("tier-data").status != 200:
            fail("warm tier: make_bucket tier-data")
        srv.tiers.set(Tier(name="WARM", endpoint=f"http://127.0.0.1:{wport}",
                           access_key="minioadmin", secret_key="minioadmin",
                           bucket="tier-data", prefix="smoke/"))
        r = cli.request("PUT", f"/{cold}", query={"lifecycle": ""}, body=TRANSITION_NOW.encode())
        if r.status != 200:
            fail(f"PUT lifecycle: {r.status} {r.body[:200]!r}")
        md5["cold/obj"] = hashlib.md5(cold_body).hexdigest()
        r = cli.request("PUT", f"/{cold}/cold/obj", body=cold_body, timeout=600)
        if r.status != 200:
            fail(f"PUT cold/obj: {r.status}")
        moved["put"] += len(cold_body)
        t0 = time.perf_counter()
        srv.background.scan_once()
        t["transition_64MiB_s"] = time.perf_counter() - t0
        if srv.background.stats.get("ilm_transitioned", 0) < 1:
            fail(f"no object transitioned to the warm tier: {srv.background.stats}")
        left = [f for d in drives for _, _, fs in os.walk(os.path.join(d, cold)) for f in fs
                if f.startswith("part.")]
        if left:
            fail(f"the transitioned object kept {len(left)} local shard files")
        listed = wcli.list_objects_v2("tier-data", prefix="smoke/")
        if b"<Key>smoke/" not in listed.body:
            fail("the warm tier holds no transitioned object")
        t0 = time.perf_counter()
        get_check("cold/obj", md5["cold/obj"], b=cold)
        t["get_from_warm_tier_64MiB_s"] = time.perf_counter() - t0

        # 7. the metrics plane: the dispatcher's series as scraped equal
        # its own aggregate
        r2 = cli.request("GET", "/minio/v2/metrics/node")
        r3 = cli.request("GET", "/minio/metrics/v3/api/tpu")
        agg = dispatcher.aggregate_stats()
        if r2.status != 200 or r3.status != 200:
            fail(f"metrics scrape: v2 node {r2.status}, v3 api/tpu {r3.status}")
        text = r3.body.decode()
        scraped = {"minio_tpu_dispatch_total": _prom_value(text, "minio_tpu_dispatch_total"),
                   "minio_tpu_dispatch_blocks_total{class=\"foreground\"}": _prom_value(
                       text, "minio_tpu_dispatch_blocks_total{class=\"foreground\"}"),
                   "minio_s3_requests_total series": r2.body.count(b"minio_s3_requests_total{")}
        if scraped["minio_tpu_dispatch_total"] != agg["dispatches"] or \
                scraped["minio_tpu_dispatch_blocks_total{class=\"foreground\"}"] != agg["fg_blocks"]:
            fail(f"scraped dispatcher series {scraped} != aggregate_stats "
                 f"dispatches={agg['dispatches']} fg_blocks={agg['fg_blocks']}")
        launches, shapes = _counts(mods)  # counts read just after
        t["phase_s"] = time.perf_counter() - t_phase

        for name in ("fused_encode_hash", "fused_decode_hash", "gf_apply", "hh_chain"):
            if not launches[name]:
                fail(f"the S3 phase launched no {name}: {launches}")
        stats = {}
        for key, d in dispatcher._dispatchers.items():
            s1, s0 = d.stats_snapshot(), disp0.get(key)
            for f in ("fused_failures", "device_faults", "numpy_blocks"):
                if s1[f] - (s0[f] if s0 else 0):
                    fail(f"dispatcher {key[0]}+{key[1]}: {f} moved in the S3 phase")
            stats[f"{key[0]}+{key[1]}"] = {
                f: s1[f] - (s0[f] if s0 else 0)
                for f in ("dispatches", "blocks", "fg_blocks", "bg_blocks", "fused", "device_s",
                          "host_s", "queue_wait_s", "pad_blocks")}
        return {"launches": launches, "shapes": shapes, "seconds": t, "bytes": moved,
                "stats": stats, "scraped": scraped, "streaming_puts": srv.streaming_puts,
                "transitioned": srv.background.stats.get("ilm_transitioned", 0)}
    finally:
        for stop in reversed(stops):
            stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the cluster phase's deployment: MinIO's "Deploy MinIO: Multi-Node
# Multi-Drive" (`minio server http://minio{1...4}.example.net:9000/mnt/
# disk{1...4}/minio`) on one host: 4 nodes of 4 drives, one erasure set of
# 16, each node a `python -m minio_tpu_torch.server` process on a port of
# its own; the storage classes of phase 5, and heals through the device.
# Beside it a single node of 16 drives runs as a pool of 2 workers
# (MINIO_TPU_WORKERS=2): the reference refuses a pool in a distributed
# deployment, as the port does
CLUSTER_ENV = {**S3_ENV, "MINIO_TPU_DEVICE_HEAL": "1"}
NODES, NODE_DRIVES = 4, 4
NODE_START_S = 300  # bootstrap retries once a second, 180 times
NODE_STOP_S = 30
# 64 MiB objects, 4 clients of 2 each a node: at 8 each (2 GiB a node,
# all 4 nodes at once) the peers' rows outlast the coordinator's fan-out
# timeout, the reference's 120 s (diag.fanout_collect)
SPEEDTEST = {"size": str(64 * MIB), "ops": "2", "concurrency": "4"}


class _Node:
    """One `python -m minio_tpu_torch.server` process and its log."""

    def __init__(self, name: str, port: int, args: list, env: dict, log: str):
        self.name, self.port, self.args, self.env, self.log = name, port, args, env, log
        self.proc = None

    def start(self) -> None:
        from minio_tpu_torch.server import nodes

        self.proc = nodes.spawn(self.port, self.args, self.env, self.log)

    def tail(self, n: int = 4000) -> str:
        from minio_tpu_torch.server import nodes

        return nodes.tail(self.log, n)

    def fail(self, msg: str) -> None:
        fail(f"{self.name}: {msg}\n--- tail of {self.name}'s log ---\n{self.tail()}")

    def kill(self) -> None:
        from minio_tpu_torch.server import nodes

        if self.proc is not None:
            nodes.stop_all([self.proc], NODE_STOP_S)


def _wait_online(group, clients) -> None:
    """Until each client's node answers GET / with 200 (a pool's workers
    are two clients of one node)."""
    from minio_tpu_torch.server import nodes

    try:
        nodes.wait_online(clients, [n.proc for n in group], NODE_START_S)
    except (RuntimeError, TimeoutError) as e:
        fail(f"{e} ({[n.name for n in group]})\n" + "".join(
            f"--- tail of {n.name}'s log ---\n{n.tail()}\n" for n in dict.fromkeys(group)))


def _wait_drives_online(node, cli, want: int) -> None:
    """Until the node's storage info shows ``want`` drives "ok": a peer's
    drives come back to it only after its circuit breaker's cooldown
    (MINIO_TPU_DRIVE_COOLDOWN_S, 15 s), as `mc admin info` would show."""
    deadline = time.monotonic() + NODE_START_S
    while True:
        r = cli.request("GET", "/minio/admin/v3/storageinfo")
        ok = [d for d in json.loads(r.body)["disks"] if d.get("state") == "ok"] \
            if r.status == 200 else []
        if len(ok) == want:
            return
        if time.monotonic() > deadline:
            node.fail(f"{len(ok)} of {want} drives online after {NODE_START_S} s")
        time.sleep(0.5)


def _scrape(cli, group: str, local: bool = False) -> dict:
    """{series (name and labels): value} of one metrics v3 group."""
    r = cli.request("GET", f"/minio/metrics/v3{group}", query={"local": "on"} if local else None)
    if r.status != 200:
        fail(f"scrape {group}: HTTP {r.status}")
    out = {}
    for ln in r.body.decode().splitlines():
        if ln and not ln.startswith("#"):
            name, _, value = ln.rpartition(" ")
            out[name] = float(value)
    return out


KERNELS = ("fused_encode_hash", "fused_decode_hash", "gf_apply", "hh_chain")
FAULT_SERIES = ("minio_tpu_fused_failures_total", "minio_tpu_backend_device_faults_total",
                "minio_tpu_backend_numpy_blocks_total", "minio_tpu_backend_demotions_total")


def _launch_shapes(tpu: dict) -> dict:
    """{kernel: {shape key: launches}} from the minio_tpu_kernel_launch_
    shapes_total series of an /api/tpu scrape (the key a JSON list in the
    shape label, as the wrapper keeps it)."""
    import re

    out = {k: {} for k in KERNELS}
    for series, n in tpu.items():
        m = re.fullmatch(r'minio_tpu_kernel_launch_shapes_total\{kernel="(\w+)",'
                         r'shape="((?:[^"\\]|\\.)*)"\}', series)
        if m:
            key = json.loads(json.loads(f'"{m.group(2)}"'))
            out[m.group(1)][tuple(tuple(x) if isinstance(x, list) else x for x in key)] = int(n)
    return out


def _node_counts(cli, local: bool = False) -> dict:
    """A node's device dispatches, blocks, kernel launches (in all and by
    shape) and fault counters, from its /api/tpu and /api/fault scrapes."""
    tpu, flt = _scrape(cli, "/api/tpu", local), _scrape(cli, "/api/fault", local)
    out = {"dispatches": tpu["minio_tpu_dispatch_total"],
           "fg_blocks": tpu['minio_tpu_dispatch_blocks_total{class="foreground"}'],
           "bg_blocks": tpu['minio_tpu_dispatch_blocks_total{class="background"}'],
           "device_s": tpu["minio_tpu_device_seconds_total"],
           "launches": {k: tpu[f'minio_tpu_kernel_launches_total{{kernel="{k}"}}']
                        for k in KERNELS},
           "shapes": _launch_shapes(tpu),
           "backend_level": flt["minio_tpu_backend_level"]}
    for k in KERNELS:
        if sum(out["shapes"][k].values()) != out["launches"][k]:
            fail(f"{k}: launches by shape {out['shapes'][k]} do not add up to "
                 f"{out['launches'][k]}")
    out["faults"] = {k: tpu[k] if k in tpu else flt[k] for k in FAULT_SERIES}
    return out


def cluster_phase(torch, mods, root: str) -> dict:
    """The server as operators start it (module docstring, phase 6): a
    4-node x 4-drive deployment of `python -m minio_tpu_torch.server`
    processes sharing the card, and a 2-worker pool beside it."""
    import http.client
    import re

    import numpy as np

    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server.nodes import free_port_block, free_ports

    _build = mods["_build"]
    stale = [s for s in _build.sources() if _build._stale(
        os.path.join(_build.BUILD, f"lib{os.path.splitext(os.path.basename(s))[0]}.so"), s)]
    if stale:  # the nodes would each run nvcc
        fail(f"kernel libraries older than their sources before the nodes start: {stale}")
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINIO_")}
    env.update({k: v for k, v in os.environ.items()
                if k in ("MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_BACKEND")})
    env.update(CLUSTER_ENV, PYTHONPATH=HERE, MINIO_TPU_SANITIZE="0")
    ports = free_ports(NODES)
    specs = [f"http://127.0.0.1:{ports[i]}{root}/n{i}/d{j}"
             for i in range(NODES) for j in range(1, NODE_DRIVES + 1)]
    nodes = [_Node(f"node{i}", ports[i], specs, env, os.path.join(root, f"node{i}.log"))
             for i in range(NODES)]
    pool_port = free_port_block(3)
    pool = _Node("pool", pool_port, [os.path.join(root, "pool", f"d{j}") for j in range(16)],
                 {**env, "MINIO_TPU_WORKERS": "2",
                  "MINIO_TPU_WORKER_PORT_BASE": str(pool_port + 1)},
                 os.path.join(root, "pool.log"))
    clis = [S3Client(f"127.0.0.1:{p}") for p in ports]
    workers = [S3Client(f"127.0.0.1:{pool_port + 1 + i}") for i in range(2)]
    everyone = [*nodes, pool]
    t: dict = {}

    def step(name: str, t0: float) -> None:
        # printed as it ends: a run that fails later still shows it
        t[name] = time.perf_counter() - t0
        print(f"cluster step {name}: {t[name]:.2f} s", flush=True)

    want_dev = "cuda" if DEV.startswith("cuda") else "cpu"
    try:
        # 1. start every node with one endpoint list (and the pool); each
        # answers GET / with 200 once its object layer is online
        t0 = time.perf_counter()
        for n in everyone:
            n.start()
        _wait_online(nodes, clis)
        step("start_4_nodes_s", t0)
        _wait_online([pool, pool], workers)
        step("start_nodes_and_pool_s", t0)
        for n in everyone:
            # the pool's two workers append to one log, and their lines
            # can interleave ("device: cudadevice: cuda"): count the words
            devs = re.findall(r"device: (cuda|cpu|host)", n.tail(200_000))
            if devs != [want_dev] * (2 if n is pool else 1):
                n.fail(f"serves on {devs}, not on {want_dev}")
            if "bootstrap config check" in n.tail(200_000):
                n.fail("bootstrap found a configuration difference")

        # 2. admin info from two nodes: 4 servers, 16 drives online
        online_seen = {}
        for i in (0, 2):
            r = clis[i].request("GET", "/minio/admin/v3/info")
            if r.status != 200:
                nodes[i].fail(f"admin info: HTTP {r.status} {r.body[:200]!r}")
            info = json.loads(r.body)
            drives = [d for p in info["pools"] for st in p["sets"] for d in st["drives"]]
            servers = {d.split("/")[2] for d in drives}
            r = clis[i].request("GET", "/minio/admin/v3/storageinfo")
            online = [d for d in json.loads(r.body)["disks"] if d.get("state") == "ok"]
            if len(servers) != NODES or len(drives) != 16 or len(online) != 16:
                nodes[i].fail(f"admin info: {len(servers)} servers, {len(drives)} drives, "
                              f"{len(online)} online")
            online_seen[f"node{i}"] = {"servers": len(servers), "drives_online": len(online)}

        bucket = "cluster"
        if clis[0].make_bucket(bucket).status != 200:
            nodes[0].fail("make_bucket")
        if workers[0].make_bucket(bucket).status != 200:
            pool.fail("make_bucket")
        rng = np.random.default_rng(SEED + 6)
        std = {f"std-{i}": rng.bytes(64 * MIB) for i in range(8)}
        rrs = {f"rrs-{i}": rng.bytes(64 * MIB) for i in range(2)}
        race = [rng.bytes(16 * MIB) for _ in range(2)]
        late = rng.bytes(64 * MIB)
        md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**std, **rrs, "late": late}.items()}
        moved = {"put": 0, "get": 0, "bodies_checked": 0}

        def request(cli, node, method, path, **kw):
            # a connection cut mid-body fails with the serving node's log
            try:
                return cli.request(method, path, timeout=600, **kw)
            except (OSError, http.client.HTTPException) as e:
                node.fail(f"{method} {path}: {e!r}")

        def put(cli, node, key, body, cls="STANDARD"):
            r = request(cli, node, "PUT", f"/{bucket}/{key}", body=body, unsigned_payload=True,
                        headers={"x-amz-storage-class": cls})
            if r.status != 200 or r.headers.get("etag", "").strip('"') != hashlib.md5(
                    body).hexdigest():
                node.fail(f"PUT {key} ({cls}): {r.status} etag {r.headers.get('etag')} "
                          f"{r.body[:200]!r}")
            moved["put"] += len(body)

        def get_check(cli, node, key, want):
            r = request(cli, node, "GET", f"/{bucket}/{key}")
            if r.status != 200 or hashlib.md5(r.body).hexdigest() != want or \
                    r.headers.get("etag", "").strip('"') != want:
                node.fail(f"GET {key}: {r.status}, md5 or ETag mismatch")
            moved["get"] += len(r.body)
            moved["bodies_checked"] += 1

        # 3. 8 concurrent 64 MiB STANDARD PUTs, 2 through each node (K1
        # encode), each read back through another node; one through each
        # pool worker, read back through the other
        keys = list(std)
        t0 = time.perf_counter()
        run_all(lambda i: put(clis[i % NODES], nodes[i % NODES], keys[i], std[keys[i]]),
                range(len(keys)))
        step("put_standard_8x64MiB_s", t0)
        t0 = time.perf_counter()
        run_all(lambda i: get_check(clis[(i + 1) % NODES], nodes[(i + 1) % NODES], keys[i],
                                    md5[keys[i]]), range(len(keys)))
        step("get_standard_8x64MiB_other_node_s", t0)
        t0 = time.perf_counter()
        run_all(lambda w: put(workers[w], pool, f"pool-{w}", std[keys[w]]), range(2))
        run_all(lambda w: get_check(workers[1 - w], pool, f"pool-{w}", md5[keys[w]]), range(2))
        step("pool_put_get_2x64MiB_s", t0)

        # 4. 2 REDUCED_REDUNDANCY PUTs through node 1 (K3 + K2), read
        # through node 2
        t0 = time.perf_counter()
        run_all(lambda k: put(clis[1], nodes[1], k, rrs[k], "REDUCED_REDUNDANCY"), list(rrs))
        step("put_rrs_2x64MiB_s", t0)
        t0 = time.perf_counter()
        run_all(lambda k: get_check(clis[2], nodes[2], k, md5[k]), list(rrs))
        step("get_rrs_2x64MiB_s", t0)

        # 5. two concurrent 16 MiB overwrites of one key through nodes 0
        # and 2 (the distributed lock): every node reads one body, whole
        t0 = time.perf_counter()
        run_all(lambda i: put(clis[2 * i], nodes[2 * i], "race", race[i]), range(2))
        step("overwrite_race_2x16MiB_s", t0)
        seen = set()
        for i in range(NODES):
            r = request(clis[i], nodes[i], "GET", f"/{bucket}/race")
            if r.status != 200 or r.body not in race:
                nodes[i].fail(f"race: {r.status}, the body is neither writer's")
            seen.add(r.body)
        if len(seen) != 1:
            fail("race: the nodes read different bodies")

        # 6. node 3's files, then SIGKILL and its drives' object
        # directories wiped, as for a replaced server
        n3_drives = [os.path.join(root, "n3", f"d{j}") for j in range(1, NODE_DRIVES + 1)]
        before = {d: _user_files(d, [bucket]) for d in n3_drives}
        if not all(before.values()):
            nodes[3].fail("holds no object files")
        counts = {"node3-before-kill": _node_counts(clis[3])}
        nodes[3].kill()
        for d in n3_drives:
            for entry in os.listdir(os.path.join(d, bucket)):
                shutil.rmtree(os.path.join(d, bucket, entry))

        # 7. degraded GETs of the 8 STANDARD objects through nodes 0 and 1
        # (K1 decode), and a STANDARD PUT on the 12 drives left
        dec0 = [_node_counts(clis[i])["launches"]["fused_decode_hash"] for i in (0, 1)]
        t0 = time.perf_counter()
        run_all(lambda i: get_check(clis[i % 2], nodes[i % 2], keys[i], md5[keys[i]]),
                range(len(keys)))
        step("degraded_get_8x64MiB_node3_down_s", t0)
        dec1 = [_node_counts(clis[i])["launches"]["fused_decode_hash"] for i in (0, 1)]
        if sum(dec1) == sum(dec0):
            fail(f"the degraded GETs launched no K1 decode: {dec0} -> {dec1}")
        t0 = time.perf_counter()
        put(clis[1], nodes[1], "late", late)
        step("put_standard_64MiB_node3_down_s", t0)

        # 8. node 3 back; the admin heal of the bucket restores every file
        # it held, byte for byte, and gives the late object its shards
        t0 = time.perf_counter()
        nodes[3].start()
        _wait_online([nodes[3]], [clis[3]])
        step("restart_node3_s", t0)
        _wait_drives_online(nodes[0], clis[0], 16)
        step("node3_drives_online_at_node0_s", t0)
        dec0 = _node_counts(clis[0])["launches"]["fused_decode_hash"]
        t0 = time.perf_counter()
        r = clis[0].request("POST", f"/minio/admin/v3/heal/{bucket}", timeout=1200)
        step("admin_heal_s", t0)
        heal = json.loads(r.body) if r.status == 200 else None
        # every object held 4 shards on node 3: each is healed there
        if heal is None or heal["failed"] or heal["scanned"] != len(keys) + len(rrs) + 2 \
                or len(heal["healed"]) != NODE_DRIVES * heal["scanned"]:
            nodes[0].fail(f"admin heal: {r.status} {r.body[:400]!r}")
        after = {d: _user_files(d, [bucket]) for d in n3_drives}
        changed = sorted(f"{d}:{f}" for d in n3_drives for f, b in before[d].items()
                         if after[d].get(f) != b)
        if changed:
            fail(f"node 3's files not restored byte for byte: {changed[:8]}")
        late_dir = os.path.join(bucket, "late") + os.sep
        if not all(any(f.startswith(late_dir) for f in after[d]) for d in n3_drives):
            fail("the object written while node 3 was down has no shards there")
        heal_decodes = _node_counts(clis[0])["launches"]["fused_decode_hash"] - dec0
        if heal_decodes <= 0:
            nodes[0].fail("the admin heal launched no K1 decode")
        get_check(clis[3], nodes[3], "late", md5["late"])

        # 9. the admin object speedtest across the cluster: one row a node
        t0 = time.perf_counter()
        r = clis[0].request("POST", "/minio/admin/v3/speedtest", query=SPEEDTEST, timeout=1200)
        step("speedtest_s", t0)
        rows = json.loads(r.body)["nodes"] if r.status == 200 else {}
        if len(rows) != NODES or any("error" in v for v in rows.values()):
            nodes[0].fail(f"speedtest: {r.status} {r.body[:400]!r}")
        speed = {k: v.get("knee") for k, v in rows.items()}

        # 10. every node's scrapes, then SIGTERM: each exits 0 in time
        for i, cli in enumerate(clis):
            counts[f"node{i}"] = _node_counts(cli)
            net = _scrape(cli, "/system/network/internode")
            counts[f"node{i}"]["grid_sent_bytes"] = net[
                "minio_system_network_internode_sent_bytes_total"]
            counts[f"node{i}"]["grid_calls"] = net["minio_system_network_internode_calls_total"]
        for w in range(2):
            counts[f"pool-worker{w}"] = _node_counts(workers[w], local=True)
        for name, c in counts.items():
            # every node took PUTs: STANDARD ones (K1 encode), except node
            # 3 after its restart, which took the speedtest's (the set's
            # default parity, 12+4: the bit-plane product + K2)
            if c["dispatches"] <= 0 or not any(c["launches"].values()) or (
                    name != "node3" and c["launches"]["fused_encode_hash"] <= 0):
                fail(f"{name} took PUTs but shows no device dispatch: {c}")
            if any(c["faults"].values()) or c["backend_level"] != 2:
                fail(f"{name}: a fault counter moved: {c}")
            if name.startswith("node") and name != "node3-before-kill" and (
                    c["grid_sent_bytes"] <= 0 or c["grid_calls"] <= 0):
                fail(f"{name}: no grid traffic: {c}")
        if not counts["node1"]["launches"]["gf_apply"] or \
                not counts["node1"]["launches"]["hh_chain"]:
            fail(f"node 1 took the REDUCED_REDUNDANCY PUTs but launched no K3/K2: {counts}")
        # which processes loaded the CUDA driver: every serving process,
        # and not the pool's supervisor, which builds no object layer
        procs = {n.name: n.proc.pid for n in everyone}
        for w in range(2):  # each worker names its pid in admin info
            r = workers[w].request("GET", "/minio/admin/v3/info")
            procs[f"pool-worker{w}"] = json.loads(r.body)["pid"]
        libcuda = {}
        for name, pid in procs.items():
            try:
                with open(f"/proc/{pid}/maps") as fh:
                    libcuda[name] = "libcuda.so" in fh.read()
            except OSError:
                libcuda[name] = None
        t0 = time.perf_counter()
        for n in everyone:
            n.proc.send_signal(15)
        exits = {}
        for n in everyone:
            try:
                exits[n.name] = n.proc.wait(NODE_STOP_S)
            except subprocess.TimeoutExpired:
                n.fail(f"did not exit within {NODE_STOP_S} s of SIGTERM")
            if exits[n.name] != 0:
                n.fail(f"exited {exits[n.name]} on SIGTERM")
        step("sigterm_all_s", t0)
        t["phase_s"] = time.perf_counter() - t_phase
        # every process's counts, node 3's from before its kill and after
        # its restart (each process starts at zero)
        launches = dict.fromkeys(KERNELS, 0)
        shapes = {k: {} for k in KERNELS}
        for c in counts.values():
            per = c.pop("shapes")
            for k in KERNELS:
                launches[k] += int(c["launches"][k])
                for key, n in per[k].items():
                    shapes[k][key] = shapes[k].get(key, 0) + n
        return {"launches": launches, "shapes": shapes, "seconds": t, "bytes": moved,
                "nodes": counts, "heal": {"scanned": heal["scanned"],
                                          "healed": len(heal["healed"]),
                                          "k1_decode_launches": heal_decodes},
                "restored_files": sum(map(len, before.values())), "speedtest_knee": speed,
                "online": online_seen, "exits": exits,
                "libcuda_mapped": libcuda}
    finally:
        for n in everyone:
            n.kill()



class SFTPError(Exception):
    """An SFTP request answered with a status other than FX_OK."""

    def __init__(self, code: int, msg: str = ""):
        super().__init__(f"SFTP status {code}: {msg}")
        self.code = code


class SFTPClient:
    """A small SFTP v3 client on the client role of the port's SSH
    transport (``minio_tpu_torch/server/ssh.py``): password or ssh-ed25519
    publickey auth, one session channel with the sftp subsystem, and reads
    and writes of ``chunk`` bytes kept ``depth`` requests deep, as common
    clients pipeline theirs (the gateway answers a channel's requests in
    order)."""

    def __init__(self, port: int, user: str, password: str = "", key=None,
                 chunk: int = 32 * 1024, depth: int = 16):
        import socket

        from minio_tpu_torch.server import sftp, ssh

        self.ssh, self.fx = ssh, sftp
        self.chunk, self.depth = chunk, depth
        self.tr = ssh.SSHTransport(socket.create_connection(("127.0.0.1", port), timeout=300),
                                   "client")
        try:
            self.tr.handshake()
            self._auth(user, password, key)
            self._open_channel()
        except BaseException:
            self.tr.sock.close()
            raise
        self.rid, self.buf = 0, b""
        self._send(bytes([sftp.FXP_INIT]) + ssh.wu32(3))
        if self._recv()[0] != sftp.FXP_VERSION:
            raise ssh.SSHError("no FXP_VERSION")

    def _auth(self, user: str, password: str, key) -> None:
        ssh, tr = self.ssh, self.tr
        tr.send_packet(bytes([ssh.MSG_SERVICE_REQUEST]) + ssh.wstr("ssh-userauth"))
        if tr.read_msg()[0] != ssh.MSG_SERVICE_ACCEPT:
            raise ssh.SSHError("ssh-userauth not accepted")
        head = bytes([ssh.MSG_USERAUTH_REQUEST]) + ssh.wstr(user) + ssh.wstr("ssh-connection")
        if key is None:
            tr.send_packet(head + ssh.wstr("password") + b"\x00" + ssh.wstr(password))
        else:
            algo, blob = ssh.HOSTKEY_ALGO, ssh.ed25519_blob(key.public_key())
            # probe first (RFC 4252 section 7), then sign
            tr.send_packet(head + ssh.wstr("publickey") + b"\x00" + ssh.wstr(algo)
                           + ssh.wstr(blob))
            if tr.read_msg()[0] != ssh.MSG_USERAUTH_PK_OK:
                raise PermissionError(f"{user}: key not trusted")
            sig = key.sign(ssh.publickey_auth_blob(tr.session_id, user, algo, blob))
            tr.send_packet(head + ssh.wstr("publickey") + b"\x01" + ssh.wstr(algo)
                           + ssh.wstr(blob) + ssh.wstr(ssh.ed25519_sig_blob(sig)))
        if tr.read_msg()[0] != ssh.MSG_USERAUTH_SUCCESS:
            raise PermissionError(f"{user}: authentication refused")

    def _open_channel(self) -> None:
        ssh, tr = self.ssh, self.tr
        tr.send_packet(bytes([ssh.MSG_CHANNEL_OPEN]) + ssh.wstr("session") + ssh.wu32(0)
                       + ssh.wu32(1 << 30) + ssh.wu32(32768))
        t, r = tr.read_msg()
        if t != ssh.MSG_CHANNEL_OPEN_CONFIRMATION:
            raise ssh.SSHError(f"channel open refused ({t})")
        r.u32()
        self.chan = r.u32()
        tr.send_packet(bytes([ssh.MSG_CHANNEL_REQUEST]) + ssh.wu32(self.chan)
                       + ssh.wstr("subsystem") + b"\x01" + ssh.wstr("sftp"))
        if tr.read_msg()[0] != ssh.MSG_CHANNEL_SUCCESS:
            raise ssh.SSHError("sftp subsystem refused")

    def _send(self, payload: bytes) -> None:
        ssh = self.ssh
        framed = ssh.wu32(len(payload)) + payload
        self.tr.send_packet(bytes([ssh.MSG_CHANNEL_DATA]) + ssh.wu32(self.chan)
                            + ssh.wstr(framed))

    def _recv(self) -> tuple:
        """(type, request id or None, payload) of the next SFTP reply."""
        ssh = self.ssh
        while True:
            if len(self.buf) >= 4:
                n = int.from_bytes(self.buf[:4], "big")
                if len(self.buf) >= 4 + n:
                    pkt, self.buf = self.buf[4:4 + n], self.buf[4 + n:]
                    if pkt[0] == self.fx.FXP_VERSION:
                        return pkt[0], None, pkt[1:]
                    return pkt[0], int.from_bytes(pkt[1:5], "big"), pkt[5:]
            t, r = self.tr.read_msg()
            if t == ssh.MSG_CHANNEL_DATA:
                r.u32()
                self.buf += r.str_()
            elif t != ssh.MSG_CHANNEL_WINDOW_ADJUST:
                raise ssh.SSHError(f"unexpected message {t}")

    def _submit(self, ftype: int, body: bytes) -> int:
        self.rid += 1
        self._send(bytes([ftype]) + self.ssh.wu32(self.rid) + body)
        return self.rid

    def _reply(self, rid: int) -> tuple:
        t, got, payload = self._recv()
        if got != rid:
            raise self.ssh.SSHError(f"reply to request {got}, want {rid}")
        return t, payload

    def request(self, ftype: int, body: bytes) -> tuple:
        """One request and its reply: (reply type, payload)."""
        return self._reply(self._submit(ftype, body))

    @staticmethod
    def _status(payload: bytes) -> tuple:
        code, n = int.from_bytes(payload[:4], "big"), int.from_bytes(payload[4:8], "big")
        return code, payload[8:8 + n].decode()

    def status(self, ftype: int, body: bytes) -> int:
        """The status code a request is answered with."""
        t, payload = self.request(ftype, body)
        if t != self.fx.FXP_STATUS:
            raise self.ssh.SSHError(f"reply type {t}, want a status")
        return self._status(payload)[0]

    def _expect(self, t: int, payload: bytes, want: int) -> bytes:
        if t == self.fx.FXP_STATUS:
            raise SFTPError(*self._status(payload))
        if t != want:
            raise self.ssh.SSHError(f"reply type {t}, want {want}")
        return payload

    def realpath(self, path: str) -> str:
        p = self._expect(*self.request(self.fx.FXP_REALPATH, self.ssh.wstr(path)),
                         self.fx.FXP_NAME)
        return self.ssh.Reader(p[4:]).str_().decode()

    @staticmethod
    def _attrs(r) -> tuple:
        """(size, permissions) of an SFTP v3 attribute block."""
        flags, size, perms = r.u32(), 0, 0
        if flags & 0x1:
            size = r.u64()
        if flags & 0x2:
            r.u32(), r.u32()
        if flags & 0x4:
            perms = r.u32()
        if flags & 0x8:
            r.u32(), r.u32()
        return size, perms

    def stat(self, path: str) -> tuple:
        """(size, permissions); SFTPError where the gateway answers a status."""
        p = self._expect(*self.request(self.fx.FXP_STAT, self.ssh.wstr(path)),
                         self.fx.FXP_ATTRS)
        return self._attrs(self.ssh.Reader(p))

    def listdir(self, path: str) -> list:
        """[(name, size, is a directory)] in the order the gateway lists."""
        import stat as stat_mod

        fx, wstr = self.fx, self.ssh.wstr
        h = self.ssh.Reader(self._expect(*self.request(fx.FXP_OPENDIR, wstr(path)),
                                         fx.FXP_HANDLE)).str_()
        out = []
        while True:
            t, p = self.request(fx.FXP_READDIR, wstr(h))
            if t == fx.FXP_STATUS and self._status(p)[0] == fx.FX_EOF:
                break
            r = self.ssh.Reader(self._expect(t, p, fx.FXP_NAME))
            for _ in range(r.u32()):
                name = r.str_().decode()
                r.str_()  # longname
                size, perms = self._attrs(r)
                out.append((name, size, stat_mod.S_ISDIR(perms)))
        self.status(fx.FXP_CLOSE, wstr(h))
        return out

    def _open(self, path: str, flags: int) -> bytes:
        fx, ssh = self.fx, self.ssh
        p = self._expect(*self.request(fx.FXP_OPEN, ssh.wstr(path) + ssh.wu32(flags)
                                       + ssh.wu32(0)), fx.FXP_HANDLE)
        return ssh.Reader(p).str_()

    def _close(self, h: bytes) -> None:
        code = self.status(self.fx.FXP_CLOSE, self.ssh.wstr(h))
        if code != self.fx.FX_OK:
            raise SFTPError(code, "close")

    def put(self, path: str, data: bytes) -> None:
        """Write ``data`` as the file ``path``, ``depth`` writes in flight;
        the gateway commits it as one object PUT on close."""
        fx, ssh = self.fx, self.ssh
        h = self._open(path, fx.PF_WRITE | fx.PF_CREAT | fx.PF_TRUNC)
        inflight, off = [], 0
        while off < len(data) or inflight:
            while off < len(data) and len(inflight) < self.depth:
                part = data[off:off + self.chunk]
                inflight.append(self._submit(fx.FXP_WRITE, ssh.wstr(h) + off.to_bytes(8, "big")
                                            + ssh.wstr(part)))
                off += len(part)
            t, p = self._reply(inflight.pop(0))
            code = self._status(p)[0] if t == fx.FXP_STATUS else -1
            if code != fx.FX_OK:
                raise SFTPError(code, f"write {path}")
        self._close(h)

    def get(self, path: str) -> bytes:
        """The file ``path`` read ``chunk`` bytes a request, ``depth``
        requests in flight, until the gateway answers FX_EOF."""
        fx, ssh = self.fx, self.ssh
        h = self._open(path, fx.PF_READ)
        parts, inflight, off, eof = [], [], 0, False
        while inflight or not eof:
            while not eof and len(inflight) < self.depth:
                inflight.append(self._submit(fx.FXP_READ, ssh.wstr(h) + off.to_bytes(8, "big")
                                            + ssh.wu32(self.chunk)))
                off += self.chunk
            t, p = self._reply(inflight.pop(0))
            if t == fx.FXP_STATUS and self._status(p)[0] == fx.FX_EOF:
                eof = True
                continue
            data = ssh.Reader(self._expect(t, p, fx.FXP_DATA)).str_()
            parts.append(data)
            if len(data) < self.chunk:
                eof = True
        self._close(h)
        return b"".join(parts)

    def close(self) -> None:
        self.tr.disconnect()


# the gateway phase's deployment: MinIO's "File Transfer Protocol
# (FTP/SFTP)" (`minio server --ftp="address=:8021" --sftp="address=:8022"
# ...`): one `python -m minio_tpu_torch.server --ftp F --sftp S` process
# over 16 local drives, STANDARD = EC:8, one ed25519 key in
# MINIO_SFTP_AUTHORIZED_KEYS, the server's default read cache
GATEWAY_ENV = {"MINIO_STORAGE_CLASS_STANDARD": "EC:8", "MINIO_TPU_SCAN_INTERVAL": "0"}
GW_SESSIONS = 4  # concurrent SFTP sessions, and concurrent FTP transfers


def gateway_phase(torch, mods, root: str) -> dict:
    """The alternate frontends (module docstring, phase 7): SFTP through
    the port's SSH transport and FTP through ``ftplib`` into one server
    process on the card, a degraded read through each, the console page,
    the node's launches by shape, and SIGTERM."""
    import base64
    import ftplib
    import http.client
    import io
    import stat as stat_mod

    import numpy as np
    from cryptography.hazmat.primitives.asymmetric import ed25519

    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server import ssh
    from minio_tpu_torch.server.nodes import free_ports
    from minio_tpu_torch.storage.xlstorage import XLStorage

    _build = mods["_build"]
    stale = [s for s in _build.sources() if _build._stale(
        os.path.join(_build.BUILD, f"lib{os.path.splitext(os.path.basename(s))[0]}.so"), s)]
    if stale:  # the node would run nvcc
        fail(f"kernel libraries older than their sources before the node starts: {stale}")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 7)
    key = ed25519.Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
    stranger = ed25519.Ed25519PrivateKey.from_private_bytes(rng.bytes(32))
    keys_file = os.path.join(root, "authorized_keys")
    with open(keys_file, "w") as fh:
        fh.write("minioadmin ssh-ed25519 "
                 + base64.b64encode(ssh.ed25519_blob(key.public_key())).decode() + "\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINIO_")}
    env.update({k: v for k, v in os.environ.items()
                if k in ("MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_BACKEND")})
    env.update(GATEWAY_ENV, PYTHONPATH=HERE, MINIO_TPU_SANITIZE="0",
               MINIO_SFTP_AUTHORIZED_KEYS=keys_file)
    port, fport, sport = free_ports(3)
    drives = [os.path.join(root, f"d{i}") for i in range(16)]
    node = _Node("gateway", port, ["--ftp", fport, "--sftp", sport, *drives], env,
                 os.path.join(root, "gateway.log"))
    cli = S3Client(f"127.0.0.1:{port}")
    bucket = "gateway"
    t: dict = {}
    moved = {"sftp_put": 0, "sftp_get": 0, "ftp_put": 0, "ftp_get": 0, "s3_get": 0}

    def step(name: str, t0: float) -> None:
        t[name] = time.perf_counter() - t0
        print(f"gateway step {name}: {t[name]:.2f} s", flush=True)

    sftp_body = {f"sftp-{i}.bin": rng.bytes(64 * MIB) for i in range(GW_SESSIONS)}
    ftp_body = {f"ftp-{i}.bin": rng.bytes(64 * MIB) for i in range(GW_SESSIONS)}
    deg_body = rng.bytes(64 * MIB)
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**sftp_body, **ftp_body}.items()}
    sessions: list = []
    try:
        # 1. the node, and both gateways bound after its bootstrap
        t0 = time.perf_counter()
        node.start()
        _wait_online([node], [cli])
        want = (f"FTP gateway on port {fport}", f"SFTP gateway on port {sport}")
        while not all(w in node.tail(200_000) for w in want):
            if node.proc.poll() is not None or time.perf_counter() - t0 > NODE_START_S:
                node.fail(f"gateways not started: want {want}")
            time.sleep(0.25)
        step("start_node_and_gateways_s", t0)
        dev = [ln for ln in node.tail(200_000).splitlines() if ln.startswith("device: ")]
        want_dev = "cuda" if DEV.startswith("cuda") else "cpu"
        if len(dev) != 1 or not dev[0].startswith(f"device: {want_dev}"):
            node.fail(f"serves on {dev}, not on {want_dev}")

        # 2. SFTP: password and publickey auth; a wrong password and an
        # unlisted key are refused
        t0 = time.perf_counter()
        for i in range(GW_SESSIONS):
            c = SFTPClient(sport, "minioadmin", "minioadmin") if i % 2 == 0 else \
                SFTPClient(sport, "minioadmin", key=key)
            sessions.append(c)
            if c.realpath(".") != "/":
                node.fail("SFTP realpath . is not /")
        step("sftp_auth_4_sessions_s", t0)
        for bad in ({"password": "wrong"}, {"key": stranger}):
            try:
                SFTPClient(sport, "minioadmin", **bad).close()
                node.fail(f"SFTP accepted {list(bad)[0]} auth it must refuse")
            except PermissionError:
                pass
        fx = sessions[0].fx
        if sessions[0].status(fx.FXP_MKDIR, ssh.wstr(f"/{bucket}") + ssh.wu32(0)) != fx.FX_OK \
                or cli.request("HEAD", f"/{bucket}").status != 200:
            node.fail("SFTP mkdir of the bucket")

        # 3. 4 concurrent sessions each write one 64 MiB file (K1 encode
        # on close), read it back through SFTP, then through S3
        names = list(sftp_body)
        t0 = time.perf_counter()
        run_all(lambda i: sessions[i].put(f"/{bucket}/{names[i]}", sftp_body[names[i]]),
                range(GW_SESSIONS))
        step("sftp_put_4x64MiB_s", t0)
        moved["sftp_put"] += sum(map(len, sftp_body.values()))

        def sftp_get(i):
            got = sessions[i].get(f"/{bucket}/{names[(i + 1) % GW_SESSIONS]}")
            if got != sftp_body[names[(i + 1) % GW_SESSIONS]]:
                node.fail(f"SFTP read of {names[(i + 1) % GW_SESSIONS]} differs")

        t0 = time.perf_counter()
        run_all(sftp_get, range(GW_SESSIONS))
        step("sftp_get_4x64MiB_s", t0)
        moved["sftp_get"] += sum(map(len, sftp_body.values()))

        def s3_get(name):
            r = cli.request("GET", f"/{bucket}/{name}", timeout=600)
            if r.status != 200 or hashlib.md5(r.body).hexdigest() != md5[name] or \
                    r.headers.get("etag", "").strip('"') != md5[name]:
                node.fail(f"S3 GET {name}: {r.status}, md5 or ETag mismatch")

        t0 = time.perf_counter()
        run_all(s3_get, names)
        step("s3_get_4x64MiB_s", t0)
        moved["s3_get"] += sum(map(len, sftp_body.values()))
        e = XLStorage(drives[0]).read_version(bucket, names[0], "").erasure
        if (e.algorithm, e.data_blocks, e.parity_blocks) != ("reedsolomon", 8, 8):
            fail(f"SFTP object layout {e.algorithm} {e.data_blocks}+{e.parity_blocks}")

        # 4. stat, readdir, rename (a server-side copy: K1 encode), remove
        c = sessions[0]
        size, perms = c.stat(f"/{bucket}/{names[0]}")
        if size != 64 * MIB or not stat_mod.S_ISREG(perms) or \
                not stat_mod.S_ISDIR(c.stat(f"/{bucket}")[1]):
            node.fail(f"SFTP stat: size {size}, mode {perms:o}")
        listed = c.listdir(f"/{bucket}")
        if sorted(listed) != sorted((n, 64 * MIB, False) for n in names):
            node.fail(f"SFTP readdir: {listed}")
        t0 = time.perf_counter()
        code = c.status(fx.FXP_RENAME, ssh.wstr(f"/{bucket}/{names[0]}")
                        + ssh.wstr(f"/{bucket}/renamed-0.bin"))
        step("sftp_rename_64MiB_s", t0)
        if code != fx.FX_OK or cli.request("HEAD", f"/{bucket}/{names[0]}").status != 404:
            node.fail(f"SFTP rename: status {code}")
        md5["renamed-0.bin"] = md5[names[0]]
        s3_get("renamed-0.bin")
        moved["s3_get"] += 64 * MIB
        removed = [c.status(fx.FXP_REMOVE, ssh.wstr(f"/{bucket}/renamed-0.bin"))
                   for _ in range(2)]
        if removed != [fx.FX_OK, fx.FX_NO_SUCH_FILE]:
            node.fail(f"SFTP remove, then remove again: {removed}")

        # 5. FTP: 4 concurrent 64 MiB STORs (K1 encode), their RETRs, LIST,
        # DELE
        def ftp_login():
            f = ftplib.FTP()
            f.connect("127.0.0.1", fport, timeout=600)
            f.login("minioadmin", "minioadmin")
            return f

        fnames = list(ftp_body)

        def stor(name):
            f = ftp_login()
            try:
                f.storbinary(f"STOR /{bucket}/{name}", io.BytesIO(ftp_body[name]),
                             blocksize=1 << 20)
            finally:
                f.quit()

        def retr(name, want):
            buf = io.BytesIO()
            f = ftp_login()
            try:
                f.retrbinary(f"RETR /{bucket}/{name}", buf.write, blocksize=1 << 20)
            finally:
                f.quit()
            if buf.getvalue() != want:
                node.fail(f"FTP RETR of {name} differs")

        t0 = time.perf_counter()
        run_all(stor, fnames)
        step("ftp_stor_4x64MiB_s", t0)
        moved["ftp_put"] += sum(map(len, ftp_body.values()))
        t0 = time.perf_counter()
        run_all(lambda n: retr(n, ftp_body[n]), fnames)
        step("ftp_retr_4x64MiB_s", t0)
        moved["ftp_get"] += sum(map(len, ftp_body.values()))
        f = ftp_login()
        try:
            lines: list = []
            f.retrlines(f"LIST /{bucket}", lines.append)
            got = sorted((ln.split()[-1], int(ln.split()[4])) for ln in lines)
            if got != sorted([(n, 64 * MIB) for n in [*names[1:], *fnames]]):
                node.fail(f"FTP LIST: {got}")
            if not f.delete(f"/{bucket}/{fnames[0]}").startswith("250") or \
                    cli.request("HEAD", f"/{bucket}/{fnames[0]}").status != 404:
                node.fail("FTP DELE")
        finally:
            f.quit()

        # 6. a degraded read: an object no read has touched loses its
        # object directory on the 8 drives that hold its data shards; SFTP
        # and then FTP RETR read it back (K1 decode)
        c.put(f"/{bucket}/degraded.bin", deg_body)
        moved["sftp_put"] += len(deg_body)
        dist = XLStorage(drives[0]).read_version(bucket, "degraded.bin", "").erasure.distribution
        for i, d in enumerate(drives):
            if dist[i] <= 8:
                shutil.rmtree(os.path.join(d, bucket, "degraded.bin"))
        decodes = [_node_counts(cli)["launches"]["fused_decode_hash"]]
        t0 = time.perf_counter()
        if c.get(f"/{bucket}/degraded.bin") != deg_body:
            node.fail("the degraded SFTP read differs")
        step("sftp_degraded_get_64MiB_s", t0)
        moved["sftp_get"] += len(deg_body)
        decodes.append(_node_counts(cli)["launches"]["fused_decode_hash"])
        t0 = time.perf_counter()
        retr("degraded.bin", deg_body)
        step("ftp_degraded_retr_64MiB_s", t0)
        moved["ftp_get"] += len(deg_body)
        decodes.append(_node_counts(cli)["launches"]["fused_decode_hash"])
        deg_launches = {"sftp": decodes[1] - decodes[0], "ftp": decodes[2] - decodes[1]}
        if not deg_launches["sftp"]:
            node.fail(f"the degraded SFTP read launched no K1 decode: {deg_launches}")

        # 7. the console page, unauthenticated
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", "/minio/console/")
            r = conn.getresponse()
            page = r.read()
            hdrs = {k.lower(): v for k, v in r.getheaders()}
        finally:
            conn.close()
        console = {"status": r.status, "bytes": len(page),
                   **{h: hdrs.get(h) for h in ("content-type", "cache-control",
                                               "content-security-policy", "x-frame-options")}}
        if r.status != 200 or not hdrs.get("content-type", "").startswith("text/html") or \
                hdrs.get("cache-control") != "no-store" or \
                hdrs.get("content-security-policy") != "default-src 'self' 'unsafe-inline' blob:" \
                or hdrs.get("x-frame-options") != "DENY" or b"minio_tpu console" not in page:
            node.fail(f"console: {console}")

        # 8. the node's counts (zero at its start): K1 encode and decode
        # launched, no fault counter moved; then SIGTERM, exit 0
        counts = _node_counts(cli)
        for k in ("fused_encode_hash", "fused_decode_hash"):
            if not counts["launches"][k]:
                node.fail(f"the gateways launched no {k}: {counts['launches']}")
        if any(counts["faults"].values()) or counts["backend_level"] != 2:
            node.fail(f"a fault counter moved: {counts}")
        for s in sessions:
            s.close()
        sessions.clear()
        t0 = time.perf_counter()
        node.proc.send_signal(15)
        try:
            code = node.proc.wait(NODE_STOP_S)
        except subprocess.TimeoutExpired:
            node.fail(f"did not exit within {NODE_STOP_S} s of SIGTERM")
        if code != 0:
            node.fail(f"exited {code} on SIGTERM")
        step("sigterm_s", t0)
        t["phase_s"] = time.perf_counter() - t_phase
        shapes = counts.pop("shapes")
        return {"launches": {k: int(v) for k, v in counts["launches"].items()},
                "shapes": shapes, "seconds": t, "bytes": moved, "node": counts,
                "degraded_k1_decode_launches": deg_launches, "console": console,
                "exit": code}
    finally:
        for s in sessions:
            try:
                s.close()
            except OSError:
                pass
        node.kill()


# the sanitized node: phase 5's deployment (16 drives, STANDARD = EC:8,
# REDUCED_REDUNDANCY = EC:8 cauchy, read cache off) as one `python -m
# minio_tpu_torch.server` process with the project's runtime sanitizer on
# (MINIO_TPU_SANITIZE, its default 0.5 s stall threshold)
SANITIZED_ENV = {**S3_ENV, "MINIO_TPU_SANITIZE": "1", "MINIO_TPU_SANITIZE_STALL_S": "0.5"}
SAN_STD, SAN_RRS = 4, 2
# violations the phase must not see (a loop stall is counted and printed)
SAN_VIOLATIONS = ("lock.order", "attr.race", "resource.leak", "pool.lease-violation")
# the port's own code (not a copy of the JAX package's): a stall whose
# innermost package frame lies here is a fault of the port
PORT_ADDED = ("server/web.py", "device.py", "ops/_build.py", "ops/card.py", "_cuda.py",
              "utils/msgpack_lite.py")


class _TraceTap:
    """A signed `mc admin trace`-style stream of one node's sanitizer
    records, read on a thread of its own: they carry the stacks that
    sanitizer/status leaves out. The stream takes S3 records too: a node
    notices a gone reader only when it next writes to it, and ``close``
    makes such records so that the stream ends before the node stops
    (its front gives a request in flight a minute at shutdown)."""

    def __init__(self, cli):
        import http.client
        import urllib.parse

        from minio_tpu_torch.server.signature import UNSIGNED_PAYLOAD, sign_request

        self.cli = cli
        self.records: list = []
        qs = urllib.parse.urlencode({"type": "sanitizer,s3", "local": "on"})
        path = f"/minio/admin/v3/trace?{qs}"
        hdrs = sign_request("GET", f"http://{cli.host}:{cli.port}{path}", {}, UNSIGNED_PAYLOAD,
                            cli.access_key, cli.secret_key, cli.region)
        self.conn = http.client.HTTPConnection(cli.host, cli.port, timeout=NODE_START_S)
        self.conn.request("GET", path, headers=hdrs)
        resp = self.conn.getresponse()
        if resp.status != 200:
            fail(f"admin trace: HTTP {resp.status}")
        self._thread = threading.Thread(target=self._read, args=(resp,), daemon=True)
        self._thread.start()

    def _read(self, resp) -> None:
        try:
            for line in resp:
                rec = json.loads(line)
                if rec.get("type") == "sanitizer":
                    self.records.append(rec)
        except Exception:  # noqa: BLE001 — closed under the reader: the stream is over
            pass

    def close(self, bucket: str) -> None:
        import socket

        try:
            self.conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.conn.close()
        self._thread.join(NODE_STOP_S)
        deadline = time.monotonic() + NODE_STOP_S
        while _scrape(self.cli, "/api/trace", local=True)["minio_trace_subscribers"]:
            if time.monotonic() > deadline:
                fail(f"the node kept the closed trace stream for {NODE_STOP_S} s")
            self.cli.request("HEAD", f"/{bucket}")
            time.sleep(0.1)


def _stall_frames(stack: str, n: int = 6) -> list:
    """The innermost ``n`` frames of a stall's stack, "file:line fn"."""
    frames = [ln.strip() for ln in stack.splitlines() if ln.strip().startswith('File "')]
    out = []
    for fr in frames[-n:]:
        path, _, rest = fr[len('File "'):].partition('", line ')
        line, _, fn = rest.partition(", in ")
        out.append(f"{path.split('minio_tpu_torch/')[-1]}:{line} {fn}")
    return out


def _port_added(frames: list) -> bool:
    """Whether the innermost frame of the package among ``frames`` lies in
    code the port added."""
    pkg = [f for f in frames if not f.startswith("/") and not f.startswith("<")]
    return bool(pkg) and any(pkg[-1].split(":")[0].endswith(p) for p in PORT_ADDED)


def sanitized_phase(torch, mods, root: str) -> dict:
    """The sanitized node (module docstring, phase 8): phase 5's traffic,
    cut to 4 STANDARD and 2 REDUCED_REDUNDANCY objects, into a `python -m
    minio_tpu_torch.server` process with the lock-order, access and leak
    witnesses and the loop watchdog on, while K1, K2 and K3 run in it."""
    import re

    import numpy as np

    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server.nodes import free_ports
    from minio_tpu_torch.storage.xlstorage import XLStorage

    _build = mods["_build"]
    stale = [s for s in _build.sources() if _build._stale(
        os.path.join(_build.BUILD, f"lib{os.path.splitext(os.path.basename(s))[0]}.so"), s)]
    if stale:  # the node would run nvcc
        fail(f"kernel libraries older than their sources before the node starts: {stale}")
    with open(os.path.join(HERE, "minio_tpu_torch", "docs", "LOCK_ORDER.md")) as fh:
        ranks = len(re.findall(r"^\|\s*\d+\s*\|\s*`", fh.read(), re.M))
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINIO_")}
    env.update({k: v for k, v in os.environ.items()
                if k in ("MINIO_TPU_TORCH_DEVICE", "MINIO_TPU_BACKEND")})
    env.update(SANITIZED_ENV, PYTHONPATH=HERE)
    port = free_ports(1)[0]
    drives = [os.path.join(root, f"d{i}") for i in range(16)]
    node = _Node("sanitized", port, drives, env, os.path.join(root, "sanitized.log"))
    cli = S3Client(f"127.0.0.1:{port}")
    bucket = "sanitized"
    std = {f"std-{i}": rng.bytes(64 * MIB) for i in range(SAN_STD)}
    rrs = {f"rrs-{i}": rng.bytes(64 * MIB) for i in range(SAN_RRS)}
    parts = [rng.bytes(16 * MIB) for _ in range(S3_PARTS)]
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in {**std, **rrs}.items()}
    t: dict = {}
    moved = {"put": 0, "get": 0}
    tap = None

    def step(name: str, t0: float) -> None:
        t[name] = time.perf_counter() - t0
        print(f"sanitized step {name}: {t[name]:.2f} s", flush=True)

    def put(key, body, cls, unsigned):
        r = cli.request("PUT", f"/{bucket}/{key}", body=body, unsigned_payload=unsigned,
                        headers={"x-amz-storage-class": cls}, timeout=600)
        if r.status != 200 or r.headers.get("etag", "").strip('"') != md5[key]:
            node.fail(f"PUT {key} ({cls}): {r.status} etag {r.headers.get('etag')} != {md5[key]}")
        moved["put"] += len(body)

    def get_check(key, want_md5, etag=True):
        r = cli.request("GET", f"/{bucket}/{key}", timeout=600)
        if r.status != 200 or hashlib.md5(r.body).hexdigest() != want_md5 or (
                etag and r.headers.get("etag", "").strip('"') != want_md5):
            node.fail(f"GET {key}: {r.status}, md5 or ETag mismatch")
        moved["get"] += len(r.body)

    def layout(key):
        e = XLStorage(drives[0]).read_version(bucket, key, "").erasure
        return e.algorithm, e.data_blocks, e.parity_blocks, e.distribution

    try:
        # 1. the node, its witnesses armed at startup
        t0 = time.perf_counter()
        node.start()
        _wait_online([node], [cli])
        step("start_node_s", t0)
        tap = _TraceTap(cli)
        log = node.tail(200_000)
        dev = [ln for ln in log.splitlines() if ln.startswith("device: ")]
        if len(dev) != 1 or not dev[0].startswith("device: " + DEV.split(":")[0]):
            node.fail(f"serves on {dev}, not on {DEV}")
        armed = {w: re.search(rf"^sanitizer: {w} witness armed on (\d+) ", log, re.M)
                 for w in ("access", "leak")}
        if not all(armed.values()):
            node.fail(f"witnesses not armed at startup: {armed}")
        armed = {w: int(m.group(1)) for w, m in armed.items()}
        r = cli.make_bucket(bucket)
        if r.status != 200:
            node.fail(f"make_bucket: {r.status} {r.body[:200]!r}")

        # 2. STANDARD (K1 encode): concurrent streamed PUTs, their GETs
        t0 = time.perf_counter()
        run_all(lambda k: put(k, std[k], "STANDARD", True), list(std))
        step(f"put_standard_{SAN_STD}x64MiB_s", t0)
        t0 = time.perf_counter()
        run_all(lambda k: get_check(k, md5[k]), list(std))
        step(f"get_standard_{SAN_STD}x64MiB_s", t0)
        if layout("std-0")[:3] != ("reedsolomon", 8, 8):
            node.fail(f"STANDARD object layout {layout('std-0')[:3]}")

        # 3. REDUCED_REDUNDANCY (K3 + K2): concurrent signed PUTs, GETs
        t0 = time.perf_counter()
        run_all(lambda k: put(k, rrs[k], "REDUCED_REDUNDANCY", False), list(rrs))
        step(f"put_rrs_{SAN_RRS}x64MiB_s", t0)
        t0 = time.perf_counter()
        run_all(lambda k: get_check(k, md5[k]), list(rrs))
        step(f"get_rrs_{SAN_RRS}x64MiB_s", t0)
        if layout("rrs-0")[:3] != ("cauchy", 8, 8):
            node.fail(f"REDUCED_REDUNDANCY object layout {layout('rrs-0')[:3]}")

        # 4. multipart: 4 parts of 16 MiB uploaded concurrently
        t0 = time.perf_counter()
        r = cli.request("POST", f"/{bucket}/mp", query={"uploads": ""})
        uid = r.body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
        etags: list = [None] * S3_PARTS

        def put_part(i):
            r = cli.request("PUT", f"/{bucket}/mp", body=parts[i], timeout=600,
                            query={"partNumber": str(i + 1), "uploadId": uid})
            if r.status != 200:
                node.fail(f"upload part {i + 1}: {r.status}")
            etags[i] = r.headers["etag"]
            moved["put"] += len(parts[i])

        run_all(put_part, range(S3_PARTS))
        xml = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags)) + "</CompleteMultipartUpload>"
        r = cli.request("POST", f"/{bucket}/mp", query={"uploadId": uid}, body=xml.encode(),
                        timeout=600)
        step(f"multipart_{S3_PARTS}x16MiB_s", t0)
        want = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in parts)).hexdigest()
        got = next((el.text.strip('"') for el in r.xml().iter() if el.tag.endswith("ETag")),
                   None) if r.status == 200 else None
        if got != f"{want}-{S3_PARTS}":
            node.fail(f"multipart complete: {r.status} ETag {got!r} != {want}-{S3_PARTS}")
        get_check("mp", hashlib.md5(b"".join(parts)).hexdigest(), etag=False)

        # 5. degraded GET: the 8 drives holding std-2's data shards lose its
        # object directory (K1 decode)
        dist = layout("std-2")[3]
        for i, d in enumerate(drives):
            if dist[i] <= 8:
                shutil.rmtree(os.path.join(d, bucket, "std-2"))
        dec0 = _node_counts(cli)["launches"]["fused_decode_hash"]
        t0 = time.perf_counter()
        get_check("std-2", md5["std-2"])
        step("degraded_get_64MiB_s", t0)
        counts = _node_counts(cli)  # the node's counts, zero at its start
        if counts["launches"]["fused_decode_hash"] == dec0:
            node.fail("the degraded GET launched no K1 decode")
        for k in KERNELS:
            if not counts["launches"][k]:
                node.fail(f"the sanitized node launched no {k}: {counts['launches']}")
        if any(counts["faults"].values()) or counts["backend_level"] != 2:
            node.fail(f"a fault counter moved: {counts}")

        # 6. the sanitizer's scrape, status and the healthinfo bundle
        t0 = time.perf_counter()
        san = _scrape(cli, "/api/sanitizer", local=True)
        r = cli.admin("GET", "sanitizer/status")
        if r.status != 200:
            node.fail(f"sanitizer/status: HTTP {r.status}")
        st = json.loads(r.body)
        r = cli.admin("GET", "healthinfo")
        if r.status != 200 or json.loads(r.body)["sanitizer"]["enabled"] is not True:
            node.fail(f"healthinfo: HTTP {r.status}")
        step("scrape_status_healthinfo_s", t0)
        scraped = {"enabled": san["minio_sanitizer_enabled"],
                   "static_lock_ranks": san["minio_sanitizer_static_lock_ranks"],
                   "witnessed_attributes": san["minio_sanitizer_witnessed_attributes"],
                   "stall_episodes": san["minio_sanitizer_loop_stall_episodes_total"],
                   "violations": {k.split('"')[1]: v for k, v in san.items()
                                  if k.startswith("minio_sanitizer_violations_total{")}}
        if scraped["enabled"] != 1:
            node.fail(f"minio_sanitizer_enabled {scraped['enabled']}")
        if scraped["static_lock_ranks"] != ranks or not ranks:
            node.fail(f"{scraped['static_lock_ranks']} static lock ranks loaded, "
                      f"minio_tpu_torch/docs/LOCK_ORDER.md has {ranks}")
        if scraped["witnessed_attributes"] <= 0:
            node.fail("no attribute under the access witness")
        if "minio_tpu_torch.erasure.set.ObjectHandle" not in st["leakClasses"]:
            node.fail(f"the leak witness is not armed on ObjectHandle: {st['leakClasses']}")
        agree = {"enabled": (st["enabled"], scraped["enabled"] == 1),
                 "static_lock_ranks": (st["staticLockRanks"], scraped["static_lock_ranks"]),
                 "witnessed_attributes": (len(st["witnessedAttrs"]),
                                          scraped["witnessed_attributes"]),
                 "violations": (st["violations"], scraped["violations"])}
        if any(a != b for a, b in agree.values()) or \
                st["stallEpisodes"] > scraped["stall_episodes"]:
            node.fail(f"sanitizer/status disagrees with the scrape: {agree}")
        bad = {k: st["violations"].get(k, 0) for k in SAN_VIOLATIONS}
        if any(bad.values()):
            node.fail(f"sanitizer violations: {bad}; recent {st['recent']}")

        # 7. the trace stream closed, SIGTERM, exit 0
        tap.close(bucket)
        t0 = time.perf_counter()
        node.proc.send_signal(15)
        try:
            code = node.proc.wait(NODE_STOP_S)
        except subprocess.TimeoutExpired:
            node.fail(f"did not exit within {NODE_STOP_S} s of SIGTERM")
        if code != 0:
            node.fail(f"exited {code} on SIGTERM")
        step("sigterm_s", t0)
        stalls = []
        for rec in tap.records:
            if rec.get("name") != "loop.stall":
                continue
            frames = _stall_frames(rec.get("stack", ""))
            stalls.append({"stall_s": rec.get("stall_s"), "frames": frames,
                           "port_added": _port_added(frames)})
            print(f"sanitized loop stall {rec.get('stall_s')} s:\n  " + "\n  ".join(frames),
                  flush=True)
        ours = [s for s in stalls if s["port_added"]]
        if ours:
            node.fail(f"loop stalls in code the port added: {ours}")
        t["phase_s"] = time.perf_counter() - t_phase
        shapes = counts.pop("shapes")
        return {"launches": {k: int(v) for k, v in counts["launches"].items()},
                "shapes": shapes, "seconds": t, "bytes": moved, "node": counts,
                "witnesses": {"access_attributes": armed["access"],
                              "leak_classes": armed["leak"], "leak_class_names": st["leakClasses"],
                              "static_lock_ranks": st["staticLockRanks"],
                              "lock_order_md_ranks": ranks},
                "violations": st["violations"], "scraped": scraped,
                # episodes before the stream opened (startup) are counted
                # in stall_episodes, and their stacks not seen
                "stall_episodes": st["stallEpisodes"], "stalls": stalls, "exit": code}
    finally:
        if tap is not None:
            tap.conn.close()
        node.kill()


# the graft entry's and scripts' phase: the port's counterparts of the
# repository's __graft_entry__.py (the one-step check, the multi-device
# dry run at EC 8+8, one 1 MiB block a rank, on every visible card) and
# scripts/diag_smoke.py (a 2-worker pool of the server), and the served
# traffic of tests/test_torch_served.py (the reference's test_tpu_served
# shapes: 4 drives at EC 2+2, 32 concurrent PUTs of 2 MiB, degraded GETs
# with one drive's bucket gone, an admin heal with the device heal on, a
# multipart upload of 2 x 5 MiB; the K1 decode matrix at B=16 and the
# dispatcher's padding edges)
DIAG_SMOKE_S = 300


def graft_phase(torch, mods, root: str) -> dict:
    """The last modules on the card (module docstring, phase 9)."""
    import numpy as np

    import importlib.util

    from minio_tpu_torch import graft_entry

    # by its path: another "tests" package may be importable on the host
    spec = importlib.util.spec_from_file_location(
        "test_torch_served", os.path.join(HERE, "tests", "test_torch_served.py"))
    served = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(served)

    hh, rs = mods["hh"], mods["rs"]
    t: dict = {}
    t_phase = time.perf_counter()

    def step(name: str, t0: float) -> None:
        t[name] = time.perf_counter() - t0
        print(f"graft step {name}: {t[name]:.2f} s", flush=True)

    _zero_counts(mods)
    # the one-step check: one call on the card (K2 at 12 rows x 1 KiB)
    t0 = time.perf_counter()
    fn, (example,) = graft_entry.entry()
    parity, digests = fn(example)
    torch.cuda.synchronize()
    if parity.device.type != torch.device(DEV).type or tuple(parity.shape) != (2, 2, 1024) \
            or tuple(digests.shape) != (2, 6, 32):
        fail(f"graft entry: parity {parity.shape} on {parity.device}, digests {digests.shape}")
    ref = rs.get_codec(4, 2)
    for b in range(2):
        want = ref.split(example[b].tobytes())
        ref.encode(want)
        if not (parity[b].cpu().numpy() == want[4:]).all() or not (
                digests[b].cpu().numpy() == hh.hash256_batch_numpy(want)).all():
            fail(f"graft entry: block {b} differs from the host codec and HighwayHash")
    step("entry", t0)

    # the multi-device dry run on every visible card (nccl); its ranks
    # are processes of their own and report their K2 launches
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(torch.cuda.device_count())
    if dry["backend"] != "nccl" or dry["world"] != torch.cuda.device_count():
        fail(f"dry run took {dry['backend']} on {dry['world']} ranks")
    step("dryrun_multichip", t0)

    # the served traffic on the card, at the reference's shapes
    saved = {k: os.environ.get(k) for k in served.RIG_ENV}
    os.environ.update(served.RIG_ENV)
    rig = None
    try:
        t0 = time.perf_counter()
        rig = served.make_rig(os.path.join(root, "served"))
        step("served_start", t0)
        for name, case in (("concurrent_puts", served.concurrent_puts_ride_fused_kernel),
                           ("gets", served.served_get_roundtrip),
                           ("degraded_gets", served.degraded_get_rides_decode_kernel),
                           ("heal", served.heal_rebuilds_on_device),
                           ("multipart", served.multipart_served_on_device)):
            t0 = time.perf_counter()
            case(rig)
            step(name, t0)
    finally:
        if rig is not None:
            served.stop_rig(rig)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    t0 = time.perf_counter()
    for d, p, losses in served.DECODE_MATRIX:
        served.decode_failure_pattern_matrix(d, p, losses, DEV)
    step("decode_matrix", t0)
    t0 = time.perf_counter()
    for k in served.PADDING_EDGES:
        served.batch_padding_edges(k, DEV)
    step("padding_edges", t0)
    launches, shapes = _counts(mods)
    for key, n in dry["launches"].items():
        shapes["hh_chain"][key] = shapes["hh_chain"].get(key, 0) + n
        launches["hh_chain"] += n
    for key in ((12, 1024), (16, MIB // 8)):  # the one-step check's, the dry run's
        if key not in shapes["hh_chain"]:
            fail(f"phase 9 launched no K2 at {key}: {shapes['hh_chain']}")
    for name in ("fused_encode_hash", "fused_decode_hash"):
        if not launches[name]:
            fail(f"phase 9 launched no {name}")

    # the diag plane's smoke against a 2-worker pool on the card
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in ("MINIO_TPU_TORCH_DEVICE",
                                                             "MINIO_TPU_BACKEND")}
    env["TMPDIR"] = root
    proc = subprocess.run([sys.executable, "-m", "minio_tpu_torch.scripts.diag_smoke"],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=DIAG_SMOKE_S)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"diag_smoke exited {proc.returncode}: {proc.stderr[-3000:]}")
    step("diag_smoke", t0)
    # the pool's launches, by shape, join the shapes the kernel phase holds
    tag = "diag-smoke: launch shapes "
    pool = _launch_shapes(json.loads(next(
        ln for ln in proc.stdout.splitlines() if ln.startswith(tag))[len(tag):]))
    for name, per in pool.items():
        for key, n in per.items():
            shapes[name][key] = shapes[name].get(key, 0) + n
            launches[name] += n
    t["phase_s"] = time.perf_counter() - t_phase
    return {"launches": launches, "shapes": shapes, "seconds": t,
            "dryrun": {k: dry[k] for k in ("backend", "world", "seconds")},
            "dryrun_launches": {shape_name(k): n for k, n in dry["launches"].items()},
            "diag_pool_launches": {name: {shape_name(k): n for k, n in per.items()}
                                   for name, per in pool.items()},
            "diag_smoke": proc.stdout.strip().splitlines()[-1]}


# the reference's data-path suites on the card (module docstring, phase
# 10): the cases whose work reaches the kernels, in the order they run.
# Objects under one 1 MiB stripe block are coded on the host, so the cases
# were chosen by their launches on the card, not by their names (each
# segment-cache case here PUTs 2-4 MiB at EC 2+2: K1 at n = 524,288; the
# QoS lanes' 256-byte shards go to the bit-plane product and K2)
SUITE_CASES = (
    "test_torch_cache_segments.py::test_concurrent_overwrites_and_heals_never_serve_stale",
    "test_torch_cache_segments.py::test_two_touch_admission_then_fill_then_hit",
    "test_torch_cache_segments.py::test_partial_and_cross_segment_ranges_byte_identical",
    "test_torch_cache_segments.py::test_suffix_and_open_ended_hints_resolve",
    "test_torch_cache_segments.py::test_read_outside_hinted_range_falls_back",
    "test_torch_cache_segments.py::test_disabled_segments_knob_bypasses",
    "test_torch_cache_segments.py::test_overwrite_invalidates_segments_and_serves_new_bytes",
    "test_torch_cache_segments.py::test_delete_invalidates_segments",
    "test_torch_cache_segments.py::test_epoch_bump_revalidates_before_serving",
    "test_torch_cache_segments.py::test_demote_promote_roundtrip",
    "test_torch_cache_segments.py::test_disk_tier_disabled_evicts_instead",
    "test_torch_cache_segments.py::test_disk_read_error_falls_back_and_quarantines",
    "test_torch_cache_segments.py::test_disk_torn_write_detected_zero_wrong_bytes",
    "test_torch_dispatcher.py",
    "test_torch_qos.py::test_dispatch_priority_foreground_never_behind_background",
    "test_torch_qos.py::test_dispatch_background_rides_leftover_capacity",
    "test_torch_qos.py::test_dispatch_lone_foreground_skips_window_despite_bg_backlog",
    "test_torch_qos.py::test_dispatch_background_starvation_protection",
    "test_torch_qos.py::test_dispatch_priority_results_byte_identical",
    "test_torch_cauchy_suite.py::test_cauchy_encode_identity_numpy_xla_pallas",
    "test_torch_cauchy_suite.py::test_mixed_families_one_set_and_default_flip",
    "test_torch_cauchy_suite.py::test_heal_partial_repair_ingress",
    "test_torch_cauchy_suite.py::test_degraded_ranged_get_partial_reads",
    "test_torch_cauchy_suite.py::test_streaming_put_cauchy_roundtrip",
    "test_torch_cauchy_suite.py::test_multipart_family_pins_at_initiation",
    "test_torch_cauchy_suite.py::test_multipart_legacy_upload_defaults_to_rs",
    # sets the numpy backend itself: run on the card, its launches not counted on
    "test_torch_cauchy_suite.py::test_obs_records_carry_family",
    # the port's card-only cases, the whole file
    "test_torch_card.py",
    # the degradation ladder under injected device faults, and a slow batch
    # (the port's versions: the reference's build its XLA dispatcher)
    "test_torch_chaos.py::test_backend_degradation_round_trip",
    "test_torch_chaos.py::test_tpu_slow_batch_injection",
    # the erasure set (EC 2+2 at n = 524,288; 8+8), whole-file bitrot,
    # multipart, the metadata cache
    "test_torch_erasure_set.py::test_put_get_roundtrip[3145745]",
    "test_torch_erasure_set.py::test_range_reads",
    "test_torch_erasure_set.py::test_read_window_one",
    "test_torch_erasure_set.py::test_read_fails_beyond_parity",
    "test_torch_erasure_set.py::test_degraded_read_one_drive_gone",
    "test_torch_erasure_set.py::test_degraded_read_bitrot_corruption",
    "test_torch_erasure_set.py::test_degraded_read_ec8_two_drives_down",
    "test_torch_erasure_set.py::test_heal_object_missing_shard",
    "test_torch_erasure_set.py::test_heal_object_corrupted_shard",
    "test_torch_erasure_set.py::test_heal_commit_sweeps_staging_on_rename_failure",
    "test_torch_whole_file_bitrot.py::test_whole_file_get_roundtrip",
    "test_torch_whole_file_bitrot.py::test_whole_file_ranged_reads",
    "test_torch_whole_file_bitrot.py::test_whole_file_bitrot_detected_and_tolerated",
    "test_torch_whole_file_bitrot.py::test_whole_file_heal_preserves_format",
    "test_torch_multipart.py::test_multipart_roundtrip",
    "test_torch_cache.py::test_dead_set_entries_reclaim_first_under_pressure",
    # storage faults: GETs around down and dying drives and a straggler
    # (their PUTs K1 at 4+4; the reads decode on the host), a drive-failure storm
    "test_torch_fault_injection.py::test_get_reconstructs_across_down_matrix[1]",
    "test_torch_fault_injection.py::test_get_reconstructs_across_down_matrix[2]",
    "test_torch_fault_injection.py::test_get_reconstructs_across_down_matrix[3]",
    "test_torch_fault_injection.py::test_get_reconstructs_across_down_matrix[4]",
    "test_torch_fault_injection.py::test_drive_dying_mid_read",
    "test_torch_chaos.py::test_hedged_read_decodes_around_straggler",
    "test_torch_chaos.py::test_drive_failure_storm_family_ingress",
    # streaming PUT and the zero-copy arenas: the numpy-* variants of
    # test_streaming_put_byte_identity launch nothing and are left out, as
    # is test_dispatcher_exact_fit_arena_direct, which holds the port
    # against the reference's JAX route in its own body (the card's
    # machine has no JAX)
    "test_torch_streaming_put.py::test_streaming_put_roundtrip",
    "test_torch_streaming_put.py::test_iter_encode_matches_encode_part",
    "test_torch_streaming_put.py::test_http_streaming_put_and_multipart",
    "test_torch_streaming_put.py::test_http_signed_payload_still_buffers",
    "test_torch_streaming_put.py::test_streaming_sse_header_falls_back_to_encrypting",
    "test_torch_zerocopy.py::test_streaming_put_byte_identity[jax-reedsolomon]",
    "test_torch_zerocopy.py::test_streaming_put_byte_identity[jax-cauchy]",
    "test_torch_zerocopy.py::test_iter_encode_zc_matches_legacy_shards[reedsolomon]",
    "test_torch_zerocopy.py::test_iter_encode_zc_matches_legacy_shards[cauchy]",
    "test_torch_zerocopy.py::test_degraded_get_byte_identity[reedsolomon]",
    "test_torch_zerocopy.py::test_degraded_get_byte_identity[cauchy]",
    "test_torch_zerocopy.py::test_streaming_put_staging_zero",
    "test_torch_zerocopy.py::test_mid_put_drive_failure_keeps_pool_clean",
    "test_torch_zerocopy.py::test_mid_get_invalidation_never_poisons_served_chunks",
    "test_torch_zerocopy.py::test_copy_site_obs_record",
    "test_torch_zerocopy.py::test_pallas_interpret_encode_from_arena_view",
    # the repair plane: cauchy 8+8 PUTs (K3 + K2); the repair runs on the host
    "test_torch_repair_plane.py::test_windowed_repair_ranges_across_windows",
    "test_torch_repair_plane.py::test_plan_hedges_on_straggling_helper",
    "test_torch_repair_plane.py::test_plan_block_falls_back_on_bitrot",
    "test_torch_repair_plane.py::test_heal_straggler_partial_repairs_and_reverifies",
    "test_torch_repair_plane.py::test_heal_corrupt_helper_falls_back_per_block",
    "test_torch_repair_plane.py::test_heal_serial_baseline_still_correct",
    "test_torch_repair_plane.py::test_overwrite_racing_plan_withdraws_cleanly",
)
# the cases that may launch no kernel; every other case must launch one
SUITE_IDLE = (
    "test_torch_cauchy_suite.py::test_obs_records_carry_family",  # the numpy backend
    "test_torch_dispatcher.py::test_dispatch_error_propagates",  # refused before a launch
    "test_torch_dispatcher.py::test_replaced_cases_are_the_ports",  # the file's own check
)
# the card's route for the suites (tests/test_torch_suites.RUNG)
CARD_RUNG = {"MINIO_TPU_BACKEND": "torch", "MINIO_TPU_TORCH_DEVICE": "cuda"}
# a dispatcher counter that moves only when the device route failed
SUITE_FAULTS = ("fused_failures", "device_faults", "demotions")
# the case that walks the degradation ladder on purpose, and the K1 shape
# of its base encode and of its first batch after the promotion
LADDER_CASE = "tests/test_torch_chaos.py::test_backend_degradation_round_trip"
LADDER_K1 = ("encode", 2, 4, 2, 1024)


def suite_entry_runs(entry: str, nodeid: str) -> bool:
    """Whether the case ``nodeid`` (relative to the repo's root) is one
    that the ``SUITE_CASES`` entry names: the case, a parameter of it, or
    any case of a whole file."""
    want = f"tests/{entry}"
    if "::" not in entry:
        return nodeid.startswith(f"{want}::")
    return nodeid == want or nodeid.startswith(f"{want}[")


def suite_faults(case, s0: dict, s1: dict) -> list:
    """What the suite phase refuses in one dispatcher's counters, from
    ``s0`` before the phase to ``s1`` after it; ``case`` is the node id
    of the case that built it (None: built before the phase). Every fault
    counter stays put, except in the ladder case's dispatchers, which must
    walk the ladder as the case asserts: two device faults or more, one
    demotion, a probe and a promotion, and no fused-kernel failure."""
    moved = {f: s1[f] - s0[f] for f in (*SUITE_FAULTS, "promotions", "probes")}
    if case != LADDER_CASE:
        return [f"{f} moved by {moved[f]}" for f in SUITE_FAULTS if moved[f]]
    want = {"fused_failures": moved["fused_failures"] == 0,
            "device_faults": moved["device_faults"] >= 2, "demotions": moved["demotions"] == 1,
            "promotions": moved["promotions"] >= 1, "probes": moved["probes"] >= 1}
    return [f"{f} moved by {moved[f]}" for f, ok in want.items() if not ok]


def suite_phase(torch, mods, root: str) -> dict:
    """The reference's data-path suites on the card (module docstring,
    phase 10)."""
    import types

    import pytest

    from minio_tpu_torch import fault
    from minio_tpu_torch.fault import registry
    from minio_tpu_torch.parallel import dispatcher

    env = dict(os.environ)
    # the repository's tests, whatever other "tests" package the host has
    prev_tests = sys.modules.get("tests")
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(HERE, "tests")]
    sys.modules["tests"] = pkg
    # every dispatcher the cases reach: the registry's and those they
    # build, each with the case that built it
    current: dict = {"case": None}
    reached = {id(d): (d, d.stats_snapshot(), None) for d in dispatcher._dispatchers.values()}
    init, clear, emit = dispatcher.DeviceDispatcher.__init__, fault.clear, registry.emit
    events: list = []  # (seconds, what, case): fault rules cleared, ladder moves

    def watched(self, *a, **kw):
        init(self, *a, **kw)
        reached[id(self)] = (self, self.stats_snapshot(), current["case"])

    def watched_clear(*a, **kw):
        events.append((time.perf_counter(), "clear", current["case"]))
        return clear(*a, **kw)

    def watched_emit(name, **fields):
        if name in ("backend.demote", "backend.promote"):
            events.append((time.perf_counter(), name, current["case"]))
        return emit(name, **fields)

    cases: list = []
    failed: list = []
    skipped: list = []

    class CaseClock:
        @pytest.hookimpl(hookwrapper=True)
        def pytest_runtest_protocol(self, item, nextitem):
            l0, s0 = _counts(mods)
            current["case"] = item.nodeid
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
            current["case"] = None
            l1, s1 = _counts(mods)
            shapes = {name: {shape_name(k): n - s0[name].get(k, 0) for k, n in per.items()
                             if n != s0[name].get(k, 0)} for name, per in s1.items()}
            case = {"case": item.nodeid, "seconds": seconds,
                    "launches": {k: l1[k] - l0[k] for k in l1},
                    "shapes": {k: v for k, v in shapes.items() if v}}
            cases.append(case)
            print(f"suite case {item.nodeid}: {seconds:.2f} s launches "
                  f"{json.dumps(case['shapes'])}", flush=True)

        def pytest_runtest_logreport(self, report):
            if report.failed:
                failed.append(f"{report.nodeid} ({report.when})")
            elif report.skipped:
                skipped.append(f"{report.nodeid} ({report.when})")

    t_phase = time.perf_counter()
    dispatcher.DeviceDispatcher.__init__ = watched
    fault.clear, registry.emit = watched_clear, watched_emit
    try:
        from tests import test_torch_suites

        test_torch_suites.RUNG = dict(CARD_RUNG)
        _zero_counts(mods)
        rc = pytest.main(
            ["-q", "-p", "no:cacheprovider", "-p", "no:randomly", "--noconftest",
             "--rootdir", HERE, "--basetemp", os.path.join(root, "pytest"),
             "-W", "ignore::pytest.PytestUnknownMarkWarning"]
            + [os.path.join(HERE, "tests", c) for c in SUITE_CASES],
            plugins=[CaseClock()])
        launches, shapes = _counts(mods)  # counts read just after
    finally:
        dispatcher.DeviceDispatcher.__init__ = init
        fault.clear, registry.emit = clear, emit
        os.environ.clear()
        os.environ.update(env)
        if prev_tests is None:
            sys.modules.pop("tests", None)
        else:
            sys.modules["tests"] = prev_tests
    seconds = time.perf_counter() - t_phase
    missing = [e for e in SUITE_CASES if not any(suite_entry_runs(e, c["case"]) for c in cases)]
    if rc != 0 or failed or skipped or missing:
        fail(f"the suite phase: pytest exit {rc}, failed {failed}, skipped {skipped}, "
             f"not run {missing}")
    idle = [c["case"] for c in cases
            if not any(c["launches"].values()) and c["case"][len("tests/"):] not in SUITE_IDLE]
    if idle:
        fail(f"the suite phase: these cases launched no kernel on the card: {idle}")
    for name in launches:
        if not launches[name]:
            fail(f"the suite phase launched no {name}: {launches}")
    stats = {}
    ladder = {}
    for d, s0, case in reached.values():
        s1 = d.stats_snapshot()
        key = f"{d.codec.data_shards}+{d.codec.parity_shards} n={d.n}"
        bad = suite_faults(case, s0, s1)
        if bad:
            fail(f"dispatcher {key} built by {case}: {', '.join(bad)} in the suite phase")
        moved = {f: s1[f] - s0[f] for f in ("dispatches", "blocks", "fused", "numpy_blocks",
                                             "pad_blocks")}
        moved["max_batch"] = s1["max_batch"]  # over the dispatcher's life
        if moved["dispatches"]:
            stats.setdefault(key, []).append(moved)
        if case == LADDER_CASE:
            ladder[key] = {f: s1[f] - s0[f] for f in (*SUITE_FAULTS, "promotions", "probes",
                                                      "numpy_blocks", "fused")}
    if not ladder:
        fail(f"the suite phase: {LADDER_CASE} built no dispatcher")
    k1 = next(c for c in cases if c["case"] == LADDER_CASE)["shapes"].get(
        "fused_encode_hash", {}).get(shape_name(LADDER_K1), 0)
    if k1 < 2:
        fail(f"the ladder case launched K1 {shape_name(LADDER_K1)} {k1} times (want >= 2: "
             f"the base encode and the batch after the promotion)")
    mine = [(t, what) for t, what, case in events if case == LADDER_CASE]
    promoted = [t for t, what in mine if what == "backend.promote"]
    cleared = [t for t, what in mine if what == "clear" and promoted and t <= promoted[0]]
    ladder = {"dispatchers": ladder, "k1_launches": {shape_name(LADDER_K1): k1},
              "clear_to_promote_s": promoted[0] - cleared[-1] if cleared else None}
    print(json.dumps({"ladder": ladder}), flush=True)
    jax_mods = sorted(m for m in sys.modules if m == "minio_tpu" or m.startswith("minio_tpu."))
    if jax_mods:
        fail(f"the suite phase imported the JAX package: {jax_mods[:8]}")
    return {"launches": launches, "shapes": shapes, "seconds": {"phase_s": seconds},
            "cases": cases, "stats": stats, "ladder": ladder}


def main(argv: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "minio_tpu_torch", "csrc")):
        print("chip_smoke: minio_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.environ.pop("MINIO_TPU_TORCH_DEVICE", None)  # the card, as deployed
    os.environ.pop("MINIO_TPU_BACKEND", None)
    # the object phase checks the erasure data path itself: with the
    # read cache on, a re-read could be served from host memory
    os.environ["MINIO_TPU_CACHE"] = "0"
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    import importlib.util

    # the optional packages the host has: the port reaches each only
    # through a lazy import, and the S3 phase needs none of them. The
    # aiohttp entry decides whether the port keeps its own HTTP front
    # (server/web.py) or serves its handlers on aiohttp (ROADMAP Queue 3)
    print(json.dumps({"packages": {m: importlib.util.find_spec(m) is not None for m in (
        "aiohttp", "msgpack", "cryptography", "yaml", "pyarrow")}}), flush=True)

    from minio_tpu_torch.ops import (
        _build, bitrot_cuda, bitrot_torch, cauchy, fused_cuda, gf, gf_cuda, highwayhash, rs,
        rs_cuda, rs_torch,
    )

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    mods = {"_build": _build, "fc": fused_cuda, "bc": bitrot_cuda, "bt": bitrot_torch,
            "rs": rs, "rt": rs_torch, "gf": gf, "hh": highwayhash, "k3": rs_cuda,
            "cauchy": cauchy, "gc": gf_cuda}
    obj = cph = dur = s3 = clu = gw = san = gr = su = None
    if "--gf" in argv:
        print(json.dumps({"gf_small_batch": gf_small_batch(torch, mods)}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                  "count": torch.cuda.device_count()}}))
        return 0
    if "--kernels" in argv:
        # no main path run: the shapes it would give, launches not measured
        shapes = {k: dict.fromkeys(v) for k, v in DEFAULT_SHAPES.items()}
        launches = dict.fromkeys(shapes)
    else:
        phases = []
        for phase in (object_phase, cauchy_phase, durability_phase, s3_phase, cluster_phase,
                      gateway_phase, sanitized_phase, graft_phase, suite_phase):
            root = tempfile.mkdtemp(prefix="chip_smoke_drives_", dir=HERE)
            try:
                phases.append(phase(torch, mods, root))
            finally:
                shutil.rmtree(root, ignore_errors=True)
                for k in ("MINIO_TPU_EC_FAMILY", "MINIO_TPU_DEVICE_HEAL"):
                    os.environ.pop(k, None)
        obj, cph, dur, s3, clu, gw, san, gr, su = phases
        # each path's own counts, read just after it ran, summed per kernel
        shapes = {k: {} for k in DEFAULT_SHAPES}
        launches = dict.fromkeys(DEFAULT_SHAPES, 0)
        for ph in phases:
            for name, per in ph["shapes"].items():
                for key, n in per.items():
                    shapes[name][key] = shapes[name].get(key, 0) + n
            for name, n in ph["launches"].items():
                launches[name] += n
    # the kernels against their plain versions at the main path's shapes;
    # these launches come after the counts were read and are not counted
    kres = kernel_phase(torch, mods, shapes)
    meta = {
        "fused_encode_hash": ("minio_tpu_torch/csrc/fused_encode_hash.cu",
                              "minio_tpu/ops/fused_pallas.py:301"),
        "fused_decode_hash": ("minio_tpu_torch/csrc/fused_encode_hash.cu",
                              "minio_tpu/ops/fused_pallas.py:315"),
        "hh_chain": ("minio_tpu_torch/csrc/hh_chain.cu", "minio_tpu/ops/bitrot_pallas.py:66"),
        "gf_apply": ("minio_tpu_torch/csrc/gf_apply.cu", "minio_tpu/ops/rs_pallas.py:75"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        r = kres[name]["main"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": kres[name]["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
        })
    if obj:
        print(json.dumps({"dispatcher_stats": obj["stats"], "decode_stats": obj["decode_stats"]}))
        print(json.dumps({"object_phase_seconds": obj["seconds"],
                          "object_bytes": obj["total_bytes"], "build_s": build_s,
                          "lone_put_launches": obj["lone_put_launches"]}))
        print(json.dumps({"cauchy_phase": {
            k: cph[k] for k in ("launches", "lone_put_launches", "stats", "family_stats",
                                "repair", "seconds", "total_bytes")}}))
        print(json.dumps({"durability_phase": {
            k: dur[k] for k in ("launches", "drain_launches", "decommission", "lanes",
                                "fresh_drive_heal_k1_decode", "mrf", "deep_scan", "usage",
                                "seconds")},
            "durability_shapes": {name: {shape_name(k): n for k, n in per.items()}
                                  for name, per in dur["shapes"].items()}}))
        print(json.dumps({"fresh_drive_heal_s": dur["fresh_drive_heal_s"], "card": card}))
        print(json.dumps({"s3_phase": dict(
            {k: s3[k] for k in ("seconds", "bytes", "launches", "stats", "scraped",
                                "streaming_puts", "transitioned")},
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in s3["shapes"].items()}, card=card)}))
        print(json.dumps({"cluster_phase": dict(
            {k: clu[k] for k in ("online", "seconds", "bytes", "launches", "nodes", "heal",
                                 "restored_files", "speedtest_knee", "exits", "libcuda_mapped")},
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in clu["shapes"].items()}, card=card)}))
        print(json.dumps({"gateway_phase": dict(
            {k: gw[k] for k in ("seconds", "bytes", "launches", "node",
                                "degraded_k1_decode_launches", "console", "exit")},
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in gw["shapes"].items()}, card=card)}))
    if san:
        # the same steps of phase 5 (in process, no sanitizer) beside the
        # sanitized node's, as MiB/s: the witnesses' overhead, reported
        pairs = {"put_standard": (SAN_STD, S3_STD, 64), "get_standard": (SAN_STD, S3_STD, 64),
                 "put_rrs": (SAN_RRS, S3_RRS, 64), "get_rrs": (SAN_RRS, S3_RRS, 64),
                 "multipart": (S3_PARTS, S3_PARTS, 16), "degraded_get": (1, 1, 64)}
        def key(step, n, size):
            return f"{step}_{size}MiB_s" if n == 1 else f"{step}_{n}x{size}MiB_s"

        mibps = {step: {"phase8": n8 * size / san["seconds"][key(step, n8, size)],
                        "phase5": n5 * size / s3["seconds"][key(step, n5, size)]}
                 for step, (n8, n5, size) in pairs.items()}
        print(json.dumps({"sanitizer_phase": dict(
            {k: san[k] for k in ("seconds", "bytes", "launches", "node", "witnesses",
                                 "violations", "scraped", "stall_episodes", "stalls", "exit")},
            phase5_seconds=s3["seconds"], mib_per_s=mibps,
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in san["shapes"].items()}, card=card)}))
    if gr:
        print(json.dumps({"graft_phase": dict(
            {k: gr[k] for k in ("seconds", "launches", "dryrun", "dryrun_launches", "diag_smoke")},
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in gr["shapes"].items()}, card=card)}))
    if su:
        print(json.dumps({"suite_phase": dict(
            {k: su[k] for k in ("seconds", "launches", "cases", "stats", "ladder")},
            shapes={name: {shape_name(k): n for k, n in per.items()}
                    for name, per in su["shapes"].items()}, card=card)}))
    print(json.dumps({"kernel_shapes": {k: v["shapes"] for k, v in kres.items()}}))
    # K2's device time per packet round (n/32 rounds a message), and the
    # hash core's instructions per round in the hot loop
    rounds = {r["shape"]: r["ms"] * 1e6 / (int(r["shape"].rsplit("n=", 1)[1]) // 32)
              for r in kres["hh_chain"]["shapes"]
              if "ms" in r and int(r["shape"].rsplit("n=", 1)[1]) >= 32}
    aligned, odd, same = (rounds[f"alignment pair: rows=8192 n={n}"] for n in (
        65536, -(-MIB // 12) // 2, (-(-MIB // 12) // 2) & ~31))
    cat, slab = (rounds[f"slab pair: rows=16 pitch={p} n={-(-MIB // 12)}"]
                 for p in (-(-MIB // 12), mods["bt"].pitch(-(-MIB // 12))))
    print(json.dumps({"k2_ns_per_round": rounds, "unaligned_over_aligned": odd / aligned,
                      "unaligned_over_aligned_same_length": odd / same,
                      "ec4_block_ns_per_round": {"back_to_back": cat, "slab_pitch": slab}}))
    k3_odd, k3_aligned = (next(r["ms"] for r in kres["gf_apply"]["shapes"] if r["shape"] == (
        f"alignment pair: {shape_name((256, 24, 8, h, 2))}")) for h in K3_PAIR)
    print(json.dumps({"k3_unaligned_over_aligned": k3_odd / k3_aligned}))
    regs = gf_core_registers(_build.logs)
    print(json.dumps({"gf_core_registers": regs}))
    for lib, insts in regs.items():
        for i in insts or ():
            cap = gf_cuda.registers(i["entry"], i["small"])
            if i["registers"] > cap or i["spill_stores"] or i["spill_loads"]:
                fail(f"{lib}: gf_core_kernel<{i['entry']}, {i['cols']}, {i['small']}> takes"
                     f" {i['registers']} registers (plan: {cap}) and spills"
                     f" {i['spill_stores']}/{i['spill_loads']} bytes")
    print(json.dumps({"gf_conflict_ratio": gf_conflict_ratio(torch, mods, shapes)}))
    print(json.dumps({"gf_waves": gf_waves(torch, mods, shapes)}))
    print(json.dumps({"gf_small_batch": gf_small_batch(torch, mods)}))
    print(json.dumps({"sass_per_round": {
        name: sass_per_round(os.path.join(_build.BUILD, f"lib{name}.so"), rows)
        for name, rows in (("hh_chain", "ContigRows"), ("fused_encode_hash", "FusedRows"))}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
