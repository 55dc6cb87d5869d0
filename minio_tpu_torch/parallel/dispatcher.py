"""Device batching dispatcher — many requests, one device dispatch.

The north-star architecture (SURVEY.md §7, BASELINE.json): concurrent
PutObject calls each produce independent fixed-shape 1 MiB stripe blocks;
instead of one device call per block, a dispatcher thread packs every
block that arrives within a short window into a single fused
encode+bitrot dispatch ([B, d, n] -> parity + digests) and fans results
back to the waiting request threads. The reference's analogue is the
per-request AVX loop (cmd/erasure-encode.go:76) — batching is what the
accelerator changes about the architecture.

The device is the codec's torch device (the H100 in production, the CPU
in tests, where every kernel wrapper runs its plain version). Blocks move
host -> device with ``torch.from_numpy(...).to(device)`` and back with
``.cpu().numpy()``; on the bit-plane route each way is one pitched copy
into and out of the batch's shard slab (``bitrot_torch.shard_slab``).

A batch goes to the card at its own size: k blocks in, k blocks of
parity and digests out, on every route.

Latency contract: a block waits at most `window` (default 2 ms) before
dispatch; an idle queue dispatches immediately. p99 PUT latency gains the
window; a launch carries every block that arrived within it.

Priority lanes (qos/): foreground blocks (S3 PUT/GET handlers) and
background blocks (heal, scanner, decommission, rebalance — marked via
``qos.background_context()``) queue separately. Batch assembly always
drains foreground first; background work rides along only in leftover
batch capacity, capped at a fraction of the batch so a bg-heavy dispatch
cannot stretch foreground latency, with starvation protection: a
background block older than ``MINIO_TPU_QOS_BG_MAX_AGE_MS`` promotes to
the foreground lane so saturating PUT traffic cannot park heals forever.
The ``fg_deferred_behind_bg`` stat witnesses the invariant that no
foreground block ever waits behind background batch slots (it stays 0).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from .. import obs
from ..fault import registry as fault_registry
from ..ops import fused_cuda
from ..ops.bitrot_torch import shard_slab, to_numpy
from ..qos.context import PRI_BACKGROUND, PRI_FOREGROUND, current_priority

# backend degradation ladder (fault/ tpu boundary): fused CUDA kernel
# (K1) -> bit-plane torch product + chain kernel (K2) -> pure-numpy CPU.
# Injected faults (fault_registry.DeviceFault) walk it: kernel-fail skips
# K1 with backoff (fused_cuda.Gate), repeated device-lost demotes to
# numpy, and background probe batches re-promote. Cauchy batches have no
# fused rung: their device rung is the composite apply (K3) + K2. The
# numpy rung is byte-identical to the device rungs, so degraded mode
# changes latency, never payloads. A real kernel or CUDA error is not a
# rung: it fails the batch's waiters.
LEVEL_FUSED = 2
LEVEL_UNFUSED = 1
LEVEL_NUMPY = 0

# fixed histogram edges (seconds) for the metrics-v3 /api/tpu group: the
# queue-wait edges bracket the 2 ms batch window, the device edges the
# sub-ms..100 ms kernel range
QUEUE_WAIT_BUCKETS = (0.0005, 0.001, 0.002, 0.004, 0.008, 0.016, 0.05, 0.1, 0.5)
DEVICE_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5)
# dispatched batch sizes (blocks): each edge is the upper bound of its
# bucket; pre-seeded so the /api/tpu occupancy series exists from the
# first scrape
BUCKET_BLOCK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _hist_add(hist: list[int], edges: tuple, v: float) -> None:
    for i, edge in enumerate(edges):
        if v <= edge:
            hist[i] += 1
            return
    hist[-1] += 1


class DeviceDispatcher:
    """Batches fixed-shape [d, n] encode requests for one (d, p, n) shape."""

    def __init__(self, codec, n: int, window_s: float | None = None,
                 max_shards: int = 4096):
        from ..ops.bitrot_torch import encode_and_hash

        self.codec = codec
        self.n = n
        self.window = (
            float(os.environ.get("MINIO_TPU_BATCH_WINDOW_MS", "2")) / 1e3
            if window_s is None
            else window_s
        )
        # the device shard cap _collect enforces, in blocks
        self.max_blocks = max(1, max_shards // (codec.data_shards + codec.parity_shards))
        # background lane policy: bg blocks fill at most this many slots of
        # any one dispatch, and a bg block older than max_age promotes to
        # the foreground lane (starvation protection). Malformed env
        # values fall back to defaults — a QoS tuning typo must not take
        # down the encode plane (the dispatcher builds lazily on first PUT)
        try:
            frac = float(os.environ.get("MINIO_TPU_QOS_BG_FRACTION", "0.5"))
        except ValueError:
            frac = 0.5
        self.bg_max_blocks = max(1, min(self.max_blocks, int(self.max_blocks * frac)))
        try:
            self.bg_max_age = (
                float(os.environ.get("MINIO_TPU_QOS_BG_MAX_AGE_MS", "50")) / 1e3
            )
        except ValueError:
            self.bg_max_age = 0.05
        # whether K1 takes a batch; an injected kernel-fail backs off and
        # re-probes instead of disabling the kernel until restart
        self._gate = fused_cuda.Gate()
        self._encode_and_hash = encode_and_hash
        # degradation ladder state: consecutive device (device-rung)
        # failures past the threshold demote to the numpy rung; a probe
        # batch every `probe_after` dispatches re-promotes. Malformed env
        # values fall back — a chaos tuning typo must not kill encodes.
        try:
            self._demote_threshold = int(
                os.environ.get("MINIO_TPU_BACKEND_DEMOTE_FAULTS", "3")
            )
        except ValueError:
            self._demote_threshold = 3
        try:
            self._probe_after = int(
                os.environ.get("MINIO_TPU_BACKEND_PROBE_AFTER", "16")
            )
        except ValueError:
            self._probe_after = 16
        self._device_fault_streak = 0
        self._probe_countdown = self._probe_after
        self._shape = f"{codec.data_shards}+{codec.parity_shards}"
        # lazy per-family numpy codecs: the rung only pays when reached
        self._np_codec: dict[str, object] = {}
        self._cv = threading.Condition()
        # lanes hold (blocks, fut, priority, t_enqueue, trace_ctx, _, codec)
        # (slot 5 unused: the reference's tests enqueue items of this
        # layout by hand); unconsumed items stay at the head, so no
        # separate carry slot is needed
        self._fg: deque = deque()
        self._bg: deque = deque()
        # every key pre-seeded: observers (aggregate_stats, metrics) read
        # this dict from other threads, and a lazily-inserted key would
        # race their iteration ("dict changed size during iteration")
        self.stats = {
            "dispatches": 0, "blocks": 0, "max_batch": 0,
            "fg_blocks": 0, "bg_blocks": 0, "bg_forced": 0,
            "bg_batch_max": 0, "fg_deferred_behind_bg": 0,
            "fused": 0, "fused_failures": 0,
            # degradation ladder (metrics-v3 /api/fault): current rung,
            # device-fault streak witnesses, demote/promote transitions.
            # The gauge is a FAULT signal: 2 = healthy (fused serving, or
            # fused benignly inapplicable — disabled, unsupported shape),
            # 1 = fused faulted out (bit-plane serving), 0 = device gone (numpy)
            "backend_level": LEVEL_FUSED,
            "device_faults": 0, "demotions": 0, "promotions": 0, "probes": 0,
            "numpy_blocks": 0,
            # kernel-level timing (metrics-v3 /api/tpu): host orchestration
            # vs device execute split + per-item queue wait
            "occupancy_pct_sum": 0.0, "host_s": 0.0, "device_s": 0.0,
            "queue_wait_s": 0.0,
            "queue_wait_hist": [0] * (len(QUEUE_WAIT_BUCKETS) + 1),
            "device_time_hist": [0] * (len(DEVICE_TIME_BUCKETS) + 1),
            # zero-copy batch assembly: dispatched batch sizes, blocks
            # of pad (always 0: a batch goes at its own size; kept for
            # the reference's metric), and single-entry dispatches that
            # skipped the arena entirely (the caller's array went
            # straight to the device — the streaming-PUT steady state)
            "pad_blocks": 0, "arena_direct": 0,
            "bucket_hist": [0] * (len(BUCKET_BLOCK_BUCKETS) + 1),
        }
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"device-dispatch-{codec.data_shards}+{codec.parity_shards}",
        )
        self._thread.start()

    def stats_snapshot(self) -> dict:
        """Consistent copy of the stats dict for observers (metrics,
        admin, QoS): the dispatcher thread mutates `stats` under `_cv`,
        so a snapshot taken under the same lock can never observe a
        torn histogram or a mid-batch counter mix (miniovet races
        pass)."""
        with self._cv:
            return {
                k: (list(v) if isinstance(v, list) else v)
                for k, v in self.stats.items()
            }

    def submit(
        self, blocks: np.ndarray, priority: int | None = None, codec=None
    ) -> Future:
        """blocks: [k, d, n] -> Future of (shards [k, t, n], digests).

        priority: PRI_FOREGROUND / PRI_BACKGROUND; None resolves from the
        qos context (background planes run under ``background_context()``).

        codec: the family codec encoding this entry (defaults to the
        dispatcher's founding reedsolomon codec). Both code families ride
        ONE queue stream — each batch entry carries its family tag, and
        the dispatch loop groups same-family entries into shared device
        calls. Digest shape is the family's: [k, t, 32] for reedsolomon,
        [k, t, 2, 32] (per sub-chunk) for cauchy.
        """
        if priority is None:
            priority = current_priority()
        if codec is None:
            codec = self.codec
        fut: Future = Future()
        # trace context (request id, submitter's span) captured at submit
        # time (contextvar — one read only while spans are kept) so the
        # batch record can name the requests it served and the ring's
        # dispatch.queue spans join each request's tree
        trace_ctx = obs.current_context() if obs.recording() else None
        item = (blocks, fut, priority, _monotonic(), trace_ctx, None, codec)
        with self._cv:
            (self._bg if priority == PRI_BACKGROUND else self._fg).append(item)
            self._cv.notify()
        return fut

    def encode(self, blocks: np.ndarray, priority: int | None = None, codec=None):
        return self.submit(blocks, priority, codec).result()

    # -- worker ------------------------------------------------------------

    @staticmethod
    def _drain_locked(dq: deque, batch: list, room: int, force: bool = False) -> int:
        """Move whole items from `dq` into `batch` while they fit `room`
        blocks; an oversize head stays queued (next dispatch) unless
        `force` and the batch is still empty — the first item of a
        dispatch may exceed the cap, exactly like the old carry logic.
        Returns blocks taken. Caller holds self._cv."""
        took = 0
        while dq:
            k = dq[0][0].shape[0]
            if k > room - took and not (force and not batch):
                break
            batch.append(dq.popleft())
            took += k
        return took

    def _promote_aged_locked(self, now: float) -> None:
        """Starvation protection: background items older than bg_max_age
        move to the foreground lane (they have waited long enough that
        'leftover capacity only' would become 'never')."""
        while self._bg and now - self._bg[0][3] > self.bg_max_age:
            item = self._bg.popleft()
            self._fg.append(item)
            self.stats["bg_forced"] += item[0].shape[0]

    def _collect(self) -> list[tuple]:
        batch: list[tuple] = []
        total = 0
        with self._cv:
            while not self._fg and not self._bg:
                self._cv.wait()
            self._promote_aged_locked(_monotonic())
            total += self._drain_locked(
                self._fg, batch, self.max_blocks - total, force=True
            )
        # the straggler window opens only on evidence of CONCURRENT
        # foreground traffic (>= 2 genuinely-foreground items queued
        # together, the old single-queue contract — age-promoted bg items
        # don't count). Pending or promoted bg work must not hold a lone
        # fg block hostage for the window — that would be exactly the
        # "foreground delayed by background" regression this lane exists
        # to prevent; bg fills leftover capacity below either way.
        native_fg = sum(1 for it in batch if it[2] == PRI_FOREGROUND)
        if native_fg > 1 and total < self.max_blocks:
            deadline = _monotonic() + self.window
            while total < self.max_blocks:
                timeout = deadline - _monotonic()
                if timeout <= 0:
                    break
                with self._cv:
                    if not self._fg:
                        self._cv.wait(timeout)
                    self._promote_aged_locked(_monotonic())
                    took = self._drain_locked(
                        self._fg, batch, self.max_blocks - total
                    )
                    total += took
                    if self._fg and took == 0:
                        # head item cannot fit the remaining room, which
                        # never grows: stop burning the window (and the
                        # CPU — waiting here would spin on every notify)
                        break
        with self._cv:
            # late fg arrivals still beat queued bg work — drained first
            # under the same lock that grants bg its leftover slots
            self._promote_aged_locked(_monotonic())
            total += self._drain_locked(
                self._fg, batch, self.max_blocks - total, force=not batch
            )
            if self._fg:
                room = 0  # fg still queued (capacity-bound): bg gets nothing
            else:
                room = min(self.max_blocks - total, self.bg_max_blocks)
            took_bg = self._drain_locked(
                self._bg, batch, room, force=not batch
            )
            total += took_bg
            if took_bg:
                self.stats["bg_batch_max"] = max(
                    self.stats["bg_batch_max"], took_bg
                )
                if self._fg:
                    # defensive witness for the acceptance invariant; by
                    # construction this never fires
                    self.stats["fg_deferred_behind_bg"] += 1
        return batch

    # -- degradation ladder ------------------------------------------------

    def _tpu_fault_hook(self) -> None:
        """Device-boundary fault injection (fault/ registry): slow-batch
        stalls the dispatch, device-lost raises so the whole device rung
        (bit-plane rung included) fails and the ladder demotes."""
        rule = fault_registry.check(
            "tpu", self._shape, "dispatch", modes=("device-lost", "slow-batch")
        )
        if rule is None:
            return
        if rule.mode == "slow-batch":
            fault_registry.sleep_latency(rule)
            return
        raise fault_registry.DeviceFault("injected device loss")

    def _device_fault(self, err: Exception) -> None:
        self._device_fault_streak += 1
        demoted = False
        with self._cv:
            self.stats["device_faults"] += 1
            if (
                self.stats["backend_level"] != LEVEL_NUMPY
                and self._device_fault_streak >= self._demote_threshold
            ):
                self.stats["backend_level"] = LEVEL_NUMPY
                self.stats["demotions"] += 1
                demoted = True
        if demoted:
            self._probe_countdown = self._probe_after
            fault_registry.emit(
                "backend.demote", shape=self._shape, to="numpy",
                fault=f"{type(err).__name__}: {err}",
            )

    def _probe_device(self) -> bool:
        """Synthetic probe batch through the device rung; the
        materialization IS the probe verdict. User traffic keeps riding
        numpy until a probe succeeds — a flapping device never fails a
        live request."""
        with self._cv:
            self.stats["probes"] += 1
        try:
            self._tpu_fault_hook()
            blocks = np.zeros((1, self.codec.data_shards, self.n), dtype=np.uint8)
            parity, digests = self._encode_and_hash(self.codec, blocks)
            to_numpy(parity)
            to_numpy(digests)
            return True
        # ladder probe: False means "stay demoted"; the synthetic batch
        # exists to absorb an injected fault (real errors propagate)
        except fault_registry.DeviceFault:
            return False

    def _encode_numpy(self, blocks: np.ndarray, family: str = "reedsolomon"):
        """Pure-CPU rung: numpy GF parity + numpy HighwayHash digests,
        byte-identical to the device rungs (golden tests pin all three).
        [k, d, n] -> (shards [k, t, n], family-shaped digests)."""
        ref = self._np_codec.get(family)
        if ref is None:
            if family == "cauchy":
                from ..ops.cauchy import get_codec
            else:
                from ..ops.rs import get_codec
            ref = self._np_codec[family] = get_codec(
                self.codec.data_shards, self.codec.parity_shards
            )
        from ..erasure.coder import encode_blocks_numpy

        return encode_blocks_numpy(ref, blocks, family)

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            t_start = _monotonic()
            # per-item queue wait: submit -> dispatch start (each family
            # group recomputes its own max for the obs record)
            with self._cv:
                for it in batch:
                    wait = max(t_start - it[3], 0.0)
                    self.stats["queue_wait_s"] += wait
                    _hist_add(
                        self.stats["queue_wait_hist"], QUEUE_WAIT_BUCKETS,
                        wait,
                    )
            # ONE stream, two families: entries carry their family tag;
            # same-family entries fuse into shared device calls, and a
            # mixed batch dispatches as consecutive per-family groups
            # (matrix weights differ — they cannot share one matmul).
            groups: dict[str, list[tuple]] = {}
            for it in batch:
                groups.setdefault(
                    getattr(it[6], "family", "reedsolomon"), []
                ).append(it)
            for family, items in groups.items():
                self._dispatch_group(items, family)

    def _dispatch_group(self, batch: list[tuple], family: str) -> None:
        from ..erasure import bufpool

        t_start = _monotonic()
        # the span ring's marks (ns): start, assembled, a device route's
        # phases (copy in, its end, the launches' return, the copies
        # out's end), the device phase's end
        ring = obs.ring()
        marks = [time.monotonic_ns()] if ring is not None else None
        dev_marks: list | None = [] if ring is not None else None
        arena_lease = None
        try:
            codec = batch[0][6]
            max_wait = max(
                (max(t_start - it[3], 0.0) for it in batch), default=0.0
            )
            # malformed input is a CALLER error: it must propagate to
            # the waiters, never count as a device fault or get
            # "served degraded" by the numpy rung
            for it in batch:
                if it[0].shape[1] != self.codec.data_shards:
                    raise ValueError(
                        f"blocks have d={it[0].shape[1]}, codec "
                        f"expects {self.codec.data_shards}"
                    )
            d = self.codec.data_shards
            p = self.codec.parity_shards
            n = batch[0][0].shape[2]
            k = sum(it[0].shape[0] for it in batch)
            if len(batch) == 1:
                # a single entry (the streaming-PUT steady state, and a
                # lone PUT's block): the caller's array — often a view of
                # the pooled ingest arena — goes straight to the device.
                # No concat, no arena.
                all_blocks = batch[0][0]
                with self._cv:
                    self.stats["arena_direct"] += 1
            else:
                # a pooled arena of exactly k blocks replaces a
                # per-dispatch np.concatenate: entries copy in once
                # (inherent — they arrive scattered), and the arena
                # recycles after the dispatch
                if bufpool.zerocopy_enabled():
                    arena_lease = bufpool.get_pool().acquire(k * d * n)
                    all_blocks = arena_lease.array[: k * d * n].reshape(k, d, n)
                else:
                    all_blocks = np.empty((k, d, n), dtype=np.uint8)
                off = 0
                for it in batch:
                    kk = it[0].shape[0]
                    all_blocks[off : off + kk] = it[0]
                    off += kk
                bufpool.count_copy("dispatch-concat", len(batch))
            with self._cv:
                _hist_add(self.stats["bucket_hist"], BUCKET_BLOCK_BUCKETS, k)
            _mark(marks)
            level = self.stats["backend_level"]
            if level == LEVEL_NUMPY:
                # degraded: traffic serves on CPU; every probe_after
                # dispatches a synthetic batch probes the device and
                # re-promotes on success
                self._probe_countdown -= 1
                if self._probe_countdown <= 0:
                    if self._probe_device():
                        level = LEVEL_UNFUSED
                        with self._cv:
                            self.stats["backend_level"] = level
                            self.stats["promotions"] += 1
                        self._device_fault_streak = 0
                        fault_registry.emit(
                            "backend.promote", shape=self._shape
                        )
                    else:
                        self._probe_countdown = self._probe_after
            was_fused = False
            shards = digests = None
            # device_s covers ONLY time spent against the device
            # (successful or faulted attempts) — the numpy rung and
            # the probe are host work and land in host_s, so the
            # host-vs-device split stays honest in degraded mode
            device_s = 0.0
            if level != LEVEL_NUMPY:
                t_dev = _monotonic()
                try:
                    self._tpu_fault_hook()
                    if family == "reedsolomon":  # K1's weights are RS
                        was_fused, fired = self._gate.admit(self._shape, d, p, n)
                        if fired:
                            with self._cv:
                                self.stats["fused_failures"] += 1
                    copy_in = codec.as_tensor
                    if was_fused:
                        def enc(_codec, data):
                            return fused_cuda.fused_encode_hash(data, d, p)
                    elif family == "cauchy":
                        from ..ops.cauchy import encode_and_hash_cauchy as enc
                    else:
                        # the bit-plane route's copy in fills the data
                        # rows of the batch's pitched shard slab
                        enc = self._encode_and_hash
                        copy_in = functools.partial(shard_slab, codec)
                    # the device phases: the copy in, its end, the
                    # launches' return, the copies out's end. The copy to
                    # host is the device sync point: execute + D2H land
                    # inside the device window, fan-out is host time
                    _mark(dev_marks)
                    data = copy_in(all_blocks)
                    _mark(dev_marks)
                    parity, digests = enc(codec, data)
                    _mark(dev_marks)
                    parity = to_numpy(parity)
                    digests = to_numpy(digests)
                    _mark(dev_marks)
                    if was_fused:
                        self._gate.succeeded()
                        with self._cv:
                            self.stats["fused"] += 1
                    shards = np.concatenate([all_blocks, parity], axis=1)  # [B, t, n]
                    self._device_fault_streak = 0
                    # gauge semantics: the bit-plane rung is a DEGRADATION signal only
                    # when the fused rung is faulted out (cooldown); a
                    # benign fused skip (unsupported shape,
                    # MINIO_TPU_FUSED_CM=0, cauchy family) reads healthy
                    with self._cv:
                        if self._gate.cooldown > 0:
                            self.stats["backend_level"] = LEVEL_UNFUSED
                        else:
                            self.stats["backend_level"] = LEVEL_FUSED
                # an injected device loss: _device_fault(e) records the
                # fault, demotes past the streak threshold, and the batch
                # is re-served byte-identically on the numpy rung below.
                # Any other error (a kernel that fails to build or
                # launch) reaches the waiters through the handler below.
                except fault_registry.DeviceFault as e:
                    self._device_fault(e)
                    was_fused = False
                    shards = None
                device_s = _monotonic() - t_dev
            if shards is None:
                shards, digests = self._encode_numpy(all_blocks, family)
                with self._cv:
                    self.stats["numpy_blocks"] += k
                route = "numpy"
            elif was_fused:
                route = "fused"
            else:
                route = "cauchy" if family == "cauchy" else "bitplane"
            _mark(marks)
            from ..erasure.coder import family_stats_add

            family_stats_add(family, "encode_blocks", k)
            occupancy = 100.0  # a batch goes to the card at its own size
            with self._cv:
                self.stats["dispatches"] += 1
                self.stats["blocks"] += k
                self.stats["max_batch"] = max(self.stats["max_batch"], k)
                self.stats["occupancy_pct_sum"] += occupancy
                self.stats["device_s"] += device_s
                _hist_add(
                    self.stats["device_time_hist"], DEVICE_TIME_BUCKETS,
                    device_s,
                )
                for it in batch:
                    kk = it[0].shape[0]
                    if it[2] == PRI_BACKGROUND:
                        self.stats["bg_blocks"] += kk
                    else:
                        self.stats["fg_blocks"] += kk
            off = 0
            for it in batch:
                blocks, fut = it[0], it[1]
                kk = blocks.shape[0]
                fut.set_result(
                    (shards[off : off + kk], digests[off : off + kk])
                )
                off += kk
            if ring is not None:
                _mark(marks)
                _ring_batch(ring, batch, marks, dev_marks, k * d * n, route)
            host_s = _monotonic() - t_start - device_s
            with self._cv:
                self.stats["host_s"] += host_s
            if obs.active():
                req_ids = sorted({it[4][0] for it in batch if it[4] and it[4][0]})
                obs.publish({
                    "time": time.time(),
                    "type": obs.TYPE_TPU,
                    "name": "dispatch.batch",
                    "reqId": req_ids[0] if len(req_ids) == 1 else "",
                    "reqIds": req_ids,
                    "node": obs.trace.NODE,
                    "durationNs": int((host_s + device_s) * 1e9),
                    "deviceNs": int(device_s * 1e9),
                    "hostNs": int(host_s * 1e9),
                    "queueWaitMaxNs": int(max_wait * 1e9),
                    "blocks": k,
                    "bucket": k,
                    "occupancyPct": round(occupancy, 1),
                    "fused": was_fused,
                    "family": family,
                    "shape": f"{self.codec.data_shards}+"
                             f"{self.codec.parity_shards}",
                    "error": "",
                })
        except Exception as e:  # noqa: BLE001 — fail all waiters
            for it in batch:
                if not it[1].done():
                    it[1].set_exception(e)
        finally:
            # results handed to waiters are always fresh arrays (the
            # shards concatenate / numpy-rung output), never arena
            # views — so the bucket arena recycles here unconditionally
            if arena_lease is not None:
                arena_lease.release()


def _monotonic() -> float:
    return time.monotonic()


def _mark(marks: list | None) -> None:
    if marks is not None:
        marks.append(time.monotonic_ns())


def _ring_batch(ring, batch: list[tuple], marks: list[int], dev: list[int],
                nbytes: int, route: str) -> None:
    """One served batch in the span ring: each item's ``dispatch.queue``
    (enqueue to dispatch start, under its request and submitter's span),
    and ``dispatch.batch``, labelled with the route that served it
    (``fused``, ``bitplane``, ``cauchy`` or ``numpy``), with its phases
    as children: ``assemble``, on every device route ``h2d``,
    ``kernels`` (to the launches' return) and ``d2h`` (the kernels' end
    and the copies out), and ``results`` (to the last future set)."""
    t0, t_asm, t_dev, t_end = marks
    reqs = {it[4][0] for it in batch if it[4]}
    req = reqs.pop() if len(reqs) == 1 else ""
    for it in batch:
        ctx = it[4] or ("", 0)
        ring.add("dispatch.queue", "", ctx[0], obs.next_span_id(), ctx[1],
                 int(it[3] * 1e9), t0, it[0].nbytes)
    bid = obs.next_span_id()
    ring.add("dispatch.batch", route, req, bid, 0, t0, t_end, nbytes)
    phases = [("dispatch.assemble", t0, t_asm)]
    if len(dev) == 4:
        phases += [("dispatch.h2d", dev[0], dev[1]),
                   ("dispatch.kernels", dev[1], dev[2]),
                   ("dispatch.d2h", dev[2], dev[3])]
        t_dev = dev[3]
    phases.append(("dispatch.results", t_dev, t_end))
    for name, a, b in phases:
        ring.add(name, "", req, obs.next_span_id(), bid, a, b)


_dispatchers: dict[tuple[int, int, int], DeviceDispatcher] = {}
_dlock = threading.Lock()


def get_dispatcher(codec, n: int) -> DeviceDispatcher:
    key = (codec.data_shards, codec.parity_shards, n, str(codec.device))
    d = _dispatchers.get(key)
    if d is None:
        with _dlock:
            d = _dispatchers.get(key)
            if d is None:
                d = _dispatchers[key] = DeviceDispatcher(codec, n)
    return d


def aggregate_stats() -> dict:
    """Summed stats across every live dispatcher (metrics/admin plane).
    Histogram lists sum element-wise; max-style gauges take the max.
    Reads per-dispatcher snapshots (taken under each dispatcher's lock)
    so a scrape racing a dispatch never mixes halves of one batch."""
    out: dict = {}
    for d in list(_dispatchers.values()):
        for k, v in d.stats_snapshot().items():
            if k == "backend_level":
                # most-degraded rung across shapes: the alarming signal
                out[k] = min(out.get(k, LEVEL_FUSED), v)
            elif k in ("max_batch", "bg_batch_max"):
                out[k] = max(out.get(k, 0), v)
            elif isinstance(v, list):
                cur = out.setdefault(k, [0] * len(v))
                for i, x in enumerate(v):
                    cur[i] += x
            else:
                out[k] = out.get(k, 0) + v
    return out
