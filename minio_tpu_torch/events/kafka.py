"""Kafka event sink: a minimal produce-only client on the raw protocol.

The reference's target (internal/event/target/kafka.go:176) uses sarama;
this speaks the modern wire format directly: Produce v3 requests carrying
a v2 record batch (varint records, CRC32C over the batch body) with
acks=1, so any Kafka >= 0.11 broker accepts it — including 4.x brokers
that dropped the legacy message formats.

Events go to partition 0 of the configured topic. Multi-broker clusters
work through metadata-driven leader discovery: on (re)connect the client
asks the bootstrap broker (Metadata v0) who leads partition 0 and dials
that broker; a produce answered with NOT_LEADER_FOR_PARTITION /
LEADER_NOT_AVAILABLE — or a dropped connection — refreshes the metadata
and retries against the new leader instead of erroring into the
notifier's retry queue.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

from .notify import Target

from ..utils.checksum import crc32c  # CRC32C (Castagnoli), shared table


# ---- varints (zigzag, protobuf-style) --------------------------------------


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def varint(n: int) -> bytes:
    u = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | (0x80 if u else 0))
        if not u:
            return bytes(out)


def record_batch(value: bytes, timestamp_ms: int) -> bytes:
    """One v2 record batch holding a single record (null key, no headers)."""
    rec_body = (
        b"\x00"                      # attributes
        + varint(0)                  # timestamp delta
        + varint(0)                  # offset delta
        + varint(-1)                 # key length (null)
        + varint(len(value)) + value
        + varint(0)                  # headers count
    )
    record = varint(len(rec_body)) + rec_body
    # batch body from `attributes` onward is CRC'd
    body = (
        struct.pack(">hiqqqhii", 0, 0, timestamp_ms, timestamp_ms,
                    -1, -1, -1, 1)   # attrs, lastOffsetDelta, firstTs, maxTs,
                                     # producerId, producerEpoch, baseSeq, count
        + record
    )
    head = (
        struct.pack(">q", 0)                       # baseOffset
        + struct.pack(">i", len(body) + 4 + 1 + 4)  # batchLength (from PLE on)
        + struct.pack(">i", -1)                    # partitionLeaderEpoch
        + b"\x02"                                  # magic = 2
        + struct.pack(">I", crc32c(body))
    )
    return head + body


def _kstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


# Kafka error codes the client reacts to by re-resolving the leader
ERR_LEADER_NOT_AVAILABLE = 5
ERR_NOT_LEADER_FOR_PARTITION = 6
_LEADER_ERRS = (ERR_LEADER_NOT_AVAILABLE, ERR_NOT_LEADER_FOR_PARTITION)


def _parse_metadata_leader(resp: bytes, topic: str) -> tuple[str, int] | None:
    """Partition 0's leader (host, port) from a Metadata v0 response, or
    None when the topic/partition/leader is absent or errored."""
    off = 4  # correlation id
    nbrokers = struct.unpack(">i", resp[off:off + 4])[0]
    off += 4
    brokers: dict[int, tuple[str, int]] = {}
    for _ in range(nbrokers):
        node = struct.unpack(">i", resp[off:off + 4])[0]
        off += 4
        hlen = struct.unpack(">h", resp[off:off + 2])[0]
        host = resp[off + 2:off + 2 + hlen].decode()
        off += 2 + hlen
        port = struct.unpack(">i", resp[off:off + 4])[0]
        off += 4
        brokers[node] = (host, port)
    ntopics = struct.unpack(">i", resp[off:off + 4])[0]
    off += 4
    for _ in range(ntopics):
        terr = struct.unpack(">h", resp[off:off + 2])[0]
        off += 2
        tlen = struct.unpack(">h", resp[off:off + 2])[0]
        tname = resp[off + 2:off + 2 + tlen].decode()
        off += 2 + tlen
        nparts = struct.unpack(">i", resp[off:off + 4])[0]
        off += 4
        leader_node = None
        for _ in range(nparts):
            _perr, pid, leader = struct.unpack(">hii", resp[off:off + 10])
            off += 10
            nrep = struct.unpack(">i", resp[off:off + 4])[0]
            off += 4 + 4 * nrep
            nisr = struct.unpack(">i", resp[off:off + 4])[0]
            off += 4 + 4 * nisr
            if pid == 0:
                leader_node = leader
        if tname == topic and terr == 0 and leader_node is not None:
            return brokers.get(leader_node)
    return None


class KafkaProduceError(OSError):
    """A produce answered with a non-zero Kafka error code."""

    def __init__(self, code: int):
        super().__init__(f"kafka produce error code {code}")
        self.code = code


class KafkaTarget(Target):
    """Produce v3 / acks=1 to partition 0 of one topic, with
    metadata-driven partition-leader discovery."""

    def __init__(self, ident: str, broker: str, topic: str):
        host, _, port = broker.partition(":")
        self.host, self.port = host, int(port or 9092)  # bootstrap broker
        self.arn = f"arn:minio:sqs::{ident}:kafka"
        self.topic = topic
        self._sock: socket.socket | None = None
        self._leader: tuple[str, int] | None = None  # discovered leader
        self._corr = 0
        self._mu = threading.Lock()

    def _connect(self) -> socket.socket:
        host, port = self._leader or (self.host, self.port)
        s = socket.create_connection((host, port), timeout=5)
        s.settimeout(5)
        return s

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- leader discovery (Metadata v0) -----------------------------------

    def _refresh_leader(self) -> None:
        """Ask the BOOTSTRAP broker who currently leads partition 0 of
        the topic and remember its address; any failure (old broker,
        bootstrap down) clears the discovery so the next connect falls
        back to the bootstrap address itself."""
        try:
            s = socket.create_connection((self.host, self.port), timeout=5)
        except OSError:
            self._leader = None
            return
        try:
            s.settimeout(5)
            self._corr += 1
            body = struct.pack(">i", 1) + _kstr(self.topic)  # 1 topic
            header = (
                struct.pack(">hhi", 3, 0, self._corr)  # Metadata, v0
                + _kstr("minio-tpu")
            )
            msg = header + body
            s.sendall(struct.pack(">i", len(msg)) + msg)
            size = struct.unpack(">i", self._recv(s, 4))[0]
            resp = self._recv(s, size)
            self._leader = _parse_metadata_leader(resp, self.topic)
        except (OSError, struct.error, IndexError):
            self._leader = None
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _produce(self, s: socket.socket, value: bytes) -> None:
        self._corr += 1
        batch = record_batch(value, int(time.time() * 1000))
        partition_data = struct.pack(">i", 0) + struct.pack(">i", len(batch)) + batch
        topic_data = _kstr(self.topic) + struct.pack(">i", 1) + partition_data
        body = (
            struct.pack(">h", -1)        # transactional_id = null
            + struct.pack(">h", 1)       # acks = 1
            + struct.pack(">i", 10000)   # timeout ms
            + struct.pack(">i", 1)       # 1 topic
            + topic_data
        )
        header = (
            struct.pack(">hhi", 0, 3, self._corr)  # Produce, v3, correlation
            + _kstr("minio-tpu")
        )
        msg = header + body
        s.sendall(struct.pack(">i", len(msg)) + msg)
        # response: size, correlation, [topics: name, [part, err(2), offset(8),
        # logAppendTime(8)]], throttle
        size = struct.unpack(">i", self._recv(s, 4))[0]
        resp = self._recv(s, size)
        corr = struct.unpack(">i", resp[:4])[0]
        if corr != self._corr:
            raise OSError(f"kafka correlation mismatch {corr} != {self._corr}")
        off = 4 + 4  # correlation + topic array count
        tlen = struct.unpack(">h", resp[off:off + 2])[0]
        off += 2 + tlen + 4 + 4  # topic name + partition array count + index
        err = struct.unpack(">h", resp[off:off + 2])[0]
        if err != 0:
            raise KafkaProduceError(err)

    @staticmethod
    def _recv(s: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise OSError("kafka connection closed")
            buf += chunk
        return buf

    def send(self, record: dict) -> None:
        payload = json.dumps(
            {"EventName": record["eventName"],
             "Key": f"{record['s3']['bucket']['name']}/{record['s3']['object']['key']}",
             "Records": [record]}
        ).encode()
        self.send_raw(payload)

    def send_raw(self, payload: bytes) -> None:
        """Produce an arbitrary payload (audit log records ride the same
        client as event notifications). NOT_LEADER / LEADER_NOT_AVAILABLE
        answers and dropped connections re-resolve the partition leader
        from the bootstrap broker's metadata and retry; anything still
        failing after that propagates into the notifier's retry queue."""
        with self._mu:
            last: Exception | None = None
            for attempt in range(3):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._produce(self._sock, payload)
                    return
                except KafkaProduceError as e:
                    last = e
                    self._close()
                    if e.code not in _LEADER_ERRS:
                        raise  # a real produce error: no leader to chase
                    self._refresh_leader()
                except Exception as e:  # noqa: BLE001 — conn died: retry
                    last = e
                    self._close()
                    if attempt > 0:
                        # second consecutive connection failure: the
                        # leader we know may be gone — re-discover
                        self._refresh_leader()
            raise last if last is not None else OSError("kafka send failed")
