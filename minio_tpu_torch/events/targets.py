"""Raw-socket event sink targets: NATS, Redis, MQTT (+ registration for
the PostgreSQL/MySQL sinks in dbsinks.py and the Kafka sink in kafka.py).

The reference ships 11 sink types under MinIO internal/event/
target/ (amqp, kafka, mqtt, nats, nsq, mysql, postgresql, redis,
elasticsearch, webhook + store). Each of ours speaks just enough of the
wire protocol to publish one event frame with zero extra dependencies,
holding a persistent connection that reconnects on error (the notifier's
retry queue handles transient failures).

Env config mirrors the reference's variable naming:
  MINIO_NOTIFY_NATS_ENABLE_<ID>=on   ..._ADDRESS_<ID>=host:port  ..._SUBJECT_<ID>=subj
  MINIO_NOTIFY_REDIS_ENABLE_<ID>=on  ..._ADDRESS_<ID>=host:port  ..._KEY_<ID>=key
  MINIO_NOTIFY_MQTT_ENABLE_<ID>=on   ..._BROKER_<ID>=host:port   ..._TOPIC_<ID>=topic
  MINIO_NOTIFY_POSTGRES_ENABLE_<ID>=on ..._CONNECTION_STRING_<ID>= ..._TABLE_<ID>=
  MINIO_NOTIFY_MYSQL_ENABLE_<ID>=on  ..._DSN_STRING_<ID>=u:p@tcp(h:p)/db ..._TABLE_<ID>=
  MINIO_NOTIFY_KAFKA_ENABLE_<ID>=on  ..._BROKERS_<ID>=host:port  ..._TOPIC_<ID>=topic
"""

from __future__ import annotations

import json
import socket
import threading

from .notify import Target


class _SocketTarget(Target):
    """Shared connect/reconnect plumbing for line-protocol sinks."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._mu = threading.Lock()

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port), timeout=5)
        s.settimeout(5)
        self._handshake(s)
        return s

    def _handshake(self, s: socket.socket) -> None:  # pragma: no cover
        pass

    def send(self, record: dict) -> None:
        payload = json.dumps(
            {"EventName": record["eventName"],
             "Key": f"{record['s3']['bucket']['name']}/{record['s3']['object']['key']}",
             "Records": [record]}
        ).encode()
        with self._mu:
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._publish(self._sock, payload)
            except Exception:
                # drop the broken conn; one immediate retry on a fresh one,
                # further failures go to the notifier's retry queue
                try:
                    if self._sock is not None:
                        self._sock.close()
                finally:
                    self._sock = None
                self._sock = self._connect()
                self._publish(self._sock, payload)

    def _publish(self, s: socket.socket, payload: bytes) -> None:
        raise NotImplementedError


def _parse_addr(addr: str, default_port: int) -> tuple[str, int]:
    if ":" in addr:
        h, p = addr.rsplit(":", 1)
        return h, int(p)
    return addr, default_port


class NATSTarget(_SocketTarget):
    """NATS text protocol: INFO <- / CONNECT -> / PUB subject len\\r\\n."""

    def __init__(self, ident: str, address: str, subject: str):
        super().__init__(*_parse_addr(address, 4222))
        self.arn = f"arn:minio:sqs::{ident}:nats"
        self.subject = subject

    def _handshake(self, s: socket.socket) -> None:
        f = s.makefile("rb")
        line = f.readline()  # INFO {...}
        if not line.startswith(b"INFO"):
            raise OSError(f"unexpected NATS greeting: {line[:40]!r}")
        s.sendall(b'CONNECT {"verbose":false,"pedantic":false,'
                  b'"name":"minio-tpu"}\r\n')

    def _publish(self, s: socket.socket, payload: bytes) -> None:
        s.sendall(
            f"PUB {self.subject} {len(payload)}\r\n".encode()
            + payload + b"\r\n"
        )


class RedisTarget(_SocketTarget):
    """RESP RPUSH <key> <event> (the reference's list format)."""

    def __init__(self, ident: str, address: str, key: str):
        super().__init__(*_parse_addr(address, 6379))
        self.arn = f"arn:minio:sqs::{ident}:redis"
        self.key = key

    def _publish(self, s: socket.socket, payload: bytes) -> None:
        kb = self.key.encode()
        msg = (
            b"*3\r\n$5\r\nRPUSH\r\n"
            + b"$" + str(len(kb)).encode() + b"\r\n" + kb + b"\r\n"
            + b"$" + str(len(payload)).encode() + b"\r\n" + payload + b"\r\n"
        )
        s.sendall(msg)
        resp = s.recv(64)
        if resp[:1] == b"-":
            raise OSError(f"redis error: {resp[:60]!r}")


class MQTTTarget(_SocketTarget):
    """MQTT 3.1.1 CONNECT + QoS0 PUBLISH (minimal client)."""

    def __init__(self, ident: str, broker: str, topic: str):
        super().__init__(*_parse_addr(broker, 1883))
        self.arn = f"arn:minio:sqs::{ident}:mqtt"
        self.topic = topic

    @staticmethod
    def _varint(n: int) -> bytes:
        out = bytearray()
        while True:
            b = n % 128
            n //= 128
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def _handshake(self, s: socket.socket) -> None:
        client_id = b"minio-tpu"
        var = (
            b"\x00\x04MQTT\x04\x02\x00\x3c"  # proto, level 4, clean session
            + len(client_id).to_bytes(2, "big") + client_id
        )
        s.sendall(b"\x10" + self._varint(len(var)) + var)
        ack = s.recv(4)
        if len(ack) < 4 or ack[0] != 0x20 or ack[3] != 0:
            raise OSError(f"MQTT CONNACK refused: {ack!r}")

    def _publish(self, s: socket.socket, payload: bytes) -> None:
        tb = self.topic.encode()
        var = len(tb).to_bytes(2, "big") + tb + payload
        s.sendall(b"\x30" + self._varint(len(var)) + var)


class NSQTarget(_SocketTarget):
    """NSQ TCP protocol: '  V2' magic + PUB <topic> frame (reference
    internal/event/target/nsq.go via go-nsq)."""

    def __init__(self, ident: str, address: str, topic: str):
        super().__init__(*_parse_addr(address, 4150))
        self.arn = f"arn:minio:sqs::{ident}:nsq"
        self.topic = topic

    def _handshake(self, s: socket.socket) -> None:
        s.sendall(b"  V2")

    @staticmethod
    def _read_frame(s: socket.socket) -> tuple[int, bytes]:
        head = b""
        while len(head) < 8:
            chunk = s.recv(8 - len(head))
            if not chunk:
                raise OSError("nsq connection closed")
            head += chunk
        size = int.from_bytes(head[:4], "big")
        ftype = int.from_bytes(head[4:], "big")
        data = b""
        while len(data) < size - 4:
            chunk = s.recv(size - 4 - len(data))
            if not chunk:
                raise OSError("nsq connection closed")
            data += chunk
        return ftype, data

    def _publish(self, s: socket.socket, payload: bytes) -> None:
        s.sendall(
            f"PUB {self.topic}\n".encode()
            + len(payload).to_bytes(4, "big") + payload
        )
        # consume frames until the PUB's own response: heartbeats between
        # sparse events are answered with NOP, never mistaken for the ack
        while True:
            ftype, data = self._read_frame(s)
            if data == b"_heartbeat_":
                s.sendall(b"NOP\n")
                continue
            if ftype == 1:
                raise OSError(f"nsq error response: {data[:60]!r}")
            return


class ElasticsearchTarget(Target):
    """Index events into Elasticsearch over its HTTP API (reference
    internal/event/target/elasticsearch.go): one document per event."""

    def __init__(self, ident: str, url: str, index: str):
        self.arn = f"arn:minio:sqs::{ident}:elasticsearch"
        self.url = url.rstrip("/")
        self.index = index

    def send(self, record: dict) -> None:
        import urllib.request

        body = json.dumps(
            {"timestamp": record.get("eventTime", ""),
             "event": [record],
             "key": f"{record['s3']['bucket']['name']}/{record['s3']['object']['key']}"}
        ).encode()
        req = urllib.request.Request(
            f"{self.url}/{self.index}/_doc", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        urllib.request.urlopen(req, timeout=5).read()


def socket_targets_from_env(env) -> dict[str, Target]:
    out: dict[str, Target] = {}
    for k, v in env.items():
        if v not in ("on", "true", "1"):
            continue
        ident = k.rsplit("_", 1)[-1]
        il = ident.lower()
        if k.startswith("MINIO_NOTIFY_NATS_ENABLE_"):
            addr = env.get(f"MINIO_NOTIFY_NATS_ADDRESS_{ident}", "")
            subj = env.get(f"MINIO_NOTIFY_NATS_SUBJECT_{ident}", "minio-events")
            if addr:
                t = NATSTarget(il, addr, subj)
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_REDIS_ENABLE_"):
            addr = env.get(f"MINIO_NOTIFY_REDIS_ADDRESS_{ident}", "")
            key = env.get(f"MINIO_NOTIFY_REDIS_KEY_{ident}", "minio-events")
            if addr:
                t = RedisTarget(il, addr, key)
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_MQTT_ENABLE_"):
            broker = env.get(f"MINIO_NOTIFY_MQTT_BROKER_{ident}", "")
            topic = env.get(f"MINIO_NOTIFY_MQTT_TOPIC_{ident}", "minio-events")
            if broker:
                t = MQTTTarget(il, broker, topic)
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_POSTGRES_ENABLE_"):
            from .dbsinks import PostgresTarget

            cs = env.get(f"MINIO_NOTIFY_POSTGRES_CONNECTION_STRING_{ident}", "")
            table = env.get(f"MINIO_NOTIFY_POSTGRES_TABLE_{ident}", "minio_events")
            if cs:
                d = PostgresTarget.parse_connection_string(cs)
                t = PostgresTarget(
                    il, d.get("host", "127.0.0.1"), int(d.get("port", 5432)),
                    d.get("user", "postgres"), d.get("password", ""),
                    d.get("dbname", d.get("user", "postgres")), table,
                )
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_MYSQL_ENABLE_"):
            from .dbsinks import MySQLTarget

            dsn = env.get(f"MINIO_NOTIFY_MYSQL_DSN_STRING_{ident}", "")
            table = env.get(f"MINIO_NOTIFY_MYSQL_TABLE_{ident}", "minio_events")
            if dsn:
                d = MySQLTarget.parse_dsn(dsn)
                t = MySQLTarget(
                    il, d["host"], d["port"], d["user"], d["password"],
                    d["database"], table,
                )
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_KAFKA_ENABLE_"):
            from .kafka import KafkaTarget

            brokers = env.get(f"MINIO_NOTIFY_KAFKA_BROKERS_{ident}", "")
            topic = env.get(f"MINIO_NOTIFY_KAFKA_TOPIC_{ident}", "minio-events")
            if brokers:
                t = KafkaTarget(il, brokers.split(",")[0].strip(), topic)
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_NSQ_ENABLE_"):
            addr = env.get(f"MINIO_NOTIFY_NSQ_NSQD_ADDRESS_{ident}", "")
            topic = env.get(f"MINIO_NOTIFY_NSQ_TOPIC_{ident}", "minio-events")
            if addr:
                t = NSQTarget(il, addr, topic)
                out[t.arn] = t
        elif k.startswith("MINIO_NOTIFY_ELASTICSEARCH_ENABLE_"):
            url = env.get(f"MINIO_NOTIFY_ELASTICSEARCH_URL_{ident}", "")
            index = env.get(
                f"MINIO_NOTIFY_ELASTICSEARCH_INDEX_{ident}", "minio-events"
            )
            if url:
                t = ElasticsearchTarget(il, url, index)
                out[t.arn] = t
    return out
