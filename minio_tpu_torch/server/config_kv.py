"""Dynamic config KV store.

Mirrors the reference's layered config system (internal/config/config.go +
cmd/config-current.go): subsystem-scoped key/value settings persisted in
the backend (.minio.sys/config/settings.json), readable/settable over the
admin API, and applied live for dynamic keys.
"""

from __future__ import annotations

import json
import threading

SYSTEM_BUCKET = ".minio.sys"
CONFIG_KEY = "config/settings.json"

# subsystem -> {key: default}  (mirrors MinIO internal/config/
# subsystem registry). Values persist and are served back; only a subset
# applies live today (scanner/heal workers) — the rest provide the
# reference's config surface so tooling round-trips cleanly.
DEFAULTS: dict[str, dict[str, str]] = {
    "scanner": {"interval": "300", "deep_verify": "off"},
    "compression": {"enable": "off", "extensions": "", "mime_types": ""},
    "heal": {"workers": "2"},
    "api": {"requests_max": "0", "cors_allow_origin": "*"},
    "storage_class": {"standard": "", "rrs": ""},
    "replication": {"workers": "2"},
    "batch": {"workers": "1"},
    "identity_openid": {
        "config_url": "", "client_id": "", "claim_name": "policy",
    },
    "identity_ldap": {
        "server_addr": "", "lookup_bind_dn": "", "lookup_bind_password": "",
        "user_dn_search_base_dn": "", "user_dn_search_filter": "",
        "group_search_base_dn": "", "group_search_filter": "",
        # TLS by default (as the reference); plaintext needs an explicit
        # server_insecure=on
        "server_insecure": "off", "tls_skip_verify": "off",
    },
    "notify_webhook": {"enable": "off", "endpoint": "", "auth_token": ""},
    "notify_nats": {"enable": "off", "address": "", "subject": "minio-events"},
    "notify_redis": {"enable": "off", "address": "", "key": "minio-events"},
    "notify_mqtt": {"enable": "off", "broker": "", "topic": "minio-events"},
    "notify_kafka": {"enable": "off", "brokers": "", "topic": "minio-events"},
    "notify_amqp": {"enable": "off", "url": "", "exchange": "", "routing_key": ""},
    "notify_nsq": {"enable": "off", "nsqd_address": "", "topic": "minio-events"},
    "notify_mysql": {
        "enable": "off", "dsn_string": "", "table": "minio_events",
        "format": "namespace",
    },
    "notify_postgres": {
        "enable": "off", "connection_string": "", "table": "minio_events",
        "format": "namespace",
    },
    "notify_elasticsearch": {
        "enable": "off", "url": "", "index": "minio-events", "format": "namespace",
    },
    "logger_webhook": {"enable": "off", "endpoint": ""},
    "audit_webhook": {"enable": "off", "endpoint": ""},
    "audit_kafka": {"enable": "off", "brokers": "", "topic": ""},
    "lambda_webhook": {"enable": "off", "endpoint": ""},
    "site": {"name": "", "region": "us-east-1"},
    "region": {"name": "us-east-1"},  # legacy alias of site.region
    "etcd": {"endpoints": ""},  # accepted, unused (no etcd federation)
    "cache": {"enable": "off", "ttl": "300"},
    "browser": {"enable": "off"},
    "ilm": {"transition_workers": "1", "expiry_workers": "1"},
    "drive": {"max_timeout": "30s"},
    "subnet": {"license": ""},  # accepted for config compat
    "callhome": {"enable": "off", "frequency": "24h"},
    "kms_kes": {
        "endpoint": "", "key_name": "", "api_key": "",
        "cert_file": "", "key_file": "", "capath": "",
    },
    "identity_tls": {"enable": "off", "skip_verify": "off"},
    "identity_plugin": {"url": "", "auth_token": "", "role_policy": ""},
    "policy_opa": {"url": "", "auth_token": ""},  # deprecated in reference
    "policy_plugin": {"url": "", "auth_token": ""},
}


class ConfigKV:
    def __init__(self, store):
        self.store = store
        self._mu = threading.Lock()
        self._kv: dict[str, dict[str, str]] = {}
        self._listeners: list = []  # callbacks(subsys, key, value)
        self._load()

    def _load(self) -> None:
        from ..erasure.quorum import ObjectNotFound

        try:
            _, it = self.store.get_object(SYSTEM_BUCKET, CONFIG_KEY)
            self._kv = json.loads(b"".join(it))
        except ObjectNotFound:
            self._kv = {}

    def _persist(self) -> None:
        self.store.put_object(
            SYSTEM_BUCKET, CONFIG_KEY, json.dumps(self._kv).encode()
        )

    def get(self, subsys: str, key: str) -> str:
        with self._mu:
            v = self._kv.get(subsys, {}).get(key)
        if v is not None:
            return v
        return DEFAULTS.get(subsys, {}).get(key, "")

    def set(self, subsys: str, key: str, value: str) -> None:
        if subsys not in DEFAULTS:
            raise KeyError(f"unknown config subsystem {subsys!r}")
        if key not in DEFAULTS[subsys]:
            raise KeyError(f"unknown key {subsys}.{key}")
        with self._mu:
            self._kv.setdefault(subsys, {})[key] = value
            self._persist()
        for cb in list(self._listeners):
            try:
                cb(subsys, key, value)
            except Exception:  # noqa: BLE001
                pass

    def dump(self) -> dict:
        out = {s: dict(kv) for s, kv in DEFAULTS.items()}
        with self._mu:
            for s, kv in self._kv.items():
                out.setdefault(s, {}).update(kv)
        return out

    def on_change(self, cb) -> None:
        self._listeners.append(cb)
