"""Batch job framework.

Mirrors MinIO cmd/batch-*.go: YAML job definitions (replicate,
expire; the reference adds key-rotate) submitted over the admin API run in
a background pool with progress checkpointed as objects under .minio.sys
so an interrupted job resumes after restart (batchJobInfo,
cmd/batch-handlers.go:734).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass, field

SYSTEM_BUCKET = ".minio.sys"
JOBS_PREFIX = "batch-jobs"


@dataclass
class JobStatus:
    job_id: str
    job_type: str
    state: str = "queued"  # queued | running | done | failed | canceled
    objects_scanned: int = 0
    objects_acted: int = 0
    failed: int = 0
    last_object: str = ""
    started: float = 0.0
    finished: float = 0.0
    error: str = ""

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class BatchJobPool:
    def __init__(self, store, bucket_meta, replication_pool=None, workers: int = 1,
                 auto_resume: bool = True, kms=None):
        self.store = store
        self.buckets = bucket_meta
        self.repl = replication_pool
        self.kms = kms
        self.jobs: dict[str, JobStatus] = {}
        self._defs: dict[str, dict] = {}
        self._cancel: set[str] = set()
        self._mu = threading.Lock()
        self._load_checkpoints()
        if auto_resume:
            # interrupted jobs (marked queued by _load_checkpoints) resume
            # from their cursor — the actual restart-resume behavior
            for job_id, st in list(self.jobs.items()):
                if st.state == "queued" and self._defs.get(job_id):
                    threading.Thread(
                        target=self._run, args=(job_id,), daemon=True,
                        name=f"batch-resume-{job_id}",
                    ).start()

    # -- persistence -------------------------------------------------------

    def _ckpt_key(self, job_id: str) -> str:
        return f"{JOBS_PREFIX}/{job_id}.json"

    def _save(self, st: JobStatus, definition: dict | None = None) -> None:
        payload = {"status": st.to_dict()}
        if definition is not None:
            payload["definition"] = definition
        try:
            self.store.put_object(
                SYSTEM_BUCKET, self._ckpt_key(st.job_id), json.dumps(payload).encode()
            )
        except Exception:  # noqa: BLE001 — checkpointing is best-effort
            pass

    def _load_checkpoints(self) -> None:
        from ..erasure.quorum import ObjectNotFound

        try:
            for raw in self.store.walk_objects(SYSTEM_BUCKET, JOBS_PREFIX + "/"):
                try:
                    _, it = self.store.get_object(SYSTEM_BUCKET, raw)
                    payload = json.loads(b"".join(it))
                    st = JobStatus(**payload["status"])
                    if st.state == "running":
                        st.state = "queued"  # interrupted: resumable
                    self.jobs[st.job_id] = st
                    self._defs[st.job_id] = payload.get("definition", {})
                except (ObjectNotFound, ValueError, KeyError):
                    continue
        except Exception:  # noqa: BLE001 — empty/first boot
            pass

    # -- API ---------------------------------------------------------------

    def start(self, yaml_text: str) -> JobStatus:
        # yaml is needed only to submit a job: imported here so the server
        # starts on a host without it
        import yaml

        spec = yaml.safe_load(yaml_text)
        if not isinstance(spec, dict):
            raise ValueError("job definition must be a mapping")
        if "replicate" in spec:
            job_type = "replicate"
        elif "expire" in spec:
            job_type = "expire"
        elif "keyrotate" in spec:
            job_type = "keyrotate"
        else:
            raise ValueError(
                "unsupported job type (want replicate:, expire:, or keyrotate:)"
            )
        st = JobStatus(job_id=str(uuid.uuid4())[:13], job_type=job_type)
        with self._mu:
            self.jobs[st.job_id] = st
            self._defs[st.job_id] = spec
        self._save(st, spec)
        threading.Thread(
            target=self._run, args=(st.job_id,), daemon=True,
            name=f"batch-{st.job_id}",
        ).start()
        return st

    def cancel(self, job_id: str) -> bool:
        with self._mu:
            if job_id not in self.jobs:
                return False
            self._cancel.add(job_id)
        return True

    def describe(self, job_id: str) -> JobStatus | None:
        return self.jobs.get(job_id)

    def list(self) -> list[JobStatus]:
        return sorted(self.jobs.values(), key=lambda s: -s.started)

    # -- runner ------------------------------------------------------------

    def _run(self, job_id: str) -> None:
        st = self.jobs[job_id]
        spec = self._defs[job_id]
        st.state = "running"
        st.started = st.started or time.time()
        self._save(st, spec)
        try:
            if st.job_type == "replicate":
                self._run_replicate(st, spec["replicate"])
            elif st.job_type == "keyrotate":
                self._run_keyrotate(st, spec["keyrotate"])
            else:
                self._run_expire(st, spec["expire"])
            st.state = "canceled" if job_id in self._cancel else "done"
        except Exception as e:  # noqa: BLE001
            st.state = "failed"
            st.error = str(e)
        st.finished = time.time()
        self._save(st, spec)

    def _iter_objects(self, st: JobStatus, bucket: str, prefix: str):
        """Resumes after st.last_object (the checkpoint cursor)."""
        n = 0
        for raw in self.store.walk_objects(bucket, prefix):
            if st.job_id in self._cancel:
                return
            if st.last_object and raw <= st.last_object:
                continue
            yield raw
            st.last_object = raw
            n += 1
            if n % 100 == 0:
                self._save(st, self._defs[st.job_id])

    def _run_replicate(self, st: JobStatus, spec: dict) -> None:
        src = spec.get("source", {})
        tgt = spec.get("target", {})
        bucket = src.get("bucket", "")
        prefix = src.get("prefix", "")
        from ..client import S3Client

        cli = S3Client(
            tgt.get("endpoint", ""),
            tgt.get("credentials", {}).get("accessKey", "minioadmin"),
            tgt.get("credentials", {}).get("secretKey", "minioadmin"),
        )
        tbucket = tgt.get("bucket", bucket)
        for raw in self._iter_objects(st, bucket, prefix):
            st.objects_scanned += 1
            try:
                oi, it = self.store.get_object(bucket, raw)
                r = cli.put_object(tbucket, raw, b"".join(it))
                if r.status == 200:
                    st.objects_acted += 1
                else:
                    st.failed += 1
            except Exception:  # noqa: BLE001
                st.failed += 1

    def _run_expire(self, st: JobStatus, spec: dict) -> None:
        bucket = spec.get("bucket", "")
        prefix = spec.get("prefix", "")
        older_than = _parse_duration(spec.get("rules", [{}])[0].get("olderThan", "0s")
                                     if spec.get("rules") else spec.get("olderThan", "0s"))
        cutoff = time.time() - older_than
        versioned = self.buckets.get(bucket).versioning if self.buckets else False
        for raw in self._iter_objects(st, bucket, prefix):
            st.objects_scanned += 1
            try:
                oi = self.store.get_object_info(bucket, raw)
                if oi.mod_time / 1e9 <= cutoff:
                    self.store.delete_object(bucket, raw, versioned=versioned)
                    st.objects_acted += 1
            except Exception:  # noqa: BLE001
                st.failed += 1


    def _run_keyrotate(self, st: JobStatus, spec: dict) -> None:
        """Re-encrypt SSE-S3/SSE-KMS objects at rest under fresh object
        keys (reference cmd/batch-rotate.go). Plaintext objects skip;
        only the LATEST version of each object rotates (older versions
        keep their keys, as a new version is written on versioned
        buckets)."""
        from ..crypto import sse as ssemod
        from ..server import transforms

        if self.kms is None:
            raise RuntimeError("key rotation requires a configured KMS")
        bucket = spec.get("bucket", "")
        prefix = spec.get("prefix", "")
        for raw in self._iter_objects(st, bucket, prefix):
            st.objects_scanned += 1
            try:
                # metadata-only probe first: fetching the body of a skipped
                # object would abandon a never-started read iterator and
                # leak its namespace read lock until the TTL
                oi = self.store.get_object_info(bucket, raw)
                algo = oi.user_defined.get(ssemod.META_ALGO, "")
                if algo not in ("SSE-S3", "SSE-KMS"):
                    continue  # SSE-C needs the customer key; plaintext skips
                oi, it = self.store.get_object(bucket, raw)
                plain = transforms.decode_full(
                    b"".join(it), oi.user_defined, {}, bucket, raw, self.kms
                )
                if algo == "SSE-KMS":
                    hdr = {"x-amz-server-side-encryption": "aws:kms"}
                    key_id = oi.user_defined.get(ssemod.META_KMS_KEY_ID, "")
                    if key_id:  # keep the object's recorded KMS key
                        hdr["x-amz-server-side-encryption-aws-kms-key-id"] = key_id
                else:
                    hdr = {"x-amz-server-side-encryption": "AES256"}
                tr = transforms.encode_for_store(
                    plain, raw, oi.content_type or "", hdr, None, self.kms, bucket
                )
                meta = {
                    k: v for k, v in oi.user_defined.items()
                    # strip crypto/compression internals (re-derived below)
                    # but KEEP stored client checksums: the plaintext is
                    # unchanged by rotation
                    if not k.startswith("x-minio-internal-")
                    or k.startswith("x-minio-internal-checksum-")
                }
                if oi.content_type:
                    meta["content-type"] = oi.content_type
                meta.update(tr.metadata)
                versioned = (
                    self.buckets.get(bucket).versioning if self.buckets else False
                )
                self.store.put_object(
                    bucket, raw, tr.data, meta, versioned=versioned
                )
                st.objects_acted += 1
            except Exception:  # noqa: BLE001
                st.failed += 1


def _parse_duration(s: str) -> float:
    s = str(s).strip()
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}
    if s and s[-1] in units:
        return float(s[:-1]) * units[s[-1]]
    return float(s or 0)
