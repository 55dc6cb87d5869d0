"""Bucket lifecycle (ILM): config parsing and expiry evaluation.

Mirrors the reference's lifecycle engine (MinIO internal/bucket/
lifecycle + cmd/bucket-lifecycle.go): rules with prefix/tag filters drive
current-version expiry, noncurrent-version expiry, and expired
delete-marker cleanup. Evaluation runs inside the data scanner
(cmd/data-scanner.go applyLifecycle); transitions to remote tiers parse
and validate but are executed by the (future) tiering worker.
"""

from __future__ import annotations

import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from datetime import datetime, timezone

DAY = 24 * 3600

ACTION_NONE = "none"
ACTION_DELETE = "delete"  # expire current version (adds marker if versioned)
ACTION_DELETE_VERSION = "delete-version"  # hard-delete a noncurrent version
ACTION_DELETE_MARKER = "delete-marker"  # remove an expired delete marker
ACTION_TRANSITION = "transition"  # move data to a warm tier


@dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    tags: dict[str, str] = field(default_factory=dict)
    expiry_days: int = 0
    expiry_date: float = 0.0
    expire_delete_marker: bool = False
    noncurrent_days: int = 0
    newer_noncurrent_versions: int = 0
    transition_days: int = 0
    transition_date: float = 0.0
    transition_tier: str = ""

    def transition_due(self, age: float, now: float) -> bool:
        if not self.transition_tier:
            return False
        if self.transition_date:
            return now >= self.transition_date
        return age >= self.transition_days * DAY

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"

    def matches(self, key: str, tags: dict[str, str] | None = None) -> bool:
        if self.prefix and not key.startswith(self.prefix):
            return False
        if self.tags:
            have = tags or {}
            for k, v in self.tags.items():
                if have.get(k) != v:
                    return False
        return True


def parse_lifecycle(xml_text: str) -> list[Rule]:
    if not xml_text:
        return []
    root = ET.fromstring(xml_text)
    rules: list[Rule] = []
    for rel in root:
        if not rel.tag.endswith("Rule"):
            continue
        r = Rule()
        for el in rel:
            t = el.tag.split("}")[-1]
            if t == "ID":
                r.rule_id = el.text or ""
            elif t == "Status":
                r.status = el.text or "Enabled"
            elif t == "Prefix":
                r.prefix = el.text or ""
            elif t == "Filter":
                for sub in el.iter():
                    st = sub.tag.split("}")[-1]
                    if st == "Prefix" and sub.text:
                        r.prefix = sub.text
                    elif st == "Tag":
                        k = v = ""
                        for kv in sub:
                            if kv.tag.endswith("Key"):
                                k = kv.text or ""
                            elif kv.tag.endswith("Value"):
                                v = kv.text or ""
                        if k:
                            r.tags[k] = v
            elif t == "Expiration":
                for sub in el:
                    st = sub.tag.split("}")[-1]
                    if st == "Days" and sub.text:
                        r.expiry_days = int(sub.text)
                    elif st == "Date" and sub.text:
                        r.expiry_date = datetime.fromisoformat(
                            sub.text.replace("Z", "+00:00")
                        ).timestamp()
                    elif st == "ExpiredObjectDeleteMarker":
                        r.expire_delete_marker = (sub.text or "").lower() == "true"
            elif t == "NoncurrentVersionExpiration":
                for sub in el:
                    st = sub.tag.split("}")[-1]
                    if st == "NoncurrentDays" and sub.text:
                        r.noncurrent_days = int(sub.text)
                    elif st == "NewerNoncurrentVersions" and sub.text:
                        r.newer_noncurrent_versions = int(sub.text)
            elif t == "Transition":
                for sub in el:
                    st = sub.tag.split("}")[-1]
                    if st == "Days" and sub.text:
                        r.transition_days = int(sub.text)
                    elif st == "Date" and sub.text:
                        r.transition_date = datetime.fromisoformat(
                            sub.text.replace("Z", "+00:00")
                        ).timestamp()
                    elif st == "StorageClass" and sub.text:
                        r.transition_tier = sub.text
        rules.append(r)
    return rules


def validate_lifecycle(xml_text: str) -> None:
    rules = parse_lifecycle(xml_text)
    if not rules:
        raise ValueError("no lifecycle rules")
    for r in rules:
        if not (
            r.expiry_days or r.expiry_date or r.expire_delete_marker
            or r.noncurrent_days or r.transition_days or r.transition_tier
        ):
            raise ValueError(f"rule {r.rule_id!r} has no action")


@dataclass
class ObjectState:
    key: str
    mod_time_ns: int
    is_latest: bool
    delete_marker: bool
    num_versions: int = 1
    successor_mod_time_ns: int = 0  # when a newer version superseded this
    noncurrent_rank: int = 0  # 1 = newest noncurrent version
    tags: dict[str, str] = field(default_factory=dict)


def eval_action(rules: list[Rule], obj: ObjectState, now: float | None = None) -> str:
    """Lifecycle decision for one version (reference lifecycle.Eval)."""
    now = time.time() if now is None else now
    for r in rules:
        if not r.enabled or not r.matches(obj.key, obj.tags):
            continue
        if obj.is_latest and obj.delete_marker and r.expire_delete_marker:
            # marker with no remaining real versions underneath
            if obj.num_versions <= 1:
                return ACTION_DELETE_MARKER
        if not obj.is_latest:
            since = obj.successor_mod_time_ns / 1e9 or obj.mod_time_ns / 1e9
            if r.noncurrent_days and now - since >= r.noncurrent_days * DAY:
                # NewerNoncurrentVersions: the N newest noncurrent versions
                # are retained regardless of age
                if (
                    r.newer_noncurrent_versions
                    and obj.noncurrent_rank <= r.newer_noncurrent_versions
                ):
                    continue
                return ACTION_DELETE_VERSION
            continue
        if obj.delete_marker:
            continue
        age = now - obj.mod_time_ns / 1e9
        if r.expiry_days and age >= r.expiry_days * DAY:
            return ACTION_DELETE
        if r.expiry_date and now >= r.expiry_date:
            return ACTION_DELETE
        if r.transition_due(age, now):
            return ACTION_TRANSITION
    return ACTION_NONE


def transition_tier_for(rules: list[Rule], obj: ObjectState, now: float | None = None) -> str:
    """The tier a matching Transition rule names (after eval_action said
    ACTION_TRANSITION)."""
    now = time.time() if now is None else now
    age = now - obj.mod_time_ns / 1e9
    for r in rules:
        if r.enabled and r.matches(obj.key, obj.tags) and r.transition_due(age, now):
            return r.transition_tier
    return ""
