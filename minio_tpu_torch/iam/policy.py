"""IAM/bucket policy documents and evaluation.

Mirrors the reference's policy engine (minio/pkg/policy consumed by
MinIO cmd/iam.go and cmd/auth-handler.go:338): JSON documents
with Effect/Action/Resource/Principal/Condition statements; evaluation is
explicit-Deny-wins, then any Allow, else implicit deny. Wildcards (* and ?)
apply to actions and resources; a condition subset (prefix/delimiter string
matches) covers the common S3 listing constraints.
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field

# -- actions ----------------------------------------------------------------

# request -> action names (subset of the reference's policy.Action space
# that our API surface can emit; admin actions use the admin: prefix)
S3_ALL = "s3:*"
ADMIN_ALL = "admin:*"


def match_pattern(pattern: str, value: str) -> bool:
    """AWS-style wildcard match: '*' spans path separators, '?' one char.

    Only * and ? are wildcards — fnmatch's [seq] classes are escaped so
    literal brackets in keys/actions match themselves.
    """
    if pattern == value:
        return True
    return fnmatch.fnmatchcase(value, pattern.replace("[", "[[]"))


@dataclass
class Statement:
    effect: str = "Allow"  # Allow | Deny
    actions: list[str] = field(default_factory=list)
    not_actions: list[str] = field(default_factory=list)
    resources: list[str] = field(default_factory=list)
    principals: list[str] = field(default_factory=list)  # ["*"] or access keys
    conditions: dict = field(default_factory=dict)
    sid: str = ""

    @staticmethod
    def from_dict(d: dict) -> "Statement":
        def as_list(v):
            if v is None:
                return []
            return [v] if isinstance(v, str) else list(v)

        principals = []
        p = d.get("Principal")
        if p == "*":
            principals = ["*"]
        elif isinstance(p, dict):
            principals = as_list(p.get("AWS"))
            if principals == ["*"]:
                principals = ["*"]
        return Statement(
            effect=d.get("Effect", "Allow"),
            actions=as_list(d.get("Action")),
            not_actions=as_list(d.get("NotAction")),
            resources=as_list(d.get("Resource")),
            principals=principals,
            conditions=d.get("Condition", {}) or {},
            sid=d.get("Sid", ""),
        )

    def matches_action(self, action: str) -> bool:
        if self.not_actions:
            return not any(match_pattern(p, action) for p in self.not_actions)
        return any(match_pattern(p, action) for p in self.actions)

    def matches_resource(self, resource: str, require_resource: bool = False) -> bool:
        if not self.resources:
            # identity policies may omit Resource; resource (bucket)
            # policies must name one — fail closed on malformed documents
            return not require_resource
        for r in self.resources:
            r = r.removeprefix("arn:aws:s3:::")
            if match_pattern(r, resource):
                return True
        return False

    def matches_principal(self, access_key: str, require_principal: bool = False) -> bool:
        if not self.principals:
            # identity policies imply the attached principal; RESOURCE
            # (bucket) policies must name one — a missing Principal never
            # grants anyone, least of all anonymous callers
            return not require_principal
        for p in self.principals:
            p = p.removeprefix("arn:aws:iam:::user/")
            if p == "*" or p == access_key:
                return True
        return False

    def matches_conditions(self, ctx: dict[str, str]) -> bool:
        for op, kv in self.conditions.items():
            if not isinstance(kv, dict):
                return False
            for cond_key, want in kv.items():
                vals = [want] if isinstance(want, str) else list(want)
                got = ctx.get(cond_key.lower(), "")
                if op == "StringEquals":
                    if got not in vals:
                        return False
                elif op == "StringNotEquals":
                    if got in vals:
                        return False
                elif op == "StringLike":
                    if not any(match_pattern(v, got) for v in vals):
                        return False
                elif op == "StringNotLike":
                    if any(match_pattern(v, got) for v in vals):
                        return False
                else:
                    return False  # unsupported operator: fail closed
        return True


@dataclass
class Policy:
    version: str = "2012-10-17"
    statements: list[Statement] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "Policy":
        sts = d.get("Statement", [])
        if isinstance(sts, dict):
            sts = [sts]
        return Policy(
            version=d.get("Version", "2012-10-17"),
            statements=[Statement.from_dict(s) for s in sts],
        )

    @staticmethod
    def from_json(buf: bytes | str) -> "Policy":
        return Policy.from_dict(json.loads(buf))

    def to_dict(self) -> dict:
        out = {"Version": self.version, "Statement": []}
        for s in self.statements:
            st: dict = {"Effect": s.effect}
            if s.sid:
                st["Sid"] = s.sid
            if s.actions:
                st["Action"] = s.actions
            if s.not_actions:
                st["NotAction"] = s.not_actions
            if s.resources:
                st["Resource"] = s.resources
            if s.principals:
                st["Principal"] = {"AWS": s.principals}
            if s.conditions:
                st["Condition"] = s.conditions
            out["Statement"].append(st)
        return out

    def is_allowed(
        self,
        action: str,
        resource: str,
        access_key: str = "",
        conditions: dict[str, str] | None = None,
        require_principal: bool = False,
    ) -> bool | None:
        """True=explicit allow, False=explicit deny, None=no match.

        require_principal=True for resource (bucket) policies; it also
        requires each statement to name a Resource."""
        ctx = conditions or {}
        verdict: bool | None = None
        for s in self.statements:
            if not s.matches_action(action):
                continue
            if not s.matches_resource(resource, require_resource=require_principal):
                continue
            if not s.matches_principal(access_key, require_principal):
                continue
            if not s.matches_conditions(ctx):
                continue
            if s.effect == "Deny":
                return False  # explicit deny always wins
            verdict = True
        return verdict


def _allow(actions: list[str], resources: list[str]) -> Statement:
    return Statement(effect="Allow", actions=actions, resources=resources)


# canned policies shipped by the reference (cmd/iam.go embedded policies)
CANNED_POLICIES: dict[str, Policy] = {
    "readonly": Policy(statements=[
        _allow(["s3:GetBucketLocation", "s3:GetObject"], ["arn:aws:s3:::*"])
    ]),
    "writeonly": Policy(statements=[
        _allow(["s3:PutObject"], ["arn:aws:s3:::*"])
    ]),
    "readwrite": Policy(statements=[_allow(["s3:*"], ["arn:aws:s3:::*"])]),
    "diagnostics": Policy(statements=[
        _allow(
            ["admin:ServerInfo", "admin:Profiling", "admin:ServerTrace",
             "admin:ConsoleLog", "admin:OBDInfo", "admin:TopLocksInfo",
             "admin:BandwidthMonitor", "admin:Prometheus",
             "admin:Health", "admin:InspectData"],
            ["arn:aws:s3:::*"],
        )
    ]),
    "consoleAdmin": Policy(statements=[
        _allow(["admin:*"], []),
        _allow(["s3:*"], ["arn:aws:s3:::*"]),
        _allow(["kms:*"], []),
        _allow(["sts:*"], []),
    ]),
}
