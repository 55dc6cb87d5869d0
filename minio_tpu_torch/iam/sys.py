"""IAMSys — users, groups, policies, service accounts, temp credentials.

Mirrors the reference's IAM system (MinIO cmd/iam.go,
cmd/iam-store.go): an in-memory cache over persistent records stored as
objects under .minio.sys/config/iam/, with root credentials from the
environment. Temp (STS) and service-account credentials carry a session
token: an HMAC-signed claims blob keyed by the root secret (the reference
uses JWT with the same trust root).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets as pysecrets
import threading
import time
from dataclasses import dataclass, field

from .policy import CANNED_POLICIES, Policy

IAM_PREFIX = "config/iam"
SYSTEM_BUCKET = ".minio.sys"


class IAMError(Exception):
    pass


class NoSuchUser(IAMError):
    pass


class NoSuchPolicy(IAMError):
    pass


class NoSuchGroup(IAMError):
    pass


@dataclass
class UserIdentity:
    access_key: str
    secret_key: str
    status: str = "enabled"  # enabled | disabled
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    # service accounts / temp creds
    parent: str = ""
    session_policy: dict | None = None
    expiration: float = 0.0  # unix secs; 0 = none
    is_service_account: bool = False
    is_temp: bool = False

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @staticmethod
    def from_dict(d: dict) -> "UserIdentity":
        u = UserIdentity(d["access_key"], d["secret_key"])
        u.__dict__.update(d)
        return u


class IAMSys:
    def __init__(self, store, root_user: str, root_password: str):
        self.store = store
        self.root_user = root_user
        self.root_password = root_password
        self._lock = threading.RLock()
        self.users: dict[str, UserIdentity] = {}
        self.groups: dict[str, dict] = {}  # name -> {"members": [...], "policies": [...], "status": ...}
        self.policies: dict[str, Policy] = dict(CANNED_POLICIES)
        # LDAP DN / group-DN -> [policy names]: mappings for identities
        # that exist only in the external directory (the reference keeps
        # these in a dedicated policy DB, cmd/iam.go PolicyDBSet)
        self.ldap_policy_map: dict[str, list[str]] = {}
        self._loaded = False
        # post-persist hook (site replication); applying_remote suppresses
        # it while importing a peer's snapshot
        self.on_mutation = None
        self.applying_remote = False

    # -- persistence -------------------------------------------------------

    def _save(self, name: str, payload: dict) -> None:
        self._mutations = getattr(self, "_mutations", 0) + 1
        self.store.put_object(
            SYSTEM_BUCKET, f"{IAM_PREFIX}/{name}.json", json.dumps(payload).encode()
        )
        if self.on_mutation is not None and not self.applying_remote:
            try:
                self.on_mutation()
            except Exception:  # noqa: BLE001 — sync is best-effort async
                pass

    def _load_doc(self, name: str) -> dict:
        from ..erasure.quorum import BucketNotFound, ObjectNotFound, VersionNotFound

        try:
            _, it = self.store.get_object(SYSTEM_BUCKET, f"{IAM_PREFIX}/{name}.json")
            return json.loads(b"".join(it))
        except (ObjectNotFound, VersionNotFound, BucketNotFound):
            return {}  # never configured — any OTHER error propagates

    def load(self) -> None:
        # read ALL documents before swapping ANY in: a store error halfway
        # must never leave fresh users paired with stale policies (torn
        # cache), and holding the lock across store IO would block auth
        muts = getattr(self, "_mutations", 0)
        users_doc = self._load_doc("users")
        groups_doc = self._load_doc("groups")
        pol_doc = self._load_doc("policies")
        ldap_doc = self._load_doc("ldap_policy_map")
        with self._lock:
            if self._loaded and getattr(self, "_mutations", 0) != muts:
                # a local write landed mid-read; this snapshot is stale —
                # skip the swap, the next refresh tick re-reads
                return
            self.users = {
                k: UserIdentity.from_dict(v) for k, v in users_doc.items()
            }
            self.groups = groups_doc
            self.policies = dict(CANNED_POLICIES)
            for k, v in pol_doc.items():
                self.policies[k] = Policy.from_dict(v)
            self.ldap_policy_map = ldap_doc
            self._loaded = True

    def start_refresh(self, interval: float = 120.0) -> None:
        """Background IAM cache refresh (reference cmd/iam.go:246: the IAM
        sys re-loads every refresh interval so writes from other nodes —
        or other CLUSTERS sharing an etcd identity plane — propagate
        without restart). When the store exposes watch_changes (etcd), a
        watcher thread reloads immediately on change; the periodic pass
        stays as the fallback for missed events."""
        # check-then-set under the IAM lock: two concurrent callers (a
        # re-entered set_store, a test rig) must not each spawn a
        # refresher thread pair (miniovet races pass)
        with self._lock:
            if getattr(self, "_refresh_stop", None) is not None:
                return
            self._refresh_stop = threading.Event()
            stop = self._refresh_stop

        def reload_once():
            try:
                self.load()
            except Exception:  # noqa: BLE001 — store briefly unavailable
                pass  # next tick / next event retries

        if interval > 0:
            def periodic():
                while not stop.wait(interval):
                    reload_once()

            threading.Thread(
                target=periodic, daemon=True, name="iam-refresh"
            ).start()
        watch = getattr(self.store, "watch_changes", None)
        if watch is not None:
            threading.Thread(
                target=watch, args=(reload_once, stop), daemon=True,
                name="iam-watch",
            ).start()

    def stop_refresh(self) -> None:
        ev = getattr(self, "_refresh_stop", None)
        if ev is not None:
            ev.set()
            self._refresh_stop = None

    def _persist_users(self) -> None:
        self._save("users", {k: u.to_dict() for k, u in self.users.items()})

    def _persist_groups(self) -> None:
        self._save("groups", self.groups)

    def _persist_policies(self) -> None:
        self._save(
            "policies",
            {
                k: p.to_dict()
                for k, p in self.policies.items()
                if k not in CANNED_POLICIES
            },
        )

    # -- users -------------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str, status: str = "enabled") -> None:
        with self._lock:
            u = self.users.get(access_key)
            if u is None:
                u = UserIdentity(access_key, secret_key, status)
            else:
                u.secret_key, u.status = secret_key, status
            self.users[access_key] = u
            self._persist_users()

    def remove_user(self, access_key: str) -> None:
        with self._lock:
            if access_key not in self.users:
                raise NoSuchUser(access_key)
            del self.users[access_key]
            # drop dependents (service accounts / temp creds of this user)
            for k in [k for k, u in self.users.items() if u.parent == access_key]:
                del self.users[k]
            self._persist_users()

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._lock:
            u = self.users.get(access_key)
            if u is None:
                raise NoSuchUser(access_key)
            u.status = status
            self._persist_users()

    def list_users(self) -> dict[str, UserIdentity]:
        with self._lock:
            return {
                k: u for k, u in self.users.items()
                if not u.is_service_account and not u.is_temp
            }

    # -- groups ------------------------------------------------------------

    def update_group_members(self, group: str, members: list[str], remove: bool = False) -> None:
        with self._lock:
            g = self.groups.setdefault(
                group, {"members": [], "policies": [], "status": "enabled"}
            )
            if remove:
                g["members"] = [m for m in g["members"] if m not in members]
                if not members:  # empty remove request deletes the group
                    del self.groups[group]
            else:
                g["members"] = sorted(set(g["members"]) | set(members))
            self._persist_groups()

    def list_groups(self) -> list[str]:
        with self._lock:
            return sorted(self.groups)

    # -- policies ----------------------------------------------------------

    def set_policy(self, name: str, policy: Policy) -> None:
        with self._lock:
            self.policies[name] = policy
            self._persist_policies()

    def delete_policy(self, name: str) -> None:
        with self._lock:
            if name not in self.policies or name in CANNED_POLICIES:
                raise NoSuchPolicy(name)
            del self.policies[name]
            self._persist_policies()

    def attach_policy(self, names: list[str], user: str = "", group: str = "") -> None:
        with self._lock:
            for n in names:
                if n not in self.policies:
                    raise NoSuchPolicy(n)
            if user:
                u = self.users.get(user)
                if u is None:
                    if "=" in user:
                        # an LDAP DN: the identity lives only in the
                        # external directory, so the mapping is stored in
                        # the LDAP policy DB (reference PolicyDBSet for
                        # LDAP users, cmd/admin-handlers-users.go)
                        self.ldap_policy_map[user.lower()] = names
                        self._save("ldap_policy_map", self.ldap_policy_map)
                        return
                    raise NoSuchUser(user)
                u.policies = names
                self._persist_users()
            elif group:
                if "=" in group:
                    self.ldap_policy_map[group.lower()] = names
                    self._save("ldap_policy_map", self.ldap_policy_map)
                    return
                g = self.groups.setdefault(
                    group, {"members": [], "policies": [], "status": "enabled"}
                )
                g["policies"] = names
                self._persist_groups()

    def ldap_policies_for(self, user_dn: str, groups: list[str]) -> list[str]:
        """Policy names mapped to an LDAP user DN or any of its group DNs
        (the reference's PolicyDBGet(userDN, groups...))."""
        with self._lock:
            out: list[str] = []
            for dn in [user_dn, *groups]:
                out.extend(self.ldap_policy_map.get(dn.lower(), []))
            return sorted(set(out))

    def assume_role_ldap(
        self, user_dn: str, groups: list[str], duration_secs: int,
        policies: list[str],
    ) -> tuple[UserIdentity, str]:
        """STS AssumeRoleWithLDAPIdentity: directory-verified identity,
        policies resolved from the LDAP policy map at mint time
        (MinIO cmd/sts-handlers.go:649)."""
        return self._mint_temp(
            duration_secs,
            {"ldapUser": user_dn, "ldapGroups": groups},
            policies=policies,
        )

    def assume_role_certificate(
        self, common_name: str, duration_secs: int,
        cert_expiry: float | None = None,
    ) -> tuple[UserIdentity, str]:
        """STS AssumeRoleWithCertificate: mTLS-verified identity; the
        certificate CommonName is both the parent identity and the policy
        name, and the credentials never outlive the certificate
        (MinIO cmd/sts-handlers.go:180,917)."""
        return self._mint_temp(
            duration_secs, {"certCN": common_name}, policies=[common_name],
            max_expiry=cert_expiry,
        )

    # -- service accounts / temp creds --------------------------------------

    def _sign_token(self, claims: dict) -> str:
        body = base64.urlsafe_b64encode(json.dumps(claims).encode()).decode()
        sig = hmac.new(
            self.root_password.encode(), body.encode(), hashlib.sha256
        ).hexdigest()
        return f"{body}.{sig}"

    def verify_token(self, token: str) -> dict | None:
        try:
            body, sig = token.rsplit(".", 1)
            want = hmac.new(
                self.root_password.encode(), body.encode(), hashlib.sha256
            ).hexdigest()
            if not hmac.compare_digest(want, sig):
                return None
            return json.loads(base64.urlsafe_b64decode(body))
        except Exception:  # noqa: BLE001
            return None

    def new_service_account(
        self, parent: str, policy: dict | None = None,
        access_key: str = "", secret_key: str = "",
    ) -> UserIdentity:
        with self._lock:
            ak = access_key or ("SA" + pysecrets.token_hex(8).upper())
            sk = secret_key or pysecrets.token_urlsafe(24)
            u = UserIdentity(
                ak, sk, parent=parent, session_policy=policy,
                is_service_account=True,
            )
            self.users[ak] = u
            self._persist_users()
            return u

    def _mint_temp(
        self,
        duration_secs: int,
        extra_claims: dict,
        parent: str = "",
        session_policy: dict | None = None,
        policies: list[str] | None = None,
        max_expiry: float | None = None,
    ) -> tuple[UserIdentity, str]:
        """Shared STS credential mint: expiring identity + signed token."""
        with self._lock:
            ak = "STS" + pysecrets.token_hex(8).upper()
            sk = pysecrets.token_urlsafe(24)
            exp = time.time() + max(900, min(duration_secs, 7 * 24 * 3600))
            if max_expiry is not None:
                exp = min(exp, max_expiry)
            u = UserIdentity(
                ak, sk, parent=parent, session_policy=session_policy,
                expiration=exp, is_temp=True,
            )
            if policies:
                u.policies = list(policies)
            token = self._sign_token({"accessKey": ak, "exp": exp, **extra_claims})
            self.users[ak] = u
            self._persist_users()
            return u, token

    def assume_role(
        self, parent: str, duration_secs: int = 3600, policy: dict | None = None
    ) -> tuple[UserIdentity, str]:
        """STS AssumeRole: mint temp credentials under the caller's identity
        (MinIO cmd/sts-handlers.go AssumeRole)."""
        return self._mint_temp(
            duration_secs, {"parent": parent}, parent=parent,
            session_policy=policy,
        )

    def assume_role_web_identity(
        self,
        subject: str,
        duration_secs: int,
        policies: list[str],
        token_exp: float | None = None,
    ) -> tuple[UserIdentity, str]:
        """STS AssumeRoleWithWebIdentity: mint temp credentials for an
        OIDC-federated identity — no parent user; the validated token's
        policy claim grants directly, and the credentials never outlive
        the identity token itself
        (MinIO cmd/sts-handlers.go AssumeRoleWithWebIdentity)."""
        return self._mint_temp(
            duration_secs, {"sub": subject}, policies=policies,
            max_expiry=token_exp,
        )

    # -- auth --------------------------------------------------------------

    @staticmethod
    def _is_live(u) -> bool:
        if u is None or u.status != "enabled":
            return False
        return not (u.expiration and time.time() > u.expiration)

    def lookup_secret(self, access_key: str) -> str | None:
        """Credential lookup for SigV4 verification.

        Derived credentials (service accounts, STS temp creds) die with
        their parent: a disabled/expired/deleted parent user must cut off
        every credential minted under it (the reference rejects
        service-account auth when the parent is disabled — cmd/iam.go
        checkServiceAccount parent-status path).
        """
        if access_key == self.root_user:
            return self.root_password
        with self._lock:
            u = self.users.get(access_key)
            if not self._is_live(u):
                return None
            if u.parent and u.parent != self.root_user:
                if not self._is_live(self.users.get(u.parent)):
                    return None
        return u.secret_key

    def is_owner(self, access_key: str) -> bool:
        if access_key == self.root_user:
            return True
        with self._lock:
            u = self.users.get(access_key)
        # service accounts / temp creds of root inherit ownership
        return bool(u and u.parent == self.root_user and u.session_policy is None)

    def _policies_for(self, access_key: str) -> tuple[list[Policy], dict | None]:
        """(identity policies, optional session policy restriction)."""
        with self._lock:
            u = self.users.get(access_key)
            if u is None:
                return [], None
            names: list[str] = []
            session = None
            target = u
            if u.parent:
                session = u.session_policy
                parent = self.users.get(u.parent)
                if u.parent == self.root_user:
                    return [CANNED_POLICIES["consoleAdmin"]], session
                if not self._is_live(parent):
                    # dead parent -> derived credential has no grants
                    return [], session
                target = parent
            names.extend(target.policies)
            for gname in target.groups:
                g = self.groups.get(gname)
                if g and g.get("status") != "disabled":
                    names.extend(g.get("policies", []))
            for gname, g in self.groups.items():
                if target.access_key in g.get("members", []) and g.get("status") != "disabled":
                    names.extend(g.get("policies", []))
            pols = [self.policies[n] for n in dict.fromkeys(names) if n in self.policies]
            return pols, session

    def is_allowed(
        self,
        access_key: str,
        action: str,
        resource: str,
        conditions: dict[str, str] | None = None,
        bucket_policy: Policy | None = None,
    ) -> bool:
        """Full authorization decision for one request."""
        if self.is_owner(access_key):
            return True
        pols, session = self._policies_for(access_key)
        # explicit deny anywhere wins; session policy (if any) must ALSO allow
        allowed = False
        for p in pols:
            v = p.is_allowed(action, resource, access_key, conditions)
            if v is False:
                return False
            if v is True:
                allowed = True
        if bucket_policy is not None:
            v = bucket_policy.is_allowed(
                action, resource, access_key, conditions, require_principal=True
            )
            if v is False:
                return False
            if v is True:
                allowed = True
        if allowed and session is not None:
            v = Policy.from_dict(session).is_allowed(
                action, resource, access_key, conditions
            )
            return v is True
        return allowed
