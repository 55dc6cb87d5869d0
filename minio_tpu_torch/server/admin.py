"""Admin API — the `mc admin` surface subset.

Mirrors the reference's admin router (MinIO cmd/admin-router.go,
admin-handlers*.go) under /minio/admin/v3/: user/group/policy management,
service accounts, server info, storage info, heal triggering. Sensitive
bodies speak the madmin wire (server/madmin.py): requests from `mc
admin`-style clients arrive encrypted with the caller's secret key and
are accepted alongside plain JSON; the responses the reference encrypts
(user listings, minted credentials, config dumps) always go out
encrypted, as madmin.DecryptData expects.
"""

from __future__ import annotations

import json
import os
import time

from . import web

from ..iam.policy import Policy
from ..iam.sys import NoSuchPolicy, NoSuchUser
from . import s3err


def _json(data, status=200) -> web.Response:
    return web.Response(
        status=status, body=json.dumps(data).encode(), content_type="application/json"
    )


def _int_q(q, name: str, default: int, lo: int | None = None, hi: int | None = None) -> int:
    """Query param as int -> 400 InvalidArgument on garbage, clamped."""
    try:
        v = int(q.get(name, str(default)))
    except ValueError:
        raise s3err.InvalidArgument from None
    if lo is not None:
        v = max(v, lo)
    if hi is not None:
        v = min(v, hi)
    return v


async def handle_admin(server, request: web.Request, access_key: str, subpath: str, body: bytes):
    """Dispatch /minio/admin/v3/<op> requests."""
    from . import madmin

    op = subpath.split("?")[0]
    q = request.rel_url.query
    m = request.method
    iam = server.iam
    secret = iam.lookup_secret(access_key) or ""
    # madmin clients (`mc admin`) encrypt sensitive bodies with the
    # requester's secret key; our own SDK sends plain JSON — accept both.
    # The Argon2id KDF costs ~100 ms + 64 MiB, so it runs off-loop.
    if body and madmin.looks_encrypted(body):
        body = await server._run(madmin.maybe_decrypt, secret, body)

    async def _json_madmin(data, status=200) -> web.Response:
        """Responses the reference wraps with madmin.EncryptData (user
        listings, minted credentials, config dumps) go out encrypted to
        the requester's key, exactly as `mc admin` expects."""
        blob = await server._run(madmin.encrypt, secret, json.dumps(data).encode())
        return web.Response(
            status=status, body=blob, content_type="application/octet-stream"
        )

    def authz(action: str):
        if not iam.is_allowed(access_key, action, ""):
            raise s3err.AccessDenied

    # -- warm tiers (reference cmd/tier.go, admin-handlers-tiers) ----------
    if op == "tier" and m == "PUT":
        authz("admin:SetTier")
        from ..ilm.tier import Tier

        try:
            d = json.loads(body)
            t = Tier(
                name=d["name"], endpoint=d["endpoint"],
                access_key=d["accessKey"], secret_key=d["secretKey"],
                bucket=d["bucket"], prefix=d.get("prefix", ""),
                tier_type=d.get("type", "minio"),
            )
        except (ValueError, KeyError, TypeError):
            raise s3err.InvalidArgument from None
        await server._run(server.tiers.set, t)
        return _json({"success": True})
    if op == "tier" and m == "GET":
        authz("admin:ListTier")
        return _json([
            {"name": t.name, "endpoint": t.endpoint, "bucket": t.bucket,
             "prefix": t.prefix, "type": t.tier_type}
            for t in server.tiers.list()
        ])
    if op == "tier" and m == "DELETE":
        authz("admin:SetTier")
        await server._run(server.tiers.remove, q.get("name", ""))
        return _json({"success": True})

    # -- bucket quota (reference cmd/admin-bucket-handlers.go
    # SetBucketQuotaConfigHandler; enforced in server/app.py) --------------
    if op == "set-bucket-quota" and m == "PUT":
        authz("admin:SetBucketQuota")
        bucket = q.get("bucket", "")
        if not bucket or not await server._run(server.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        try:
            d = json.loads(body) if body else {}
            size = int(d.get("quota", d.get("size", 0)) or 0)
        except (ValueError, TypeError):
            raise s3err.InvalidArgument from None

        def setq():
            bm = server.buckets.get(bucket)
            bm.quota = size
            server.buckets.set(bucket, bm)

        await server._run(setq)
        return _json({"success": True})
    if op == "get-bucket-quota" and m == "GET":
        authz("admin:GetBucketQuota")
        bucket = q.get("bucket", "")
        if not bucket or not await server._run(server.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        bm = await server._run(server.buckets.get, bucket)
        return _json({"quota": bm.quota, "size": bm.quota,
                      "quotatype": "hard" if bm.quota else ""})

    # -- site replication (reference cmd/site-replication.go) --------------
    if op == "site-replication/info" and m == "GET":
        authz("admin:SiteReplicationInfo")
        return _json(await server._run(server.site.info))
    if op == "site-replication/add" and m == "POST":
        authz("admin:SiteReplicationAdd")
        try:
            sites = json.loads(body)
            assert isinstance(sites, list) and len(sites) >= 2
        except (ValueError, AssertionError):
            raise s3err.InvalidArgument from None
        try:
            return _json(await server._run(server.site.add_sites, sites))
        except (ValueError, RuntimeError) as e:
            return _json({"error": str(e)}, status=400)
    if op == "site-replication/join" and m == "POST":
        authz("admin:SiteReplicationAdd")
        try:
            doc = json.loads(body)
            await server._run(server.site.join, doc)
        except (ValueError, KeyError, TypeError):
            # malformed or version-skewed peer request: a 400, not a 500
            raise s3err.InvalidArgument from None
        return _json({"success": True})
    if op == "site-replication/apply" and m == "POST":
        authz("admin:SiteReplicationOperation")
        try:
            doc = json.loads(body)
            await server._run(
                server.site.apply, doc.get("kind", ""), doc.get("payload", {})
            )
        except (ValueError, KeyError, TypeError):
            raise s3err.InvalidArgument from None
        return _json({"success": True})

    # -- IAM + bucket-metadata export/import (reference
    # cmd/admin-handlers.go ExportIAM/ImportIAM,
    # ExportBucketMetadata/ImportBucketMetadata: zip-of-JSON snapshots
    # that move whole deployments between clusters) ------------------------
    if op == "export-iam" and m == "GET":
        authz("admin:ExportIAMAction")
        import io
        import zipfile

        from ..iam.policy import CANNED_POLICIES

        def _build_iam_zip() -> bytes:
            # off-loop: iam._lock may be held by a pool thread mid-persist
            iam_ = server.iam
            with iam_._lock:
                users = {
                    k: u.to_dict() for k, u in iam_.users.items() if not u.is_temp
                }
                groups = json.loads(json.dumps(iam_.groups))
                policies = {
                    k: p.to_dict() for k, p in iam_.policies.items()
                    if k not in CANNED_POLICIES
                }
                ldap_map = dict(iam_.ldap_policy_map)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr("iam-assets/users.json", json.dumps(users, indent=2))
                z.writestr("iam-assets/groups.json", json.dumps(groups, indent=2))
                z.writestr(
                    "iam-assets/policies.json", json.dumps(policies, indent=2)
                )
                z.writestr(
                    "iam-assets/ldap-policy-map.json", json.dumps(ldap_map, indent=2)
                )
            return buf.getvalue()

        return web.Response(
            body=await server._run(_build_iam_zip), content_type="application/zip",
            headers={"Content-Disposition": "attachment; filename=iam-assets.zip"},
        )
    if op == "import-iam" and m == "PUT":
        authz("admin:ImportIAMAction")
        import io
        import zipfile

        try:
            z = zipfile.ZipFile(io.BytesIO(body))

            def _read(name: str) -> dict:
                try:
                    return json.loads(z.read(f"iam-assets/{name}"))
                except KeyError:
                    return {}

            snap = {
                "users": _read("users.json"),
                "groups": _read("groups.json"),
                "policies": _read("policies.json"),
                "ldap_policy_map": _read("ldap-policy-map.json"),
            }
        except (zipfile.BadZipFile, ValueError):
            raise s3err.InvalidArgument from None

        def _merge_iam() -> None:
            # ADDITIVE: a zip carrying only policies must not wipe users
            # (the reference's ImportIAM applies file-by-file the same way)
            from ..iam.policy import Policy
            from ..iam.sys import UserIdentity

            iam_ = server.iam
            with iam_._lock:
                for k, v in snap["users"].items():
                    iam_.users[k] = UserIdentity.from_dict(v)
                iam_.groups.update(snap["groups"])
                for k, v in snap["policies"].items():
                    iam_.policies[k] = Policy.from_dict(v)
                iam_.ldap_policy_map.update(snap["ldap_policy_map"])
                iam_._persist_users()
                iam_._persist_groups()
                iam_._persist_policies()
                iam_._save("ldap_policy_map", iam_.ldap_policy_map)

        await server._run(_merge_iam)
        if getattr(server.site, "enabled", False):
            server.site.sync_iam()  # imported identities propagate site-wide
        return _json({"success": True})
    if op == "export-bucket-metadata" and m == "GET":
        authz("admin:ExportBucketMetadataAction")
        import io
        import zipfile

        only = q.get("bucket", "")
        if only and not await server._run(server.store.bucket_exists, only):
            from ..erasure.quorum import BucketNotFound

            raise BucketNotFound(only)

        def _build_zip() -> bytes:
            # off-loop: cold bucket-metadata reads hit the erasure store
            names = (
                [only] if only
                else [b.name for b in server.store.list_buckets()]
            )
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                for name in names:
                    if name.startswith(".minio.sys"):
                        continue
                    bm = server.buckets.get(name)
                    z.writestr(f"buckets/{name}.json", bm.to_json())
            return buf.getvalue()

        blob = await server._run(_build_zip)
        return web.Response(
            body=blob, content_type="application/zip",
            headers={"Content-Disposition": "attachment; filename=bucket-metadata.zip"},
        )
    if op == "import-bucket-metadata" and m == "PUT":
        authz("admin:ImportBucketMetadataAction")
        import io
        import zipfile

        from ..replication.site import _SYNCED_META

        try:
            z = zipfile.ZipFile(io.BytesIO(body))
            entries = [
                n for n in z.namelist()
                if n.startswith("buckets/") and n.endswith(".json")
            ]
            docs = {
                n[len("buckets/"):-len(".json")]: json.loads(z.read(n))
                for n in entries
            }
        except (zipfile.BadZipFile, ValueError):
            raise s3err.InvalidArgument from None

        def _apply_buckets() -> list[str]:
            from .app import BUCKET_NAME_RE

            applied = []
            # the synced set plus export-only fields that must survive a
            # migration (suspended-versioning state, ownership controls)
            fields = _SYNCED_META + ("versioning_suspended", "ownership")
            for name, doc in docs.items():
                # zip entry names are untrusted: enforce the same bucket
                # naming rules put_bucket does, and never touch the
                # system namespace
                if (
                    not BUCKET_NAME_RE.match(name)
                    or ".." in name
                    or "/" in name
                    or name.startswith(".minio.sys")
                ):
                    continue
                if not server.store.bucket_exists(name):
                    server.store.make_bucket(name)
                bm = server.buckets.get(name)
                for f in fields:
                    if f in doc:
                        setattr(bm, f, doc[f])
                server.buckets.set(name, bm)
                applied.append(name)
            return applied

        applied = await server._run(_apply_buckets)
        return _json({"success": True, "buckets": applied})

    # -- users ------------------------------------------------------------
    if op == "add-user" and m == "PUT":
        authz("admin:CreateUser")
        try:
            d = json.loads(body)
            ak = q.get("accessKey", "")
            if not ak or not d.get("secretKey"):
                raise s3err.InvalidArgument
        except ValueError:
            raise s3err.InvalidArgument from None
        await server._run(iam.add_user, ak, d["secretKey"], d.get("status", "enabled"))
        return web.Response(status=200)
    if op == "remove-user" and m == "DELETE":
        authz("admin:DeleteUser")
        try:
            await server._run(iam.remove_user, q.get("accessKey", ""))
        except NoSuchUser:
            return _json({"error": "user not found"}, 404)
        return web.Response(status=200)
    if op == "list-users" and m == "GET":
        authz("admin:ListUsers")
        users = await server._run(iam.list_users)
        return await _json_madmin(
            {
                k: {"status": u.status, "policyName": ",".join(u.policies), "memberOf": u.groups}
                for k, u in users.items()
            }
        )
    if op == "set-user-status" and m == "PUT":
        authz("admin:EnableUser")
        try:
            await server._run(iam.set_user_status, q.get("accessKey", ""), q.get("status", "enabled"))
        except NoSuchUser:
            return _json({"error": "user not found"}, 404)
        return web.Response(status=200)

    # -- groups -----------------------------------------------------------
    if op == "update-group-members" and m == "PUT":
        authz("admin:AddUserToGroup")
        try:
            d = json.loads(body)
        except ValueError:
            raise s3err.InvalidArgument from None
        await server._run(
            iam.update_group_members,
            d.get("group", ""),
            d.get("members", []),
            d.get("isRemove", False),
        )
        return web.Response(status=200)
    if op == "groups" and m == "GET":
        authz("admin:ListGroups")
        return _json(await server._run(iam.list_groups))
    if op == "group" and m == "GET":
        authz("admin:GetGroup")
        g = iam.groups.get(q.get("group", ""))
        if g is None:
            return _json({"error": "group not found"}, 404)
        return _json({"name": q.get("group"), **g})

    # -- policies ---------------------------------------------------------
    if op == "add-canned-policy" and m == "PUT":
        authz("admin:CreatePolicy")
        try:
            pol = Policy.from_json(body)
        except (ValueError, KeyError):
            raise s3err.InvalidArgument from None
        await server._run(iam.set_policy, q.get("name", ""), pol)
        return web.Response(status=200)
    if op == "remove-canned-policy" and m == "DELETE":
        authz("admin:DeletePolicy")
        try:
            await server._run(iam.delete_policy, q.get("name", ""))
        except NoSuchPolicy:
            return _json({"error": "policy not found"}, 404)
        return web.Response(status=200)
    if op == "list-canned-policies" and m == "GET":
        authz("admin:ListUserPolicies")
        return _json({k: p.to_dict() for k, p in iam.policies.items()})
    if op == "info-canned-policy" and m == "GET":
        authz("admin:GetPolicy")
        p = iam.policies.get(q.get("name", ""))
        if p is None:
            return _json({"error": "policy not found"}, 404)
        return _json(p.to_dict())
    if op == "set-user-or-group-policy" and m == "PUT":
        authz("admin:AttachUserOrGroupPolicy")
        names = [n for n in q.get("policyName", "").split(",") if n]
        try:
            if q.get("isGroup") == "true":
                await server._run(iam.attach_policy, names, "", q.get("userOrGroup", ""))
            else:
                await server._run(iam.attach_policy, names, q.get("userOrGroup", ""), "")
        except (NoSuchUser, NoSuchPolicy) as e:
            return _json({"error": str(e)}, 404)
        return web.Response(status=200)

    # -- service accounts -------------------------------------------------
    if op == "add-service-account" and m == "PUT":
        try:
            d = json.loads(body) if body else {}
        except ValueError:
            raise s3err.InvalidArgument from None
        parent = d.get("targetUser") or access_key
        if parent != access_key:
            # minting for ANOTHER identity needs the admin grant; minting
            # for oneself does not (reference AddServiceAccount: self-ops
            # bypass the policy check, cmd/admin-handlers-users.go)
            authz("admin:CreateServiceAccount")
        # creating credentials for ANOTHER identity inherits that identity's
        # privileges — only the cluster owner may do it (else any holder of
        # admin:CreateServiceAccount could mint root-equivalent keys)
        if parent != access_key and not iam.is_owner(access_key):
            raise s3err.AccessDenied
        u = await server._run(
            iam.new_service_account,
            parent,
            d.get("policy"),
            d.get("accessKey", ""),
            d.get("secretKey", ""),
        )
        return await _json_madmin(
            {"credentials": {"accessKey": u.access_key, "secretKey": u.secret_key}}
        )

    if op == "list-service-accounts" and m == "GET":
        # reference cmd/admin-handlers-users.go ListServiceAccounts: any
        # authenticated user may manage their OWN service accounts (no
        # admin policy needed); other users' SAs need owner/admin rights
        target = q.get("user", "") or access_key
        if target != access_key:
            authz("admin:ListServiceAccounts")
            if not iam.is_owner(access_key):
                raise s3err.AccessDenied
        accounts = [
            {"accessKey": u.access_key, "parentUser": u.parent,
             "accountStatus": u.status,
             "expiration": u.expiration or None}
            for u in iam.users.values()
            if u.parent == target and not u.is_temp
        ]
        return await _json_madmin({"accounts": accounts})
    if op == "info-service-account" and m == "GET":
        sa = iam.users.get(q.get("accessKey", ""))
        if sa is None or not sa.parent or sa.is_temp:
            return _json({"error": "service account not found"}, 404)
        if sa.parent != access_key:
            authz("admin:ListServiceAccounts")
            if not iam.is_owner(access_key):
                raise s3err.AccessDenied
        return await _json_madmin({
            "parentUser": sa.parent,
            "accountStatus": sa.status,
            "impliedPolicy": not sa.session_policy,
            "policy": json.dumps(sa.session_policy) if sa.session_policy else "",
        })
    if op == "delete-service-account" and m == "DELETE":
        sa = iam.users.get(q.get("accessKey", ""))
        if sa is None or not sa.parent or sa.is_temp:
            return _json({"error": "service account not found"}, 404)
        # the parent may always revoke their own SA; anyone else needs
        # owner/admin rights (reference DeleteServiceAccount)
        if sa.parent != access_key:
            authz("admin:RemoveServiceAccount")
            if not iam.is_owner(access_key):
                raise s3err.AccessDenied
        await server._run(iam.remove_user, sa.access_key)
        return web.Response(status=204)

    # -- fault injection (chaos plane, fault/registry.py) ------------------
    if op == "fault/inject" and m == "POST":
        authz("admin:ServerUpdate")
        from .. import fault

        try:
            spec = json.loads(body) if body else {}
            rid = fault.inject(spec)
        except ValueError as e:
            return _json({"error": str(e)}, 400)
        out = {"id": rid, "rule": spec}
        if q.get("local") != "true":
            out["peers"] = await server._run(
                _admin_fanout, server, "fault/inject", body, {}
            )
        return _json(out)
    if op == "fault/clear" and m == "POST":
        authz("admin:ServerUpdate")
        from .. import fault

        rid = None
        if q.get("id"):
            try:
                rid = int(q["id"])
            except ValueError:
                raise s3err.InvalidArgument from None
        removed = fault.clear(rid)
        out = {"removed": removed}
        # rule ids are per-process counters, so an id-scoped clear is
        # meaningful only on the node that minted the id — fanning an id
        # out would clear a DIFFERENT (or no) rule on each peer while
        # reporting success. Only full clears go cluster-wide.
        if q.get("local") != "true" and rid is None:
            out["peers"] = await server._run(
                _admin_fanout, server, "fault/clear", b"", {}
            )
        return _json(out)
    if op == "fault/status" and m == "GET":
        authz("admin:OBDInfo")
        from .. import fault
        from ..parallel import dispatcher as dmod

        st = fault.status()
        ds = dmod.aggregate_stats()
        st["backendLevel"] = ds.get("backend_level", 2)
        st["demotions"] = ds.get("demotions", 0)
        st["promotions"] = ds.get("promotions", 0)
        return _json(st)

    # -- caching layer (cache/: FileInfo + data + segment + listing tiers) -
    if op == "cache/status" and m == "GET":
        authz("admin:OBDInfo")
        from .. import cache
        from ..cache import coherence as cache_coherence
        from ..cache import segment as cache_segment

        st = await server._run(cache.aggregate_stats, server.store)
        st["coherence"] = cache_coherence.stats()
        # operator-facing tier config: is the range-segment tier live,
        # and where/how big is this worker's NVMe spool
        st["segmentsEnabled"] = cache_segment.segments_enabled()
        st["segments"]["disk_enabled"] = cache_segment.disk_budget() > 0
        return _json(st)
    if op == "cache/clear" and m == "POST":
        authz("admin:ServerUpdate")
        from .. import cache

        out = {"cleared": await server._run(cache.clear_store, server.store)}
        if q.get("local") != "true":
            out["peers"] = await server._run(
                _admin_fanout, server, "cache/clear", b"", {}
            )
        return _json(out)

    # -- observability ----------------------------------------------------
    if op == "trace" and m == "GET":
        authz("admin:ServerTrace")
        return await _stream_trace(server, request)
    if op == "sanitizer/status" and m == "GET":
        # runtime sanitizer state: lock witness, access witness,
        # stall episodes, violation counters + recent ring (stackless)
        authz("admin:OBDInfo")
        from ..analysis import sanitizer

        return _json(sanitizer.status())
    if op == "datausageinfo" and m == "GET":
        authz("admin:DataUsageInfo")
        bg = server.background
        return _json(bg.usage.snapshot() if bg else {})
    if op == "background-heal/status" and m == "GET":
        authz("admin:Heal")
        bg = server.background
        return _json(
            {
                "mrfQueued": len(bg.mrf) if bg else 0,
                **(bg.stats if bg else {}),
            }
        )
    if op == "scanner/status" and m == "GET":
        authz("admin:OBDInfo")
        bg = server.background
        return _json(bg.stats if bg else {})
    if op == "inflight-requests" and m == "GET":
        # QoS observability (`mc admin top api` analogue): per-class
        # admission state, last-minute per-API latency, adaptive
        # deadlines, and the device dispatcher's priority-lane counters
        authz("admin:OBDInfo")
        from ..parallel import dispatcher as dmod

        snap = server.qos.snapshot()
        snap["dispatcher"] = dmod.aggregate_stats()
        return _json(snap)
    if op == "top/locks" and m == "GET":
        authz("admin:TopLocksInfo")
        # aggregate lock tables reachable from this node
        from ..cluster.locks import LocalLocker

        stats = {}
        first = server.store
        sets = getattr(getattr(first, "pools", [first])[0], "sets", [])
        if sets:
            for lk in sets[0].ns.lockers:
                if isinstance(lk, LocalLocker):
                    stats.update(lk.stats())
        return _json(stats)

    # -- replication targets ----------------------------------------------
    if op == "set-remote-target" and m == "PUT":
        authz("admin:SetBucketTarget")
        from ..replication.replicate import RemoteTarget

        try:
            d = json.loads(body)
            import uuid as _uuid

            arn = d.get("arn") or (
                f"arn:minio:replication::{str(_uuid.uuid4())[:8]}:{d['targetbucket']}"
            )
            t = RemoteTarget(
                arn=arn,
                source_bucket=d["sourcebucket"],
                endpoint=d["endpoint"],
                access_key=d["credentials"]["accessKey"],
                secret_key=d["credentials"]["secretKey"],
                target_bucket=d["targetbucket"],
            )
        except (ValueError, KeyError):
            raise s3err.InvalidArgument from None
        await server._run(server.repl_targets.set, t)
        return _json({"arn": t.arn})
    if op == "list-remote-targets" and m == "GET":
        authz("admin:GetBucketTarget")
        out = [t.to_dict() for t in server.repl_targets.list(q.get("bucket", ""))]
        for t in out:
            t.pop("secret_key", None)
        return _json(out)
    if op == "remove-remote-target" and m == "DELETE":
        authz("admin:SetBucketTarget")
        await server._run(server.repl_targets.remove, q.get("arn", ""))
        return web.Response(status=204)
    if op == "replication/status" and m == "GET":
        authz("admin:GetBucketTarget")
        return _json(server.replication.stats)
    if op == "replication/resync" and m == "POST":
        authz("admin:SetBucketTarget")
        n = await server._run(server.replication.resync, q.get("bucket", ""))
        return _json({"queued": n})

    # -- batch jobs --------------------------------------------------------
    if op == "start-job" and m == "POST":
        authz("admin:StartBatchJob")
        import yaml as _yaml

        try:
            st = await server._run(server.batch.start, body.decode())
        except (ValueError, _yaml.YAMLError) as e:
            return _json({"error": str(e)}, 400)
        return _json(st.to_dict())
    if op == "list-jobs" and m == "GET":
        authz("admin:ListBatchJobs")
        return _json([s.to_dict() for s in server.batch.list()])
    if op == "describe-job" and m == "GET":
        authz("admin:DescribeBatchJob")
        st = server.batch.describe(q.get("jobId", ""))
        return _json(st.to_dict() if st else {"error": "not found"},
                     200 if st else 404)
    if op == "cancel-job" and m == "DELETE":
        authz("admin:CancelBatchJob")
        ok = server.batch.cancel(q.get("jobId", ""))
        return web.Response(status=204 if ok else 404)

    # -- placement + live topology (placement/) ----------------------------
    if op.startswith("placement/"):
        pl = getattr(server.store, "placement", None)
        if pl is None:
            return _json({"error": "store has no placement engine"}, 400)
        if op == "placement/set" and m == "POST":
            authz("admin:ServerUpdate")
            try:
                d = json.loads(body) if body else {}
                rule = await server._run(pl.set_rule, d)
            except (ValueError, TypeError, KeyError) as e:
                return _json({"error": str(e)}, 400)
            out = {"rule": rule}
            if q.get("local") != "true":
                # rules persist through the shared object layer; peers
                # (cluster nodes AND pool workers) just re-read them
                out["peers"] = await server._run(
                    _admin_fanout, server, "placement/reload", b"", {}
                )
            return _json(out)
        if op == "placement/delete" and m == "POST":
            authz("admin:ServerUpdate")
            try:
                d = json.loads(body) if body else {}
                removed = await server._run(
                    pl.delete_rule, d.get("bucket", ""), d.get("prefix", "")
                )
            except (ValueError, TypeError) as e:
                return _json({"error": str(e)}, 400)
            out = {"removed": removed}
            if q.get("local") != "true":
                out["peers"] = await server._run(
                    _admin_fanout, server, "placement/reload", b"", {}
                )
            return _json(out)
        if op == "placement/reload" and m == "POST":
            authz("admin:ServerUpdate")
            return _json({"rules": await server._run(pl.reload)})
        if op == "placement/get" and m == "GET":
            authz("admin:ServerInfo")
            return _json(await server._run(pl.rules))
        if op == "placement/status" and m == "GET":
            authz("admin:ServerInfo")
            st = await server._run(pl.status)
            if server.pool_mgr is not None:
                st["pools"] = await server._run(server.pool_mgr.pool_usage)
            return _json(st)

    if op in ("pool/expand", "pool/remove") and m == "POST":
        authz("admin:ServerUpdate")
        if server.pool_mgr is None:
            return _json({"error": "store has no pool topology"}, 400)
        if getattr(server, "worker_count", 1) > 1 or (
            getattr(server, "peers", None) or []
        ):
            # every process must see a pool the instant it exists —
            # worker pools / clusters take the coordinated-restart path
            return _json(
                {"error": "online pool topology changes need a "
                          "single-process deployment; add/remove the "
                          "pool spec in the server args and restart"},
                400,
            )
        from ..placement import topology as topomod
        from ..storage.errors import StorageError

        if op == "pool/expand":
            try:
                d = json.loads(body) if body else {}
                spec = str(d["spec"])
                set_size = int(d.get("setSize", 0) or 0)
            except (ValueError, KeyError, TypeError):
                raise s3err.InvalidArgument from None
            bg = server.background
            try:
                out = await server._run(
                    topomod.expand_pool, server.store, spec, set_size,
                    bg.mrf.add if bg is not None else None,
                )
            except (ValueError, StorageError, OSError) as e:
                return _json({"error": str(e)}, 400)
            return _json(out)
        # pool/remove: only a pool decommissioned to completion detaches
        idx = _int_q(q, "pool", -1)
        st = server.pool_mgr.status(idx)
        if st is None or st.state != "complete":
            return _json(
                {"error": "pool must be decommissioned to completion "
                          "before removal"},
                400,
            )
        try:
            out = await server._run(
                topomod.remove_pool, server.store, idx
            )
        except ValueError as e:
            return _json({"error": str(e)}, 400)
        # decommission records key pool INDEXES: re-key them (and drop
        # the removed pool's, incl. persisted checkpoints) so a stale
        # 'complete' can never vouch for a later pool at this index
        await server._run(server.pool_mgr.reindex_after_remove, idx)
        return _json(out)

    # -- pools: decommission / rebalance ----------------------------------
    if op.startswith("pools/") and server.pool_mgr is not None:
        pm = server.pool_mgr
        if op == "pools/list" and m == "GET":
            authz("admin:ServerInfo")
            return _json(pm.pool_usage())
        if op == "pools/decommission" and m == "POST":
            authz("admin:DecommissionPool")
            try:
                st = await server._run(
                    pm.start_decommission, _int_q(q, "pool", -1)
                )
            except ValueError as e:
                return _json({"error": str(e)}, 400)
            return _json(st.to_dict())
        if op == "pools/decommission/status" and m == "GET":
            authz("admin:DecommissionPool")
            st = pm.status(_int_q(q, "pool", -1))
            return _json(st.to_dict() if st else {"state": "idle"})
        if op == "pools/decommission/cancel" and m == "POST":
            authz("admin:DecommissionPool")
            pm.cancel_decommission(_int_q(q, "pool", -1))
            return web.Response(status=200)
        if op == "pools/rebalance" and m == "POST":
            authz("admin:RebalancePool")
            thr = None
            if q.get("threshold"):
                try:
                    thr = float(q["threshold"])
                except ValueError:
                    raise s3err.InvalidArgument from None
            try:
                out = await server._run(pm.start_rebalance_continuous, thr)
            except ValueError as e:
                return _json({"error": str(e)}, 400)
            return _json(out)
        if op == "pools/rebalance/status" and m == "GET":
            authz("admin:RebalancePool")
            return _json(pm.rebalance_status())
        if op == "pools/rebalance/stop" and m == "POST":
            authz("admin:RebalancePool")
            return _json(pm.stop_rebalance())

    # -- profiling (reference cmd/admin-handlers.go:1024 ProfileHandler) ---
    if op == "profile" and m == "POST":
        authz("admin:Profiling")
        from . import profiling

        ptype = q.get("profilerType", "cpu")
        try:
            duration = min(float(q.get("duration", "5") or 5), 120.0)
        except ValueError:
            raise s3err.InvalidArgument from None
        if ptype not in profiling.PROFILERS:
            raise s3err.InvalidArgument
        if q.get("local") == "true":
            # fan-out leaf: profile this node only
            text = await server._run(profiling.run_local, ptype, duration)
            return _json({"nodes": {"local": {ptype: text}}})
        return _json(
            await server._run(profiling.run_cluster, server, ptype, duration)
        )

    # -- config KV ---------------------------------------------------------
    if op == "get-config" and m == "GET":
        authz("admin:ConfigUpdate")
        return await _json_madmin(server.config.dump())
    if op == "set-config-kv" and m == "PUT":
        authz("admin:ConfigUpdate")
        try:
            d = json.loads(body)
            await server._run(
                server.config.set, d["subsys"], d["key"], str(d["value"])
            )
        except (ValueError, KeyError) as e:
            return _json({"error": str(e)}, 400)
        return web.Response(status=200)

    # -- self-measurement plane (diag/: speedtests, netperf, healthinfo) ---
    if op == "speedtest" and m == "POST":
        # autotuning object speedtest through the real erasure path on
        # the QoS background lane (reference cmd/perf-tests.go); the
        # coordinator merges per-node rows, `local=true` leaves measure
        authz("admin:Health")
        from .. import diag

        size = _int_q(q, "size", 1 << 20, lo=4096, hi=64 << 20)
        ops_n = _int_q(q, "ops", 4, lo=1, hi=64)
        concurrency = _int_q(q, "concurrency", 0, lo=0, hi=256)
        if q.get("local") == "true":
            row = await server._run(
                diag.object_speedtest, server, size, ops_n, concurrency
            )
            return _json({"nodes": {"local": row}})
        return _json(await server._run(
            diag.run_cluster, server, "object", "speedtest",
            {"size": str(size), "ops": str(ops_n),
             "concurrency": str(concurrency)},
            lambda: diag.object_speedtest(server, size, ops_n, concurrency),
        ))
    if op == "speedtest/drive" and m == "POST":
        authz("admin:Health")
        from .. import diag

        size_mb = _int_q(q, "sizeMiB", 4, lo=1, hi=64)
        rand_count = _int_q(q, "randCount", 16, lo=1, hi=256)
        if q.get("local") == "true":
            return _json({"nodes": {"local": await server._run(
                diag.drive_speedtest, server, size_mb, rand_count)}})
        return _json(await server._run(
            diag.run_cluster, server, "drive", "speedtest/drive",
            {"sizeMiB": str(size_mb), "randCount": str(rand_count)},
            lambda: diag.drive_speedtest(server, size_mb, rand_count),
        ))
    if op == "speedtest/net" and m == "POST":
        authz("admin:Health")
        from .. import diag

        size = _int_q(q, "size", 0, lo=0, hi=64 << 20)
        count = _int_q(q, "count", 4, lo=1, hi=64)
        pings = _int_q(q, "pings", 8, lo=1, hi=256)
        if q.get("local") == "true":
            return _json({"nodes": {"local": await server._run(
                diag.run_netperf, server, size, count, pings)}})
        return _json(await server._run(
            diag.run_cluster, server, "net", "speedtest/net",
            {"size": str(size), "count": str(count), "pings": str(pings)},
            lambda: diag.run_netperf(server, size, count, pings),
        ))
    if op == "speedtest/object" and m == "POST":
        # legacy fixed-concurrency form, kept for compatibility — the
        # autotuning `speedtest` op above supersedes it
        authz("admin:Health")
        size = _int_q(q, "size", 1 << 20, lo=4096, hi=64 << 20)
        count = _int_q(q, "count", 8, lo=1, hi=32)
        return _json(await server._run(_object_speedtest, server, size, count))
    if op == "healthinfo" and m == "GET":
        authz("admin:OBDInfo")
        from ..diag import healthinfo as hinfo

        info = await server._run(hinfo.build_healthinfo, server)
        if q.get("format") == "zip":
            blob = await server._run(hinfo.healthinfo_zip, info)
            return web.Response(
                status=200, body=blob, content_type="application/zip",
                headers={"Content-Disposition":
                         'attachment; filename="healthinfo.zip"'},
            )
        return _json(info)
    if op == "inspect-data" and m == "GET":
        authz("admin:InspectData")
        from ..diag import healthinfo as hinfo

        bucket = q.get("bucket", "")
        obj = q.get("object", "")
        if not bucket or not obj:
            raise s3err.InvalidArgument
        blob = await server._run(hinfo.inspect_data, server, bucket, obj)
        return web.Response(
            status=200, body=blob, content_type="application/zip",
            headers={"Content-Disposition":
                     'attachment; filename="inspect-data.zip"'},
        )

    # -- info / heal ------------------------------------------------------
    if op == "info" and m == "GET":
        authz("admin:ServerInfo")
        return _json(await server._run(server.server_info))
    if op == "storageinfo" and m == "GET":
        authz("admin:StorageInfo")
        return _json(await server._run(server.storage_info))
    if op.startswith("heal/") or op == "heal":
        authz("admin:Heal")
        parts = op.split("/", 2)
        bucket = parts[1] if len(parts) > 1 else ""
        prefix = parts[2] if len(parts) > 2 else ""
        result = await server._run(server.heal_sweep, bucket, prefix)
        return _json(result)

    raise s3err.NotImplemented_


def server_info_payload(server) -> dict:
    pools = getattr(server.store, "pools", [server.store])
    info = {
        "mode": "online",
        "deploymentID": getattr(pools[0], "deployment_id", ""),
        "region": server.region,
        "pools": [],
        "uptime": int(time.time() - server.started_at),
        "version": "minio-tpu/0.1.0",
        "backendType": "Erasure",
        # SO_REUSEPORT pool identity: which worker answered, how many
        # serve this node (tests + debugging address workers by this)
        "workerIndex": getattr(server, "worker_index", 0),
        "workerCount": getattr(server, "worker_count", 1),
        "pid": os.getpid(),
    }
    for p in pools:
        sets = getattr(p, "sets", [p])
        info["pools"].append(
            {
                "sets": [
                    {
                        "id": s.set_index,
                        "drives": [d.endpoint for d in s.disks],
                        "parity": s.default_parity,
                    }
                    for s in sets
                ]
            }
        )
    return info


def storage_info_payload(server) -> dict:
    out = {"disks": []}
    for d in server.store.disks:
        try:
            di = d.disk_info()
            out["disks"].append(
                {
                    "endpoint": di.endpoint,
                    "total": di.total,
                    "free": di.free,
                    "used": di.used,
                    "state": "ok" if not di.error else di.error,
                }
            )
        except Exception as e:  # noqa: BLE001
            out["disks"].append({"endpoint": d.endpoint, "state": str(e)})
    return out


def _peer_trace_pump(server, peer: str, flt, sub, stop) -> None:
    """Stream one peer's trace records into `sub`'s queue (cluster
    fan-out: a single `mc admin trace`-style stream shows every node).
    Filters forward with the request so peers drop records at the
    source; `local=on` stops the fan-out from recursing."""
    import http.client as _hc
    import socket as _socket
    import urllib.parse as _up

    from .signature import sign_request

    host, _, port = peer.rpartition(":")
    qs = flt.to_query()
    qs["local"] = "on"
    path = "/minio/admin/v3/trace?" + _up.urlencode(qs)
    url = f"http://{host}:{port}{path}"
    conn = None
    try:
        signed = sign_request(
            "GET", url, {}, b"", server.root_user, server.root_pass,
            server.region,
        )
        conn = _hc.HTTPConnection(host, int(port), timeout=2.0)
        conn.request("GET", path, headers=signed)
        resp = conn.getresponse()
        if resp.status != 200:
            return
        buf = b""
        while not stop.is_set():
            try:
                chunk = resp.read1(1 << 16)
            except (_socket.timeout, TimeoutError):
                continue  # idle peer: re-check stop
            if not chunk:
                return  # peer closed its stream
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict) or "type" not in rec:
                    continue  # peer's end-of-stream epitaph, not a record
                try:
                    sub.q.put_nowait(rec)
                except Exception:  # noqa: BLE001 — slow consumer: count it
                    sub.dropped += 1
    except Exception:  # noqa: BLE001 — a dead peer mutes, not kills, the stream
        pass
    finally:
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


def _admin_fanout(server, path: str, body: bytes, query: dict) -> dict:
    """Replay an admin POST on every peer's endpoint with ``local=true``
    (the same stop-the-recursion convention the profile fan-out uses);
    drives fault inject/clear and cache clear cluster-wide. Peers are
    contacted in parallel — chaos tooling must work on a chaotic
    cluster, where some peers are down and a serial 10 s connect timeout
    each would make injection itself the outage. A dead peer is a row in
    the result, not a failure."""
    from concurrent.futures import ThreadPoolExecutor

    peers = getattr(server, "peers", None) or []
    if not peers:
        return {}

    def one(peer: str) -> tuple[str, str]:
        host, _, port = peer.rpartition(":")
        try:
            from ..client import S3Client

            cli = S3Client(
                f"{host}:{port}",
                access_key=server.iam.root_user,
                secret_key=server.iam.root_password,
            )
            r = cli.request(
                "POST", f"/minio/admin/v3/{path}",
                query={**query, "local": "true"}, body=body, timeout=10,
            )
            return peer, "ok" if r.status == 200 else f"HTTP {r.status}"
        except Exception as e:  # noqa: BLE001 — a dead peer is a row
            return peer, f"error: {e}"

    with ThreadPoolExecutor(max_workers=min(len(peers), 16)) as pool:
        return dict(pool.map(one, peers))


async def _stream_trace(server, request: web.Request) -> web.StreamResponse:
    """Long-lived JSON-lines trace stream (`mc admin trace` analogue)
    with the reference tracer's filters: ``type=`` (comma-separated
    trace types), ``threshold=`` (minimum duration), ``err-only=on``.
    Unless ``local=on``, records from every cluster peer merge into the
    same stream."""
    import asyncio
    import queue as _queue
    import threading as _threading

    from .. import obs

    q = request.rel_url.query
    try:
        flt = obs.TraceFilter.from_query(q)
    except ValueError:
        raise s3err.InvalidArgument from None
    sub = server.trace.subscribe(
        filter=None if flt.is_noop else flt, label=request.remote or "trace"
    )
    stop = None
    local_only = q.get("local", "").lower() in ("on", "true", "1")
    peers = [] if local_only else (getattr(server, "peers", None) or [])
    if peers:
        stop = _threading.Event()
        for peer in peers:
            # dedicated daemon threads, NOT the long-poll pool: a pump
            # lives as long as its stream, and a few streams on a large
            # cluster would otherwise pin every pool worker and starve
            # the trace/listen waits the pool exists to serve
            _threading.Thread(
                target=_peer_trace_pump,
                args=(server, peer, flt, sub, stop),
                daemon=True, name=f"trace-pump-{peer}",
            ).start()
    resp = web.StreamResponse(headers={"Content-Type": "application/json"})
    await resp.prepare(request)
    loop = asyncio.get_running_loop()
    try:
        while True:
            try:
                rec = await loop.run_in_executor(
                    server._longpoll_pool, sub.q.get, True, 1.0
                )
            except _queue.Empty:
                continue
            await resp.write(json.dumps(rec).encode() + b"\n")
    except (ConnectionResetError, asyncio.CancelledError):
        pass
    finally:
        server.trace.unsubscribe(sub)
        if stop is not None:
            stop.set()
        try:
            # best-effort epitaph: how many records this subscriber lost
            # to its own queue overflowing (visible when the server ends
            # the stream; a vanished client just won't receive it)
            await resp.write(
                json.dumps({"dropped": sub.dropped}).encode() + b"\n"
            )
        except asyncio.CancelledError:
            raise  # client disconnect mid-write: propagate
        except Exception:  # noqa: BLE001 — client already gone
            pass
    return resp


def _object_speedtest(server, size: int, count: int) -> dict:
    """PUT+GET throughput through the full object path (reference
    cmd/perf-tests.go selfSpeedTest)."""
    import os as _os
    import time as _time

    import uuid as _uuid

    bucket = ".minio.sys"
    run_id = str(_uuid.uuid4())[:8]
    payload = _os.urandom(min(size, 64 << 20))
    t0 = _time.perf_counter()
    for i in range(count):
        server.store.put_object(bucket, f"speedtest/{run_id}-{i}", payload)
    put_dt = _time.perf_counter() - t0
    t0 = _time.perf_counter()
    for i in range(count):
        _, it = server.store.get_object(bucket, f"speedtest/{run_id}-{i}")
        for _ in it:
            pass
    get_dt = _time.perf_counter() - t0
    for i in range(count):
        try:
            server.store.delete_object(bucket, f"speedtest/{run_id}-{i}")
        except Exception:  # noqa: BLE001
            pass
    total = len(payload) * count / 2**20
    return {
        "objectSize": len(payload),
        "count": count,
        "putMiBps": round(total / put_dt, 1),
        "getMiBps": round(total / get_dt, 1),
    }
