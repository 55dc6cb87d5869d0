"""STS handlers: AssumeRole — temporary credentials over the S3 endpoint.

Mirrors MinIO cmd/sts-handlers.go: POST / with form-encoded
Action=AssumeRole issued by a SigV4-authenticated user mints expiring
credentials + a signed session token carrying the parent identity.
"""

from __future__ import annotations

import json
import urllib.parse
from datetime import datetime, timezone
from xml.sax.saxutils import escape

from . import web

from . import s3err


def _credentials_xml(action: str, user, token: str) -> bytes:
    exp = datetime.fromtimestamp(user.expiration, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        f'<{action}Response xmlns="https://sts.amazonaws.com/doc/2011-06-15/">'
        f"<{action}Result><Credentials>"
        f"<AccessKeyId>{escape(user.access_key)}</AccessKeyId>"
        f"<SecretAccessKey>{escape(user.secret_key)}</SecretAccessKey>"
        f"<SessionToken>{escape(token)}</SessionToken>"
        f"<Expiration>{exp}</Expiration>"
        f"</Credentials></{action}Result></{action}Response>"
    ).encode()


def _duration(form: dict) -> int:
    """DurationSeconds form param -> int, 400 on garbage (shared by all
    AssumeRole* variants)."""
    try:
        return int(form.get("DurationSeconds", "3600") or "3600")
    except ValueError:
        raise s3err.InvalidArgument from None


async def handle_sts(server, request: web.Request, access_key: str, body: bytes):
    form = dict(urllib.parse.parse_qsl(body.decode("utf-8", "replace")))
    action = form.get("Action", "")
    if action == "AssumeRoleWithWebIdentity":
        return await _web_identity(server, form)
    if action == "AssumeRoleWithLDAPIdentity":
        return await _ldap_identity(server, form)
    if action == "AssumeRoleWithCertificate":
        return await _certificate(server, request, form)
    if action != "AssumeRole":
        raise s3err.NotImplemented_
    if not access_key:
        raise s3err.AccessDenied
    duration = _duration(form)
    policy = None
    if form.get("Policy"):
        try:
            policy = json.loads(form["Policy"])
        except ValueError:
            raise s3err.MalformedXML from None
    user, token = await server._run(
        server.iam.assume_role, access_key, duration, policy
    )
    return web.Response(
        body=_credentials_xml("AssumeRole", user, token),
        content_type="application/xml",
    )


async def _certificate(server, request: web.Request, form: dict) -> web.Response:
    """mTLS STS: the verified client certificate IS the credential
    (MinIO cmd/sts-handlers.go:180 AssumeRoleWithCertificate).

    Requires the TLS listener (the CA-validated peer certificate arrives
    on the connection's ssl object); the certificate's CommonName names
    both the minted identity and the policy it gets — the reference's
    `parentUser = cert.Subject.CommonName` + policy-by-CN mapping.
    Gated on MINIO_IDENTITY_TLS_ENABLE like the reference's sts_tls
    config subsystem.
    """
    enabled = server.config.get("identity_tls", "enable") if hasattr(
        server, "config"
    ) else ""
    import os as _os

    if (_os.environ.get("MINIO_IDENTITY_TLS_ENABLE", enabled or "")
            .lower() not in ("on", "true", "1")):
        raise s3err.NotImplemented_
    ssl_obj = request.transport.get_extra_info("ssl_object")
    if ssl_obj is None:
        # reference: sts-handlers.go rejects non-TLS certificate STS
        raise s3err.AccessDenied
    der = ssl_obj.getpeercert(binary_form=True)
    if not der:
        raise s3err.AccessDenied
    # the handshake already chain-validated against the certs-dir CAs
    # (CERT_OPTIONAL still verifies any presented cert); here we only
    # check the leaf is client-auth capable and extract identity
    from ..crypto import x509util

    if not x509util.cert_is_client_auth(der):
        # reference rejects certs whose EKU lists neither ClientAuth nor
        # Any — a chain-valid server-only cert must not mint credentials
        raise s3err.AccessDenied
    cn = x509util.cert_common_name(der)
    if not cn:
        raise s3err.AccessDenied
    duration = _duration(form)
    if cn not in server.iam.policies:
        # reference: no policy matching the CN -> auth failure, so a
        # random-but-valid client cert can't mint credentials
        raise s3err.AccessDenied
    user, session = await server._run(
        server.iam.assume_role_certificate, cn, duration,
        x509util.cert_not_after(der),
    )
    return web.Response(
        body=_credentials_xml("AssumeRoleWithCertificate", user, session),
        content_type="application/xml",
    )


async def _ldap_identity(server, form: dict) -> web.Response:
    """Directory-backed STS: the LDAP username/password pair IS the
    credential — no SigV4 auth required
    (MinIO cmd/sts-handlers.go:649 AssumeRoleWithLDAPIdentity:
    lookup-bind search -> user bind -> policy map -> temp credentials)."""
    from ..iam import ldap as ldapmod

    cfg = ldapmod.from_config(server.config)
    if not cfg.enabled:
        raise s3err.NotImplemented_
    username = form.get("LDAPUsername", "")
    password = form.get("LDAPPassword", "")
    if not username or not password:
        raise s3err.InvalidArgument
    duration = _duration(form)
    try:
        user_dn, groups = await server._run(cfg.bind_user, username, password)
    except ldapmod.LDAPError:
        raise s3err.AccessDenied from None
    except (OSError, ValueError):
        # directory unreachable, or a malformed configured filter
        # template: a server-side failure, not bad credentials
        raise s3err.InternalError from None
    # stale names (policy deleted after mapping) drop out; reject only
    # when NOTHING valid remains (the reference's PolicyDBGet behavior)
    policies = [
        p
        for p in server.iam.ldap_policies_for(user_dn, groups)
        if p in server.iam.policies
    ]
    if not policies:
        raise s3err.AccessDenied
    user, session = await server._run(
        server.iam.assume_role_ldap, user_dn, groups, duration, policies
    )
    return web.Response(
        body=_credentials_xml("AssumeRoleWithLDAPIdentity", user, session),
        content_type="application/xml",
    )


async def _web_identity(server, form: dict) -> web.Response:
    """OIDC-federated STS: unauthenticated; the JWT is the credential
    (MinIO cmd/sts-handlers.go:62 AssumeRoleWithWebIdentity)."""
    from ..iam.oidc import OIDCError, OIDCProvider

    provider = getattr(server, "_oidc", None)
    if provider is None or not provider.enabled:
        provider = OIDCProvider()
        server._oidc = provider
    if not provider.enabled:
        raise s3err.NotImplemented_
    token = form.get("WebIdentityToken", "")
    if not token:
        raise s3err.InvalidArgument
    duration = _duration(form)
    try:
        claims = await server._run(provider.validate, token)
    except OIDCError:
        raise s3err.AccessDenied from None
    policies = provider.policies_for(claims)
    if not policies or any(p not in server.iam.policies for p in policies):
        # no grant, or a claim naming a nonexistent policy: surface the
        # misconfiguration at login rather than minting dead credentials
        raise s3err.AccessDenied
    user, session = await server._run(
        server.iam.assume_role_web_identity,
        str(claims.get("sub", "")),
        duration,
        policies,
        float(claims["exp"]),
    )
    return web.Response(
        body=_credentials_xml("AssumeRoleWithWebIdentity", user, session),
        content_type="application/xml",
    )
