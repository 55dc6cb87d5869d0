"""OIDC identity federation for STS AssumeRoleWithWebIdentity.

Mirrors the reference's identity_openid subsystem
(MinIO cmd/sts-handlers.go AssumeRoleWithWebIdentity,
internal/config/identity/openid): a JWT from a configured provider is
validated against the provider's JWKS, and a claim (default "policy")
names the IAM policies attached to the minted temporary credentials.

Config (env, matching the reference's variable names):
  MINIO_IDENTITY_OPENID_CONFIG_URL   discovery document URL
  MINIO_IDENTITY_OPENID_JWKS_URL     direct JWKS URL (skips discovery)
  MINIO_IDENTITY_OPENID_CLIENT_ID    expected audience
  MINIO_IDENTITY_OPENID_CLAIM_NAME   policy claim (default "policy")

RS256 verification uses the `cryptography` primitives already shipped for
SSE; no external OIDC library.
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.request


class OIDCError(Exception):
    pass


def _b64url(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def _b64url_uint(data: str) -> int:
    return int.from_bytes(_b64url(data), "big")


class OIDCProvider:
    def __init__(
        self,
        config_url: str = "",
        jwks_url: str = "",
        client_id: str = "",
        claim_name: str = "",
    ):
        self.config_url = config_url or os.environ.get(
            "MINIO_IDENTITY_OPENID_CONFIG_URL", ""
        )
        self.jwks_url = jwks_url or os.environ.get(
            "MINIO_IDENTITY_OPENID_JWKS_URL", ""
        )
        self.client_id = client_id or os.environ.get(
            "MINIO_IDENTITY_OPENID_CLIENT_ID", ""
        )
        self.claim_name = claim_name or os.environ.get(
            "MINIO_IDENTITY_OPENID_CLAIM_NAME", "policy"
        )
        self._jwks: dict | None = None
        self._jwks_at = 0.0
        self._forced_at = 0.0  # negative-cache: unknown-kid refetch backoff

    @property
    def enabled(self) -> bool:
        # client_id is mandatory: without an audience check any token the
        # IdP ever issued (to any app) could mint credentials here
        return bool((self.config_url or self.jwks_url) and self.client_id)

    def _fetch_json(self, url: str) -> dict:
        try:
            with urllib.request.urlopen(url, timeout=10) as r:  # noqa: S310
                return json.loads(r.read())
        except OIDCError:
            raise
        except Exception as e:  # noqa: BLE001 — IdP down/garbage: STS 403
            raise OIDCError(f"cannot fetch {url}: {type(e).__name__}") from None

    def _get_jwks(self, force: bool = False) -> dict:
        if not force and self._jwks is not None and time.time() - self._jwks_at < 300:
            return self._jwks
        url = self.jwks_url
        if not url:
            disc = self._fetch_json(self.config_url)
            url = disc.get("jwks_uri", "")
            if not url:
                raise OIDCError("discovery document has no jwks_uri")
        self._jwks = self._fetch_json(url)
        self._jwks_at = time.time()
        return self._jwks

    def _key_for(self, kid: str):
        key = self._key_in(self._get_jwks(), kid)
        if key is None and time.time() - self._forced_at > 30:
            # key rotation: the cached JWKS may predate this kid. The
            # 30 s backoff stops unauthenticated garbage-kid floods from
            # hammering the IdP with a refetch per request.
            self._forced_at = time.time()
            key = self._key_in(self._get_jwks(force=True), kid)
        if key is None:
            raise OIDCError(f"no RSA key for kid {kid!r} in JWKS")
        return key

    @staticmethod
    def _key_in(jwks: dict, kid: str):
        from cryptography.hazmat.primitives.asymmetric.rsa import (
            RSAPublicNumbers,
        )

        for jwk in jwks.get("keys", []):
            try:
                if jwk.get("kty") != "RSA":
                    continue
                if kid and jwk.get("kid") and jwk["kid"] != kid:
                    continue
                return RSAPublicNumbers(
                    _b64url_uint(jwk["e"]), _b64url_uint(jwk["n"])
                ).public_key()
            except (KeyError, ValueError, TypeError):
                continue  # malformed JWK entry: skip
        return None

    def validate(self, token: str) -> dict:
        """Verify signature + temporal + audience claims; return claims."""
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url(header_b64))
            claims = json.loads(_b64url(payload_b64))
            sig = _b64url(sig_b64)
        except (ValueError, TypeError):
            raise OIDCError("malformed JWT") from None
        if header.get("alg") != "RS256":
            raise OIDCError(f"unsupported alg {header.get('alg')!r}")
        key = self._key_for(header.get("kid", ""))
        try:
            key.verify(
                sig,
                f"{header_b64}.{payload_b64}".encode(),
                padding.PKCS1v15(),
                hashes.SHA256(),
            )
        except InvalidSignature:
            raise OIDCError("invalid JWT signature") from None
        now = time.time()
        try:
            if "exp" not in claims or now > float(claims["exp"]):
                raise OIDCError("token expired")
            if "nbf" in claims and now < float(claims["nbf"]):
                raise OIDCError("token not yet valid")
        except (TypeError, ValueError):
            raise OIDCError("malformed temporal claims") from None
        aud = claims.get("aud", [])
        auds = [aud] if isinstance(aud, str) else list(aud)
        if self.client_id not in auds and claims.get("azp") != self.client_id:
            raise OIDCError("audience mismatch")
        return claims

    def policies_for(self, claims: dict) -> list[str]:
        v = claims.get(self.claim_name, "")
        if isinstance(v, str):
            return [p.strip() for p in v.split(",") if p.strip()]
        if isinstance(v, list):
            return [str(p).strip() for p in v if str(p).strip()]
        return []
