"""CORS enforcement — preflight and response headers.

The reference wraps its API router in a CORS middleware driven by the
`api.cors_allow_origin` config (wildcard origins, all methods, S3
headers exposed — MinIO cmd/api-router.go:651 corsHandler)
and additionally stores per-bucket CORS rule documents. Here both
layers are enforced: a bucket with a CORS configuration evaluates its
own rules (AllowedOrigin/AllowedMethod/AllowedHeader/ExposeHeader/
MaxAgeSeconds); buckets without one fall back to the global config.
"""

from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET

S3_METHODS = ("GET", "PUT", "HEAD", "POST", "DELETE", "OPTIONS", "PATCH")
EXPOSED = (
    "Date, ETag, Server, Connection, Accept-Ranges, Content-Range, "
    "Content-Encoding, Content-Length, Content-Type, Content-Disposition, "
    "Last-Modified, Content-Language, Cache-Control, Retry-After, "
    "X-Amz-Bucket-Region, Expires, X-Amz-Request-Id, x-amz-version-id, "
    "x-amz-delete-marker"
)


def parse_bucket_cors(xml_text: str) -> list[dict]:
    """<CORSConfiguration><CORSRule>... -> rule dicts; raises ValueError
    on malformed documents (PutBucketCors must reject them)."""
    root = ET.fromstring(xml_text)
    if root.tag.rsplit("}", 1)[-1] != "CORSConfiguration":
        raise ValueError("root element must be CORSConfiguration")
    rules = []
    for rule in root:
        # exact localname on DIRECT children only: <MyCORSRule> or nested
        # strays must be rejected, not silently enforced
        if rule.tag.rsplit("}", 1)[-1] != "CORSRule":
            raise ValueError(f"unexpected element {rule.tag!r}")
        r = {
            "origins": [], "methods": [], "headers": [], "expose": [],
            "max_age": "",
        }
        for el in rule:
            tag = el.tag.rsplit("}", 1)[-1]
            text = (el.text or "").strip()
            if tag == "AllowedOrigin":
                r["origins"].append(text)
            elif tag == "AllowedMethod":
                if text.upper() not in S3_METHODS:
                    raise ValueError(f"unsupported CORS method {text!r}")
                r["methods"].append(text.upper())
            elif tag == "AllowedHeader":
                r["headers"].append(text)
            elif tag == "ExposeHeader":
                r["expose"].append(text)
            elif tag == "MaxAgeSeconds":
                r["max_age"] = text
        if not r["origins"] or not r["methods"]:
            raise ValueError("CORSRule needs AllowedOrigin and AllowedMethod")
        rules.append(r)
    if not rules:
        raise ValueError("no CORSRule in configuration")
    return rules


def _origin_matches(patterns: list[str], origin: str) -> bool:
    return any(fnmatch.fnmatchcase(origin, p) for p in patterns)


def match_rule(
    rules: list[dict], origin: str, method: str, req_headers: list[str]
) -> dict | None:
    """First bucket rule admitting (origin, method, requested headers)."""
    for r in rules:
        if not _origin_matches(r["origins"], origin):
            continue
        if method not in r["methods"]:
            continue
        allowed = [h.lower() for h in r["headers"]]
        if req_headers and not all(
            any(fnmatch.fnmatchcase(h.lower(), a) for a in allowed)
            for h in req_headers
        ):
            continue
        return r
    return None


def evaluate(
    origin: str,
    method: str,
    req_headers: list[str],
    bucket_rules: list[dict] | None,
    global_origins: list[str],
) -> dict[str, str] | None:
    """-> CORS response headers, or None when the request is not allowed.
    Bucket rules take precedence when configured; otherwise the global
    `api.cors_allow_origin` list governs with all-methods semantics."""
    if bucket_rules is not None:
        r = match_rule(bucket_rules, origin, method, req_headers)
        if r is None:
            return None
        out = {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Methods": ", ".join(r["methods"]),
            "Access-Control-Allow-Credentials": "true",
            "Access-Control-Expose-Headers": ", ".join(r["expose"]) or EXPOSED,
            "Vary": "Origin",
        }
        if r["headers"]:
            out["Access-Control-Allow-Headers"] = ", ".join(r["headers"])
        elif req_headers:
            out["Access-Control-Allow-Headers"] = ", ".join(req_headers)
        if r["max_age"]:
            out["Access-Control-Max-Age"] = r["max_age"]
        return out
    if not _origin_matches(global_origins, origin):
        return None
    return {
        "Access-Control-Allow-Origin": origin,
        "Access-Control-Allow-Methods": ", ".join(S3_METHODS),
        "Access-Control-Allow-Headers": ", ".join(req_headers) or "*",
        "Access-Control-Allow-Credentials": "true",
        "Access-Control-Expose-Headers": EXPOSED,
        "Vary": "Origin",
    }
