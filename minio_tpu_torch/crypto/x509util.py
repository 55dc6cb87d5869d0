"""X.509 helpers: CA + leaf certificate generation.

Used by tests (boot a TLS cluster from a throwaway CA) and by dev
bring-up.  The reference relies on externally provisioned certificates
(its test helpers generate them with Go's crypto/x509; see
MinIO cmd/testdata and internal/certs tests); this is the
equivalent on `cryptography`.
"""

from __future__ import annotations

import datetime
import ipaddress

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID


def _name(cn: str) -> x509.Name:
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def generate_ca(cn: str = "minio-tpu-test-ca"):
    """Self-signed CA. Returns (cert_pem: bytes, key, cert)."""
    key = ec.generate_private_key(ec.SECP256R1())
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(cn))
        .issuer_name(_name(cn))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=1),
                       critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), key, cert


def issue_cert(
    ca_key,
    ca_cert,
    cn: str,
    sans: list[str] | None = None,
    client: bool = False,
    days: int = 30,
    server_only: bool = False,
):
    """Issue a leaf cert signed by the CA.

    `sans` entries that parse as IPs become IP SANs (Python's ssl verifies
    IP endpoints against IP SANs, not CN).  Returns (cert_pem, key_pem).
    """
    key = ec.generate_private_key(ec.SECP256R1())
    san_entries: list[x509.GeneralName] = []
    for s in sans or []:
        try:
            san_entries.append(x509.IPAddress(ipaddress.ip_address(s)))
        except ValueError:
            san_entries.append(x509.DNSName(s))
    if server_only:
        eku = [ExtendedKeyUsageOID.SERVER_AUTH]
    elif client:
        eku = [ExtendedKeyUsageOID.CLIENT_AUTH]
    else:
        eku = [ExtendedKeyUsageOID.SERVER_AUTH, ExtendedKeyUsageOID.CLIENT_AUTH]
    b = (
        x509.CertificateBuilder()
        .subject_name(_name(cn))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=days))
        .add_extension(x509.ExtendedKeyUsage(eku), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
    )
    if san_entries:
        b = b.add_extension(
            x509.SubjectAlternativeName(san_entries), critical=False
        )
    cert = b.sign(ca_key, hashes.SHA256())
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def cert_common_name(der: bytes) -> str:
    """CN of a DER certificate (peer cert from an ssl socket)."""
    cert = x509.load_der_x509_certificate(der)
    cns = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
    return cns[0].value if cns else ""


def cert_serial(der: bytes) -> int:
    return x509.load_der_x509_certificate(der).serial_number


def cert_is_client_auth(der: bytes) -> bool:
    """True when the leaf's ExtendedKeyUsage grants TLS client auth.

    The reference (cmd/sts-handlers.go:884-893) accepts only certificates
    whose EKU lists ClientAuth or Any; a certificate without the extension
    has an empty usage list there and is rejected too.
    """
    cert = x509.load_der_x509_certificate(der)
    try:
        eku = cert.extensions.get_extension_for_class(
            x509.ExtendedKeyUsage
        ).value
    except x509.ExtensionNotFound:
        return False
    return (
        ExtendedKeyUsageOID.CLIENT_AUTH in eku
        or ExtendedKeyUsageOID.ANY_EXTENDED_KEY_USAGE in eku
    )


def cert_not_after(der: bytes) -> float:
    """Expiry of a DER certificate as a unix timestamp."""
    cert = x509.load_der_x509_certificate(der)
    return cert.not_valid_after_utc.timestamp()
