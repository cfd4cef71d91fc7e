"""RSASSA-PKCS1-v1_5 sign/verify + minimal DER/PEM key parsing.

The reference verifies third-party JWTs (RS256/384/512) via the jsonwebtoken
crate (core/src/iam/verify.rs) and signs issued tokens with a configured
issuer key (core/src/iam/issue.rs); no crypto library ships in this image,
so both primitives are implemented directly: sig^e mod n must equal the
EMSA-PKCS1-v1_5 encoding of the token digest, and signing is em^d mod n.
"""

from __future__ import annotations

import hashlib

_DIGEST_INFO = {
    # DER DigestInfo prefixes (RFC 8017 §9.2)
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


def verify_pkcs1_v15(n: int, e: int, msg: bytes, sig: bytes,
                     hash_name: str = "sha256") -> bool:
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    h = hashlib.new(hash_name, msg).digest()
    t = _DIGEST_INFO[hash_name] + h
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return em == expected


# ---------------------------------------------------------------------------
# DER / PEM
# ---------------------------------------------------------------------------


def _der_read(buf: bytes, i: int):
    tag = buf[i]
    i += 1
    ln = buf[i]
    i += 1
    if ln & 0x80:
        nb = ln & 0x7F
        ln = int.from_bytes(buf[i:i + nb], "big")
        i += nb
    return tag, buf[i:i + ln], i + ln


def rsa_public_key_from_der(der: bytes) -> tuple[int, int]:
    """(n, e) from either SubjectPublicKeyInfo or PKCS#1 RSAPublicKey."""
    tag, body, _ = _der_read(der, 0)
    if tag != 0x30:
        raise ValueError("not a DER sequence")
    tag1, first, nxt = _der_read(body, 0)
    if tag1 == 0x02:
        # PKCS#1: SEQUENCE { INTEGER n, INTEGER e }
        n = int.from_bytes(first, "big")
        _t, eb, _ = _der_read(body, nxt)
        return n, int.from_bytes(eb, "big")
    # SPKI: SEQUENCE { AlgorithmIdentifier, BIT STRING { RSAPublicKey } }
    _t, bitstr, _ = _der_read(body, nxt)
    inner = bitstr[1:]  # skip unused-bits octet
    _t, seq, _ = _der_read(inner, 0)
    _t, nb, j = _der_read(seq, 0)
    _t, eb, _ = _der_read(seq, j)
    return int.from_bytes(nb, "big"), int.from_bytes(eb, "big")


def rsa_public_key_from_pem(pem: str) -> tuple[int, int]:
    import base64
    import re

    body = re.sub(r"-----[A-Z ]+-----|\s", "", pem)
    return rsa_public_key_from_der(base64.b64decode(body))


def sign_pkcs1_v15(n: int, d: int, msg: bytes,
                   hash_name: str = "sha256") -> bytes:
    import hashlib as _hl

    k = (n.bit_length() + 7) // 8
    h = _hl.new(hash_name, msg).digest()
    t = _DIGEST_INFO[hash_name] + h
    if k < len(t) + 11:
        raise ValueError("RSA modulus too small for digest")
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def rsa_private_key_from_der(der: bytes) -> tuple[int, int]:
    """(n, d) from PKCS#1 RSAPrivateKey or PKCS#8 PrivateKeyInfo."""
    tag, body, _ = _der_read(der, 0)
    if tag != 0x30:
        raise ValueError("not a DER sequence")
    tag1, first, nxt = _der_read(body, 0)
    if tag1 != 0x02:
        raise ValueError("not a private key")
    if len(first) <= 1 and nxt < len(body):
        # could be PKCS#1 (version, n, e, d, ...) or PKCS#8
        # (version, AlgorithmIdentifier, OCTET STRING)
        tag2, second, nxt2 = _der_read(body, nxt)
        if tag2 == 0x30:
            # PKCS#8: unwrap the OCTET STRING holding RSAPrivateKey
            _t, octets, _ = _der_read(body, nxt2)
            return rsa_private_key_from_der(octets)
        # PKCS#1: second element is n
        nb = second
        _t, _eb, j = _der_read(body, nxt2)
        _t, db, _ = _der_read(body, j)
        return int.from_bytes(nb, "big"), int.from_bytes(db, "big")
    raise ValueError("unrecognised private key structure")


def rsa_private_key_from_pem(pem: str) -> tuple[int, int]:
    import base64
    import re

    body = re.sub(r"-----[A-Z ]+-----|\s", "", pem)
    return rsa_private_key_from_der(base64.b64decode(body))
