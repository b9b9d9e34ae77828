"""P-256 ECVRF: the CONIKS-style discrete-log VRF.

Behavioral parity with the reference's p256 VRF (reference:
crypto/vrf/p256/p256.go — the keytransparency construction):

* H1: try-and-increment onto the curve — candidate compressed point
  0x02 || SHA512(be32(i) || m)[:32], first i that decompresses wins;
* H2: SP 800-90A simple-discard — SHA512(be32(i) || m)[:32] as an
  integer, first value in [1, N-1] wins;
* Evaluate: VRF = [k]H1(m); proof = (s, t, VRF) with
  s = H2(G, H, [k]G, VRF, [r]G, [r]H) and t = r - s*k (mod N);
* ProofToHash: recompute s from [t]G + [s]PK and [t]H + [s]VRF,
  constant-time-compare; index = SHA256(VRF).

Point serialization is Go's elliptic.Marshal (0x04 || X32 || Y32).
Pure host-side bigint — the epoch-randomness path runs once per epoch
and stays on the host (SURVEY §2.1).

The port's copy of the JAX package's ``crypto_vrf_p256.py``.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets
import struct

# NIST P-256 domain parameters
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5


def _inv(x: int) -> int:
    return pow(x, -1, P)


def _on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + A * x + B)) % P == 0


def _add(p1, p2):
    """Affine addition; None = infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1 + A) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(pt, k: int):
    k %= N
    out = None
    while k:
        if k & 1:
            out = _add(out, pt)
        pt = _add(pt, pt)
        k >>= 1
    return out


G = (GX, GY)


def _marshal(pt) -> bytes:
    if pt is None:
        return b"\x00"
    return b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _unmarshal(data: bytes):
    if len(data) != 65 or data[0] != 4:
        return None
    x = int.from_bytes(data[1:33], "big")
    y = int.from_bytes(data[33:], "big")
    if x >= P or y >= P or not _on_curve(x, y):
        return None
    return (x, y)


def _decompress(prefix: int, x: int):
    if x >= P:
        return None
    rhs = (x * x * x + A * x + B) % P
    y = pow(rhs, (P + 1) // 4, P)
    if y * y % P != rhs:
        return None
    if (y & 1) != (prefix & 1):
        y = P - y
    return (x, y)


def h1(m: bytes):
    """Try-and-increment hash to curve (p256.go:62-77 H1)."""
    for i in range(100):
        digest = hashlib.sha512(struct.pack(">I", i) + m).digest()
        pt = _decompress(2, int.from_bytes(digest[:32], "big"))
        if pt is not None:
            return pt
    raise ValueError("H1: no curve point in 100 tries")


def h2(m: bytes) -> int:
    """Hash to [1, N-1] by simple discard (p256.go:106-121 H2)."""
    i = 0
    while True:
        digest = hashlib.sha512(struct.pack(">I", i) + m).digest()
        k = int.from_bytes(digest[:32], "big")
        if k < N - 1:
            return k + 1
        i += 1


def keygen(seed: bytes | None = None) -> int:
    if seed is not None:
        return (int.from_bytes(hashlib.sha512(seed).digest(), "big")
                % (N - 1)) + 1
    return secrets.randbelow(N - 1) + 1


def pubkey(sk: int):
    return _mul(G, sk)


def serialize_pubkey(pk) -> bytes:
    return pk[0].to_bytes(32, "big") + pk[1].to_bytes(32, "big")


def deserialize_pubkey(data: bytes):
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:], "big")
    if not _on_curve(x, y):
        raise ValueError("pubkey not on P-256")
    return (x, y)


def evaluate(sk: int, m: bytes, r: int | None = None):
    """(index32, proof) — proof = s32 || t32 || marshal(VRF) (97 B).
    ``r`` is the prover nonce (random by default; injectable for
    deterministic tests)."""
    if r is None:
        r = secrets.randbelow(N - 1) + 1
    H = h1(m)
    vrf_pt = _mul(H, sk)
    vrf = _marshal(vrf_pt)
    rg = _mul(G, r)
    rh = _mul(H, r)
    pk = pubkey(sk)
    s = h2(
        _marshal(G) + _marshal(H) + _marshal(pk) + vrf
        + _marshal(rg) + _marshal(rh)
    )
    t = (r - s * sk) % N
    proof = s.to_bytes(32, "big") + t.to_bytes(32, "big") + vrf
    return hashlib.sha256(vrf).digest(), proof


def proof_to_hash(pk, m: bytes, proof: bytes) -> bytes:
    """Verify and return the 32-byte index, or raise ValueError
    (p256.go:174-225 ProofToHash)."""
    if len(proof) != 64 + 65:
        raise ValueError("invalid VRF proof length")
    s = int.from_bytes(proof[:32], "big")
    t = int.from_bytes(proof[32:64], "big")
    vrf = proof[64:]
    vrf_pt = _unmarshal(vrf)
    if vrf_pt is None:
        raise ValueError("invalid VRF point")
    H = h1(m)
    # [t]G + [s]PK  and  [t]H + [s]VRF
    u = _add(_mul(G, t), _mul(pk, s))
    v = _add(_mul(H, t), _mul(vrf_pt, s))
    got = h2(
        _marshal(G) + _marshal(H) + _marshal(pk) + vrf
        + _marshal(u) + _marshal(v)
    )
    if not _hmac.compare_digest(
        got.to_bytes(32, "big"), proof[:32]
    ):
        raise ValueError("invalid VRF proof")
    return hashlib.sha256(vrf).digest()
