"""eth-keystore V3 (Web3 Secret Storage) interop.

The reference's accounts/keystore is the go-ethereum fork: ECDSA keys
at rest as V3 JSON — KDF (scrypt or pbkdf2-sha256) -> AES-128-CTR
ciphertext -> keccak MAC over dk[16:32] || ciphertext.  This module
speaks that exact format so keyfiles produced by geth / harmony CLI /
any web3 tool import directly.

AES-128-CTR is this module's own, in plain Python (FIPS-197's cipher,
NIST SP 800-38A's counter mode: a keyfile's secret is two blocks), where
the JAX package's takes it from the ``cryptography`` package; scrypt and
pbkdf2 come from hashlib.  The BLS keystore (``keystore.py``) is a
separate, framework-native format — this one is for the ECDSA account
keys the ethereum tooling expects.

The port's copy of the JAX package's ``accounts/keystore_v3.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid

from ..ref.keccak import keccak256

# scrypt work factors: standard = geth's defaults, light = test vectors
SCRYPT_N, SCRYPT_R, SCRYPT_P = 262144, 8, 1
LIGHT_N = 4096
PBKDF2_C = 262144


class KeystoreError(ValueError):
    pass


def _scrypt(password: bytes, salt: bytes, n: int, r: int, p: int,
            dklen: int) -> bytes:
    """hashlib.scrypt, with an EVP_KDF fallback: OpenSSL 3.0's legacy
    EVP_PBE_scrypt path overestimates memory as 128*r*n*p and ignores
    the maxmem argument, refusing valid keystores (e.g. the V3 spec
    vector's n=262144, r=1, p=8).  The providers-era EVP_KDF interface
    honors maxmem_bytes; drive it via ctypes when hashlib refuses."""
    try:
        return hashlib.scrypt(password, salt=salt, n=n, r=r, p=p,
                              dklen=dklen, maxmem=2**31 - 1)
    except ValueError:
        pass
    import ctypes

    lib = ctypes.CDLL("libcrypto.so.3")
    lib.EVP_KDF_fetch.restype = ctypes.c_void_p
    lib.EVP_KDF_fetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p]
    lib.EVP_KDF_CTX_new.restype = ctypes.c_void_p
    lib.EVP_KDF_CTX_new.argtypes = [ctypes.c_void_p]
    lib.EVP_KDF_derive.restype = ctypes.c_int
    lib.EVP_KDF_derive.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t, ctypes.c_void_p]

    class OsslParam(ctypes.Structure):
        _fields_ = [("key", ctypes.c_char_p),
                    ("data_type", ctypes.c_uint),
                    ("data", ctypes.c_void_p),
                    ("data_size", ctypes.c_size_t),
                    ("return_size", ctypes.c_size_t)]

    UINT, OCTET = 2, 5
    pw = ctypes.create_string_buffer(password, len(password))
    st = ctypes.create_string_buffer(salt, len(salt))
    n64 = ctypes.c_uint64(n)
    r32 = ctypes.c_uint32(r)
    p32 = ctypes.c_uint32(p)
    mm = ctypes.c_uint64(512 * 1024 * 1024)
    unset = ctypes.c_size_t(-1).value  # OSSL_PARAM_UNMODIFIED

    def P(key, typ, buf, size):
        return OsslParam(key, typ, ctypes.cast(buf, ctypes.c_void_p),
                         size, unset)

    params = (OsslParam * 7)(
        P(b"pass", OCTET, pw, len(password)),
        P(b"salt", OCTET, st, len(salt)),
        P(b"n", UINT, ctypes.byref(n64), 8),
        P(b"r", UINT, ctypes.byref(r32), 4),
        P(b"p", UINT, ctypes.byref(p32), 4),
        P(b"maxmem_bytes", UINT, ctypes.byref(mm), 8),
        OsslParam(None, 0, None, 0, 0),
    )
    kdf = lib.EVP_KDF_fetch(None, b"SCRYPT", None)
    if not kdf:
        raise KeystoreError("OpenSSL SCRYPT KDF unavailable")
    ctx = lib.EVP_KDF_CTX_new(kdf)
    out = ctypes.create_string_buffer(dklen)
    try:
        if lib.EVP_KDF_derive(ctx, out, dklen, params) != 1:
            raise KeystoreError(
                "scrypt refused by OpenSSL 3.0 (its provider computes "
                f"memory as ~16384*n*p and caps it: n={n} r={r} p={p} "
                "is over the cap regardless of maxmem).  geth-default "
                "parameters (r=8, p=1) are unaffected."
            )
    finally:
        lib.EVP_KDF_CTX_free.argtypes = [ctypes.c_void_p]
        lib.EVP_KDF_CTX_free(ctx)
        lib.EVP_KDF_free.argtypes = [ctypes.c_void_p]
        lib.EVP_KDF_free(kdf)
    return out.raw[:dklen]


def _xtime(a: int) -> int:
    """a * x in GF(2^8) modulo AES's polynomial x^8 + x^4 + x^3 + x + 1."""
    a <<= 1
    return a ^ 0x11B if a & 0x100 else a


def _make_sbox() -> tuple:
    """FIPS-197's S-box: the inverse in GF(2^8) (0 to 0), then the
    affine map.  p runs over the powers of the generator 3 and q over
    those of its inverse, so q = 1 / p at every step."""
    def rotl8(x, n):
        return ((x << n) | (x >> (8 - n))) & 0xFF

    sbox = [0x63] * 256
    p = q = 1
    while True:
        p ^= _xtime(p)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        sbox[p] = (q ^ rotl8(q, 1) ^ rotl8(q, 2) ^ rotl8(q, 3)
                   ^ rotl8(q, 4) ^ 0x63)
        if p == 1:
            return tuple(sbox)


_SBOX = _make_sbox()


def _aes128_round_keys(key16: bytes) -> list:
    """The 11 round keys of AES-128 (FIPS-197 §5.2), 16 bytes each."""
    w = [list(key16[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(11)]


def _aes128_block(round_keys: list, block: bytes) -> bytes:
    """One AES-128 encryption.  The state is FIPS-197's, column-major:
    byte i sits at row i % 4 of column i // 4."""
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows: row r turns left by r columns
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd < 10:
            mixed = []
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c:c + 4]
                x = a0 ^ a1 ^ a2 ^ a3
                mixed += [a0 ^ x ^ _xtime(a0 ^ a1), a1 ^ x ^ _xtime(a1 ^ a2),
                          a2 ^ x ^ _xtime(a2 ^ a3), a3 ^ x ^ _xtime(a3 ^ a0)]
            s = mixed
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


def _aes128_ctr(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    """AES-128 in counter mode: the IV is a 128-bit big-endian counter,
    one step a block, so encryption and decryption are the same map."""
    round_keys = _aes128_round_keys(key16)
    counter = int.from_bytes(iv16, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        pad = _aes128_block(round_keys, counter.to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[off:off + 16], pad))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)


def _derive_key(crypto: dict, password: bytes) -> bytes:
    kdf = crypto.get("kdf")
    params = crypto.get("kdfparams", {})
    salt = bytes.fromhex(params["salt"])
    dklen = int(params.get("dklen", 32))
    if kdf == "scrypt":
        return _scrypt(password, salt, int(params["n"]),
                       int(params["r"]), int(params["p"]), dklen)
    if kdf == "pbkdf2":
        if params.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeystoreError("unsupported pbkdf2 prf")
        return hashlib.pbkdf2_hmac(
            "sha256", password, salt, int(params["c"]), dklen
        )
    raise KeystoreError(f"unsupported kdf {kdf!r}")


def decrypt(keyfile: dict | str, password: str) -> bytes:
    """V3 JSON (dict or string) + password -> 32-byte ECDSA secret.

    Verifies the keccak MAC before decrypting (wrong password or
    tampered file fails loudly, never returns garbage)."""
    if isinstance(keyfile, str):
        keyfile = json.loads(keyfile)
    if int(keyfile.get("version", 0)) != 3:
        raise KeystoreError("only keystore version 3 is supported")
    crypto = keyfile.get("crypto") or keyfile.get("Crypto")
    if crypto is None:
        raise KeystoreError("no crypto section")
    if crypto.get("cipher") != "aes-128-ctr":
        raise KeystoreError(f"unsupported cipher {crypto.get('cipher')!r}")
    dk = _derive_key(crypto, password.encode())
    ct = bytes.fromhex(crypto["ciphertext"])
    mac = keccak256(dk[16:32] + ct)
    if mac.hex() != crypto["mac"].lower():
        raise KeystoreError("MAC mismatch (wrong password?)")
    iv = bytes.fromhex(crypto["cipherparams"]["iv"])
    return _aes128_ctr(dk[:16], iv.rjust(16, b"\x00"), ct)


def encrypt(secret: bytes, password: str, kdf: str = "scrypt",
            light: bool = False) -> dict:
    """32-byte secret + password -> V3 JSON dict (geth-compatible)."""
    if len(secret) != 32:
        raise KeystoreError("secret must be 32 bytes")
    salt = os.urandom(32)
    iv = os.urandom(16)
    if kdf == "scrypt":
        n = LIGHT_N if light else SCRYPT_N
        dk = _scrypt(password.encode(), salt, n, SCRYPT_R, SCRYPT_P, 32)
        kdfparams = {"dklen": 32, "n": n, "r": SCRYPT_R, "p": SCRYPT_P,
                     "salt": salt.hex()}
    elif kdf == "pbkdf2":
        c = 1024 if light else PBKDF2_C
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, c, 32)
        kdfparams = {"dklen": 32, "c": c, "prf": "hmac-sha256",
                     "salt": salt.hex()}
    else:
        raise KeystoreError(f"unsupported kdf {kdf!r}")
    ct = _aes128_ctr(dk[:16], iv, secret)
    from ..crypto_ecdsa import ECDSAKey

    address = ECDSAKey.from_bytes(secret).address()
    return {
        "version": 3,
        "id": str(uuid.uuid4()),
        "address": address.hex(),
        "crypto": {
            "cipher": "aes-128-ctr",
            "cipherparams": {"iv": iv.hex()},
            "ciphertext": ct.hex(),
            "kdf": kdf,
            "kdfparams": kdfparams,
            "mac": keccak256(dk[16:32] + ct).hex(),
        },
    }


def save(path: str, secret: bytes, password: str, **kw):
    blob = json.dumps(encrypt(secret, password, **kw))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(blob)
    os.replace(tmp, path)


def load(path: str, password: str) -> bytes:
    with open(path) as f:
        return decrypt(f.read(), password)
