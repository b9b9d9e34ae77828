"""The port's V3 keystore (``harmony_tpu_torch/accounts/keystore_v3.py``)
against the JAX package's: the spec's pbkdf2 vector, files made by either
package opened by the other (scrypt and pbkdf2), the same JSON from both
for a fixed salt, IV and uuid, and wrong passwords and tampered MACs
refused by both.  The port's AES-128-CTR is its own, in plain Python (the
card's machine has no ``cryptography`` package): it is held to FIPS-197's
and SP 800-38A's vectors and to the JAX module's cipher, which takes
``cryptography``'s, on random inputs."""

from __future__ import annotations

import hashlib
import json
import os
import uuid

import pytest

from harmony_tpu.accounts import keystore_v3 as JKS
from harmony_tpu_torch.accounts import keystore_v3 as TKS

PACKAGES = {"jax": JKS, "port": TKS}
_SECRET = bytes.fromhex(
    "7a28b5ba57c53603b0b07b56bba752f7784bf506fa95edc395f5cf6c7514fe9d")
# the Web3 Secret Storage Definition's pbkdf2 vector (password
# "testpassword")
_PBKDF2_VECTOR = {
    "crypto": {
        "cipher": "aes-128-ctr",
        "cipherparams": {"iv": "6087dab2f9fdbbfaddc31a909735c1e6"},
        "ciphertext": ("5318b4d5bcd28de64ee5559e671353e16f075ecae9f99c7a79"
                       "a38af5f869aa46"),
        "kdf": "pbkdf2",
        "kdfparams": {"c": 262144, "dklen": 32, "prf": "hmac-sha256",
                      "salt": ("ae3cd4e7013836a3df6bd7241b12db061dbe2c6785"
                               "853cce422d148a624ce0bd")},
        "mac": ("517ead924a9d0dc3124507e3393d175ce3ff7c1e96529c6c555ce9e5"
                "1205e9b2"),
    },
    "id": "3198bc9c-6672-5ab3-d995-4942343ae5b6",
    "version": 3,
}


def test_aes128_block_is_fips197s():
    keys = TKS._aes128_round_keys(bytes(range(16)))
    got = TKS._aes128_block(keys, bytes.fromhex(
        "00112233445566778899aabbccddeeff"))
    assert got.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_aes128_ctr_is_sp800_38a_f51():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    plain = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    want = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")
    assert TKS._aes128_ctr(key, iv, plain) == want
    assert TKS._aes128_ctr(key, iv, want) == plain


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 32, 33, 100])
def test_aes128_ctr_is_the_jax_modules(n):
    rng = hashlib.sha256(b"ctr-%d" % n).digest()
    key, data = rng[:16], (rng * 4)[:n]
    for iv in (rng[16:], b"\xff" * 16, b"\xff" * 15 + b"\xfe"):
        assert TKS._aes128_ctr(key, iv, data) == JKS._aes128_ctr(key, iv,
                                                                 data)


@pytest.mark.parametrize("name", PACKAGES)
def test_spec_pbkdf2_vector(name):
    assert PACKAGES[name].decrypt(_PBKDF2_VECTOR, "testpassword") == _SECRET


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
@pytest.mark.parametrize("maker, opener", [("jax", "port"), ("port", "jax")])
def test_files_open_in_the_other_package(kdf, maker, opener, tmp_path):
    path = str(tmp_path / "key.json")
    PACKAGES[maker].save(path, _SECRET, "hunter2", kdf=kdf, light=True)
    assert PACKAGES[opener].load(path, "hunter2") == _SECRET
    blob = json.loads(open(path).read())
    assert blob["crypto"]["kdf"] == kdf and blob["version"] == 3


def _fixed(monkeypatch):
    """os.urandom and uuid4 made deterministic: the salt and IV, and the
    file's id, are the same for both packages."""
    monkeypatch.setattr(os, "urandom", lambda n: hashlib.sha512(
        b"fixed-%d" % n).digest()[:n])
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(
        "3198bc9c-6672-5ab3-d995-4942343ae5b6"))


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
def test_fixed_salt_iv_and_uuid_give_the_same_json(kdf, monkeypatch):
    _fixed(monkeypatch)
    got = {k: json.dumps(m.encrypt(_SECRET, "pw", kdf=kdf, light=True),
                         sort_keys=True)
           for k, m in PACKAGES.items()}
    assert got["port"] == got["jax"]
    blob = json.loads(got["port"])
    assert blob["crypto"]["cipherparams"]["iv"] == os.urandom(16).hex()
    assert blob["crypto"]["kdfparams"]["salt"] == os.urandom(32).hex()


@pytest.mark.parametrize("name", PACKAGES)
def test_wrong_password_and_tampered_mac_fail(name):
    ks = PACKAGES[name]
    blob = TKS.encrypt(_SECRET, "pw", kdf="pbkdf2", light=True)
    with pytest.raises(ks.KeystoreError, match="MAC"):
        ks.decrypt(blob, "not-pw")
    for field in ("mac", "ciphertext"):
        bad = json.loads(json.dumps(blob))
        text = bad["crypto"][field]
        bad["crypto"][field] = ("0" if text[0] != "0" else "1") + text[1:]
        with pytest.raises(ks.KeystoreError, match="MAC"):
            ks.decrypt(bad, "pw")
    with pytest.raises(ks.KeystoreError):
        ks.decrypt(dict(blob, version=2), "pw")
