"""The port's key stores against the JAX package's: ``keystore.py``
(passphrase-encrypted BLS key files) and ``blsgen_kms.py`` (KMS
envelopes), and the binary's resolver ``cli.load_node_bls_keys``.  A key
file or envelope written by one package opens in the other to the same
key; a wrong passphrase, a tampered file and a wrong master key fail in
both with the same error."""

import json

import pytest

from harmony_tpu import bls as J_B
from harmony_tpu import blsgen_kms as J_KMS
from harmony_tpu import keystore as J_KS
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import blsgen_kms as T_KMS
from harmony_tpu_torch import keystore as T_KS

PACKAGES = {"jax": (J_B, J_KS, J_KMS), "port": (T_B, T_KS, T_KMS)}
PAIRS = [("jax", "port"), ("port", "jax")]


def _key(B, i):
    return B.PrivateKey.generate(b"keystore-interop-%d" % i)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_a_key_file_opens_in_the_other_package(tmp_path, writer, reader):
    wB, wKS, _ = PACKAGES[writer]
    rB, rKS, _ = PACKAGES[reader]
    sk = _key(wB, 1)
    path = tmp_path / "validator.key"
    wKS.save_key(str(path), sk, "hunter2")
    got = rKS.load_key(str(path), "hunter2")
    assert got.scalar == sk.scalar
    assert got.pub.bytes == _key(rB, 1).pub.bytes == sk.pub.bytes
    # several files, one passphrase each
    pairs = []
    for i in range(3):
        p = tmp_path / f"k{i}.key"
        wKS.save_key(str(p), _key(wB, 10 + i), f"pw{i}")
        pairs.append((str(p), f"pw{i}"))
    assert [k.pub.bytes for k in rKS.load_keys(pairs)] == [
        _key(wB, 10 + i).pub.bytes for i in range(3)]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_wrong_passphrase_and_tampering_fail_in_both(writer, reader):
    wB, wKS, _ = PACKAGES[writer]
    _, rKS, _ = PACKAGES[reader]
    blob = wKS.encrypt_key(_key(wB, 2), "correct")
    errors = []
    for KS in (rKS, wKS):
        with pytest.raises(ValueError) as e:
            KS.decrypt_key(blob, "incorrect")
        errors.append(str(e.value))
    doc = json.loads(blob)
    ct = bytearray(bytes.fromhex(doc["ciphertext"]))
    ct[0] ^= 1
    doc["ciphertext"] = bytes(ct).hex()
    for KS in (rKS, wKS):
        with pytest.raises(ValueError) as e:
            KS.decrypt_key(json.dumps(doc).encode(), "correct")
        errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            KS.decrypt_key(b"not json", "pw")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "wrong passphrase" in errors[0]
    assert errors[2:4] == errors[4:6]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_a_kms_envelope_opens_in_the_other_package(tmp_path, writer,
                                                   reader):
    wB, _, wKMS = PACKAGES[writer]
    _, _, rKMS = PACKAGES[reader]
    wKMS.LocalKMSProvider.generate_master(str(tmp_path / "master"))
    sk = _key(wB, 3)
    wKMS.save_kms_key(str(tmp_path / "k.kms"), sk.bytes,
                      wKMS.LocalKMSProvider(str(tmp_path / "master")))
    provider = rKMS.LocalKMSProvider(str(tmp_path / "master"))
    assert rKMS.load_kms_key(str(tmp_path / "k.kms"), provider) == sk.bytes
    # another master key fails closed in both packages, with one message
    rKMS.LocalKMSProvider.generate_master(str(tmp_path / "other"))
    messages = []
    for KMS in (rKMS, wKMS):
        with pytest.raises(ValueError) as e:
            KMS.load_kms_key(str(tmp_path / "k.kms"),
                             KMS.LocalKMSProvider(str(tmp_path / "other")))
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_the_binarys_key_resolver_reads_the_jax_packages_files(
        tmp_path, monkeypatch):
    """cli.load_node_bls_keys of the port, over files the JAX package
    wrote (passphrase file, env, a multikey directory, a KMS envelope),
    resolves the keys the JAX package's resolver does."""
    from harmony_tpu.cli import load_node_bls_keys as j_load
    from harmony_tpu_torch.cli import load_node_bls_keys as t_load

    keys = [_key(J_B, 20 + i) for i in range(4)]
    J_KS.save_key(str(tmp_path / "a.key"), keys[0], "pw-one")
    (tmp_path / "a.pass").write_text("pw-one\n")
    J_KS.save_key(str(tmp_path / "b.key"), keys[1], "pw-two")
    monkeypatch.setenv("B_PASS", "pw-two")
    d = tmp_path / "multikey"
    d.mkdir()
    J_KS.save_key(str(d / "c.key"), keys[2], "pw-dir")
    (tmp_path / "dir.pass").write_text("pw-dir")
    J_KMS.LocalKMSProvider.generate_master(str(tmp_path / "master"))
    J_KMS.save_kms_key(str(tmp_path / "d.kms"), keys[3].bytes,
                       J_KMS.LocalKMSProvider(str(tmp_path / "master")))
    cfg = {
        "bls_keys": [
            {"path": str(tmp_path / "a.key"),
             "passphrase_file": str(tmp_path / "a.pass")},
            {"path": str(tmp_path / "b.key"), "passphrase_env": "B_PASS"},
            {"path": str(tmp_path / "d.kms"), "kms": True},
        ],
        "bls_dir": str(d),
        "bls_dir_passphrase_file": str(tmp_path / "dir.pass"),
        "kms_master_key": str(tmp_path / "master"),
    }
    got = [k.pub.bytes for k in t_load(cfg)]
    assert got == [k.pub.bytes for k in j_load(cfg)]
    assert set(got) == {k.pub.bytes for k in keys}
    for bad in ([{"path": str(tmp_path / "b.key"),
                  "passphrase_env": "NOPE"}],
                [{"path": str(tmp_path / "b.key")}]):
        for load in (t_load, j_load):
            with pytest.raises(ValueError):
                load({"bls_keys": bad})
