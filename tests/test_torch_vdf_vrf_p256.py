"""The port's host crypto with no node caller against the JAX package's:
the sha3-chain VDF, the Wesolowski class-group VDF at small bit sizes
(discriminants, forms, outputs and proofs, each package verifying the
other's) and the P-256 VRF (keys, outputs and proofs for a fixed nonce
``r``, each package verifying the other's, forgeries refused by both)."""

from __future__ import annotations

import pytest

from harmony_tpu import crypto_vrf_p256 as JV
from harmony_tpu import vdf as JVDF
from harmony_tpu import vdf_wesolowski as JW
from harmony_tpu_torch import crypto_vrf_p256 as TV
from harmony_tpu_torch import vdf as TVDF
from harmony_tpu_torch import vdf_wesolowski as TW


@pytest.mark.parametrize("difficulty", [1, 7, 100])
def test_hash_chain_vdf_is_the_jax_packages(difficulty):
    port = TVDF.VDF(difficulty).evaluate(b"epoch-seed")
    assert port == JVDF.VDF(difficulty).evaluate(b"epoch-seed")
    assert TVDF.VDF(difficulty).verify(b"epoch-seed", port)
    assert not TVDF.VDF(difficulty + 1).verify(b"epoch-seed", port)
    assert (TVDF.vrf_plus_vdf_randomness(b"vrf", port)
            == JVDF.vrf_plus_vdf_randomness(b"vrf", port))


@pytest.mark.parametrize("bits", [128, 256])
def test_class_group_is_the_jax_packages(bits):
    D = TW.create_discriminant(b"group", bits)
    assert D == JW.create_discriminant(b"group", bits)
    assert D < 0 and (-D) % 8 == 7 and TW.is_probable_prime(-D)
    for e in (0, 1, 5, 77):
        assert (TW.generator(D).pow(e).serialize()
                == JW.generator(D).pow(e).serialize())
    f = TW.generator(D).pow(77)
    assert TW.Form.deserialize(f.serialize(), D) == f
    assert TW.hash_prime(b"x") == JW.hash_prime(b"x")


@pytest.mark.parametrize("difficulty, bits", [(16, 128), (160, 256)])
def test_wesolowski_outputs_and_proofs_agree(difficulty, bits):
    seed = b"epoch-randomness-seed"
    out, proof = TW.WesolowskiVDF(difficulty, bits).evaluate(seed)
    j_out, j_proof = JW.WesolowskiVDF(difficulty, bits).evaluate(seed)
    assert out == j_out
    assert (proof.y.serialize(), proof.pi.serialize()) == (
        j_proof.y.serialize(), j_proof.pi.serialize())
    # each package verifies the other's proof, carried as bytes
    D = TW.create_discriminant(seed, bits)
    as_port = TW.WesolowskiProof(TW.Form.deserialize(j_proof.y.serialize(), D),
                                 TW.Form.deserialize(j_proof.pi.serialize(), D))
    as_jax = JW.WesolowskiProof(JW.Form.deserialize(proof.y.serialize(), D),
                                JW.Form.deserialize(proof.pi.serialize(), D))
    assert TW.WesolowskiVDF(difficulty, bits).verify(seed, j_out, as_port)
    assert JW.WesolowskiVDF(difficulty, bits).verify(seed, out, as_jax)
    if difficulty > 128:
        # 2^T / l > 1 (l has 128 bits): pi is no identity, so a tampered
        # pi must fail
        fake = TW.WesolowskiProof(proof.y, proof.pi.square())
        assert not TW.WesolowskiVDF(difficulty, bits).verify(seed, out, fake)
    assert not TW.WesolowskiVDF(difficulty, bits).verify(b"other", out, proof)


@pytest.mark.parametrize("seed, msg, r", [
    (b"vrf-seed", b"epoch-7-entropy", 999),
    (b"a", b"msg", 2**200 + 12345),
    (b"b", b"", 1),
])
def test_p256_vrf_outputs_and_proofs_agree(seed, msg, r):
    sk = TV.keygen(seed)
    assert sk == JV.keygen(seed)
    pk = TV.pubkey(sk)
    assert TV.serialize_pubkey(pk) == JV.serialize_pubkey(JV.pubkey(sk))
    idx, proof = TV.evaluate(sk, msg, r=r)
    assert (idx, proof) == JV.evaluate(sk, msg, r=r)
    assert TV.proof_to_hash(pk, msg, proof) == idx
    assert JV.proof_to_hash(JV.deserialize_pubkey(TV.serialize_pubkey(pk)),
                            msg, proof) == idx
    assert TV.h1(msg) == JV.h1(msg) and TV.h2(msg) == JV.h2(msg)


@pytest.mark.parametrize("package", [JV, TV], ids=["jax", "port"])
def test_p256_vrf_forgeries_refused(package):
    sk = package.keygen(b"a")
    pk = package.pubkey(sk)
    _, proof = package.evaluate(sk, b"msg", r=4242)
    bad = bytearray(proof)
    bad[70] ^= 1
    for pk_, msg, prf in ((pk, b"other-msg", proof),
                          (package.pubkey(package.keygen(b"b")), b"msg", proof),
                          (pk, b"msg", bytes(bad)), (pk, b"msg", proof[:-1])):
        with pytest.raises(ValueError):
            package.proof_to_hash(pk_, msg, prf)
    with pytest.raises(ValueError):
        package.deserialize_pubkey(b"\x01" * 64)
