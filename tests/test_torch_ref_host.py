"""The port's host path against the JAX package's: ref/native (the port's
own build of native/bls381.cpp), ref/serialize, ref/pairing, ref/bls and
both branches of ref/hash_to_curve.

Inputs are seeded (``random.Random``); points, GT elements, bytes and
verdicts must be equal, and every malformed encoding must be refused by
both packages with the same error.  The library builds once, at the
first test that needs it, into ``harmony_tpu_torch/_build/``.
"""

import os
import random
import stat
import threading

import pytest

from harmony_tpu.ref import bls as J_RB
from harmony_tpu.ref import fields as J_F
from harmony_tpu.ref import hash_to_curve as J_HC
from harmony_tpu.ref import pairing as J_PR
from harmony_tpu.ref import serialize as J_SZ
from harmony_tpu.ref.curve import G1_GEN, G2_GEN, g1, g2
from harmony_tpu.ref.params import H2, P, R_ORDER
from harmony_tpu_torch.ref import bls as T_RB
from harmony_tpu_torch.ref import fields as T_F
from harmony_tpu_torch.ref import hash_to_curve as T_HC
from harmony_tpu_torch.ref import native as T_NB
from harmony_tpu_torch.ref import pairing as T_PR
from harmony_tpu_torch.ref import serialize as T_SZ

rng = random.Random(0x5EED)
SCALARS = [rng.randrange(1, R_ORDER) for _ in range(3)]
MSG = b"0123456789abcdef0123456789abcdef"


@pytest.fixture(scope="module")
def native():
    """The port's library, built from harmony_tpu_torch/native/."""
    assert T_NB.available(), "the port's native library did not build"
    return T_NB


def test_library_builds_from_the_ports_source(native):
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "harmony_tpu_torch"
    assert native._lib is not None and native._lib.hbls_ready() == 1


def test_build_is_locked_and_atomic(native, tmp_path, monkeypatch):
    """Concurrent first uses run one compiler and all load one finished
    file; no temporary file is left behind."""
    calls = tmp_path / "calls"
    fake = tmp_path / "cxx"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        "sleep 0.3\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        f'cp {native.library_path()} "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out = []
    threads = [threading.Thread(target=lambda: out.append(native._build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(out)) == 1 and len(out) == 4
    assert calls.read_text().count("x") == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        sorted([out[0].name, "bls381.lock"])


def test_library_failing_to_build_leaves_the_bigint_path(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(T_NB, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(T_NB, "_lib", None)
    monkeypatch.setattr(T_NB, "_avail", None)
    assert T_NB.available() is False


# -- native against the JAX package's bigint reference ------------------------------


def test_native_scalar_mul_and_sums(native):
    ks = [1, 2, 3, R_ORDER - 1, R_ORDER, R_ORDER + 5, H2, -3] + SCALARS
    assert [native.g1_mul(G1_GEN, k) for k in ks] == \
        [g1.mul(G1_GEN, k) for k in ks]
    assert [native.g2_mul(G2_GEN, k) for k in ks[:4] + ks[-1:]] == \
        [g2.mul(G2_GEN, k) for k in ks[:4] + ks[-1:]]
    assert native.g1_mul(G1_GEN, 0) is None and native.g1_mul(None, 5) is None
    pts1 = [g1.mul(G1_GEN, k) for k in (1, 5, 9, 13)]
    assert native.g1_sum(pts1) == g1.mul(G1_GEN, 28)
    assert native.g2_sum([g2.mul(G2_GEN, k) for k in (2, 4, 8)]) == \
        g2.mul(G2_GEN, 14)
    assert native.g1_sum([]) is None
    assert native.g1_sum([None, G1_GEN, None]) == G1_GEN
    assert native.g1_sum([G1_GEN, g1.neg(G1_GEN)]) is None


def test_native_subgroup_and_sqrt(native):
    assert native.g1_in_subgroup(G1_GEN) and native.g2_in_subgroup(G2_GEN)
    assert native.g1_in_subgroup(None)
    x = 1
    while True:
        y = J_F.fp_sqrt((x * x * x + 4) % P)
        if y is not None and g1.mul((x, y), R_ORDER) is not None:
            break
        x += 1
    assert not native.g1_in_subgroup((x, y))
    assert not native.g1_in_subgroup((G1_GEN[0], (G1_GEN[1] + 1) % P))
    for seed in range(8):
        a = (pow(3, seed + 2, P), pow(5, seed + 3, P))
        sq = J_F.fp2_sqr(a)
        assert native.fp2_sqrt(sq) == J_F.fp2_sqrt(sq) == T_F.fp2_sqrt(sq)
        assert native.fp_sqrt(a[0] * a[0] % P) == J_F.fp_sqrt(a[0] * a[0] % P)
    probe = (2, 0)
    while J_F.fp2_sqrt(probe) is not None:
        probe = (probe[0] + 1, 1)
    assert native.fp2_sqrt(probe) is None


def test_native_pairing_against_the_bigint_pairing(native):
    p, q = g1.mul(G1_GEN, 7), g2.mul(G2_GEN, 11)
    gt = J_PR.pairing(p, q)
    assert native.multi_pairing([(p, q)]) == gt
    assert T_PR.pairing(p, q) == gt
    pairs = [(g1.mul(G1_GEN, 3), G2_GEN), (g1.neg(G1_GEN), g2.mul(G2_GEN, 3))]
    assert native.pairing_check(pairs)
    assert not native.pairing_check([(G1_GEN, G2_GEN)])
    assert native.multi_pairing([(None, G2_GEN)]) == T_F.FP12_ONE
    assert native.pairing_check([])


# -- ref/pairing ----------------------------------------------------------------------


def test_pairing_multi_and_projective_against_the_jax_package():
    pairs = [(g1.neg(G1_GEN), g2.dbl(G2_GEN)), (g1.dbl(G1_GEN), G2_GEN)]
    assert T_PR.multi_pairing(pairs) == J_PR.multi_pairing(pairs) == \
        T_F.FP12_ONE
    f = T_PR.miller_loop_projective(G1_GEN, G2_GEN)
    assert f == J_PR.miller_loop_projective(G1_GEN, G2_GEN)
    assert T_PR.miller_loop(None, G2_GEN) == T_F.FP12_ONE


# -- ref/bls and ref/serialize ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["native", "bigint"])
def test_bls_sign_verify_aggregate_against_the_jax_package(mode, native,
                                                           monkeypatch):
    sks = [T_RB.keygen(bytes([i])) for i in range(3)]
    assert sks == [J_RB.keygen(bytes([i])) for i in range(3)]
    want_sigs = [J_RB.sign(sk, MSG) for sk in sks[:2]]
    if mode == "bigint":
        monkeypatch.setenv("HOST_BLS", "bigint")
    pks = [T_RB.pubkey(sk) for sk in sks]
    assert pks == [g1.mul(G1_GEN, sk) for sk in sks]
    sigs = [T_RB.sign(sks[0], MSG)] + want_sigs[1:]
    assert sigs == want_sigs
    agg = T_RB.aggregate_sigs(sigs)
    assert agg == g2.add(sigs[0], sigs[1])
    assert T_RB.aggregate_pubkeys(pks[:2]) == g1.add(pks[0], pks[1])
    assert T_RB.verify_aggregate(pks[:2], MSG, agg)
    assert not T_RB.verify_aggregate(pks, MSG, agg)
    assert not T_RB.verify(None, MSG, sigs[0])
    if mode == "native":
        assert T_RB.verify(pks[0], MSG, sigs[0])
        assert not T_RB.verify(pks[1], MSG, sigs[0])


@pytest.mark.parametrize("k", SCALARS + [1, R_ORDER - 1])
def test_compress_decompress_against_the_jax_package(k, native):
    p1, p2 = g1.mul(G1_GEN, k), g2.mul(G2_GEN, k)
    b1, b2 = T_SZ.g1_compress(p1), T_SZ.g2_compress(p2)
    assert (b1, b2) == (J_SZ.g1_compress(p1), J_SZ.g2_compress(p2))
    assert T_SZ.g1_decompress(b1) == p1 and T_SZ.g2_decompress(b2) == p2
    negb = T_SZ.g1_compress(g1.neg(p1))
    assert negb[0] ^ b1[0] == 0x20
    assert T_RB.sk_from_bytes(T_RB.sk_to_bytes(k)) == k % R_ORDER


def _off_subgroup_g1():
    x = 1
    while True:
        y = J_F.fp_sqrt((x * x * x + 4) % P)
        if y is not None and g1.mul((x, y), R_ORDER) is not None:
            return J_SZ.g1_compress((x, y))
        x += 1


def _off_curve_x_g1():
    x = 0
    while J_F.fp_sqrt((x * x * x + 4) % P) is not None:
        x += 1
    return bytes([0x80]) + x.to_bytes(48, "big")[1:]


MALFORMED = {
    "g1 short": ("g1", lambda: bytes(47)),
    "g1 uncompressed": ("g1", lambda: bytes(48)),
    "g1 junk infinity": ("g1", lambda: bytes([0xC0]) + bytes(46) + b"\x01"),
    "g1 infinity with sign": ("g1", lambda: bytes([0xE0]) + bytes(47)),
    "g1 x >= p": ("g1", lambda: bytes([0x80 | (P >> 376)])
                  + (P % (1 << 376)).to_bytes(47, "big")),
    "g1 x off the curve": ("g1", _off_curve_x_g1),
    "g1 off the subgroup": ("g1", _off_subgroup_g1),
    "g2 short": ("g2", lambda: bytes(95)),
    "g2 uncompressed": ("g2", lambda: bytes(96)),
    "g2 junk infinity": ("g2", lambda: bytes([0xC0]) + bytes(94) + b"\x02"),
    "g2 x0 >= p": ("g2", lambda: bytes([0x80]) + bytes(47)
                   + P.to_bytes(48, "big")),
    "g2 x off the subgroup": ("g2", lambda: bytes([0x80]) + bytes(46)
                              + b"\x01" + bytes(47) + b"\x05"),
}


@pytest.mark.parametrize("mode", ["native", "bigint"])
@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_bytes_refused_as_the_jax_package(case, mode, native,
                                                    monkeypatch):
    if mode == "bigint":
        monkeypatch.setenv("HOST_BLS", "bigint")
    group, make = MALFORMED[case]
    data = make()
    errors = []
    for sz in (J_SZ, T_SZ):
        with pytest.raises(ValueError) as e:
            getattr(sz, f"{group}_decompress")(data)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError):
        getattr(T_RB, "pubkey_from_bytes" if group == "g1"
                else "sig_from_bytes")(data)


def test_infinity_encodings():
    assert T_RB.pubkey_from_bytes(bytes([0xC0]) + bytes(47)) is None
    assert T_RB.sig_from_bytes(bytes([0xC0]) + bytes(95)) is None
    assert T_SZ.g1_compress(None) == J_SZ.g1_compress(None)
    assert T_SZ.g2_compress(None) == J_SZ.g2_compress(None)


# -- ref/hash_to_curve: both branches ----------------------------------------------


HASH_MSGS = [b"\x00" * 32, b"parity-vector-1", b"\xff" * 32]


def test_hash_to_g2_native_and_pure_python_branches(native, monkeypatch):
    want = [J_HC.hash_to_g2(m) for m in HASH_MSGS]
    assert [T_HC.hash_to_g2(m) for m in HASH_MSGS] == want
    assert T_HC.map_to_twist(HASH_MSGS[0]) == J_HC.map_to_twist(HASH_MSGS[0])
    monkeypatch.setenv("HOST_BLS", "bigint")
    assert not T_NB.available()
    assert [T_HC.hash_to_g2(m) for m in HASH_MSGS] == want
    tw = T_HC.map_to_twist(HASH_MSGS[1])
    assert g2.is_on_curve(tw)
    assert g2.mul(want[0], R_ORDER) is None and g2.is_on_curve(want[0])


def test_the_port_keeps_the_public_names():
    import harmony_tpu.ref.native as J_NB

    for jax_mod, port_mod in ((J_NB, T_NB), (J_SZ, T_SZ), (J_PR, T_PR),
                              (J_RB, T_RB), (J_HC, T_HC)):
        public = {n for n, v in vars(jax_mod).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "") == jax_mod.__name__}
        assert public <= set(vars(port_mod)), (jax_mod.__name__,
                                               public - set(vars(port_mod)))
    assert os.path.basename(T_NB.SOURCE) == "bls381.cpp"
