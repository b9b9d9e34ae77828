"""harmony_tpu_torch.ops.pairing against the JAX package's bigint pairing.

One port-side pairing product (two lanes, two pairs each) runs once per
module and every test reads it; the bigint reference
(harmony_tpu.ref.pairing) gives the expected GT elements.  Tolerance 0:
the GT element's canonical limbs are unique.  No JAX program is jitted
here: a pairing-shaped XLA:CPU compile takes minutes.
"""

import ast
import random
from pathlib import Path

import pytest
import torch

from harmony_tpu.ref import bls as RB
from harmony_tpu.ref import curve as RC
from harmony_tpu.ref import fields as RF
from harmony_tpu.ref import pairing as RP
from harmony_tpu.ref.params import R_ORDER
from harmony_tpu_torch.kernels import _build as KB
from harmony_tpu_torch.kernels import final_exp as KF
from harmony_tpu_torch.kernels import miller_loop as KML
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ops import pairing as PR
from harmony_tpu_torch.ops import _constants as C
from harmony_tpu_torch.ops import schedule as S
from harmony_tpu_torch.ops.limbs import limbs_to_int

rng = random.Random(0xA7E)


@pytest.fixture(scope="module")
def product():
    """Lane 0: e(P1, Q1) e(P2, Q2) for random points (a GT element that
    is not 1).  Lane 1: e(-G1, sig) e(pk, H(m)) for a valid signature
    (exactly 1)."""
    a, b, c, d = (rng.randrange(1, R_ORDER) for _ in range(4))
    lane0 = [(RC.g1.mul(RC.G1_GEN, a), RC.g2.mul(RC.G2_GEN, b)),
             (RC.g1.mul(RC.G1_GEN, c), RC.g2.mul(RC.G2_GEN, d))]
    sk = rng.randrange(1, R_ORDER)
    msg = b"commit block 0x42"
    from harmony_tpu.ref.hash_to_curve import hash_to_g2

    lane1 = [(RC.g1.neg(RC.G1_GEN), RB.sign(sk, msg)),
             (RB.pubkey(sk), hash_to_g2(msg))]
    lanes = [lane0, lane1]
    # (K pairs, B lanes, ...) with the pair axis first, as verify builds it
    ps = torch.stack([torch.stack([TI.g1_affine_to_arr(lane[k][0])
                                   for lane in lanes]) for k in range(2)])
    qs = torch.stack([torch.stack([TI.g2_affine_to_arr(lane[k][1])
                                   for lane in lanes]) for k in range(2)])
    gt = PR.pairing_product(ps, qs)
    return {"gt": gt, "lanes": lanes}


def test_product_shape_and_dtype(product):
    assert product["gt"].shape == (2, 2, 3, 2, 32)
    assert product["gt"].dtype == torch.int32


def test_gt_element_equals_bigint_pairing(product):
    expect = RP.multi_pairing(product["lanes"][0])
    assert expect != RF.FP12_ONE
    assert TI.arr_to_fp12(product["gt"][0]) == expect


def test_valid_signature_product_is_one(product):
    assert TI.arr_to_fp12(product["gt"][1]) == RF.FP12_ONE


def test_is_one_per_lane(product):
    assert PR.is_one(product["gt"]).tolist() == [False, True]


def test_schedules_match_the_bits_of_x():
    """The static square-and-multiply schedules replay |x| and |x| + 1."""
    for sched, e in ((S.X_SCHED, S.ABS_X), (S.XM1_SCHED, S.ABS_X + 1)):
        acc = 1
        for n_sqr, do_mul in zip(*sched):
            acc <<= n_sqr
            acc += do_mul
        assert acc == e


def test_generated_header_carries_the_loop_schedule():
    """The kernels' generated header gives the Miller loop |x|'s schedule
    from ops/schedule.py; the build layer reads it there and imports no op
    module above the constants (ops/pairing.py imports the build)."""
    defs = dict(line.split(" ", 2)[1:]
                for line in KB.params_header().splitlines())
    for name, want in (("HARMONY_MILLER_DBL", S.X_SCHED[0]),
                       ("HARMONY_MILLER_ADD", S.X_SCHED[1])):
        assert tuple(map(int, defs[name].split(", "))) == want
    tree = ast.parse(Path(KB.__file__).read_text(encoding="utf-8"))
    ops = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
           and n.module == "ops" and n.level == 2 for a in n.names}
    ops |= {n.module.split(".")[1] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level == 2
            and (n.module or "").startswith("ops.")}
    assert ops <= {"_constants", "limbs", "schedule"}, ops


def _stub_miller(monkeypatch):
    """Replace the plain loop by a stub that records its calls."""
    calls = []
    monkeypatch.setattr(PR, "miller_loop_reference",
                        lambda p, q: calls.append((p, q)) or "plain")
    return calls


def test_cpu_miller_loop_takes_the_plain_version_and_launches_nothing(
        monkeypatch):
    calls = _stub_miller(monkeypatch)
    p = torch.zeros(2, 2, 32, dtype=torch.int32)
    q = torch.zeros(2, 2, 2, 32, dtype=torch.int32)
    assert PR.miller_loop(p, q) == "plain"
    assert len(calls) == 1 and calls[0][0] is p and calls[0][1] is q
    assert KML.LAUNCHES == 0


def test_miller_loop_off_the_cpu_goes_to_the_kernel_and_never_falls_back(
        monkeypatch):
    """Tensors that are not on the CPU reach the kernel's wrapper, which
    launches or raises: here (no card) it raises, and the plain loop is
    never called."""
    calls = _stub_miller(monkeypatch)
    p = torch.empty(2, 2, 32, dtype=torch.int32, device="meta")
    q = torch.empty(2, 2, 2, 32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        PR.miller_loop(p, q)
    assert calls == []
    assert KML.LAUNCHES == 0


def test_miller_loop_kernel_refuses_cpu_tensors_dtypes_and_shapes():
    p = torch.zeros(2, 2, 32, dtype=torch.int32)
    q = torch.zeros(2, 2, 2, 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KML.miller_loop(p, q)
    with pytest.raises(TypeError, match="int32"):
        KML.miller_loop(p.long(), q)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2, 2, 32\)"):
        KML.miller_loop(p, q[..., 0, :])
    assert KML.LAUNCHES == 0


def _header_defs():
    return dict(line.split(" ", 2)[1:]
                for line in KB.params_header().splitlines())


def test_generated_header_carries_the_final_exponentiation_constants():
    """The final exponentiation's kernel gets |x - 1|'s schedule from
    ops/schedule.py and the Frobenius constants of ops/_constants.py,
    FROB_GAMMA[k - 1][m] for k = 1..3 and m = 0..5 as Fp2 pairs of 12
    little-endian 32-bit words, in that order."""
    defs = _header_defs()
    for name, want in (("HARMONY_XM1_SQR", S.XM1_SCHED[0]),
                       ("HARMONY_XM1_MUL", S.XM1_SCHED[1])):
        assert tuple(map(int, defs[name].split(", "))) == want
    words = [int(w.rstrip("u"), 16)
             for w in defs["HARMONY_FROB_WORDS"].split(", ")]
    got = [sum(w << (32 * j) for j, w in enumerate(words[i:i + 12]))
           for i in range(0, len(words), 12)]
    assert got == [limbs_to_int(limbs) for gammas in C.FROB_GAMMA
                   for pair in gammas for limbs in pair]
    assert len(got) == 3 * 6 * 2


def _stub_final_exp(monkeypatch):
    """Replace the plain final exponentiation by a stub that records its
    calls."""
    calls = []
    monkeypatch.setattr(PR, "final_exponentiation_reference",
                        lambda f: calls.append(f) or "plain")
    return calls


def test_cpu_final_exp_takes_the_plain_version_and_launches_nothing(
        monkeypatch):
    calls = _stub_final_exp(monkeypatch)
    f = torch.zeros(2, 2, 3, 2, 32, dtype=torch.int32)
    assert PR.final_exponentiation(f) == "plain"
    assert len(calls) == 1 and calls[0] is f
    assert KF.LAUNCHES == 0


def test_final_exp_off_the_cpu_goes_to_the_kernel_and_never_falls_back(
        monkeypatch):
    """Tensors that are not on the CPU reach the kernel's wrapper, which
    launches or raises: here (no card) it raises, through
    final_exponentiation, pairing and pairing_product, and the plain
    version is never called."""
    calls = _stub_final_exp(monkeypatch)
    monkeypatch.setattr(PR, "miller_loop", lambda p, q: torch.empty(
        (*q.shape[:-3], 2, 3, 2, 32), dtype=torch.int32, device="meta"))
    f = torch.empty(2, 2, 3, 2, 32, dtype=torch.int32, device="meta")
    # one pair: the product over pairs needs no Fp12 product first
    p = torch.empty(1, 3, 2, 32, dtype=torch.int32, device="meta")
    q = torch.empty(1, 3, 2, 2, 32, dtype=torch.int32, device="meta")
    for call in (lambda: PR.final_exponentiation(f),
                 lambda: PR.pairing(p[0], q[0]),
                 lambda: PR.pairing_product(p, q)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert calls == []
    assert KF.LAUNCHES == 0


def test_final_exp_kernel_refuses_cpu_tensors_dtypes_and_shapes():
    f = torch.zeros(2, 2, 3, 2, 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KF.final_exp(f)
    with pytest.raises(TypeError, match="int32"):
        KF.final_exp(f.long())
    with pytest.raises(ValueError, match=r"\(\.\.\., 2, 3, 2, 32\)"):
        KF.final_exp(f[..., 0, :, :, :])
    assert KF.LAUNCHES == 0
