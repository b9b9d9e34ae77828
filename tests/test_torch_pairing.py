"""harmony_tpu_torch.ops.pairing against the JAX package's bigint pairing.

One port-side pairing product (two lanes, two pairs each) runs once per
module and every test reads it; the bigint reference
(harmony_tpu.ref.pairing) gives the expected GT elements.  Tolerance 0:
the GT element's canonical limbs are unique.  No JAX program is jitted
here: a pairing-shaped XLA:CPU compile takes minutes.
"""

import random

import pytest
import torch

from harmony_tpu.ref import bls as RB
from harmony_tpu.ref import curve as RC
from harmony_tpu.ref import fields as RF
from harmony_tpu.ref import pairing as RP
from harmony_tpu.ref.params import R_ORDER
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ops import pairing as PR

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
    for sched, e in ((PR._X_SCHED, PR._ABS_X), (PR._XM1_SCHED, PR._ABS_X + 1)):
        acc = 1
        for n_sqr, do_mul in zip(*sched):
            acc <<= n_sqr
            acc += do_mul
        assert acc == e
