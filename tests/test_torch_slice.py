"""The port's quorum-verify slice, end to end on the CPU, against the JAX
package.

The committee table is carried across from the JAX package
(``harmony_tpu.device.CommitteeTable(points)._np`` into
``CommitteeTable.from_numpy``); the verdicts of
``agg_verify_batch_on_device(..., device="cpu")`` must equal those of the
JAX package's bigint twin (``harmony_tpu.ops.twin.agg_verify_batch``).
One port-side batch runs once per module.  Keys and signatures come from
a seeded ``random``.
"""

import random

import numpy as np
import pytest
import torch

from harmony_tpu import device as JD
from harmony_tpu.ops import interop as JI
from harmony_tpu.ops import twin as JTW
from harmony_tpu.ref import bls as RB
from harmony_tpu.ref.hash_to_curve import hash_to_g2 as j_hash_to_g2
from harmony_tpu.ref.params import R_ORDER
from harmony_tpu_torch import device as TD
from harmony_tpu_torch.kernels import _build as KB
from harmony_tpu_torch.kernels import final_exp as KF
from harmony_tpu_torch.kernels import fp12_cyclo_sqr as KC
from harmony_tpu_torch.kernels import fp12_mul as KM
from harmony_tpu_torch.kernels import fp_addsub as KA
from harmony_tpu_torch.kernels import fp_inv as KI
from harmony_tpu_torch.kernels import g1_masked_sum as KG
from harmony_tpu_torch.kernels import miller_loop as KML
from harmony_tpu_torch.kernels import mont_mul as K
from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2 as t_hash_to_g2

rng = random.Random(0x51CE)
SKS = [rng.randrange(1, R_ORDER) for _ in range(5)]
PKS = [RB.pubkey(sk) for sk in SKS]
PAYLOAD = b"harmony commit: shard 0, block 1673"
INFINITY_G2 = ((0, 0), (0, 0))


def _agg_sig(bits):
    return RB.sign(sum(sk for sk, b in zip(SKS, bits) if b) % R_ORDER,
                   PAYLOAD)


@pytest.fixture(scope="module")
def lanes():
    """Three replay lanes: a valid quorum certificate, the same signature
    under a bitmap with one bit flipped, and an infinity signature."""
    bits = [1, 1, 0, 1, 1]
    flipped = [1, 1, 1, 1, 1]
    sig = _agg_sig(bits)
    h = j_hash_to_g2(PAYLOAD)
    return {"bits": [bits, flipped, bits], "h": [h, h, h],
            "sig": [sig, sig, INFINITY_G2], "expect": [True, False, False]}


@pytest.fixture(scope="module")
def table():
    jax_table = JD.CommitteeTable(PKS)
    return TD.CommitteeTable.from_numpy(jax_table._np, jax_table.n,
                                        device="cpu")


@pytest.fixture(scope="module")
def port_verdicts(table, lanes):
    before = dict(TD.COUNTERS)
    out = TD.agg_verify_batch_on_device(table, lanes["bits"], lanes["h"],
                                        lanes["sig"])
    return out, before


def test_table_carries_across(table):
    jax_table = JD.CommitteeTable(PKS)
    assert (table.n, table.size) == (5, 8)
    np.testing.assert_array_equal(table.device_array().numpy(),
                                  jax_table._np)
    np.testing.assert_array_equal(
        TD.CommitteeTable(PKS, device="cpu").device_array().numpy(),
        jax_table._np)
    np.testing.assert_array_equal(table.pad_bits([1, 0, 1, 1, 0]),
                                  jax_table.pad_bits([1, 0, 1, 1, 0]))


def test_batch_verdicts_equal_the_jax_twin(port_verdicts, lanes):
    tbl = JD.CommitteeTable(PKS)
    bitmaps = np.stack([tbl.pad_bits(b) for b in lanes["bits"]])
    h_arrs = np.stack([JI.g2_affine_to_arr(h) for h in lanes["h"]])
    sig_arrs = np.stack([np.zeros((2, 2, 32), np.int32) if s == INFINITY_G2
                         else JI.g2_affine_to_arr(s) for s in lanes["sig"]])
    twin = JTW.agg_verify_batch(tbl._np, bitmaps, h_arrs, sig_arrs)
    assert port_verdicts[0] == [bool(x) for x in twin]


def test_batch_verdicts_are_as_constructed(port_verdicts, lanes):
    assert port_verdicts[0] == lanes["expect"]


def test_batch_counts_one_chunk_and_no_kernel_launch(port_verdicts):
    _, before = port_verdicts
    assert TD.COUNTERS["batch_verify"] == before["batch_verify"] + 1
    # CPU tensors never reach the CUDA kernels
    assert (K.LAUNCHES, KA.LAUNCHES, KM.LAUNCHES, KC.LAUNCHES, KML.LAUNCHES,
            KI.LAUNCHES, KG.LAUNCHES, KF.LAUNCHES) == (0,) * 8


def test_hash_to_g2_equals_jax_package():
    assert t_hash_to_g2(PAYLOAD) == j_hash_to_g2(PAYLOAD)


def test_buckets_match_jax_package():
    assert TD.COMMITTEE_BUCKETS == JD.COMMITTEE_BUCKETS
    assert TD.BATCH_BUCKETS_CPU == JD.BATCH_BUCKETS_CPU
    assert TD.BATCH_BUCKETS_GPU == JD.BATCH_BUCKETS_TPU
    for n in (1, 8, 9, 200, 1024):
        assert TD.committee_bucket(n) == JD.committee_bucket(n)
    with pytest.raises(ValueError):
        TD.committee_bucket(1025)
    assert [TD.batch_bucket(n, "cpu") for n in (3, 9, 300)] == [8, 64, 64]
    assert [TD.batch_bucket(n, "cuda") for n in (3, 65, 300)] == [8, 256, 256]


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.CommitteeTable(PKS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.verify_many_on_device(PKS[:1], [INFINITY_G2], [INFINITY_G2])
    assert TD.resolve_device("cpu") == torch.device("cpu")


def test_from_numpy_rejects_a_table_of_the_wrong_bucket():
    with pytest.raises(ValueError):
        TD.CommitteeTable.from_numpy(np.zeros((16, 2, 32), np.int32), 5,
                                     device="cpu")


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(KB, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(KB, "_lib", None)
    with pytest.raises(OSError):
        KB.build()
    assert KB._lib is None
