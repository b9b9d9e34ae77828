"""harmony_tpu_torch.parallel.mesh over torch.distributed on the CPU (gloo).

Two ranks run in spawned processes, each with its own shard, and the
``sharded_*`` results are held against the unsharded port and the bigint
reference (``ref``): the masked sum's Jacobian limbs against the plain
per-chunk sums merged in rank order (the JAX package's order), its
affine point against the reference sum; the pairing product's GT element
and the verdicts against the reference pairing.  The ranks have a time
limit of their own, and a rank that dies or hangs fails the test.  Then
world size 1 in this process, with the checks that need no collective
and the forged aggregate (a pairing product takes seconds on the CPU, so
each check runs once).  Inputs come from a seeded ``random``.
"""

import multiprocessing
import queue
import random
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from harmony_tpu_torch.ops import bls as TB
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.parallel import mesh as M
from harmony_tpu_torch.ref import pairing as RP
from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
from harmony_tpu_torch.ref.params import R_ORDER

RANK_TIMEOUT_S = 60
N_KEYS = 8  # 4 a rank at world size 2

rng = random.Random(0x3E5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """Committee keys (Jacobian) and a bitmap with a key twice and one off;
    a hashed message, the aggregate signature of the selected keys and a
    forged one; per-lane single checks (two lanes, one a wrong key); and
    two pairs for the pairing product."""
    sks = [rng.randrange(1, R_ORDER) for _ in range(N_KEYS)]
    sks[5] = sks[1]
    bitmap = [1, 1, 0, 1, 1, 1, 1, 0]
    h = g2.mul(G2_GEN, rng.randrange(1, R_ORDER))
    agg_sk = sum(k for k, b in zip(sks, bitmap) if b == 1) % R_ORDER
    pks = [g1.mul(G1_GEN, k) for k in sks]
    pairs = [(g1.mul(G1_GEN, rng.randrange(1, R_ORDER)),
              g2.mul(G2_GEN, rng.randrange(1, R_ORDER))) for _ in range(2)]
    return {
        "keys": torch.stack([TI.g1_affine_to_jacobian_arr(p) for p in pks]),
        "bitmap": torch.tensor(bitmap, dtype=torch.int32),
        "h": TI.g2_affine_to_arr(h),
        "sig": TI.g2_affine_to_arr(g2.mul(h, agg_sk)),
        "forged": TI.g2_affine_to_arr(g2.mul(h, agg_sk + 1)),
        "pk": torch.stack([TI.g1_affine_to_arr(pks[0]),
                           TI.g1_affine_to_arr(pks[2])]),
        "sig1": torch.stack([TI.g2_affine_to_arr(g2.mul(h, sks[0]))] * 2),
        "p": torch.stack([TI.g1_affine_to_arr(p) for p, _ in pairs]),
        "q": torch.stack([TI.g2_affine_to_arr(q) for _, q in pairs]),
        "ref": {"sum": g1.mul(G1_GEN, agg_sk), "pairs": pairs},
    }


def _run_sharded(mesh, x, rank, size, names):
    """The sharded_* of ``names`` on this rank's shard: the keys and
    bitmap by chunks, one single-check lane and one pair a rank (a pairing
    product on the CPU takes seconds, so each runs once)."""
    n = N_KEYS // size
    keys, bits = x["keys"][rank * n:(rank + 1) * n], \
        x["bitmap"][rank * n:(rank + 1) * n]
    lanes = slice(rank * 2 // size, (rank + 1) * 2 // size)
    run = {
        "sum": lambda: M.sharded_masked_sum(mesh)(keys, bits),
        "verify": lambda: M.sharded_verify(mesh)(
            x["pk"][lanes], x["h"].expand(2, 2, 2, 32)[lanes],
            x["sig1"][lanes]),
        "product": lambda: M.sharded_pairing_product(mesh)(
            x["p"][lanes], x["q"][lanes]),
        "agg": lambda: M.sharded_agg_verify(mesh)(keys, bits, x["h"],
                                                  x["sig"]),
        "forged": lambda: M.sharded_agg_verify(mesh)(keys, bits, x["h"],
                                                     x["forged"]),
    }
    return {name: run[name]().numpy() for name in names}


def _rank_main(rank, size, port, x, names, results):
    mesh = M.make_mesh("cpu", init_method=f"tcp://127.0.0.1:{port}",
                       world_size=size, rank=rank)
    try:
        assert (mesh.rank, mesh.size) == (rank, size)
        results.put((rank, _run_sharded(mesh, x, rank, size, names)))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _check(x, out_by_rank, size):
    """Each rank's results against the unsharded port and the reference:
    the sum's limbs are the plain per-chunk sums merged in rank order."""
    n = N_KEYS // size
    partials = torch.stack([
        TCV.masked_sum_reference(x["keys"][r * n:(r + 1) * n],
                                 x["bitmap"][r * n:(r + 1) * n], TCV.FP_OPS)
        for r in range(size)])
    merged = TCV.masked_sum_reference(partials, torch.ones(size), TCV.FP_OPS)
    verdicts = []
    for rank in range(size):
        out = out_by_rank[rank]
        np.testing.assert_array_equal(out["sum"], merged.numpy())
        assert TI.arr_to_g1_affine(out["sum"]) == x["ref"]["sum"]
        if "product" in out:
            np.testing.assert_array_equal(out["product"], TI.fp12_to_arr(
                RP.multi_pairing(x["ref"]["pairs"])).numpy())
        if "agg" in out:
            assert bool(out["agg"]) is True
        if "forged" in out:
            assert bool(out["forged"]) is False
        verdicts += list(out.get("verify", []))
    assert verdicts in ([], [True, False])
    assert ("verify" in out_by_rank[0]) == bool(verdicts)


def test_two_ranks_under_gloo_agree_with_the_reference(inputs):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    names = ("sum", "product", "agg")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, port, inputs, names,
                                                  results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < 2:
            try:
                rank, out = results.get(timeout=RANK_TIMEOUT_S)
            except queue.Empty:
                dead = [p.exitcode for p in procs]
                pytest.fail(f"the ranks gave no result within "
                            f"{RANK_TIMEOUT_S} s (exit codes {dead})")
            got[rank] = out
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
            assert p.exitcode == 0, f"a rank exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert sorted(got) == [0, 1]
    _check(inputs, got, 2)


def test_world_size_one_in_process(inputs):
    """The mesh over a gloo group of this process alone, as on one card:
    the all_gather gives the rank's own partial, so the sum is the
    unsharded masked_sum's; the single checks (a valid lane and a wrong
    key) and the forged aggregate, beside the two ranks' valid one."""
    port = _free_port()
    mesh = M.make_mesh("cpu", init_method=f"tcp://127.0.0.1:{port}",
                       world_size=1, rank=0)
    try:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert M.make_mesh("cpu").group is None  # the group as it is
        out = _run_sharded(mesh, inputs, 0, 1, ("sum", "verify", "forged"))
        np.testing.assert_array_equal(
            out["sum"], TB.aggregate_pubkeys(inputs["keys"],
                                             inputs["bitmap"]).numpy())
        _check(inputs, {0: out}, 1)
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_group_or_its_address_and_a_device(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        M.make_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh()
