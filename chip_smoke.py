#!/usr/bin/env python3
"""Smoke test of harmony_tpu_torch on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card.  It

1. prints the card's name and power limit and builds the seven CUDA
   kernels (harmony_tpu_torch/csrc/mont_mul.cu, fp_addsub.cu,
   fp12_mul.cu, fp12_cyclo_sqr.cu, miller_loop.cu, fp_inv.cu and
   g1_masked_sum.cu, one library) from the checkout, with the build's
   time, each kernel's
   registers, stack frame, spills and shared memory (ptxas) and SASS
   instructions (cuobjdump); miller_loop and fp12_cyclo_sqr must have
   no stack frame and no spills;
2. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the shapes the verify path gives it and on edge cases;
   times both with the wrapper, and each kernel alone on the device
   (torch.profiler), and the wrapper's host cost per call;
3. drives the quorum-verify path through its entry points at Harmony
   mainnet width (a 200-slot committee, bucket 256): one quorum
   certificate and its forgeries, a replay batch of 64 headers, 8
   single checks and one check from payload bytes, each verdict as
   constructed; it shows that every entry point went through the kernels
   of its path (all seven for the quorum checks; all but the masked G1
   sum for the single checks), holds one quorum check to its launch
   limits, and counts the other tensor ops each call issues;
4. holds a pairing product on the card against the CPU plain path, and
   profiles one Fp12 product, one quorum check, one replay batch and 8
   single checks (wall time against device time, split by kernel);
5. prints a JSON line describing each kernel, then, last,
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Without CUDA,
or without the harmony_tpu_torch package next to it, it exits non-zero
and prints no result.  Keys, payloads and signatures come from --seed.
"""

import argparse
import collections
import contextlib
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks: HBM3 bandwidth, and int32 operations taken
# as half the non-tensor fp32 FMA rate (67 TFLOP/s = 33.5e12 FMA/s; an SM
# has 64 INT32 lanes to 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# Per row, what each function must move and compute.  mont_mul: read a and
# b, write the product (128 B each); 2 x 12 x 12 = 288 32x32->64-bit word
# products, 2 IMAD each.  add, sub: read two rows, write one; neg: read
# one, write one; 12 words each of add-with-carry, subtract-with-borrow
# and select.  Per Fp12 lane (12 rows): fp12_mul reads a and b and writes
# the product, and makes 54 Montgomery products; fp12_cyclo_sqr reads and
# writes one lane whatever the count n of squarings, and makes 18
# Montgomery products per squaring (its operations are per squaring).
# Per lane, miller_loop reads P (2 rows) and Q (4 rows) and writes f (12
# rows), and makes the plain loop's products, the fewest of its parts:
# per doubling 36 for f^2 (the complex method of
# harmony_tpu_torch/ops/towers.py fp12_sqr_reference), 54 for f times the
# line and 34 for the step, per addition 54 + 44: 63 x 124 + 5 x 98
# products (a sparse line product would need fewer; the kernel makes
# 9,436, squaring by the 54-product plan).  The adds and subs around the
# products are left out of the operations: a few per cent more.  fp_inv
# and g1_masked_sum do work that depends on their inputs, counted from
# each run's data (inv_work, g1_work): per row, fp_inv reads a and writes
# its inverse; its binary GCD takes some 270 steps of INV_STEP_OPS word
# operations (a 12-word subtraction; a modular subtraction, 36; a 12-word
# shift; the coefficient's division by 2^k, 12 word products of 2 IMAD
# and a shift, subtraction and select of 12 words each, 60), then one
# Montgomery product.  Per lane, g1_masked_sum reads the points and the
# mask and writes the sum and its affine form; its products are those of
# the lane's tree on this data (g1_tree): an add with infinity needs none,
# an add of two finite points 16, 11 where one has Z = 1 (an affine leaf,
# or one passed up against infinity) and 6 where both have; an add of
# equal or opposite points needs only the 8, 4 or 0 products that find
# them so, and the doubling 7 (6 where Z = 1).  Then the inversion of Z
# and 4 products for the affine form, unless the sum is infinity or still
# has Z = 1.
MONT_IMAD = 2 * 288
MILLER_PRODUCTS = 63 * (36 + 54 + 34) + 5 * (54 + 44)
INV_STEP_OPS = 12 + 36 + 12 + 60
# by the number of operands with Z = 1: 0, 1, 2
G1_ADD_PRODUCTS = (16, 11, 6)
G1_MATCH_PRODUCTS = (8, 4, 0)
WORK = {"mont_mul": (3 * 128, MONT_IMAD), "add": (3 * 128, 3 * 12),
        "sub": (3 * 128, 3 * 12), "neg": (2 * 128, 3 * 12),
        "fp12_mul": (3 * 12 * 128, 54 * MONT_IMAD),
        "fp12_cyclo_sqr": (2 * 12 * 128, 18 * MONT_IMAD),
        "miller_loop": ((2 + 4 + 12) * 128, MILLER_PRODUCTS * MONT_IMAD)}

# Rows per call at the shapes timed: one fp12_mul at 64 lanes (54 products
# x 64), 2^16, and the largest call the slice makes.  That is the first
# level of the masked G1 sum of the 64-header batch at bucket 256: 128 x 64
# point additions, whose products mont_mul takes four coordinates at a
# time (4 x 128 x 64 rows) and whose additions take one (128 x 64).
FP12_ROWS = 54 * 64
LARGEST_ROWS = {"mont_mul": 4 * 128 * 64, "fp_addsub": 128 * 64}
# Fp12 lanes at the path's shapes: a quorum check's final exponentiation
# (1) and Miller loop (2 pairings), and the 64-header batch's Miller loop
# (2 x 64)
FP12_LANES = {"1": 1, "2": 2, "2x64": 128}
# the runs of squarings of |x|'s and |x - 1|'s schedules
CYCLO_RUNS = (1, 2, 3, 9, 16, 32)
# Miller-loop lanes at the path's shapes: a quorum check's two pairings,
# and the 64-header batch's 2 x 64.  fp_inv is checked at 1, 3 and 3,456
# rows, and timed at the path's: 1 (each of a quorum check's two
# inversions) and 64 (the batch's aggregate keys made affine).
MILLER_LANES = {"2": (2,), "2x64": (2, 64)}
# lane counts each redesigned kernel is also held at: one block per lane
MILLER_EDGE_LANES = (1, 3, 127, 129)
CYCLO_EDGE_LANES = (1, 5, 64, 65)
INV_ROWS = (1, 3, 64, 3456)
INV_TIMED_ROWS = (1, 64)
# the masked G1 sum: the buckets held at (the smallest, mainnet's, the
# largest), the lane counts of the (N, B) form at bucket 256, and the
# lanes timed (a quorum check's 1; the replay batch's 64)
G1_BUCKETS = (8, 256, 1024)
G1_LANES = (1, 3, 64, 256)
G1_TIMED_LANES = (1, 64)
# what one quorum check may launch, now that the Miller loop, the Fp12
# inversion and the masked G1 sum with its affine form are one launch each
QC_LAUNCHES = {"miller_loop": (1, 1), "fp_inv": (1, 1),
               "g1_masked_sum": (1, 1), "fp_addsub": (0, 110),
               "mont_mul": (0, 15), "fp12_mul": (0, 40),
               "fp12_cyclo_sqr": (0, 40)}

# the functions of the path to which count_ops assigns launches and ops,
# the innermost on the stack winning
SOURCES = ("masked_sum", "masked_sum_to_affine", "to_affine", "miller_loop",
           "fp12_tree_reduce", "final_exponentiation", "verify",
           "agg_verify", "agg_verify_batch", "agg_verify_hashed_on_device",
           "agg_verify_batch_on_device", "verify_many_on_device")

COMMITTEE = 200  # Harmony mainnet: 200 slots per shard (epoch >= 1673)
QUORUM = 150
REPLAY_DISTINCT, REPLAY_REPEAT = 16, 4
SINGLE_CHECKS = 8


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def canonical_limbs(rng, shape):
    """Random canonical field elements (< p) as int32 limbs: 12-bit limbs
    with the top limb below p's (416), so every value is below p."""
    import numpy as np

    limbs = rng.integers(0, 4096, size=(*shape, 32), dtype=np.int32)
    limbs[..., 31] = rng.integers(0, 416, size=shape, dtype=np.int32)
    return limbs


KERNELS = ("mont_mul", "fp_addsub", "fp12_mul", "fp12_cyclo_sqr",
           "miller_loop", "fp_inv", "g1_masked_sum")


def wrappers():
    """Each kernel's wrapper module, by kernel name; each counts its
    launches in ``LAUNCHES``."""
    from harmony_tpu_torch.kernels import fp12_cyclo_sqr, fp12_mul, \
        fp_addsub, fp_inv, g1_masked_sum, miller_loop, mont_mul

    return {"mont_mul": mont_mul, "fp_addsub": fp_addsub,
            "fp12_mul": fp12_mul, "fp12_cyclo_sqr": fp12_cyclo_sqr,
            "miller_loop": miller_loop, "fp_inv": fp_inv,
            "g1_masked_sum": g1_masked_sum}


def launches():
    return {name: m.LAUNCHES for name, m in wrappers().items()}


def symbol(name):
    """What the profiler calls a kernel: ``<name>_kernel`` (no name is a
    part of another's symbol)."""
    return f"{name}_kernel"


def ptxas_report():
    """Each kernel's registers, stack frame, spills and shared memory, as
    ptxas reported them when kernels/_build.py compiled the library."""
    from harmony_tpu_torch.kernels import _build

    out, kernel = {}, None
    for line in _build.report_path().read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in KERNELS if symbol(k) in line), None)
        elif kernel and ("stack frame" in line or "Used" in line):
            out.setdefault(kernel, []).append(
                line.split(":", 1)[-1].strip())
    check(set(out) == set(KERNELS), f"ptxas reported {sorted(out)}")
    return {k: "; ".join(v) for k, v in out.items()}


def sass_sizes():
    """Each kernel's SASS instructions in the library, as cuobjdump
    lists them (the toolkit's, beside nvcc)."""
    from harmony_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    sizes, kernel = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            kernel = next((k for k in KERNELS if symbol(k) in line), None)
        elif kernel and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[kernel] = sizes.get(kernel, 0) + 1
    check(set(sizes) == set(KERNELS), f"cuobjdump listed {sorted(sizes)}")
    return sizes


def profiled(fn, reps, activities=("CUDA",)):
    """(key_averages(), device us per call of each hand kernel) over reps
    runs of fn() under torch.profiler.  The launch counters say how many
    launches of each hand kernel the profiler should see; on the card it
    has been seen to drop one launch in fifty, and in about one session
    in ten most or all of a session's kernels.  Each kernel's time per
    call is the mean of the launches seen times the launches made; a
    session that missed half of a kernel's launches is run again, at
    most four times more, and then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    attempts = 5
    for attempt in range(1, attempts + 1):
        before = launches()
        with profile(activities=[getattr(ProfilerActivity, a)
                                 for a in activities]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        made = {k: n - before[k] for k, n in launches().items()}
        seen = {k: sum(r.count for r in rows if symbol(k) in r.key)
                for k in KERNELS}
        if all(seen[k] >= 0.5 * made[k] for k in KERNELS):
            return rows, {
                k: sum(r.self_device_time_total for r in rows
                       if symbol(k) in r.key) / seen[k] * made[k] / reps
                if seen[k] else 0.0
                for k in KERNELS}
        log(f"the profiler saw {seen} of {made} launches (attempt "
            f"{attempt} of {attempts})")
    raise AssertionError(f"the profiler saw {seen} of {made} launches")


def device_us(fn, kernel, reps):
    """Device time per call of fn(), a call of the hand kernel ``kernel``,
    as torch.profiler records it: the kernel alone, without the wrapper or
    the launch."""
    us = profiled(fn, reps)[1][kernel]
    check(us > 0, f"the profiler recorded no device time for {kernel}")
    return us


def host_us(fn, reps):
    """Host time per call of fn() over reps back-to-back calls: the clock
    stops before the device is waited for, so this is what the caller's
    thread pays to issue one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def bound(op, rows, n=1):
    """(ms, what bounds it): the least time the card could take for ``op``
    on ``rows`` rows (Fp12 lanes for the towers; n squarings for
    fp12_cyclo_sqr), from the bytes it must move and the operations it
    must do, at the published peaks."""
    nbytes, ops = WORK[op]
    return roofline(rows * nbytes, rows * ops * n)


def roofline(nbytes, ops):
    """(ms, what bounds it) for ``nbytes`` moved and ``ops`` int32
    operations at the published peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations")


def gcd_steps(x):
    """The steps of csrc/fp384.cuh inv's binary GCD on the plain integer x
    (a R mod p for Montgomery limbs of a): each step one subtraction and
    the stripping of its factors of 2."""
    from harmony_tpu_torch.ref.params import P

    u, v = x, P
    if u == 0:
        return 0
    u >>= (u & -u).bit_length() - 1
    steps = 0
    while u != v:
        steps += 1
        if u > v:
            u -= v
            u >>= (u & -u).bit_length() - 1
        else:
            v -= u
            v >>= (v & -v).bit_length() - 1
    return steps


def inv_ops(limbs):
    """The int32 operations of inverting the rows of ``limbs`` (..., 32):
    the GCD's steps on each row's value, and one Montgomery product."""
    from harmony_tpu_torch.ops.limbs import limbs_to_int

    values = [limbs_to_int(r) for r in limbs.reshape(-1, 32).cpu().numpy()]
    return sum(gcd_steps(x) * INV_STEP_OPS + MONT_IMAD for x in values if x)


def inv_work(limbs):
    """(ms, what bounds it) of fp_inv on these limbs: read and write each
    row once, and the steps this data needs."""
    return roofline(limbs.numel() // 32 * 2 * 128, inv_ops(limbs))


def g1_tree(keys, bits):
    """(Montgomery products, whether the sum has Z = 1) of one lane of the
    masked G1 sum on these keys (host affine points, None for a pad row)
    with Z = 1 where ``z_one`` and mask words ``bits``: the tree of
    masked_sum run on the host, each add counted by what its operands
    need (the table above WORK)."""
    from harmony_tpu_torch.ref.curve import g1

    keys, z_one = keys
    nodes = [(k, z) if b == 1 and k is not None else (None, False)
             for k, z, b in zip(keys, z_one, bits)]
    size = 1
    while size < len(nodes):
        size *= 2
    nodes += [(None, False)] * (size - len(nodes))
    products = 0
    while len(nodes) > 1:
        half = len(nodes) // 2
        level = []
        for (p, p_one), (q, q_one) in zip(nodes[:half], nodes[half:]):
            if p is None or q is None:  # passed up as it is
                level.append((q, q_one) if p is None else (p, p_one))
                continue
            ones = p_one + q_one
            if p[0] == q[0]:  # equal or opposite: found, then doubled
                products += G1_MATCH_PRODUCTS[ones]
                if p[1] == q[1]:
                    products += 6 if p_one else 7
            else:
                products += G1_ADD_PRODUCTS[ones]
            level.append((g1.add(p, q), False))
        nodes = level
    return products, nodes[0][1]


def g1_keys(points):
    """The rows of a G1 table ((N, C, 32) on the card) as (host affine
    points, None for infinity; whether each has Z = 1)."""
    from harmony_tpu_torch.ops import interop as I

    rows = points.reshape(points.shape[0], *points.shape[-2:]).cpu()
    if rows.shape[-2] == 3:  # Jacobian: Z as it is
        return [I.arr_to_g1_affine(r) for r in rows], [False] * len(rows)
    keys = [None if not r.any() else (I.arr_to_fp(r[0]), I.arr_to_fp(r[1]))
            for r in rows]
    return keys, [True] * len(rows)


def g1_work(points, mask, sums):
    """(ms, what bounds it) of g1_masked_sum on these inputs, whose
    Jacobian sums (from the plain version) are ``sums``: read the points
    and the mask, write each lane's sum and affine form; the products of
    each lane's tree on this data (g1_tree), and, where the sum is finite
    without Z = 1, the inversion of its Z and 4 products."""
    keys = g1_keys(points)
    m = mask.reshape(mask.shape[0], -1).cpu().tolist()
    sums = sums.reshape(-1, *sums.shape[-2:])
    lanes = len(m[0])
    ops = 0
    for b in range(lanes):
        products, z_one = g1_tree(keys, [row[b] for row in m])
        ops += products * MONT_IMAD
        if not z_one and sums[b, 2].any():
            ops += inv_ops(sums[b, 2]) + 4 * MONT_IMAD
    nbytes = points.numel() * 4 + mask.numel() * 4 + lanes * (3 + 2) * 128
    return roofline(nbytes, ops)


def _compare(name, got, want, stats):
    import torch

    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    check(got.shape == want.shape and err == 0,
          f"{name}: kernel differs from the plain version (max {err})")
    log(f"kernel == plain (bit for bit, tolerance 0): {name} "
        f"{tuple(got.shape)}")


def mont_mul_phase(seed, stats):
    """The mont_mul kernel against its plain version on the card, bit for
    bit."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import mont_mul as K
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
    from harmony_tpu_torch.ref.params import P

    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    r_mont = 1 << 384
    dev = torch.device("cuda")

    def compare(name, a, b):
        a, b = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
        got = K.mont_mul(a, b)
        _compare(name, got, fp.mont_mul_reference(a, b), stats)
        return got

    xs = [prng.randrange(P) for _ in range(150)]
    ys = [prng.randrange(P) for _ in range(150)]
    got = compare("150 ragged lanes",
                  ints_to_limbs([x * r_mont % P for x in xs]),
                  ints_to_limbs([y * r_mont % P for y in ys]))
    check([limbs_to_int(row) for row in got.cpu().numpy()]
          == [x * y * r_mont % P for x, y in zip(xs, ys)],
          "150 ragged lanes: kernel differs from the host bigint")
    w = ints_to_limbs([(P - 1) * r_mont % P] * 4)
    got = compare("(p-1)^2", w, w)
    check(all(limbs_to_int(row) == (P - 1) ** 2 * r_mont % P
              for row in got.cpu().numpy()), "(p-1)^2 against the bigint")
    sq = canonical_limbs(rng, (2, 36))
    compare("a*a over (2, 36, 32)", sq, sq)
    # one Fp12 product at 64 lanes reaches mont_mul as (3, 6, 3, 64, 32)
    f12_shape = (3, 6, 3, 64)
    compare("stacked fp12_mul, 64 lanes", canonical_limbs(rng, f12_shape),
            canonical_limbs(rng, f12_shape))
    n = 1 << 16
    a, b = canonical_limbs(rng, (n,)), canonical_limbs(rng, (n,))
    got = compare("2^16 random products", a, b).cpu().numpy()
    inv_r = pow(r_mont, -1, P)
    for i in prng.sample(range(n), 8):
        check(limbs_to_int(got[i]) == limbs_to_int(a[i]) * limbs_to_int(b[i])
              * inv_r % P, f"2^16 batch, lane {i}: kernel differs from bigint")
    log("mont_mul kernel == host bigint on 8 lanes of the 2^16 batch")


def addsub_phase(seed, stats):
    """The fp_addsub kernel (add, sub, neg) against the plain versions on
    the card, bit for bit, on edge vectors, full-width carry ripples, the
    path's shapes, strided and broadcast operands, and 2^16 random rows."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import fp_addsub as KA
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
    from harmony_tpu_torch.ref.params import P

    rng = np.random.default_rng(seed + 3)
    prng = random.Random(seed + 3)
    dev = torch.device("cuda")
    plain = {"add": fp.add_reference, "sub": fp.sub_reference,
             "neg": fp.neg_reference}

    def compare(name, a, b, ops=("add", "sub", "neg")):
        a, b = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
        out = {}
        for op in ops:
            args = (a,) if op == "neg" else (a, b)
            out[op] = getattr(KA, op)(*args)
            _compare(f"{op}, {name}", out[op], plain[op](*args), stats)
        return out

    edges = [0, 1, P - 1]
    compare("0, 1, p-1 against each other",
            ints_to_limbs([x for x in edges for _ in edges]),
            ints_to_limbs(edges * 3))
    xs = [prng.randrange(1, P) for _ in range(64)]
    got = compare("a + b = p exactly", ints_to_limbs(xs),
                  ints_to_limbs([P - x for x in xs]), ops=("add",))
    check(not got["add"].any(), "a + (p - a) is not 0")
    got = compare("a = b", ints_to_limbs(xs), ints_to_limbs(xs),
                  ops=("sub",))
    check(not got["sub"].any(), "a - a is not 0")
    got = compare("neg(0)", ints_to_limbs([0] * 4), ints_to_limbs([0] * 4),
                  ops=("neg",))
    check(not got["neg"].any(), "neg(0) is not 0")
    # limbs of all ones below the top: every carry and borrow ripples the
    # whole width
    ones = [(1 << 380) - 1, P - (1 << 12), P - 1, (1 << 372) - 1]
    compare("all-ones limb runs", ints_to_limbs(ones),
            ints_to_limbs([1, 1 << 12, 1, P - (1 << 372)]))
    # the Fp12 operands of one fp12_mul at 64 lanes, (64, 2, 3, 2, 32)
    f12 = (64, 2, 3, 2)
    compare("fp12 shape, 64 lanes", canonical_limbs(rng, f12),
            canonical_limbs(rng, f12))
    # the towers' strided views, and a constant broadcast against a batch
    fp2 = torch.from_numpy(canonical_limbs(rng, (256, 2))).to(dev)
    compare("strided Fp2 halves", fp2[..., 0, :], fp2[..., 1, :])
    compare("(32,) against (256, 32)", fp2[:, 0],
            torch.from_numpy(canonical_limbs(rng, ())), ops=("add", "sub"))
    n = 1 << 16
    a, b = canonical_limbs(rng, (n,)), canonical_limbs(rng, (n,))
    got = compare("2^16 random rows", a, b)
    for i in prng.sample(range(n), 8):
        x, y = limbs_to_int(a[i]), limbs_to_int(b[i])
        check([limbs_to_int(got[op][i].cpu().numpy()) for op in plain]
              == [(x + y) % P, (x - y) % P, -x % P],
              f"2^16 rows, lane {i}: fp_addsub differs from the bigint")
    log("fp_addsub kernel == host bigint on 8 lanes of the 2^16 batch")


def timing_phase(seed):
    """Each kernel at the path's shapes: wrapper-inclusive ms by CUDA
    events, the kernel's own device time by torch.profiler, the plain
    version's ms, the bound, and the wrapper's host cost per call."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import fp_addsub as KA
    from harmony_tpu_torch.kernels import mont_mul as K
    from harmony_tpu_torch.ops import fp

    rng = np.random.default_rng(seed + 4)
    dev = torch.device("cuda")
    calls = {"mont_mul": (K.mont_mul, fp.mont_mul_reference, "mont_mul"),
             "add": (KA.add, fp.add_reference, "fp_addsub"),
             "sub": (KA.sub, fp.sub_reference, "fp_addsub"),
             "neg": (KA.neg, fp.neg_reference, "fp_addsub")}
    timings = {}
    for op, (kernel, plain, family) in calls.items():
        shapes = {"fp12x64": FP12_ROWS, "2^16": 1 << 16,
                  "largest": LARGEST_ROWS[family]}
        for shape, rows in shapes.items():
            a, b = (torch.from_numpy(canonical_limbs(rng, (rows,))).to(dev)
                    for _ in range(2))
            args = (a,) if op == "neg" else (a, b)
            bound_ms, bound_by = bound(op, rows)
            t = timings.setdefault(op, {})[shape] = {
                "rows": rows,
                "ms": cuda_ms(lambda: kernel(*args), 200),
                "device_ms": 1e-3 * device_us(lambda: kernel(*args), family,
                                              50),
                "plain_ms": cuda_ms(lambda: plain(*args), 10),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            if shape == "fp12x64":
                t["host_us_per_call"] = host_us(lambda: kernel(*args), 2000)
            log(f"{op} at {shape} ({rows} rows): {t['ms']:.6f} ms with the "
                f"wrapper, {t['device_ms']:.6f} ms on the device, plain "
                f"{t['plain_ms']:.6f} ms, bound {bound_ms:.6f} ms "
                f"({bound_by})" + (f", host {t['host_us_per_call']:.3f} us "
                                    f"per call" if "host_us_per_call" in t
                                    else ""))
    # what one wrapper call costs the host, beside its allocation, one
    # plain ATen op, and the copy that a strided operand (a tower's Fp2
    # half, v[..., 0, :]) costs before the launch
    a, b = (torch.from_numpy(canonical_limbs(rng, (FP12_ROWS,))).to(dev)
            for _ in range(2))
    v = torch.stack([a, b], dim=-2)
    timings["host_us"] = {
        "fp_addsub add wrapper": host_us(lambda: KA.add(a, b), 2000),
        "torch.empty_like": host_us(lambda: torch.empty_like(a), 2000),
        "one ATen add (a + b)": host_us(lambda: a + b, 2000),
        "copy of a strided view": host_us(
            lambda: v[..., 0, :].contiguous(), 2000),
    }
    log("host us per call at 3456 rows: " + ", ".join(
        f"{k} {us:.3f}" for k, us in timings["host_us"].items()))
    return timings


@contextlib.contextmanager
def plain_fp():
    """Within: the dispatchers of ops/fp.py, ops/towers.py,
    ops/pairing.py and ops/curve.py (with the Fp dispatchers that
    ``curve.FP_OPS`` holds) are their plain PyTorch versions, so the plain
    compositions (``*_reference``) run on the card without a hand
    kernel, as the plain versions the fused kernels are held against and
    timed beside.  Checks that no hand kernel launched."""
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops import pairing as PR
    from harmony_tpu_torch.ops import towers as T

    def cyclo_sqr_n(a, n):
        for _ in range(n):
            a = T.fp12_cyclo_sqr_reference(a)
        return a

    swaps = [(fp, n, getattr(fp, f"{n}_reference"))
             for n in ("add", "sub", "neg", "mont_mul", "inv")]
    swaps += [(CV.FP_OPS, n, getattr(fp, f"{m}_reference"))
              for n, m in (("mul", "mont_mul"), ("add", "add"),
                           ("sub", "sub"), ("neg", "neg"), ("inv", "inv"))]
    swaps += [(T, "fp12_mul", T.fp12_mul_reference),
              (T, "fp12_sqr", T.fp12_sqr_reference),
              (T, "fp12_cyclo_sqr_n", cyclo_sqr_n),
              (PR, "miller_loop", PR.miller_loop_reference),
              (CV, "masked_sum", CV.masked_sum_reference),
              (CV, "masked_sum_to_affine",
               CV.masked_sum_to_affine_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    before = launches()
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    check(launches() == before, "a plain version launched a hand kernel")


def fp12_limbs(rng, *lead):
    """Random canonical Fp12 values, (*lead, 2, 3, 2, 32), on the card."""
    import torch

    return torch.from_numpy(canonical_limbs(rng, (*lead, 2, 3, 2))).cuda()


def cyclotomic(rng, lanes):
    """Unitary Fp12 values f^((p^6 - 1)(p^2 + 1)) of random f, as every
    final-exponentiation intermediate after the easy part; built on the
    CPU by the plain path, returned on the card."""
    import torch

    from harmony_tpu_torch.ops import towers as T

    f = torch.from_numpy(canonical_limbs(rng, (lanes, 2, 3, 2)))
    with torch.inference_mode():
        f1 = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f))
        return T.fp12_mul(T.fp12_frobenius(f1, 2), f1).cuda()


def fp12_mul_phase(seed, stats):
    """The fp12_mul kernel (products, and squares on (a, a)) against the
    plain composition on the card, bit for bit, at the path's lane counts,
    the stacked Miller shape, a broadcast operand, strided views and edge
    values; two lanes also against the host bigint."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import fp12_mul as KM
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import towers as T
    from harmony_tpu_torch.ops.limbs import ints_to_limbs
    from harmony_tpu_torch.ref import fields as RF
    from harmony_tpu_torch.ref.params import P

    rng = np.random.default_rng(seed + 5)

    def compare(name, a, b=None):
        if b is None:
            got = KM.fp12_mul(a, a)
            with plain_fp():
                want = T.fp12_sqr_reference(a)
        else:
            got = KM.fp12_mul(a, b)
            with plain_fp():
                want = T.fp12_mul_reference(a, b)
        _compare(name, got, want, stats)
        return got

    for lanes in (1, 2, 64, 128):
        a, b = fp12_limbs(rng, lanes), fp12_limbs(rng, lanes)
        got = compare(f"fp12_mul, {lanes} lanes", a, b)
        compare(f"fp12_sqr, {lanes} lanes", a)
    for i in (0, 127):
        x, y, z = (I.arr_to_fp12(t[i].cpu()) for t in (a, b, got))
        check(z == RF.fp12_mul(x, y),
              f"fp12_mul lane {i}: kernel differs from the host bigint")
    log("fp12_mul kernel == host bigint on 2 lanes of 128")
    compare("fp12_mul, the stacked Miller shape (2, 64)",
            fp12_limbs(rng, 2, 64), fp12_limbs(rng, 2, 64))
    compare("fp12_mul, one value broadcast against 64 lanes",
            fp12_limbs(rng, 64), fp12_limbs(rng))
    x = fp12_limbs(rng, 128)
    compare("fp12_mul, strided views (alternate lanes)", x[::2], x[1::2])
    compare("fp12_sqr, a strided view", x[1::2])
    edges = [0, 1, P - 1, (1 << 380) - 1, P - (1 << 12), (1 << 372) - 1,
             P - (1 << 372)]
    rows = ints_to_limbs([edges[i % len(edges)] for i in range(4 * 12)])
    e = torch.from_numpy(rows).reshape(4, 2, 3, 2, 32).cuda()
    compare("fp12_mul, edge values", e, e.flip(0))
    compare("fp12_sqr, edge values", e)


def cyclo_phase(seed, stats):
    """The fp12_cyclo_sqr kernel against n plain squarings on the card,
    bit for bit, for each run length of the path, on unitary values (64
    lanes) and on random values (1 lane), which it must square by the
    same polynomial, and at n = 0, 1 and 32 on 1, 5, 64 and 65 lanes (one
    block per lane); two results also against the host bigint."""
    import numpy as np

    from harmony_tpu_torch.kernels import fp12_cyclo_sqr as KC
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import towers as T
    from harmony_tpu_torch.ref import fields as RF

    rng = np.random.default_rng(seed + 6)
    inputs = {"unitary, 64 lanes": cyclotomic(rng, 64),
              "random, 1 lane": fp12_limbs(rng, 1)}
    unitary = I.arr_to_fp12(inputs["unitary, 64 lanes"][0].cpu())
    for n in CYCLO_RUNS:
        for kind, a in inputs.items():
            got = KC.fp12_cyclo_sqr_n(a, n)
            want = a
            with plain_fp():
                for _ in range(n):
                    want = T.fp12_cyclo_sqr_reference(want)
            _compare(f"fp12_cyclo_sqr, n = {n}, {kind}", got, want, stats)
            if kind.startswith("unitary") and n in (1, 32):
                check(I.arr_to_fp12(got[0].cpu())
                      == RF.fp12_pow(unitary, 1 << n),
                      f"fp12_cyclo_sqr n = {n}: kernel differs from the "
                      f"host bigint")
    log("fp12_cyclo_sqr kernel == host bigint a^(2^n), n = 1 and 32")
    # one block per lane: lane counts around the warp and the block of
    # the old geometry, each held against a prefix of one plain run
    a = fp12_limbs(rng, max(CYCLO_EDGE_LANES))
    for n in (0, 1, 32):
        want = a
        with plain_fp():
            for _ in range(n):
                want = T.fp12_cyclo_sqr_reference(want)
        for lanes in CYCLO_EDGE_LANES:
            _compare(f"fp12_cyclo_sqr, n = {n}, {lanes} lanes",
                     KC.fp12_cyclo_sqr_n(a[:lanes], n), want[:lanes], stats)


def tower_timing_phase(seed):
    """fp12_mul and fp12_cyclo_sqr at the path's shapes: wrapper-inclusive
    ms by CUDA events, the kernel's own device time by torch.profiler, the
    plain version's ms (plain PyTorch on the card), the ms of the
    composition over the Fp kernels that the fused kernel replaced, the
    bound, and the wrapper's host cost per call."""
    import numpy as np

    from harmony_tpu_torch.kernels import fp12_cyclo_sqr as KC
    from harmony_tpu_torch.kernels import fp12_mul as KM
    from harmony_tpu_torch.ops import towers as T

    rng = np.random.default_rng(seed + 7)
    timings = {"fp12_mul": {}, "fp12_cyclo_sqr": {}}

    def cyclo_loop(a, n):
        for _ in range(n):
            a = T.fp12_cyclo_sqr_reference(a)
        return a

    def plain(fn):
        def run():
            with plain_fp():
                return fn()
        return run

    cases = [("fp12_mul", f"{shape} lanes", lanes, 1)
             for shape, lanes in FP12_LANES.items()]
    cases += [("fp12_cyclo_sqr", f"{lanes} lanes, n = {n}", lanes, n)
              for lanes, n in ((1, 1), (1, 32), (64, 32))]
    for op, shape, lanes, n in cases:
        a, b = fp12_limbs(rng, lanes), fp12_limbs(rng, lanes)
        if op == "fp12_mul":
            kernel = lambda: KM.fp12_mul(a, b)  # noqa: E731
            composed = lambda: T.fp12_mul_reference(a, b)  # noqa: E731
        else:
            kernel = lambda: KC.fp12_cyclo_sqr_n(a, n)  # noqa: E731
            composed = lambda: cyclo_loop(a, n)  # noqa: E731
        bound_ms, bound_by = bound(op, lanes, n)
        t = timings[op][shape] = {
            "lanes": lanes,
            "n": n,
            "ms": cuda_ms(kernel, 200),
            "device_ms": 1e-3 * device_us(kernel, op, 50),
            "plain_ms": cuda_ms(plain(composed), 2 if n > 1 else 5),
            "composed_ms": cuda_ms(composed, 5 if n > 1 else 20),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "host_us_per_call": host_us(kernel, 500),
        }
        log(f"{op} at {shape}: {t['ms']:.6f} ms with the wrapper, "
            f"{t['device_ms']:.6f} ms on the device, plain "
            f"{t['plain_ms']:.6f} ms, composed over the Fp kernels "
            f"{t['composed_ms']:.6f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}), host {t['host_us_per_call']:.3f} us per call")
    return timings


def miller_phase(seed, stats):
    """The miller_loop kernel against the plain loop on the card, bit for
    bit, every case against plain PyTorch (no hand kernel launched): a
    quorum check's 2 lanes, the batch's 2 x 64 lanes (there also against
    the composition over the Fp and Fp12 kernels, the path before the
    kernel), lanes of infinity (0, 0) as verify's padded and forged lanes
    give it, a broadcast operand, strided views, and 1, 3, 127 and 129
    lanes (one block per lane)."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import miller_loop as KML
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import pairing as PR
    from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = np.random.default_rng(seed + 8)
    prng = random.Random(seed + 8)
    ps = torch.stack([I.g1_affine_to_arr(g1.mul(G1_GEN, prng.randrange(
        1, R_ORDER))) for _ in range(3)]).cuda()
    qs = torch.stack([I.g2_affine_to_arr(g2.mul(G2_GEN, prng.randrange(
        1, R_ORDER))) for _ in range(3)]).cuda()

    def compare(name, p, q, composed=False):
        got = KML.miller_loop(p, q)
        # the plain loop takes P and Q with the same leading axes
        p = p.expand(*q.shape[:-3], *p.shape[-2:])
        with plain_fp():
            want = PR.miller_loop_reference(p, q)
        _compare(f"miller_loop, {name}, against plain PyTorch", got, want,
                 stats)
        if composed:
            _compare(f"miller_loop, {name}, against the composition over "
                     f"the Fp and Fp12 kernels", got,
                     PR.miller_loop_reference(p, q), stats)

    compare("2 pairs", ps[:2], qs[:2])
    compare("2 x 64 lanes", torch.from_numpy(canonical_limbs(
        rng, (2, 64, 2))).cuda(), torch.from_numpy(canonical_limbs(
            rng, (2, 64, 2, 2))).cuda(), composed=True)
    zp, zq = torch.zeros_like(ps[0]), torch.zeros_like(qs[0])
    compare("lanes of infinity: (P, 0), (0, Q), (0, 0), (P, Q)",
            torch.stack([ps[0], zp, zp, ps[1]]),
            torch.stack([zq, qs[0], zq, qs[1]]))
    q16 = torch.from_numpy(canonical_limbs(rng, (16, 2, 2))).cuda()
    compare("one P broadcast against 16 Q", ps[2:3], q16)
    compare("an expanded P (stride 0), as verify builds -G1",
            ps[2].expand(16, 2, 32), q16)
    p8 = torch.from_numpy(canonical_limbs(rng, (8, 2))).cuda()
    q8 = torch.from_numpy(canonical_limbs(rng, (8, 2, 2))).cuda()
    compare("strided views (alternate lanes)", p8[::2], q8[1::2])
    # one block per lane: lane counts around a warp and the card's 132
    # SMs, each held against a prefix of one plain run
    most = max(MILLER_EDGE_LANES)
    p = torch.from_numpy(canonical_limbs(rng, (most, 2))).cuda()
    q = torch.from_numpy(canonical_limbs(rng, (most, 2, 2))).cuda()
    with plain_fp():
        want = PR.miller_loop_reference(p, q)
    for lanes in MILLER_EDGE_LANES:
        _compare(f"miller_loop, {lanes} lanes, against plain PyTorch",
                 KML.miller_loop(p[:lanes], q[:lanes]), want[:lanes], stats)


def inv_phase(seed, stats):
    """The fp_inv kernel (the binary GCD) against the plain Fermat chain
    (plain PyTorch on the card, no hand kernel launched), bit for bit, at
    1, 3, 64 and 3,456 rows with 0, 1 and p - 1 among them; the rows also
    against the host bigint."""
    import torch

    from harmony_tpu_torch.kernels import fp_inv as KI
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
    from harmony_tpu_torch.ref.params import P

    prng = random.Random(seed + 9)
    r_mont = 1 << 384
    for rows in INV_ROWS:
        xs = [prng.randrange(P)] if rows == 1 else (
            [0, 1, P - 1] + [prng.randrange(P) for _ in range(rows - 3)])
        a = torch.from_numpy(ints_to_limbs([x * r_mont % P for x in xs]))
        got = KI.inv(a.cuda())
        with plain_fp():
            want = fp.inv_reference(a.cuda())
        _compare(f"fp_inv, {rows} rows", got, want, stats)
        got = got.cpu().numpy()
        for i in (range(rows) if rows < 8 else
                  [0, 1, 2] + prng.sample(range(3, rows), 8)):
            check(limbs_to_int(got[i])
                  == pow(xs[i], P - 2, P) * r_mont % P,
                  f"fp_inv, {rows} rows, row {i}: kernel differs from the "
                  f"host bigint")
    log("fp_inv kernel == host bigint a^(p-2) on the rows checked")


def g1_committee(rng, n):
    """n affine G1 keys (reference points) cheaply: k_i G for k_i = k_0 +
    i d."""
    from harmony_tpu_torch.ref.curve import G1_GEN, g1
    from harmony_tpu_torch.ref.params import R_ORDER

    step = g1.mul(G1_GEN, rng.randrange(1, R_ORDER))
    keys = [g1.mul(G1_GEN, rng.randrange(1, R_ORDER))]
    for _ in range(n - 1):
        keys.append(g1.add(keys[-1], step))
    return keys


def g1_tables(rng, keys):
    """(affine (n, 2, 32), Jacobian (n, 3, 32) with random Z) limbs of the
    keys, on the card; None is a pad row (0, 0), (0, 0, 0) in Jacobian."""
    import numpy as np
    import torch

    from harmony_tpu_torch.ops.limbs import ints_to_limbs
    from harmony_tpu_torch.ref.params import P

    def mont(xs):
        return ints_to_limbs([x * (1 << 384) % P for x in xs])

    aff, jac = [], []
    for pt in keys:
        if pt is None:
            aff.append(mont([0, 0]))
            jac.append(mont([0, 0, 0]))
            continue
        (x, y), z = pt, rng.randrange(1, P)
        aff.append(mont([x, y]))
        jac.append(mont([x * z * z % P, y * z * z * z % P, z]))
    return (torch.from_numpy(np.stack(aff)).cuda(),
            torch.from_numpy(np.stack(jac)).cuda())


def g1_masks(rng, n, lanes):
    """(n, lanes) int32 masks on the card: the special cases first (no
    key, every key, one key, a key twice, a key and its negative, a pad
    row, mask words other than 0 and 1), then random masks of 2/3 of the
    keys; the table puts keys[0] again at row n/2, -keys[1] at row n/2 +
    1 and the pad row last (g1_sum_phase)."""
    import torch

    half, cases = n // 2, []
    for on in ((), range(n), (3,), (0, half), (1, half + 1), (2, n - 1),
               (n - 1,)):
        col = [0] * n
        for i in on:
            col[i] = 1
        cases.append(col)
    cases.append([(2, 1, -1, 255, 0)[i % 5] for i in range(n)])
    while len(cases) < lanes:
        col = [0] * n
        for i in rng.sample(range(n), 2 * n // 3):
            col[i] = 1
        cases.append(col)
    return torch.tensor(cases[:lanes], dtype=torch.int32).T.contiguous() \
        .cuda()


def g1_sum_phase(seed, stats):
    """The g1_masked_sum kernel against the plain masked_sum and to_affine
    (plain PyTorch on the card, no hand kernel launched), bit for bit,
    the Jacobian sum and the affine form: at buckets 8, 256 and 1024, one
    lane per case (no key, every key, one key, a key twice, a key and its
    negative, a pad row (0, 0), mask words other than 0 and 1, random
    masks), from affine and from Jacobian points; the (N, B) form at B =
    1, 3, 64 and 256 at bucket 256, and at B = 3 the sum alone, without
    the affine form; and a quorum check's mask, 150 of 200 keys, also
    against the host bigint."""
    import torch

    from harmony_tpu_torch.kernels import g1_masked_sum as KG
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref.curve import g1

    rng = random.Random(seed + 11)

    def plain(points, mask):
        with plain_fp():
            jac = points if points.shape[-2] == 3 else \
                CV.affine_to_jacobian_g1(points)
            out = CV.masked_sum_reference(jac, mask, CV.FP_OPS)
            ax, ay = CV.to_affine(out, CV.FP_OPS)
            return out, torch.stack([ax, ay], dim=-2)

    def compare(name, got, want):
        _compare(f"g1_masked_sum, {name}, sum", got[0], want[0], stats)
        _compare(f"g1_masked_sum, {name}, affine", got[1], want[1], stats)

    for n in G1_BUCKETS:
        keys = g1_committee(rng, n)
        keys[n // 2], keys[n // 2 + 1], keys[n - 1] = (
            keys[0], g1.neg(keys[1]), None)
        tables = g1_tables(rng, keys)
        mask = g1_masks(rng, n, 9 if n != 256 else max(G1_LANES))
        for form, table in zip(("affine", "Jacobian"), tables):
            if n == 1024 and form == "Jacobian":
                continue
            want = plain(table[:, None], mask)
            for b in range(min(mask.shape[1], 9)):
                compare(f"bucket {n}, {form} points, lane {b} as (N,)",
                        KG.g1_masked_sum(table, mask[:, b]),
                        (want[0][b], want[1][b]))
            if n == 256 and form == "affine":
                for lanes in G1_LANES:
                    compare(f"bucket 256, (N, B) with B = {lanes}",
                            KG.g1_masked_sum(table[:, None],
                                             mask[:, :lanes]),
                            (want[0][:lanes], want[1][:lanes]))
                # the sum alone (masked_sum's launch): no affine form
                got, none = KG.g1_masked_sum(table[:, None], mask[:, :3],
                                             affine=False)
                check(none is None, "g1_masked_sum made an affine form "
                      "that was not asked for")
                _compare("g1_masked_sum, bucket 256, B = 3, the sum alone",
                         got, want[0][:3], stats)
    # a quorum check: 150 of 200 keys in bucket 256, against the bigint
    keys = g1_committee(rng, COMMITTEE)
    aff = g1_tables(rng, keys + [None] * (256 - COMMITTEE))[0]
    bits = [0] * 256
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bits[i] = 1
    mask = torch.tensor(bits, dtype=torch.int32).cuda()
    got = KG.g1_masked_sum(aff, mask)
    compare("a quorum check, 150 of 200 keys", got, plain(aff, mask))
    want = None
    for key, bit in zip(keys, bits):
        if bit:
            want = g1.add(want, key)
    check(I.arr_to_g1_affine(got[0].cpu()) == want
          and (I.arr_to_fp(got[1][0].cpu()), I.arr_to_fp(got[1][1].cpu()))
          == want, "g1_masked_sum differs from the host bigint sum")
    log("g1_masked_sum kernel == host bigint sum of a quorum check's keys")
    return aff, mask


def loop_timing_phase(seed, qc_keys, qc_mask, g1_stats):
    """miller_loop, fp_inv and g1_masked_sum at the path's shapes:
    wrapper-inclusive ms by CUDA events, the kernel's own device time by
    torch.profiler, the plain version's ms (plain PyTorch on the card),
    the ms of the composition over the other kernels that the kernel
    replaced (for fp_inv, the Fermat chain over the mont_mul kernel), the
    bound from this run's inputs, and the wrapper's host cost per call.
    g1_masked_sum runs on a quorum check's affine table and mask (1 lane),
    and on that table with 64 random masks of 2/3 of the keys (the replay
    batch's 64 lanes), each held bit for bit against the plain version
    first; its bound counts from the plain version's sums."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import fp_inv as KI
    from harmony_tpu_torch.kernels import g1_masked_sum as KG
    from harmony_tpu_torch.kernels import miller_loop as KML
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops import pairing as PR

    rng = np.random.default_rng(seed + 10)
    timings = {"miller_loop": {}, "fp_inv": {}, "g1_masked_sum": {}}

    def plain(fn):
        def run():
            with plain_fp():
                return fn()
        return run

    cases = []
    for shape, lead in MILLER_LANES.items():
        p = torch.from_numpy(canonical_limbs(rng, (*lead, 2))).cuda()
        q = torch.from_numpy(canonical_limbs(rng, (*lead, 2, 2))).cuda()
        cases.append(("miller_loop", f"{shape} lanes", math.prod(lead),
                      lambda p=p, q=q: KML.miller_loop(p, q),
                      lambda p=p, q=q: PR.miller_loop_reference(p, q),
                      bound("miller_loop", math.prod(lead))))
    for rows in INV_TIMED_ROWS:
        a = torch.from_numpy(canonical_limbs(rng, (rows,))).cuda()
        cases.append(("fp_inv", f"{rows} rows", rows,
                      lambda a=a: KI.inv(a),
                      lambda a=a: fp.inv_reference(a), inv_work(a)))
    for lanes in G1_TIMED_LANES:
        if lanes == 1:
            pts, mask = qc_keys, qc_mask
        else:
            pts = qc_keys[:, None]
            mask = torch.from_numpy(
                (rng.random((len(qc_keys), lanes)) < 2 / 3).astype(
                    np.int32) * qc_mask.cpu().numpy()[:, None]).cuda()
        # the plain sums: held against the kernel's, and counted from
        with plain_fp():
            sums = CV.masked_sum_reference(CV.affine_to_jacobian_g1(pts),
                                           mask, CV.FP_OPS)
            xy = CV.masked_sum_to_affine_reference(pts, mask)
        got = KG.g1_masked_sum(pts, mask)
        _compare(f"g1_masked_sum, timed at {lanes} lanes, sum", got[0], sums,
                 g1_stats)
        _compare(f"g1_masked_sum, timed at {lanes} lanes, affine", got[1],
                 xy, g1_stats)
        cases.append(("g1_masked_sum", f"{lanes} lanes", lanes,
                      lambda p=pts, m=mask: KG.g1_masked_sum(p, m),
                      lambda p=pts, m=mask:
                      CV.masked_sum_to_affine_reference(p, m),
                      g1_work(pts, mask, sums)))
    for op, shape, n, kernel, composed, (bound_ms, bound_by) in cases:
        t = timings[op][shape] = {
            "rows" if op == "fp_inv" else "lanes": n,
            "ms": cuda_ms(kernel, 20),
            "device_ms": 1e-3 * device_us(kernel, op, 10),
            "plain_ms": cuda_ms(plain(composed), 1),
            "composed_ms": cuda_ms(composed, 2),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "host_us_per_call": host_us(kernel, 200),
        }
        log(f"{op} at {shape}: {t['ms']:.6f} ms with the wrapper, "
            f"{t['device_ms']:.6f} ms on the device, plain "
            f"{t['plain_ms']:.6f} ms, composed over the other kernels "
            f"{t['composed_ms']:.6f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}), host {t['host_us_per_call']:.3f} us per call")
    return timings


def build_committee(rng):
    """200 keys cheaply: sk_i = sk_0 + i*delta, pk_i = pk_(i-1) + delta*G1."""
    from harmony_tpu_torch.ref.curve import G1_GEN, g1
    from harmony_tpu_torch.ref.params import R_ORDER

    sk0, delta = rng.randrange(1, R_ORDER), rng.randrange(1, R_ORDER)
    sks = [(sk0 + i * delta) % R_ORDER for i in range(COMMITTEE)]
    step = g1.mul(G1_GEN, delta)
    pks = [g1.mul(G1_GEN, sk0)]
    for _ in range(COMMITTEE - 1):
        pks.append(g1.add(pks[-1], step))
    return sks, pks


def agg_sign(sks, bits, h):
    from harmony_tpu_torch.ref.curve import g2
    from harmony_tpu_torch.ref.params import R_ORDER

    return g2.mul(h, sum(sk for sk, b in zip(sks, bits) if b) % R_ORDER)


def _source():
    """The innermost function of the path (SOURCES) on the caller's
    stack."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_name in SOURCES:
            return frame.f_code.co_name
        frame = frame.f_back
    return "other"


def count_ops(fn, *args):
    """(result, tensor ops, by source) of one call: the ATen operators it
    dispatches, views left out.  A ``contiguous`` that copies counts,
    though ATen marks the operator as a view.  Most ops launch a kernel on
    the card; an allocation (``empty_like``) launches none.  The
    hand-written kernels go through ctypes and are counted apart.  By
    source: the hand kernels' launches (counted where every wrapper
    launches, ``_build._launch``) and the other ops, by the innermost
    function of the path that issued them."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from harmony_tpu_torch.kernels import _build

    contiguous = torch.ops.aten.contiguous.default
    # per source: other ops, and launches by C entry point
    by_source = collections.defaultdict(collections.Counter)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view or (func is contiguous
                                    and not args[0].is_contiguous()):
                self.n += 1
                by_source[_source()]["ops"] += 1
            return func(*args, **(kwargs or {}))

    launch = _build._launch

    def counted_launch(entry, *a, **k):
        by_source[_source()][entry.removeprefix("harmony_")] += 1
        return launch(entry, *a, **k)

    mode = Count()
    before = launches()
    _build._launch = counted_launch
    try:
        with mode:
            out = fn(*args)
    finally:
        _build._launch = launch
    made = sum(launches().values()) - sum(before.values())
    check(sum(c.total() - c["ops"] for c in by_source.values()) == made,
          "the launches by source miss some of the call's launches")
    return out, mode.n, dict(by_source)


def timed(fn, *args):
    """(result, wall ms, launches of each kernel, ms waited) of one call;
    every entry point returns host bools, so the call has finished on the
    card.  The ms waited are spent in ``Tensor.cpu``, where the host waits
    for the card to finish the work it has been given: the device's tail
    after the host issued its last launch."""
    import torch

    waited = []
    to_cpu = torch.Tensor.cpu

    def timed_cpu(self, *a, **k):
        t = time.perf_counter()
        out = to_cpu(self, *a, **k)
        waited.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    before = launches()
    torch.Tensor.cpu = timed_cpu
    try:
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.Tensor.cpu = to_cpu
    return (out, ms, {k: n - before[k] for k, n in launches().items()},
            1e3 * sum(waited))


def slice_phase(seed):
    """The quorum-verify path at mainnet width through its entry points."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.ref.curve import g2
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2

    rng = random.Random(seed)
    t0 = time.perf_counter()
    sks, pks = build_committee(rng)
    table = D.CommitteeTable(pks)
    check((table.n, table.size) == (COMMITTEE, 256), "committee bucket")
    payloads = [b"harmony shard 0 block %d seed %d" % (j, seed)
                for j in range(REPLAY_DISTINCT)]
    hashes = [hash_to_g2(p) for p in payloads]
    log(f"host set-up (200 keys, {len(payloads)} payloads hashed) "
        f"{time.perf_counter() - t0:.3f} s")
    results, sources = {}, {}

    # one commit quorum certificate and its forgeries
    bits = [0] * COMMITTEE
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bits[i] = 1
    h, sig = hashes[0], agg_sign(sks, bits, hashes[0])
    flipped = list(bits)
    flipped[bits.index(1)] = 0
    fn = D.agg_verify_hashed_on_device
    ok, ops, src = count_ops(fn, table, bits, h, sig)  # warm
    check(ok is True, "valid quorum certificate rejected")
    ok, ms, made, wait = timed(fn, table, bits, h, sig)
    check(ok is True, "valid quorum certificate rejected (second call)")
    results["agg_verify_hashed_on_device"] = (ms, made, ops, wait)
    sources["agg_verify_hashed_on_device"] = src
    calls = {"one quorum check": (fn, table, bits, h, sig)}
    for what, args in (("one bit flipped", (flipped, h, sig)),
                       ("wrong payload", (bits, hashes[1], sig)),
                       ("infinity signature", (bits, h, ((0, 0), (0, 0))))):
        ok = timed(fn, table, *args)[0]
        check(ok is False, f"forged certificate accepted: {what}")
    log("agg_verify_hashed_on_device: valid True; one bit flipped, wrong "
        "payload, infinity signature all False")

    # replay batch: 16 distinct headers, each 4 times; forged lanes
    triples, expect = [], []
    for j in range(REPLAY_DISTINCT):
        bm = [0] * COMMITTEE
        for i in rng.sample(range(COMMITTEE), rng.randrange(134, 201)):
            bm[i] = 1
        sig_j = agg_sign(sks, bm, hashes[j])
        if j % 4 == 1:  # a signer claimed who did not sign
            bm = list(bm)
            bm[bm.index(0) if 0 in bm else 0] ^= 1
            triples.append((bm, hashes[j], sig_j))
            expect.append(False)
        elif j % 4 == 2:  # a signature the signers did not make
            triples.append((bm, hashes[j], g2.neg(sig_j)))
            expect.append(False)
        else:
            triples.append((bm, hashes[j], sig_j))
            expect.append(True)
    lanes = [t for t in triples for _ in range(REPLAY_REPEAT)]
    want = [e for e in expect for _ in range(REPLAY_REPEAT)]
    args = ([t[0] for t in lanes], [t[1] for t in lanes],
            [t[2] for t in lanes])
    fn = D.agg_verify_batch_on_device
    out, ops, src = count_ops(fn, table, *args)  # warm
    check(out == want, f"replay batch verdicts {out} != {want}")
    out, ms, made, wait = timed(fn, table, *args)
    check(out == want, "replay batch verdicts (second call)")
    results["agg_verify_batch_on_device"] = (ms, made, ops, wait)
    sources["agg_verify_batch_on_device"] = src
    calls["one replay batch of 64 headers"] = (fn, table, *args)
    log(f"agg_verify_batch_on_device: {len(lanes)} headers, "
        f"{sum(want)} valid and {len(want) - sum(want)} forged, as built")

    # independent single checks at width 8
    pk_pts, h_pts, sig_pts, expect = [], [], [], []
    for k in range(SINGLE_CHECKS):
        i = rng.randrange(COMMITTEE)
        sig_k = g2.mul(hashes[k], sks[i])
        forged = k % 3 == 2
        pk_pts.append(pks[(i + 1) % COMMITTEE] if forged else pks[i])
        h_pts.append(hashes[k])
        sig_pts.append(sig_k)
        expect.append(not forged)
    fn = D.verify_many_on_device
    out, ops, src = count_ops(fn, pk_pts, h_pts, sig_pts)  # warm
    check(out == expect, f"single checks {out} != {expect}")
    out, ms, made, wait = timed(fn, pk_pts, h_pts, sig_pts)
    check(out == expect, "single checks (second call)")
    calls["8 single checks"] = (fn, pk_pts, h_pts, sig_pts)
    results["verify_many_on_device"] = (ms, made, ops, wait)
    sources["verify_many_on_device"] = src
    log(f"verify_many_on_device: {SINGLE_CHECKS} checks, "
        f"{sum(expect)} valid and {len(expect) - sum(expect)} forged")

    # one single check from the payload bytes (it hashes on the host)
    i = rng.randrange(COMMITTEE)
    ok, ms, made, wait = timed(D.verify_on_device, pks[i], payloads[0],
                               g2.mul(hashes[0], sks[i]))
    check(ok is True, "verify_on_device rejected a valid signature")
    results["verify_on_device"] = (ms, made, None, wait)
    log("verify_on_device: valid signature True")

    for name, (ms, made, ops, wait) in results.items():
        # the single checks sum no mask
        for kernel, n in made.items():
            if kernel != "g1_masked_sum" or name.startswith("agg_"):
                check(n > 0, f"{name} never launched the {kernel} kernel")
        line = (f"{name}: {ms:.3f} ms per call ({wait:.3f} ms of it waiting "
                f"for the card at the end), " + ", ".join(
                    f"{n} {kernel}" for kernel, n in made.items())
                + " launches")
        if ops is not None:
            dispatches = sum(made.values()) + ops
            line += (f" and {ops} other tensor ops per call: {dispatches} "
                     f"host dispatches ({1e3 * ms / dispatches:.3f} us per "
                     f"launch or op)")
        log(line)
        if name in sources:
            log(f"{name} by source: " + "; ".join(
                f"{src} {c.total() - c['ops']} launches ("
                + ", ".join(f"{k} {n}" for k, n in sorted(c.items())
                            if k != "ops")
                + f") + {c['ops']} other ops"
                for src, c in sorted(sources[name].items(),
                                     key=lambda kv: -kv[1].total())))
    # what fusing the towers, the Miller loop, the inversion and the masked
    # sum must have left of one check's launches
    made = results["agg_verify_hashed_on_device"][1]
    for kernel, (least, most) in QC_LAUNCHES.items():
        check(least <= made[kernel] <= most,
              f"one quorum check launched {kernel} {made[kernel]} times, "
              f"not {least} to {most}")
    return results, calls


def gt_phase(seed):
    """A pairing product on the card equals the CPU plain path's."""
    import torch

    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import pairing as PR
    from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 1)
    pairs = [(g1.mul(G1_GEN, rng.randrange(1, R_ORDER)),
              g2.mul(G2_GEN, rng.randrange(1, R_ORDER))) for _ in range(2)]
    ps = torch.stack([I.g1_affine_to_arr(p)[None] for p, _ in pairs])
    qs = torch.stack([I.g2_affine_to_arr(q)[None] for _, q in pairs])
    on_card = PR.pairing_product(ps.cuda(), qs.cuda()).cpu()
    on_cpu = PR.pairing_product(ps, qs)
    check(torch.equal(on_card, on_cpu),
          "pairing product on the card differs from the CPU plain path")
    check(not bool(PR.is_one(on_cpu)[0]), "random pairing product is 1")
    log("pairing_product on the card == CPU plain path (GT, 2 pairs)")


def profile_phase(seed, entry_calls):
    """Where the time goes: one Fp12 product at 64 lanes (the fused
    kernel, and the composition over the Fp kernels that it replaced),
    and one call of each entry point the slice phase timed (``entry_calls``:
    name -> (entry point, arguments); one quorum check, one replay batch,
    8 single checks, bucket 256); each one's wall time without a profiler
    against the device time torch.profiler records, by kernel.
    Device time is summed over the device's own rows: the rows of the
    ATen operators carry their kernels' time again."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from harmony_tpu_torch.ops import towers as T

    rng = np.random.default_rng(seed + 2)
    a, b = fp12_limbs(rng, 64), fp12_limbs(rng, 64)
    calls = {
        "fp12_mul at 64 lanes": (lambda: T.fp12_mul(a, b), 20),
        "the composition over the Fp kernels at 64 lanes": (
            lambda: T.fp12_mul_reference(a, b), 20),
    }
    for name, (entry, *args) in entry_calls.items():
        calls[name] = (lambda entry=entry, args=args: entry(*args), 3)
    out = {}
    for name, (fn, reps) in calls.items():
        with torch.inference_mode():
            fn()
            before = launches()
            fn()
            made = {k: n - before[k] for k, n in launches().items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / reps
            rows, split = profiled(fn, reps, ("CPU", "CUDA"))
        others = [r for r in rows
                  if not any(symbol(k) in r.key for k in KERNELS)]
        rest = sum(r.self_device_time_total for r in others
                   if r.device_type == DeviceType.CUDA) / reps
        rest_all_rows = sum(r.self_device_time_total for r in others) / reps
        device = rest + sum(split.values())
        if "composition" not in name:
            check(split["fp12_mul"] > 0, f"{name}: no fp12_mul kernel seen")
        out[name] = {"wall_us": wall_us, "device_us": device,
                     "busy": device / wall_us, "launches": made,
                     "kernel_us": split, "rest_us": rest,
                     "rest_us_all_rows": rest_all_rows}
        log(f"{name}: {wall_us:.3f} us wall per call, {device:.3f} us "
            f"device time ({100 * device / wall_us:.2f}% busy): " + ", ".join(
                f"{k} {split[k]:.3f} us in {made[k]} launches"
                for k in KERNELS) + f", the rest {rest:.3f} us (summed over "
            f"all rows, as before: {rest_all_rows:.3f} us)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1673)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from harmony_tpu_torch.kernels import _build
        wrappers()
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    started = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    log(f"built {_build.library_path().name} from "
        f"{', '.join(src.name for src in _build.SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s")
    ptxas = ptxas_report()
    sass = sass_sizes()
    for kernel, line in ptxas.items():
        log(f"ptxas, {kernel}: {line}; {sass[kernel]} SASS instructions")
    # the phase plans keep every index into a register array constant
    for kernel in ("miller_loop", "fp12_cyclo_sqr"):
        check(all(f"0 bytes {what}" in ptxas[kernel] for what in
                  ("stack frame", "spill stores", "spill loads")),
              f"{kernel} has a stack frame or spills: {ptxas[kernel]}")

    stats = {k: {"max_abs_err": 0} for k in KERNELS}
    mont_mul_phase(args.seed, stats["mont_mul"])
    addsub_phase(args.seed, stats["fp_addsub"])
    fp12_mul_phase(args.seed, stats["fp12_mul"])
    cyclo_phase(args.seed, stats["fp12_cyclo_sqr"])
    miller_phase(args.seed, stats["miller_loop"])
    inv_phase(args.seed, stats["fp_inv"])
    qc_keys, qc_mask = g1_sum_phase(args.seed, stats["g1_masked_sum"])
    timings = timing_phase(args.seed)
    timings.update(tower_timing_phase(args.seed))
    timings.update(loop_timing_phase(args.seed, qc_keys, qc_mask,
                                     stats["g1_masked_sum"]))

    # the main path: launch counts start from zero here
    for module in wrappers().values():
        module.LAUNCHES = 0
    _, entry_calls = slice_phase(args.seed)
    path = launches()
    for name, n in path.items():
        check(n > 0, f"the main path never launched the {name} kernel")
    log("main path: " + ", ".join(f"{n} {name}" for name, n in path.items())
        + " launches")
    gt_phase(args.seed)
    profile_phase(args.seed, entry_calls)

    def entry(name, source, replaces, op, shape, described, kept):
        t = timings[op][shape]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": path[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "ptxas": ptxas[name],
            "sass_instructions": sass[name],
            "shape": described,
            "timings": {o: timings[o] for o in kept},
        }

    kernels = [
        entry("mont_mul", "harmony_tpu_torch/csrc/mont_mul.cu",
              "harmony_tpu/ops/fp_pallas.py:35", "mont_mul", "2^16",
              "65536 rows, mont_mul", ("mont_mul", "host_us")),
        entry("fp_addsub", "harmony_tpu_torch/csrc/fp_addsub.cu",
              "none: fuses harmony_tpu/ops/fp.py:121-139 (jnp, fused by XLA)",
              "add", "2^16", "65536 rows, add", ("add", "sub", "neg")),
        entry("fp12_mul", "harmony_tpu_torch/csrc/fp12_mul.cu",
              "none: fuses harmony_tpu/ops/towers.py:212 (jnp, fused by XLA)",
              "fp12_mul", "2x64 lanes",
              "128 lanes, the stacked (2, 64) Miller shape", ("fp12_mul",)),
        entry("fp12_cyclo_sqr", "harmony_tpu_torch/csrc/fp12_cyclo_sqr.cu",
              "none: fuses harmony_tpu/ops/towers.py:255 (jnp, fused by XLA)",
              "fp12_cyclo_sqr", "1 lanes, n = 32",
              "1 lane, 32 squarings (a quorum check's longest run)",
              ("fp12_cyclo_sqr",)),
        entry("miller_loop", "harmony_tpu_torch/csrc/miller_loop.cu",
              "none: fuses harmony_tpu/ops/pairing.py:155-194 (scan and "
              "fori_loop, fused by XLA)", "miller_loop", "2 lanes",
              "2 lanes, a quorum check's two pairs", ("miller_loop",)),
        entry("fp_inv", "harmony_tpu_torch/csrc/fp_inv.cu",
              "none: fuses harmony_tpu/ops/fp.py:224-245 (pow_fixed scan, "
              "fused by XLA)", "fp_inv", "1 rows",
              "1 row, a quorum check's inversion", ("fp_inv",)),
        entry("g1_masked_sum", "harmony_tpu_torch/csrc/g1_masked_sum.cu",
              "none: fuses harmony_tpu/ops/curve.py:235-262 masked_sum and "
              ":220-231 to_affine (jnp, fused by XLA)", "g1_masked_sum",
              "1 lanes", "bucket 256, 1 lane: a quorum check's 150 of 200 "
              "keys", ("g1_masked_sum",)),
    ]
    log(f"chip_smoke took {time.perf_counter() - started:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
