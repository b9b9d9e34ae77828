#!/usr/bin/env python3
"""Smoke test of harmony_tpu_torch on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card.  It

1. prints the card's name and power limit and builds the CUDA kernels
   (harmony_tpu_torch/csrc/mont_mul.cu and fp_addsub.cu, one library)
   from the checkout;
2. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the shapes the verify path gives it and on edge cases;
   times both with the wrapper, and each kernel alone on the device
   (torch.profiler), and the wrapper's host cost per call;
3. drives the quorum-verify path through its entry points at Harmony
   mainnet width (a 200-slot committee, bucket 256): one quorum
   certificate and its forgeries, a replay batch of 64 headers, 8
   single checks and one check from payload bytes, each verdict as
   constructed; it shows that every entry point went through both
   kernels and counts the other tensor ops each call issues;
4. holds a pairing product on the card against the CPU plain path, and
   profiles one Fp12 product (wall time against device time, split by
   kernel);
5. prints a JSON line describing each kernel, then, last,
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Without CUDA,
or without the harmony_tpu_torch package next to it, it exits non-zero
and prints no result.  Keys, payloads and signatures come from --seed.
"""

import argparse
import json
import random
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
# and select.
WORK = {"mont_mul": (3 * 128, 2 * 288), "add": (3 * 128, 3 * 12),
        "sub": (3 * 128, 3 * 12), "neg": (2 * 128, 3 * 12)}

# Rows per call at the shapes timed: one fp12_mul at 64 lanes (54 products
# x 64), 2^16, and the largest call the slice makes.  That is the first
# level of the masked G1 sum of the 64-header batch at bucket 256: 128 x 64
# point additions, whose products mont_mul takes four coordinates at a
# time (4 x 128 x 64 rows) and whose additions take one (128 x 64).
FP12_ROWS = 54 * 64
LARGEST_ROWS = {"mont_mul": 4 * 128 * 64, "fp_addsub": 128 * 64}

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


HAND_KERNELS = ("mont_mul_kernel", "fp_addsub_kernel")


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

    from harmony_tpu_torch.kernels import fp_addsub as KA
    from harmony_tpu_torch.kernels import mont_mul as K

    fn()
    torch.cuda.synchronize()
    attempts = 5
    for attempt in range(1, attempts + 1):
        before = (K.LAUNCHES, KA.LAUNCHES)
        with profile(activities=[getattr(ProfilerActivity, a)
                                 for a in activities]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        made = dict(zip(HAND_KERNELS, (K.LAUNCHES - before[0],
                                       KA.LAUNCHES - before[1])))
        seen = {k: sum(r.count for r in rows if k in r.key)
                for k in HAND_KERNELS}
        if all(seen[k] >= 0.5 * made[k] for k in HAND_KERNELS):
            return rows, {
                k: sum(r.self_device_time_total for r in rows if k in r.key)
                / seen[k] * made[k] / reps if seen[k] else 0.0
                for k in HAND_KERNELS}
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


def bound(op, rows):
    """(ms, what bounds it): the least time the card could take for ``op``
    on ``rows`` rows, from the bytes it must move and the operations it
    must do, at the published peaks."""
    nbytes, ops = WORK[op]
    by_bytes = rows * nbytes / HBM_BYTES_PER_S
    by_ops = rows * ops / INT32_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations")


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
    calls = {"mont_mul": (K.mont_mul, fp.mont_mul_reference,
                          "mont_mul_kernel"),
             "add": (KA.add, fp.add_reference, "fp_addsub_kernel"),
             "sub": (KA.sub, fp.sub_reference, "fp_addsub_kernel"),
             "neg": (KA.neg, fp.neg_reference, "fp_addsub_kernel")}
    timings = {}
    for op, (kernel, plain, name) in calls.items():
        family = "mont_mul" if op == "mont_mul" else "fp_addsub"
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
                "device_ms": 1e-3 * device_us(lambda: kernel(*args), name, 50),
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


def count_ops(fn, *args):
    """(result, tensor ops) of one call: the ATen operators it dispatches,
    views left out.  A ``contiguous`` that copies counts, though ATen
    marks the operator as a view.  Most ops launch a kernel on the card;
    an allocation (``empty_like``) launches none.  The hand-written kernels
    go through ctypes and are counted apart."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    contiguous = torch.ops.aten.contiguous.default

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view or (func is contiguous
                                    and not args[0].is_contiguous()):
                self.n += 1
            return func(*args, **(kwargs or {}))

    mode = Count()
    with mode:
        out = fn(*args)
    return out, mode.n


def timed(fn, *args):
    """(result, wall ms, (mont_mul, fp_addsub) launches) of one call; every
    entry point returns host bools, so the call has finished on the card."""
    import torch

    from harmony_tpu_torch.kernels import fp_addsub as KA
    from harmony_tpu_torch.kernels import mont_mul as K

    torch.cuda.synchronize()
    before = (K.LAUNCHES, KA.LAUNCHES)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), (
        K.LAUNCHES - before[0], KA.LAUNCHES - before[1])


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
    results = {}

    # one commit quorum certificate and its forgeries
    bits = [0] * COMMITTEE
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bits[i] = 1
    h, sig = hashes[0], agg_sign(sks, bits, hashes[0])
    flipped = list(bits)
    flipped[bits.index(1)] = 0
    fn = D.agg_verify_hashed_on_device
    ok, ops = count_ops(fn, table, bits, h, sig)  # warm
    check(ok is True, "valid quorum certificate rejected")
    ok, ms, launches = timed(fn, table, bits, h, sig)
    check(ok is True, "valid quorum certificate rejected (second call)")
    results["agg_verify_hashed_on_device"] = (ms, launches, ops)
    for what, args in (("one bit flipped", (flipped, h, sig)),
                       ("wrong payload", (bits, hashes[1], sig)),
                       ("infinity signature", (bits, h, ((0, 0), (0, 0))))):
        ok, _, _ = timed(fn, table, *args)
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
    out, ops = count_ops(fn, table, *args)  # warm
    check(out == want, f"replay batch verdicts {out} != {want}")
    out, ms, launches = timed(fn, table, *args)
    check(out == want, "replay batch verdicts (second call)")
    results["agg_verify_batch_on_device"] = (ms, launches, ops)
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
    out, ops = count_ops(fn, pk_pts, h_pts, sig_pts)  # warm
    check(out == expect, f"single checks {out} != {expect}")
    out, ms, launches = timed(fn, pk_pts, h_pts, sig_pts)
    check(out == expect, "single checks (second call)")
    results["verify_many_on_device"] = (ms, launches, ops)
    log(f"verify_many_on_device: {SINGLE_CHECKS} checks, "
        f"{sum(expect)} valid and {len(expect) - sum(expect)} forged")

    # one single check from the payload bytes (it hashes on the host)
    i = rng.randrange(COMMITTEE)
    ok, ms, launches = timed(D.verify_on_device, pks[i], payloads[0],
                             g2.mul(hashes[0], sks[i]))
    check(ok is True, "verify_on_device rejected a valid signature")
    results["verify_on_device"] = (ms, launches, None)
    log("verify_on_device: valid signature True")

    for name, (ms, (muls, addsubs), ops) in results.items():
        check(muls > 0, f"{name} never launched the mont_mul kernel")
        check(addsubs > 0, f"{name} never launched the fp_addsub kernel")
        line = (f"{name}: {ms:.3f} ms per call, {muls} mont_mul and "
                f"{addsubs} fp_addsub launches")
        if ops is not None:
            line += (f" and {ops} other tensor ops per call "
                     f"({1e3 * ms / (muls + addsubs + ops):.3f} us per "
                     f"launch or op)")
        log(line)
    return results


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


def profile_phase(seed):
    """Where the time of the path's commonest call goes: one Fp12 product
    at 64 lanes, its wall time without a profiler against the device time
    torch.profiler records for it, by kernel."""
    import numpy as np
    import torch

    from harmony_tpu_torch.kernels import fp_addsub as KA
    from harmony_tpu_torch.kernels import mont_mul as K
    from harmony_tpu_torch.ops import towers as T

    rng = np.random.default_rng(seed + 2)
    shape = (64, 2, 3, 2)
    a = torch.from_numpy(canonical_limbs(rng, shape)).cuda()
    b = torch.from_numpy(canonical_limbs(rng, shape)).cuda()
    reps = 20
    with torch.inference_mode():
        for _ in range(2):
            T.fp12_mul(a, b)
        before = (K.LAUNCHES, KA.LAUNCHES)
        T.fp12_mul(a, b)
        muls, addsubs = K.LAUNCHES - before[0], KA.LAUNCHES - before[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            T.fp12_mul(a, b)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / reps
        rows, split = profiled(lambda: T.fp12_mul(a, b), reps,
                               ("CPU", "CUDA"))
    rest = sum(r.self_device_time_total for r in rows
               if not any(k in r.key for k in HAND_KERNELS)) / reps
    device_us = rest + sum(split.values())
    check(all(split.values()), f"a kernel is missing from fp12_mul: {split}")
    log(f"fp12_mul at 64 lanes: {wall_us:.3f} us wall per call, "
        f"{device_us:.3f} us device time ({100 * device_us / wall_us:.2f}% "
        f"busy): mont_mul {split['mont_mul_kernel']:.3f} us in {muls} "
        f"launches, fp_addsub {split['fp_addsub_kernel']:.3f} us in "
        f"{addsubs} launches, the rest {rest:.3f} us")


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
        from harmony_tpu_torch.kernels import fp_addsub as KA
        from harmony_tpu_torch.kernels import mont_mul as K
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    log(f"built {_build.library_path().name} from "
        f"{', '.join(src.name for src in _build.SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s")

    stats = {"mont_mul": {"max_abs_err": 0}, "fp_addsub": {"max_abs_err": 0}}
    mont_mul_phase(args.seed, stats["mont_mul"])
    addsub_phase(args.seed, stats["fp_addsub"])
    timings = timing_phase(args.seed)

    # the main path: launch counts start from zero here
    K.LAUNCHES = KA.LAUNCHES = 0
    slice_phase(args.seed)
    launches = {"mont_mul": K.LAUNCHES, "fp_addsub": KA.LAUNCHES}
    for name, n in launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")
    log(f"main path: {launches['mont_mul']} mont_mul and "
        f"{launches['fp_addsub']} fp_addsub launches")
    gt_phase(args.seed)
    profile_phase(args.seed)

    def entry(name, source, replaces, op):
        t = timings[op]["2^16"]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": f"{t['rows']} rows, {op}",
            "timings": {o: timings[o] for o in ("mont_mul", "add", "sub",
                                                "neg", "host_us")
                        if (o == "mont_mul") == (name == "mont_mul")},
        }

    kernels = [
        entry("mont_mul", "harmony_tpu_torch/csrc/mont_mul.cu",
              "harmony_tpu/ops/fp_pallas.py:35", "mont_mul"),
        entry("fp_addsub", "harmony_tpu_torch/csrc/fp_addsub.cu",
              "none: fuses harmony_tpu/ops/fp.py:121-139 (jnp, fused by XLA)",
              "add"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
