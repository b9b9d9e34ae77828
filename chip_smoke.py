#!/usr/bin/env python3
"""Smoke test of harmony_tpu_torch on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card.  It

1. prints the card's name and power limit and builds the CUDA kernel
   (harmony_tpu_torch/csrc/mont_mul.cu) from the checkout;
2. holds the kernel against its plain PyTorch version on the card, bit for
   bit, at the shapes the verify path gives it, and times both;
3. drives the quorum-verify path through its entry points at Harmony
   mainnet width (a 200-slot committee, bucket 256): one quorum
   certificate and its forgeries, a replay batch of 64 headers, 8
   single checks and one check from payload bytes, each verdict as
   constructed; it shows that every entry point went through the kernel
   and counts the other tensor ops each call issues;
4. holds a pairing product on the card against the CPU plain path, and
   profiles one Fp12 product (wall time against device time);
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

# H100 SXM published peaks: HBM3 bandwidth, and int32 multiply-adds taken
# as half the non-tensor fp32 FMA rate (67 TFLOP/s = 33.5e12 FMA/s; an SM
# has 64 INT32 lanes to 128 FP32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_IMAD_PER_S = 16.75e12
# One Montgomery product: read a and b, write the result (128 B each); at
# least 2 x 12 x 12 = 288 32x32->64-bit products, 2 IMAD each.
BYTES_PER_PRODUCT = 3 * 128
IMAD_PER_PRODUCT = 2 * 288

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


def kernel_phase(seed, stats):
    """The kernel against its plain version on the card, bit for bit."""
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
        want = fp.mont_mul_reference(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        check(got.shape == want.shape and err == 0,
              f"{name}: kernel differs from the plain version (max {err})")
        log(f"kernel == plain (bit for bit, tolerance 0): {name} "
            f"{tuple(got.shape)}")
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
    fa, fb = canonical_limbs(rng, f12_shape), canonical_limbs(rng, f12_shape)
    compare("stacked fp12_mul, 64 lanes", fa, fb)
    n = 1 << 16
    a, b = canonical_limbs(rng, (n,)), canonical_limbs(rng, (n,))
    got = compare("2^16 random products", a, b).cpu().numpy()
    inv_r = pow(r_mont, -1, P)
    for i in prng.sample(range(n), 8):
        check(limbs_to_int(got[i]) == limbs_to_int(a[i]) * limbs_to_int(b[i])
              * inv_r % P, f"2^16 batch, lane {i}: kernel differs from bigint")
    log("kernel == host bigint on 8 lanes of the 2^16 batch")

    timings = {}
    for name, (x, y) in (("2^16", (a, b)), ("fp12x64", (fa, fb))):
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        products = x.numel() // 32
        timings[name] = {
            "products": products,
            "ms": cuda_ms(lambda: K.mont_mul(x, y), 200),
            "plain_ms": cuda_ms(lambda: fp.mont_mul_reference(x, y), 10),
            "bound_ms": 1e3 * max(products * BYTES_PER_PRODUCT
                                  / HBM_BYTES_PER_S,
                                  products * IMAD_PER_PRODUCT
                                  / INT32_IMAD_PER_S),
            "bound_by": ("bytes" if BYTES_PER_PRODUCT / HBM_BYTES_PER_S
                         >= IMAD_PER_PRODUCT / INT32_IMAD_PER_S
                         else "operations"),
        }
        t = timings[name]
        log(f"mont_mul at {name} ({products} products): kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
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
    views left out.  On the card each is at least one kernel launch; the
    mont_mul kernel itself goes through ctypes and is counted apart."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    mode = Count()
    with mode:
        out = fn(*args)
    return out, mode.n


def timed(fn, *args):
    """(result, wall ms, mont_mul launches) of one call; every entry point
    returns host bools, so the call has finished on the card."""
    import torch

    from harmony_tpu_torch.kernels import mont_mul as K

    torch.cuda.synchronize()
    before = K.LAUNCHES
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), K.LAUNCHES - before


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

    for name, (ms, launches, ops) in results.items():
        check(launches > 0, f"{name} never launched the mont_mul kernel")
        line = f"{name}: {ms:.3f} ms per call, {launches} mont_mul launches"
        if ops is not None:
            line += (f" and {ops} other tensor ops per call "
                     f"({1e3 * ms / (launches + ops):.3f} us per op)")
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
    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch.ops import towers as T

    rng = np.random.default_rng(seed + 2)
    shape = (64, 2, 3, 2)
    a = torch.from_numpy(canonical_limbs(rng, shape)).cuda()
    b = torch.from_numpy(canonical_limbs(rng, shape)).cuda()
    reps = 20
    with torch.inference_mode():
        for _ in range(3):
            T.fp12_mul(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            T.fp12_mul(a, b)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                T.fp12_mul(a, b)
            torch.cuda.synchronize()
    rows = prof.key_averages()
    device_us = sum(r.self_device_time_total for r in rows) / reps
    kernel_us = sum(r.self_device_time_total for r in rows
                    if "mont_mul_kernel" in r.key) / reps
    check(device_us > 0, "the profiler recorded no device time")
    log(f"fp12_mul at 64 lanes: {wall_us:.3f} us wall per call, "
        f"{device_us:.3f} us device time ({100 * device_us / wall_us:.2f}% "
        f"busy), of which mont_mul {kernel_us:.3f} us")


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
        from harmony_tpu_torch.kernels import mont_mul as K
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    K.build()
    log(f"built {K.library_path().name} from {K.SOURCE.name} in "
        f"{time.perf_counter() - t0:.3f} s")

    stats = {"max_abs_err": 0}
    timings = kernel_phase(args.seed, stats)

    # the main path: launch counts start from zero here
    K.LAUNCHES = 0
    slice_phase(args.seed)
    launches = K.LAUNCHES
    check(launches > 0, "the main path never launched the mont_mul kernel")
    log(f"main path: {launches} mont_mul launches")
    gt_phase(args.seed)
    profile_phase(args.seed)

    t = timings["2^16"]
    kernels = [{
        "name": "mont_mul",
        "route": "cuda",
        "source": "harmony_tpu_torch/csrc/mont_mul.cu",
        "replaces": "harmony_tpu/ops/fp_pallas.py:35",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "shape": f"{t['products']} products",
        "at_fp12x64": timings["fp12x64"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
