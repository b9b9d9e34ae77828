#!/usr/bin/env python3
"""Smoke test of harmony_tpu_torch on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card.  It

1. prints the card's name and power limit and builds the CUDA kernels
   (harmony_tpu_torch/csrc/mont_mul.cu, fp_addsub.cu, fp12_mul.cu,
   fp12_cyclo_sqr.cu, miller_loop.cu, fp_inv.cu, g1_masked_sum.cu,
   final_exp.cu, scalar_mul.cu (scalar_mul_g1 and scalar_mul_g2) and
   g2_masked_sum.cu, one library) from the checkout, and beside them the
   native host library (native/bls381.cpp, g++), with the build's time,
   each kernel's registers, stack frame, spills and shared memory (ptxas)
   and SASS instructions (cuobjdump); the kernels on plans of phases or
   rounds (fp12_mul, fp12_cyclo_sqr, miller_loop, g1_masked_sum,
   final_exp, scalar_mul_g1, scalar_mul_g2, g2_masked_sum) must have no
   stack frame and no spills;
2. holds each kernel against its plain PyTorch version on the card, bit
   for bit, at the shapes the verify path gives it and on edge cases;
   times both with the wrapper, and each kernel alone on the device
   (torch.profiler), and the wrapper's host cost per call;
3. drives the quorum-verify path through its entry points at Harmony
   mainnet width (a 200-slot committee, bucket 256): one quorum
   certificate and its forgeries, a replay batch of 64 headers, 8
   single checks and one check from payload bytes, each verdict as
   constructed, each timed once (the first three also as the median of
   25 more calls); it shows that every entry point went through the kernels
   of its path and no other (g1_masked_sum, miller_loop, fp12_mul and
   final_exp for the quorum checks; all but the masked G1 sum for the
   single checks), holds one quorum check to its launch counts, and
   counts the other tensor ops each call issues;
4. holds a pairing product on the card against the CPU plain path, and
   profiles one Fp12 product, one quorum check, one replay batch and 8
   single checks (wall time against device time, split by kernel);
5. drives the node's verification layer (node_phase): the scheduler's
   three lanes from three threads at once (quorum checks on CONSENSUS,
   64 replay checks on SYNC, single checks and proofs of possession on
   INGRESS), each flush held to its exact launches, every verdict as
   constructed and as the host path gives it, each lane's median wait
   in the queue over its requests; Mask.aggregate_public twice (the
   second call finds the key table in the mask's cache); the entry
   points from payload bytes with hash_to_g2 native against pure Python;
   one injected dispatch fault, which must give one counted host
   fallback; and one failing dispatch on the card, which must raise
   DeviceError and reach no host path.  device_enabled() must be True
   by AUTO, the
   twins off and the native host library loaded; after every phase
   through an entry point, no check may have fallen back to the host,
   none may have been shed and the breaker must be closed;
6. drives the node's consumers of those checks (consumers_phase), at
   mainnet width with keys from --seed: the chain engine's replay of 64
   headers (16 distinct, each 4 times, one forged, one below quorum),
   whose verdicts must be the host reference's, a second call of the same
   batch (only the forged repeats checked again), the verified ones from
   the cache (no launch) and one header's check on CONSENSUS; an FBFT
   round of 10 nodes of 20 keys (every vote and proof checked, a tampered
   proof rejected); a NEWVIEW that embeds the round's PREPARED proof (one
   g1_masked_sum launch per aggregate_public); Handel's check of an honest
   and a forged partial; and the sidecar server with the port's client
   on each route: through the scheduler (a QC of 150 of 200 bits and a
   wrong bitmap, 8 single checks with one wrong signer, the engine's
   replay through it), under the exec lock with the scheduler disarmed,
   and the direct ops/bls.py branch with the device path off; and one
   verify_crosslinks_batch of 8 cross-links of the committee's headers,
   one presenting its neighbour's proof, each verdict the host
   reference's (the port's ref), one flush of one launch each.  Every
   scheduler flush must launch each kernel of its path exactly once, and
   the routes outside the scheduler their exact launches; node_clean
   after every part;
7. drives the node itself (localnet_phase): 10 Nodes of 20 keys (200
   slots, keys from --seed, each node one operator under the
   LeaderRotation gate) on the port's chain, tx pool and in-process
   gossip, each Blockchain wired to an Engine so every insert re-checks
   its commit proof on the card: three rounds by a manual pump (an empty
   block, a transfer, a create-validator whose proof of possession the
   pool checks on INGRESS, a forged copy refused), one view change whose
   NEWVIEW carries the PREPARED proof, and run_forever threads
   until 5 more blocks commit within 120 s; then a behind Node with no
   keys, whose registry Downloader syncs over a SyncServer of node 0's
   chain, every seal checked on the card: a run of future-round gossip
   spins it up once, and it rejoins at the network's round; every node
   at the same head and commit proofs, every flush at its exact launches,
   node_clean and no dropped message after every part; it prints each
   part's seconds, the rounds' wall seconds and each lane's median wait;
8. drives the node's sync (sync_phase) at mainnet width: a serving
   chain of 256 blocks, each sealed by a 150-of-200 commit proof signed
   on the host, served by SyncServer on loopback; fresh chains sync it
   through the staged Downloader in windows of 64, every window's seals
   one batch through Engine.verify_headers_batch on the card (one flush,
   one launch of each quorum kernel): a full replay, the same headers
   again on a chain sharing the engine (its cache: no launch), a window
   with a forged proof refused twice and then healed, fast_sync (its
   windows, state download and receipts tail) and the snapshot bootstrap
   from the served pages, both under state_retention=1 and then taking 4
   more blocks, and one beacon epoch header into an EpochChain by the
   epoch feed; every synced chain equal to the serving chain, every
   part's launches exact; it prints seconds per window, blocks per
   second, the fast sync's seconds and the direct
   agg_verify_batch_on_device of one window; then mainnet_genesis(0)
   boots a chain, ref.herumi decodes its 150 keys, and their masked sum
   under a seeded bitmap of 100, one g1_masked_sum on the card, equals
   the host reference's bit for bit (mainnet_genesis_phase);
9. holds the signing ops' kernels (scalar_mul_g1, scalar_mul_g2,
   g2_masked_sum) against their plain versions on the card, bit for bit,
   and times them (sign_kernels_phase, sign_timing_phase; the ladders'
   step also by phase, from a timed build of each, ladder_phases; the G2
   sum at 200 and 1,024 points, also by part of its adds, from its timed
   build, g2_sum_timing); then
   drives the signing path through ops/bls.py with its launch counts from
   zero (signing_phase): 256 keys derived and 256 signatures made on the
   card, one payload's cofactor cleared, the aggregate of 150 of 200;
   every lane, made affine on the host, equal to the native host
   library's; the aggregate verified through agg_verify_hashed_on_device
   against a table of the derived keys, one forged lane rejected; each
   call held to its exact launches;
10. drives parallel/mesh.py over a NCCL process group of world size 1
   (mesh_phase): each sharded_* equal to the unsharded call;
11. drives the node's serving surface (serving_phase): a fresh process
   runs aot.startup_warmup(), which must warm all 43 programs of the
   manifest on the card with no failure, and then its first quorum check
   at 200 slots, which must count a JIT hit and no miss; a second fresh
   process makes the same first check without warmup, a third after the
   kernel library's load and each kernel's first launch alone (the wall
   ms of the load, of those launches, of each first and second check, and
   of the median of 25 more, printed); then, in
   this process, a resource governor forced PRESSURED, CRITICAL and back
   to NORMAL: an INGRESS and a SYNC check bound for the card fail with
   DeviceError as governor sheds and launch nothing, a CONSENSUS flush
   launches exactly its 4 kernels, /readyz of the MetricsServer over
   loopback reads 200, 503, 200, /metrics carries the port's families,
   and prof.capture around one quorum check writes a Chrome trace that
   parses (the kernels it saw printed, or none: not measured);
12. drives the node binary (boot_phase): a bootnode and four processes
   of ``python -m harmony_tpu_torch.cli`` on this one card, each holding
   50 of 200 dev keys on its own native-KV datadir, tracing into one span
   directory: every node commits 8 blocks with one hash at each height,
   a dev-genesis transfer sent over hmy_sendRawTransaction lands with the
   same balances on every node, a WebSocket newHeads subscription gets
   every head, the explorer and Rosetta agree with RPC; node 3 stops on
   SIGTERM at block 4 and comes back on its datadir, syncs what it missed
   with the seals on the card and keeps the network's head (its votes
   counted); every /metrics shows quorum
   checks on the card, no host fallback and no twin, /readyz is 200,
   every child exits 0 on SIGTERM and no log holds a traceback or a
   native-KV fallback; then ``cli.build_node`` in this process, a solo
   node of all 200 keys, whose 5 blocks each launch exactly what the
   code says (two aggregate flushes and one single flush a block); it
   prints each child's seconds to `node up`, seconds a block, the RPC
   medians, the transfer's seconds, the restart's, and the committed
   rounds' median split by phase from the span files;
13. runs three of the JAX package's adversarial scenarios through the
   port's chaostest on the card with the real kernels (chaos_phase,
   HARMONY_CHAOS_REAL_KERNELS=1, each in its quick form):
   view_change_storm (the leader black-holed under an ingress flood),
   byz_double_voter_slashed (a staked validator double-votes and is
   slashed) and wan_committee_200 (200 slots under a WAN matrix and the
   Handel overlay); each must pass with no host fallback, no consensus
   shed, no shed for an open breaker, no message dropped for a
   DeviceError and no twin answer, and every launch must belong to a
   scheduler flush or a masked_pubkey_sum held to its exact launches; it
   prints each scenario's seconds, heads, round p50 and p99, view
   changes, round phases, units of device work and launches (violation
   dumps in chaos_phase_dumps/);
14. runs the port's operator tools (harmony_tpu_torch/tools/,
   tools_phase) on the card at their own configurations: obs_smoke,
   sched_smoke, loadgen --duration 5 --check, soak --quick --check and
   chaos_sweep --quick --check over leader_kill_restart and
   rolling_restart in this process, every launch in a scheduler flush or
   a masked_pubkey_sum at its exact count; crash_sweep --check over the
   FileKV and the native KV; round_forensics --check over the boot
   phase's span files, its phase medians the boot phase's; and in fresh
   processes compile_surface_smoke (no first use after warmup across a
   committee-width change) and localnet --nodes 4 --blocks 3
   --device-path --device-real; each tool's --check, no twin answer, no
   host fallback, the breaker closed, no message dropped for a
   DeviceError, no traceback in a child's output; it prints each tool's
   output line and wall seconds (logs in tools_phase_logs/);
15. prints a JSON line describing each kernel (with its launches on
   the main path, the consumers, the signing path, the localnet, the
   sync phase, the node binary, the chaos phase and the tools phase),
   then, last, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Without CUDA,
or without the harmony_tpu_torch package next to it, it exits non-zero
and prints no result.  Keys, payloads and signatures come from --seed.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import random
import re
import subprocess
import sys
import threading
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
# the product, and makes 54 Montgomery products (the plain version's and
# the kernel's, one round of the plan); fp12_cyclo_sqr reads and
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
# its inverse; its batched binary GCD takes some 19 batches (inv_batches,
# 26 at most) of INV_BATCH_OPS word operations (30 steps of about 20 on
# the 62-bit approximations and the four coefficients; two exact linear
# combinations of 13 limbs of 30 bits, about 8 a limb with 2 products of
# 2 IMAD; two modular ones, about 14 a limb with the third product and
# the reduction; about 120 to form the approximations), then one
# Montgomery product.  Per lane, g1_masked_sum reads the points and the
# mask and writes the sum and its affine form; its products are those of
# the lane's tree on this data (sum_tree): an add with infinity needs
# none, an add of two finite points 16, 11 where one has Z = 1 (an affine
# leaf, or one passed up against infinity) and 6 where both have; an add
# of equal or opposite points needs only the 8, 4 or 0 products that find
# them so, and the doubling 7 (6 where Z = 1).  Then the inversion of Z
# and 4 products for the affine form, unless the sum is infinity or still
# has Z = 1.  Per lane, final_exp reads f and writes the result, and makes
# the plain version's products (FINAL_EXP_PRODUCTS: 315 cyclotomic
# squarings of 18, 34 Fp12 products of 54 and one square of 36, the
# inverse's 112 and three Frobenius maps of 18; the kernel makes 7,726,
# squaring by the 54-product plan), and the batches of the GCD on
# the Fp value its inverse reaches, counted from each run's data
# (final_exp_work), and one Montgomery product after them.
MONT_IMAD = 2 * 288
MILLER_PRODUCTS = 63 * (36 + 54 + 34) + 5 * (54 + 44)
FINAL_EXP_PRODUCTS = 315 * 18 + 34 * 54 + 36 + 112 + 3 * 18
INV_BATCH_OPS = 30 * 20 + 2 * 13 * 8 + 2 * 13 * 14 + 120
# by the number of operands with Z = 1: 0, 1, 2
G1_ADD_PRODUCTS = (16, 11, 6)
G1_MATCH_PRODUCTS = (8, 4, 0)
# The signing ops.  scalar_mul_g1 and scalar_mul_g2 read each point (384
# and 768 B) and the bits (4 B each; once for all lanes where they are
# shared) and write each result; their products are those of the
# double-and-add on this data (ladder_work): none before the first set
# bit (the accumulator is at infinity), then per bit the doubling (7 over
# Fp, 16 over Fp2: Karatsuba products, complex squares) and, per set bit
# after the first, the addition of the point (16 and 43, 11 and 30 where
# the point has Z = 1).  The kernels compute both every step (constant
# time).  g2_masked_sum reads the points (768 B) and the mask and writes
# the sum; its products are its tree's on this data (sum_tree), counted
# as g1_masked_sum's with the Fp2 products: an add 43, 30 and 16, finding
# equal or opposite operands 22, 11 and 0, the doubling 16 (13 where
# Z = 1).
SUM_PRODUCTS = {"g1": (G1_ADD_PRODUCTS, G1_MATCH_PRODUCTS, (7, 6)),
                "g2": ((43, 30, 16), (22, 11, 0), (16, 13))}
LADDER_PRODUCTS = {"scalar_mul_g1": (7, (16, 11)),
                   "scalar_mul_g2": (16, (43, 30))}
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
# Fp12 lanes at the path's shapes: fp12_tree_reduce's one product of a
# quorum check (1) and of the 64-header batch (64); and 128, the shape
# the kernel was timed at before its redesign
FP12_LANES = {"1": 1, "64": 64, "128": 128}
# lane counts fp12_mul is also held at: one block per lane
FP12_EDGE_LANES = (1, 2, 3, 64, 128, 129)
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
# the final exponentiation: the lane counts held at (each a prefix of one
# plain run), and those timed (a quorum check's 1, the single checks' 8,
# the replay batch's 64, the widest batch bucket's 256)
FINAL_EXP_LANES = (1, 3, 8, 64, 65, 256)
FINAL_EXP_TIMED_LANES = (1, 8, 64, 256)
# what one quorum check launches, now that the masked G1 sum with its
# affine form, the Miller loop, the product of the two pairs' Miller
# values and the final exponentiation are one launch each
QC_LAUNCHES = {"miller_loop": (1, 1), "fp_inv": (0, 0),
               "g1_masked_sum": (1, 1), "fp_addsub": (0, 0),
               "mont_mul": (0, 0), "fp12_mul": (1, 1),
               "fp12_cyclo_sqr": (0, 0), "final_exp": (1, 1)}
# the kernels each entry point launches, and no other
ENTRY_KERNELS = {
    "agg_verify_hashed_on_device": ("g1_masked_sum", "miller_loop",
                                    "fp12_mul", "final_exp"),
    "agg_verify_batch_on_device": ("g1_masked_sum", "miller_loop",
                                   "fp12_mul", "final_exp"),
    "verify_many_on_device": ("miller_loop", "fp12_mul", "final_exp"),
    "verify_on_device": ("miller_loop", "fp12_mul", "final_exp"),
}
PATH_KERNELS = ENTRY_KERNELS["agg_verify_hashed_on_device"]

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
# calls of each entry point whose median wall time the slice phase reports
MEDIAN_CALLS = 25


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
           "miller_loop", "fp_inv", "g1_masked_sum", "final_exp",
           "scalar_mul_g1", "scalar_mul_g2", "g2_masked_sum")


def wrappers():
    """Each kernel's wrapper module, by kernel name; each counts its
    launches in ``LAUNCHES`` (kernels/scalar_mul.py, a count of each of its
    two kernels, by name)."""
    from harmony_tpu_torch.kernels import final_exp, fp12_cyclo_sqr, \
        fp12_mul, fp_addsub, fp_inv, g1_masked_sum, g2_masked_sum, \
        miller_loop, mont_mul, scalar_mul

    return {"mont_mul": mont_mul, "fp_addsub": fp_addsub,
            "fp12_mul": fp12_mul, "fp12_cyclo_sqr": fp12_cyclo_sqr,
            "miller_loop": miller_loop, "fp_inv": fp_inv,
            "g1_masked_sum": g1_masked_sum, "final_exp": final_exp,
            "scalar_mul_g1": scalar_mul, "scalar_mul_g2": scalar_mul,
            "g2_masked_sum": g2_masked_sum}


def launches():
    return {name: m.LAUNCHES[name] if isinstance(m.LAUNCHES, dict)
            else m.LAUNCHES for name, m in wrappers().items()}


def reset_launches():
    """Every kernel's launch count to 0."""
    for name, m in wrappers().items():
        if isinstance(m.LAUNCHES, dict):
            m.LAUNCHES[name] = 0
        else:
            m.LAUNCHES = 0


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
    has been seen to drop one launch in fifty, and in one session in ten
    to one in two most or all of a session's kernels (five sessions in a
    row, once).  Each kernel's time per call is the mean of the launches
    seen times the launches made; a session that missed half of a
    kernel's launches is run again, at most nine times more, and then the
    phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    attempts = 10
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


def inv_batches(x):
    """The batches of csrc/fp384.cuh inv on the plain integer x (a R mod
    p for Montgomery limbs of a): Pornin's binary GCD, 30 steps a batch on
    62-bit approximations of a and b, until a = 0."""
    from harmony_tpu_torch.ref.params import P

    mask30, top32 = (1 << 30) - 1, (1 << 32) - 1
    a, b, batches = x, P, 0
    while a:
        n = max(a.bit_length(), b.bit_length(), 62)
        ta = a & mask30 | (a >> (n - 32) & top32) << 30
        tb = b & mask30 | (b >> (n - 32) & top32) << 30
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(30):
            if ta & 1:
                if ta < tb:
                    ta, tb, f0, g0, f1, g1 = tb, ta, f1, g1, f0, g0
                ta, f0, g0 = ta - tb, f0 - f1, g0 - g1
            ta, f1, g1 = ta >> 1, 2 * f1, 2 * g1
        a, b = abs(a * f0 + b * g0) >> 30, abs(a * f1 + b * g1) >> 30
        batches += 1
    return batches


def inv_ops(limbs):
    """The int32 operations of inverting the rows of ``limbs`` (..., 32):
    the GCD's batches on each row's value, and one Montgomery product."""
    from harmony_tpu_torch.ops.limbs import limbs_to_int

    values = [limbs_to_int(r) for r in limbs.reshape(-1, 32).cpu().numpy()]
    return sum(inv_batches(x) * INV_BATCH_OPS + MONT_IMAD
               for x in values if x)


def inv_work(limbs):
    """(ms, what bounds it) of fp_inv on these limbs: read and write each
    row once, and the steps this data needs."""
    return roofline(limbs.numel() // 32 * 2 * 128, inv_ops(limbs))


def sum_tree(keys, bits, field="g1"):
    """(Montgomery products, whether the sum has Z = 1) of one lane of the
    masked sum over G1 or G2 on these keys (host affine points, None for a
    pad row) with Z = 1 where ``z_one`` and mask words ``bits``: the tree
    of masked_sum run on the host, each add counted by what its operands
    need (the tables above WORK)."""
    from harmony_tpu_torch.ref.curve import g1, g2

    group = g1 if field == "g1" else g2
    add_products, match_products, dbl_products = SUM_PRODUCTS[field]
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
                products += match_products[ones]
                if p[1] == q[1]:
                    products += dbl_products[p_one]
            else:
                products += add_products[ones]
            level.append((group.add(p, q), False))
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
    each lane's tree on this data (sum_tree), and, where the sum is finite
    without Z = 1, the inversion of its Z and 4 products."""
    keys = g1_keys(points)
    m = mask.reshape(mask.shape[0], -1).cpu().tolist()
    sums = sums.reshape(-1, *sums.shape[-2:])
    lanes = len(m[0])
    ops = 0
    for b in range(lanes):
        products, z_one = sum_tree(keys, [row[b] for row in m])
        ops += products * MONT_IMAD
        if not z_one and sums[b, 2].any():
            ops += inv_ops(sums[b, 2]) + 4 * MONT_IMAD
    nbytes = points.numel() * 4 + mask.numel() * 4 + lanes * (3 + 2) * 128
    return roofline(nbytes, ops)


def final_exp_gcd_value(limbs):
    """The Fp value that final_exp's inverse hands to the binary GCD for
    one lane's f (limbs (2, 3, 2, 32)): d0^2 + d1^2, with d the Fp2 norm
    of n = a0^2 - v a1^2 (csrc/final_exp.cuh), as the plain integer x R
    mod p of its Montgomery limbs."""
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref import fields as RF
    from harmony_tpu_torch.ref.params import P

    mul, sub, xi = RF.fp2_mul, RF.fp2_sub, RF.fp2_mul_xi
    a0, a1 = I.arr_to_fp12(limbs)
    n0, n1, n2 = RF.fp6_sub(RF.fp6_mul(a0, a0),
                            RF.fp6_mul_v(RF.fp6_mul(a1, a1)))
    t0 = sub(mul(n0, n0), xi(mul(n1, n2)))
    t1 = sub(xi(mul(n2, n2)), mul(n0, n1))
    t2 = sub(mul(n1, n1), mul(n0, n2))
    d = RF.fp2_add(mul(n0, t0), xi(RF.fp2_add(mul(n2, t1), mul(n1, t2))))
    return (d[0] ** 2 + d[1] ** 2) * (1 << 384) % P


def final_exp_work(f):
    """(ms, what bounds it) of final_exp on these lanes f (..., 2, 3, 2,
    32): read f and write the result once; the plain version's products
    per lane, and the GCD's batches on each lane's Fp value (none for a
    zero lane) with the Montgomery product after them."""
    lanes = f.reshape(-1, 2, 3, 2, 32).cpu()
    ops = len(lanes) * FINAL_EXP_PRODUCTS * MONT_IMAD
    for lane in lanes:
        x = final_exp_gcd_value(lane)
        if x:
            ops += inv_batches(x) * INV_BATCH_OPS + MONT_IMAD
    return roofline(len(lanes) * 2 * 12 * 128, ops)


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
    ``curve.FP_OPS`` holds; the masked sum and the scalar multiplication
    over G1 and G2) are their plain PyTorch versions, so the plain
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
              (PR, "final_exponentiation",
               PR.final_exponentiation_reference),
              (CV, "masked_sum", CV.masked_sum_reference),
              (CV, "scalar_mul", CV.scalar_mul_reference),
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
    values, and at 1, 2, 3, 64, 128 and 129 lanes (one block per lane);
    two lanes also against the host bigint."""
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

    for lanes in FP12_EDGE_LANES:
        a, b = fp12_limbs(rng, lanes), fp12_limbs(rng, lanes)
        got = compare(f"fp12_mul, {lanes} lanes", a, b)
        compare(f"fp12_sqr, {lanes} lanes", a)
    for i in (0, 128):
        x, y, z = (I.arr_to_fp12(t[i].cpu()) for t in (a, b, got))
        check(z == RF.fp12_mul(x, y),
              f"fp12_mul lane {i}: kernel differs from the host bigint")
    log("fp12_mul kernel == host bigint on 2 lanes of 129")
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
    """The fp_inv kernel (batched binary GCD steps) against the plain
    Fermat chain (plain PyTorch on the card, no hand kernel launched), bit
    for bit, at 1, 3, 64 and 3,456 rows with 0, 1 and p - 1 among them;
    the rows also against the host bigint."""
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


def final_exp_inputs(seed):
    """256 lanes of f on the card, the interesting ones first: the Miller
    values of 8 pairing products of two pairs as verify_many builds them
    (5 of real pairs, then 3 pad lanes of infinity (0, 0), whose Miller
    values leave the cyclotomic subgroup), made by the Miller-loop and
    Fp12 kernels; a zero lane; one; and random values."""
    import numpy as np
    import torch

    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import pairing as PR
    from harmony_tpu_torch.ops import towers as T
    from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = np.random.default_rng(seed + 12)
    prng = random.Random(seed + 12)
    ps = torch.zeros(2, 8, 2, 32, dtype=torch.int32)
    qs = torch.zeros(2, 8, 2, 2, 32, dtype=torch.int32)
    for k in range(2):
        for b in range(5):
            ps[k, b] = I.g1_affine_to_arr(
                g1.mul(G1_GEN, prng.randrange(1, R_ORDER)))
            qs[k, b] = I.g2_affine_to_arr(
                g2.mul(G2_GEN, prng.randrange(1, R_ORDER)))
    with torch.inference_mode():
        miller = PR.fp12_tree_reduce(PR.miller_loop(ps.cuda(), qs.cuda()))
    return torch.cat([miller, T.fp12_zero((1,), "cuda"),
                      T.fp12_one((1,), "cuda"),
                      fp12_limbs(rng, 256 - 10)])


def final_exp_phase(seed, stats):
    """The final_exp kernel against final_exponentiation_reference (plain
    PyTorch on the card, no hand kernel launched), bit for bit, at 1, 3,
    8, 64, 65 and 256 lanes, each a prefix of one plain run over the 256
    lanes of final_exp_inputs (Miller values with pad lanes, 0, 1, random
    values); the 256 lanes also against the composition over the other
    kernels (the path before this kernel).  Returns the inputs."""
    import torch

    from harmony_tpu_torch.kernels import final_exp as KF
    from harmony_tpu_torch.ops import pairing as PR

    f = final_exp_inputs(seed)
    with torch.inference_mode(), plain_fp():
        want = PR.final_exponentiation_reference(f)
    for lanes in FINAL_EXP_LANES:
        _compare(f"final_exp, {lanes} lanes, against plain PyTorch",
                 KF.final_exp(f[:lanes]), want[:lanes], stats)
    with torch.inference_mode():
        _compare("final_exp, 256 lanes, against the composition over the "
                 "other kernels", KF.final_exp(f),
                 PR.final_exponentiation_reference(f), stats)
    check(not want[8].any() and bool(PR.is_one(want[9])),
          "the final exponentiation of 0 is not 0, or of 1 not 1")
    return f


def final_exp_timing_phase(f):
    """final_exp at the path's lane counts, on prefixes of the inputs of
    final_exp_phase: wrapper-inclusive ms by CUDA events, the kernel's own
    device time by torch.profiler, the ms of the composition over the
    other kernels that it replaced, the bound from these inputs (the GCD's
    batches counted from each lane's data), the wrapper's host cost per
    call; and at 1 lane the plain version's ms (plain PyTorch on the
    card, some seconds a call)."""
    from harmony_tpu_torch.kernels import final_exp as KF
    from harmony_tpu_torch.ops import pairing as PR

    def plain(a):
        def run():
            with plain_fp():
                return PR.final_exponentiation_reference(a)
        return run

    timings = {}
    for lanes in FINAL_EXP_TIMED_LANES:
        a = f[:lanes]
        kernel = lambda a=a: KF.final_exp(a)  # noqa: E731
        bound_ms, bound_by = final_exp_work(a)
        t = timings[f"{lanes} lanes"] = {
            "lanes": lanes,
            "ms": cuda_ms(kernel, 20),
            "device_ms": 1e-3 * device_us(kernel, "final_exp", 10),
            "composed_ms": cuda_ms(
                lambda a=a: PR.final_exponentiation_reference(a), 2),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "host_us_per_call": host_us(kernel, 200),
        }
        if lanes == 1:
            t["plain_ms"] = cuda_ms(plain(a), 1)
        log(f"final_exp at {lanes} lanes: {t['ms']:.6f} ms with the "
            f"wrapper, {t['device_ms']:.6f} ms on the device, "
            + (f"plain {t['plain_ms']:.6f} ms, " if "plain_ms" in t else "")
            + f"composed over the other kernels {t['composed_ms']:.6f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}), host "
            f"{t['host_us_per_call']:.3f} us per call")
    return {"final_exp": timings}


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


def median_ms(fn, *args, want):
    """(median, least, most) wall ms of MEDIAN_CALLS calls of fn(*args),
    after the calls that warmed it; each call ends on the host (the
    verdicts are host bools), and each verdict must be ``want``."""
    import statistics

    import torch

    times = []
    for _ in range(MEDIAN_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(out == want, f"{fn.__name__}: verdicts changed between calls")
    return statistics.median(times), min(times), max(times)


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
    results["agg_verify_hashed_on_device"] = (
        ms, made, ops, wait, median_ms(fn, table, bits, h, sig, want=True))
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
    results["agg_verify_batch_on_device"] = (
        ms, made, ops, wait, median_ms(fn, table, *args, want=want))
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
    results["verify_many_on_device"] = (
        ms, made, ops, wait,
        median_ms(fn, pk_pts, h_pts, sig_pts, want=expect))
    sources["verify_many_on_device"] = src
    log(f"verify_many_on_device: {SINGLE_CHECKS} checks, "
        f"{sum(expect)} valid and {len(expect) - sum(expect)} forged")

    # one single check from the payload bytes (it hashes on the host)
    i = rng.randrange(COMMITTEE)
    ok, ms, made, wait = timed(D.verify_on_device, pks[i], payloads[0],
                               g2.mul(hashes[0], sks[i]))
    check(ok is True, "verify_on_device rejected a valid signature")
    results["verify_on_device"] = (ms, made, None, wait, None)
    log("verify_on_device: valid signature True")

    for name, (ms, made, ops, wait, median) in results.items():
        for kernel, n in made.items():
            if kernel in ENTRY_KERNELS[name]:
                check(n > 0, f"{name} never launched the {kernel} kernel")
            else:
                check(n == 0, f"{name} launched the {kernel} kernel, which "
                      f"is not on its path")
        line = (f"{name}: {ms:.3f} ms per call ({wait:.3f} ms of it waiting "
                f"for the card at the end), " + ", ".join(
                    f"{n} {kernel}" for kernel, n in made.items())
                + " launches")
        if median is not None:
            line += (f"; over {MEDIAN_CALLS} more calls {median[0]:.3f} ms "
                     f"median ({median[1]:.3f} to {median[2]:.3f})")
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
    # what fusing the masked sum, the Miller loop and the final
    # exponentiation must have left of one check's launches
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
    ATen operators carry their kernels' time again.  A call whose kernels
    the profiler missed in every session (``profiled``) keeps its wall
    time, its device time not measured."""
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
            try:
                rows, split = profiled(fn, reps, ("CPU", "CUDA"))
            except AssertionError as e:
                # torch.profiler can miss a process's launches in every
                # session; the wall time stands, the device time is not
                # measured
                log(f"{name}: {wall_us:.3f} us wall per call, device time "
                    f"not measured: {e}")
                out[name] = {"wall_us": wall_us, "device_us": None,
                             "launches": made}
                continue
        others = [r for r in rows
                  if not any(symbol(k) in r.key for k in KERNELS)]
        rest = sum(r.self_device_time_total for r in others
                   if r.device_type == DeviceType.CUDA) / reps
        rest_all_rows = sum(r.self_device_time_total for r in others) / reps
        device = rest + sum(split.values())
        for k in KERNELS:
            check(split[k] > 0 or not made[k],
                  f"{name}: no device time seen for {k}")
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


NODE_THREADS = ("consensus", "sync", "ingress")
POPS = 4
# a flush of aggregate checks, and one of single checks, launches each of
# its path's kernels exactly once (every flush here fits one chunk)
FLUSH_LAUNCHES = {"agg": ENTRY_KERNELS["agg_verify_batch_on_device"],
                  "single": ENTRY_KERNELS["verify_many_on_device"]}


def node_clean(what, sheds=0):
    """After a phase that went through the node layer or an entry point:
    no check fell back to the host, none was shed but the ``sheds`` the
    run made on purpose, the breaker is closed."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.sched.scheduler import SHED

    check(D.COUNTERS["ref_fallback"] == 0,
          f"{what}: {D.COUNTERS['ref_fallback']} checks fell back to the "
          f"host path")
    check(SHED.total() == sheds, f"{what}: the scheduler shed "
          f"{SHED.total()} checks, not {sheds}")
    check(D.BREAKER.state == "closed",
          f"{what}: the device breaker is {D.BREAKER.state}")


def counted_scheduler(**opts):
    """A fresh global scheduler (built with ``opts``) whose flushes record
    their launches, by kind: (kind, checks, launches of each kernel).
    Counted on the flush thread, the only one that launches while the
    lanes run."""
    from harmony_tpu_torch import sched

    sched.reset()
    sched.configure(device="cuda", **opts)
    s = sched.scheduler()
    flushes = []
    for kind, attr in (("agg", "_run_agg"), ("single", "_run_single")):
        run = getattr(s, attr)

        def counted(batch, kind=kind, run=run):
            before = launches()
            out = run(batch)
            flushes.append((kind, len(batch), since(before)))
            return out
        setattr(s, attr, counted)
    return s, flushes


def since(before):
    return {k: n - before[k] for k, n in launches().items()}


def check_flushes(flushes, what):
    """Every flush launches each kernel of its path exactly once."""
    for kind, n, made in flushes:
        want = {k: int(k in FLUSH_LAUNCHES[kind]) for k in made}
        check(made == want, f"{what}: a {kind} flush of {n} checks "
              f"launched {made}")


def node_phase(seed):
    """The node's verification layer on the card: the scheduler's three
    lanes fed from three threads at once, Mask.aggregate_public, the
    entry points from payload bytes, and one injected dispatch fault."""
    import os
    import statistics
    import threading

    import torch

    from harmony_tpu_torch import bls as B
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import faultinject as FI
    from harmony_tpu_torch import prof
    from harmony_tpu_torch import sched
    from harmony_tpu_torch.consensus.mask import Mask
    from harmony_tpu_torch.ref import bls as RB
    from harmony_tpu_torch.ref import hash_to_curve as HC
    from harmony_tpu_torch.ref import native as NB
    from harmony_tpu_torch.ref.curve import g2
    from harmony_tpu_torch.ref.params import R_ORDER
    from harmony_tpu_torch.sched.scheduler import FILL, LANE_NAMES

    check(D._FORCED is None and D.device_enabled(),
          "device_enabled() is not True by AUTO on the card")
    check(not D.kernel_twin_active(), "HARMONY_KERNEL_TWIN is set")
    check(os.environ.get("HOST_BLS", "auto") == "auto" and NB.available()
          and NB._lib is not None, "the native host library did not load")
    node_clean("before the node phase")
    started = time.perf_counter()
    card = card_line()

    rng = random.Random(seed + 3)
    sks, pks = build_committee(rng)
    table = D.get_committee_table([RB.pubkey_to_bytes(p) for p in pks], pks)
    check((table.size, table.device.type) == (256, "cuda"),
          "the node's committee table is not a bucket of 256 on the card")
    payload = b"harmony shard 0 commit %d" % seed
    h = HC.hash_to_g2(payload)
    bits = [0] * COMMITTEE
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bits[i] = 1
    sig = agg_sign(sks, bits, h)
    flipped = list(bits)
    flipped[bits.index(1)] = 0
    qcs = [(bits, sig, True), (flipped, sig, False),
           (bits, ((0, 0), (0, 0)), False)]
    # 64 replay checks: 16 headers, each 4 times, a quarter forged
    replay = []
    for j in range(REPLAY_DISTINCT):
        pj = b"harmony shard 0 replay %d seed %d" % (j, seed)
        hj = HC.hash_to_g2(pj)
        bm = [0] * COMMITTEE
        for i in rng.sample(range(COMMITTEE), rng.randrange(134, 201)):
            bm[i] = 1
        sj = agg_sign(sks, bm, hj)
        if j % 4 == 1:
            sj = g2.neg(sj)
        replay.append((bm, hj, sj, j % 4 != 1))
    replay = [t for t in replay for _ in range(REPLAY_REPEAT)]
    # 8 single checks (every third forged) and 4 proofs of possession
    singles = []
    for k in range(SINGLE_CHECKS):
        i = rng.randrange(COMMITTEE)
        pk_msg = b"harmony tx %d seed %d" % (k, seed)
        hk = HC.hash_to_g2(pk_msg)
        forged = k % 3 == 2
        singles.append((pks[(i + 1) % COMMITTEE] if forged else pks[i], hk,
                        g2.mul(hk, sks[i]), not forged))
    pop_keys = [B.PrivateKey(rng.randrange(1, R_ORDER)) for _ in range(POPS)]
    pops = [(k.pub.bytes, B.proof_of_possession(k)) for k in pop_keys]
    # the host path's verdicts, for each distinct check
    for bm, sg, want in qcs:
        check(D._ref_agg_verify(table, bm, h, sg) is want,
              "host verdict of a quorum check differs from its construction")
    for bm, hj, sj, want in replay[::REPLAY_REPEAT]:
        check(D._ref_agg_verify(table, bm, hj, sj) is want,
              "host verdict of a replay check differs from its construction")
    for pk, hk, sk_sig, want in singles:
        check(RB.verify_hashed(pk, hk, sk_sig) is want,
              "host verdict of a single check differs from its construction")

    s, flushes = counted_scheduler()
    # each request's enqueue-to-dispatch wait, read where the scheduler
    # observes it into its histogram
    lane_waits = {name: [] for name in LANE_NAMES.values()}
    observe = s._observe_waits

    def observed(batch):
        now = s._clock()
        for req in batch:
            lane_waits[LANE_NAMES[req.lane]].append(now - req.enqueued_at)
        observe(batch)
    s._observe_waits = observed
    reset_launches()
    got, errors = {}, []
    start = threading.Barrier(len(NODE_THREADS))

    def consensus():
        start.wait()
        got["consensus"] = [
            sched.agg_verify(table, bm, payload, sg,
                             lane=sched.Lane.CONSENSUS)
            for bm, sg, _ in qcs]

    def sync():
        start.wait()
        got["sync"] = sched.agg_verify_many(
            table, [t[0] for t in replay], [t[1] for t in replay],
            [t[2] for t in replay], lane=sched.Lane.SYNC)

    def ingress():
        start.wait()
        futs = [s.submit_single(pk, hk, sg, lane=sched.Lane.INGRESS)
                for pk, hk, sg, _ in singles]
        got["pop"] = B.verify_proofs_of_possession(pops)
        got["ingress"] = [f.result(60) for f in futs]

    def run(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (consensus, sync, ingress)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"a lane's thread failed: {errors}")
    path, lane_flushes = launches(), list(flushes)
    check(got["consensus"] == [want for _, _, want in qcs],
          f"quorum checks through the scheduler: {got['consensus']}")
    check(got["sync"] == [t[3] for t in replay],
          "replay checks through the scheduler differ from construction")
    check(got["ingress"] == [t[3] for t in singles],
          f"single checks through the scheduler: {got['ingress']}")
    check(got["pop"] is True, "valid proofs of possession rejected")
    bad = list(pops)
    bad[1] = (bad[1][0], pops[2][1])
    check(B.verify_proofs_of_possession(bad) is False,
          "a proof of another key accepted")
    check_flushes(flushes, "the node lanes")
    for name in PATH_KERNELS:
        check(path[name] > 0, f"the node path never launched {name}")
    by_kind = collections.Counter(kind for kind, _, _ in lane_flushes)
    items, slots = FILL["items"], FILL["slots"]
    waits = {name: (statistics.median(w) if w else None, len(w))
             for name, w in lane_waits.items()}
    log(f"[{card}] node lanes, 3 threads at once: {len(qcs)} quorum checks "
        f"(CONSENSUS), {len(replay)} replay checks (SYNC), "
        f"{SINGLE_CHECKS} single checks and {POPS} proofs of possession "
        f"(INGRESS), every verdict as built and as the host path's, in "
        f"{wall:.3f} s; flushes: " + ", ".join(
            f"{n} {kind}" for kind, n in sorted(by_kind.items()))
        + f" ({sorted(n for _, n, _ in lane_flushes)} checks each); fill "
        "ratio "
        f"{items}/{slots} = {items / slots if slots else 0:.3f} over the "
        "batched flushes (the check of a forged proof after the threads "
        "included); median wait in the queue " + ", ".join(
            f"{name} {1e3 * w} ms of {n}" if n else f"{name} none"
            for name, (w, n) in waits.items())
        + "; launches " + ", ".join(f"{n} {k}" for k, n in path.items()))
    node_clean("the scheduler's lanes")

    # one quorum check through the scheduler against the direct call
    def via_sched():
        return s.submit_agg(table, bits, h, sig).result(60)

    def direct():
        return D.agg_verify_hashed_on_device(table, bits, h, sig)

    qc_ms = {}
    for name, fn in (("through the scheduler", via_sched),
                     ("direct", direct)):
        times = []
        for _ in range(MEDIAN_CALLS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            check(fn() is True, f"valid quorum check rejected, {name}")
            times.append(1e3 * (time.perf_counter() - t))
        qc_ms[name] = (statistics.median(times), min(times), max(times))
    log(f"[{card}] one quorum check, median of {MEDIAN_CALLS} calls: "
        + "; ".join(
        f"{name} {m:.3f} ms ({lo:.3f} to {hi:.3f})"
        for name, (m, lo, hi) in qc_ms.items()))
    sched.reset()
    node_clean("the quorum check through the scheduler")

    # Mask.aggregate_public: 150 of 200 keys, twice; the second call
    # finds the key table in the mask's cache and ships the bitmap alone
    mask = Mask(pks)
    for i, b in enumerate(bits):
        mask.set_bit(i, bool(b))
    want = mask.aggregate_public(device=False)
    for call in ("first", "second"):
        before, h2d = launches(), D.TRANSFER["h2d"]
        got_pk = mask.aggregate_public()
        made = {k: n - before[k] for k, n in launches().items()}
        sent = D.TRANSFER["h2d"] - h2d
        check(got_pk == want, f"Mask.aggregate_public ({call} call) differs "
              f"from the host aggregate")
        check(made == {k: int(k == "g1_masked_sum") for k in made},
              f"Mask.aggregate_public ({call} call) launched {made}")
        if call == "second":
            check(sent == 4 * 256, f"the cached call shipped {sent} bytes, "
                  f"not the bitmap's {4 * 256}")
        log(f"Mask.aggregate_public, {call} call: == host aggregate, one "
            f"g1_masked_sum launch, {sent} bytes to the card")
    node_clean("Mask.aggregate_public")

    # the entry points from payload bytes; hash_to_g2 timed by prof
    prof.reset()
    prof.configure(enabled=True)
    for _ in range(3):
        check(D.agg_verify_on_device(table, bits, payload, sig) is True,
              "agg_verify_on_device rejected a valid quorum certificate")
        i = rng.randrange(COMMITTEE)
        check(D.verify_on_device(pks[i], payload, g2.mul(h, sks[i])) is True,
              "verify_on_device rejected a valid signature")
    native = prof.stage_summary()["hash_to_g2"]
    os.environ["HOST_BLS"] = "bigint"
    try:
        with prof.stage("hash_to_g2 pure Python"):
            check(HC.hash_to_g2(payload) == h,
                  "the pure-Python hash_to_g2 differs from the native")
    finally:
        del os.environ["HOST_BLS"]
    python = prof.stage_summary()["hash_to_g2 pure Python"]
    prof.reset()
    log(f"[{card}] agg_verify_on_device and verify_on_device from payload "
        f"bytes: "
        f"valid True; hash_to_g2 native {1e3 * native['sum_s'] / native['count']:.3f} "
        f"ms a payload ({native['count']} calls), pure Python "
        f"{1e3 * python['sum_s']:.3f} ms (1 call)")
    node_clean("the entry points from payload bytes")

    # one injected dispatch fault: the host path answers, counted
    FI.reset()
    FI.arm("device.dispatch", times=1)
    try:
        ok = D.agg_verify_hashed_on_device(table, bits, h, sig)
    finally:
        FI.reset()
    check(ok is True, "the fallback's verdict on a valid check is wrong")
    check(D.COUNTERS["ref_fallback"] == 1,
          f"{D.COUNTERS['ref_fallback']} fallbacks, not 1")
    check(D.BREAKER._failures == 1 and D.BREAKER.state == "closed",
          "the breaker did not record exactly one failure")
    log("fault at device.dispatch: verdict right, 1 host fallback counted, "
        "1 breaker failure")
    D.COUNTERS["ref_fallback"] = 0
    D.BREAKER.record_success()
    node_clean("after the fault phase")
    # any other failure of a dispatch on the card raises, never the host
    host = []

    def refused():
        raise RuntimeError("a wrapper refused its tensors")
    try:
        D._guarded("verify", refused, lambda: host.append(1),
                   device=table.device)
        check(False, "a failing dispatch on the card returned")
    except D.DeviceError:
        pass
    check(not host and D.COUNTERS["ref_fallback"] == 0,
          "a failing dispatch on the card was answered by the host")
    D.BREAKER.record_success()
    node_clean("after a failing dispatch on the card")
    check(D.agg_verify_hashed_on_device(table, flipped, h, sig) is False,
          "a forged quorum check accepted after the fault phase")
    node_clean("the check after the fault phase")
    log(f"[{card}] node phase took {time.perf_counter() - started:.3f} s")
    return {"flushes": dict(by_kind), "fill": (items, slots),
            "median_wait_ms": {k: (None if w is None else 1e3 * w, n)
                               for k, (w, n) in waits.items()},
            "qc_ms": qc_ms, "launches": path,
            "hash_to_g2_ms": {
                "native": 1e3 * native["sum_s"] / native["count"],
                "python": 1e3 * python["sum_s"]}}


# the consumers phase: Harmony mainnet's 200 slots as 10 nodes of 20 keys
# each, so that every vote is a multi-key aggregate, as validators run
# them; 7 of the nodes (140 keys, above the 134 of a quorum) vote in the
# view change.  Replay headers sign with at least 134 keys; one header of
# the batch is signed by 120 (below quorum) and one carries another
# header's signature (forged).
NODES, KEYS_PER_NODE, VIEW_CHANGE_VOTERS = 10, 20, 7
EPOCH = 1673
BELOW_QUORUM, FORGED_AT, BELOW_AT = 120, 5, 9
SIDECAR_ITEMS = 8
CROSSLINKS, CROSSLINK_FORGED = 8, 5


@contextlib.contextmanager
def recorded_lanes():
    """The lane of every check a consumer hands to the scheduler's
    wrappers (``sched.agg_verify``, ``agg_verify_many``,
    ``verify_single``), as (wrapper, lane) pairs."""
    from harmony_tpu_torch import sched

    lanes = []
    saved = {name: getattr(sched, name) for name in
             ("agg_verify", "agg_verify_many", "verify_single")}

    def recorder(name, fn):
        def call(*a, lane, **k):
            lanes.append((name, lane))
            return fn(*a, lane=lane, **k)
        return call
    for name, fn in saved.items():
        setattr(sched, name, recorder(name, fn))
    try:
        yield lanes
    finally:
        for name, fn in saved.items():
            setattr(sched, name, fn)


def consumers_phase(seed):
    """The node's consumers of the device checks on the card, at Harmony
    mainnet width (200 slots, bucket 256): the chain engine's replay and
    header checks, an FBFT round, view change, Handel's partial checks and
    the sidecar server on each of its routes.  Launch counts start from
    zero; every flush is held to its exact launches."""
    from harmony_tpu_torch import bls as B
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import multibls as MB
    from harmony_tpu_torch import sched
    from harmony_tpu_torch.chain import crosslink as CL
    from harmony_tpu_torch.chain import engine as ENG
    from harmony_tpu_torch.chain.header import Header
    from harmony_tpu_torch.consensus import aggregation as AGG
    from harmony_tpu_torch.consensus import fbft as FB
    from harmony_tpu_torch.consensus import quorum as Q
    from harmony_tpu_torch.consensus import view_change as VC
    from harmony_tpu_torch.consensus.mask import bits_from_bytes
    from harmony_tpu_torch.consensus.messages import FBFTMessage, MsgType
    from harmony_tpu_torch.consensus.signature import \
        construct_commit_payload, prepare_payload
    from harmony_tpu_torch.ref import bls as RB
    from harmony_tpu_torch.ref.curve import g1 as RG1
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2
    from harmony_tpu_torch.ref.keccak import keccak256
    from harmony_tpu_torch.ref.params import R_ORDER
    from harmony_tpu_torch.sidecar.client import SidecarClient
    from harmony_tpu_torch.sidecar.server import SidecarServer

    check(D._FORCED is None and D.device_enabled(),
          "device_enabled() is not True by AUTO on the card")
    node_clean("before the consumers phase")
    started = time.perf_counter()
    card = card_line()
    rng = random.Random(seed + 5)
    keys = [B.PrivateKey(rng.randrange(1, R_ORDER)) for _ in range(COMMITTEE)]
    committee = [k.pub.bytes for k in keys]
    s, flushes = counted_scheduler()
    reset_launches()
    parts = {}

    def bitmap(signers):
        out = bytearray((COMMITTEE + 7) >> 3)
        for i in signers:
            out[i >> 3] |= 1 << (i & 7)
        return bytes(out)

    def quorum_signers():
        return rng.sample(range(COMMITTEE), rng.randrange(134, COMMITTEE + 1))

    def signed(payload, signers):
        """The signers' aggregate signature: one signature by the sum of
        their secret keys."""
        return RB.sig_to_bytes(RB.sign(
            sum(keys[i].scalar for i in signers) % R_ORDER, payload))

    def sign_header(header, signers):
        return signed(construct_commit_payload(
            header.hash(), header.block_num, header.view_id, True),
            signers), bitmap(signers)

    def part(name, fn):
        """Run one part; its launches and time, and node_clean after it."""
        before, t0 = launches(), time.perf_counter()
        out = fn()
        parts[name] = (since(before), time.perf_counter() - t0)
        node_clean(name)
        return out

    # -- replay through the engine: 16 headers, each 4 times ------------------
    def provider(shard, epoch):
        return ENG.EpochContext(committee)

    headers, prev = [], bytes(32)
    for j in range(REPLAY_DISTINCT):
        h = Header(shard_id=0, block_num=1000 + j, epoch=EPOCH,
                   view_id=1000 + j, parent_hash=prev)
        headers.append(h)
        prev = h.hash()
    distinct = []
    for j, h in enumerate(headers):
        sig, bm = sign_header(h, range(BELOW_QUORUM) if j == BELOW_AT
                              else quorum_signers())
        distinct.append([h, sig, bm])
    distinct[FORGED_AT][1] = distinct[FORGED_AT - 1][1]
    items = [tuple(t) for t in distinct for _ in range(REPLAY_REPEAT)]
    want = [j not in (FORGED_AT, BELOW_AT) for j in range(REPLAY_DISTINCT)
            for _ in range(REPLAY_REPEAT)]
    check(ENG.Engine(provider, device=False).verify_headers_batch(items)
          == want, "the host reference's replay verdicts differ from the "
          "construction")
    engine = ENG.Engine(provider)
    check(engine.device is True and ENG.verify_buckets() ==
          ENG.VERIFY_BUCKETS_GPU, "the engine is not on the device path")
    replay_ms = {}

    def replay():
        del flushes[:]
        with recorded_lanes() as lanes:
            got, replay_ms["first"], _, _ = timed(
                engine.verify_headers_batch, items)
        check(got == want, f"replay verdicts {got}")
        first = [f for f in flushes if f[0] == "agg"]
        check(sum(n for _, n, _ in first) == REPLAY_DISTINCT
              * REPLAY_REPEAT - REPLAY_REPEAT and len(first) == len(flushes),
              f"the first replay dispatched {flushes}, not the 60 checks of "
              f"the headers at quorum (repeats included)")
        check(lanes == [("agg_verify_many", sched.Lane.SYNC)],
              f"the replay's lanes: {lanes}")
        check_flushes(flushes, "the first replay")
        n_first = len(flushes)
        got, replay_ms["again"], _, _ = timed(engine.verify_headers_batch,
                                              items)
        check(got == want, "the second replay's verdicts changed")
        check(sum(n for _, n, _ in flushes[n_first:]) == REPLAY_REPEAT,
              f"the second replay dispatched {flushes[n_first:]}, not the "
              f"forged header's {REPLAY_REPEAT} repeats")
        check_flushes(flushes, "the second replay")
        kept = [t for j, t in enumerate(items)
                if j // REPLAY_REPEAT != FORGED_AT]
        before, n_flushes = launches(), len(flushes)
        got, replay_ms["cached"], _, _ = timed(engine.verify_headers_batch,
                                               kept)
        check(got == [w for j, w in enumerate(want)
                      if j // REPLAY_REPEAT != FORGED_AT]
              and not any(since(before).values())
              and len(flushes) == n_flushes,
              "the cached replay launched or changed its verdicts")
        # the same 64 checks straight into the entry point
        table = engine.epoch_context(0, EPOCH).committee_table()
        bits = [bits_from_bytes(bm, COMMITTEE) for _, _, bm in items]
        hs = [hash_to_g2(construct_commit_payload(
            h.hash(), h.block_num, h.view_id, True)) for h, _, _ in items]
        sigs = [RB.sig_from_bytes(sig) for _, sig, _ in items]
        got, replay_ms["direct"], _, _ = timed(
            D.agg_verify_batch_on_device, table, bits, hs, sigs)
        check(got == [j // REPLAY_REPEAT != FORGED_AT for j in
                      range(len(items))],
              "the direct batch's pairing verdicts differ from the "
              "construction")
        # one header's check on the consensus lane
        h = Header(shard_id=0, block_num=2000, epoch=EPOCH, view_id=2000,
                   parent_hash=prev)
        sig, bm = sign_header(h, quorum_signers())
        n_flushes = len(flushes)
        with recorded_lanes() as lanes:
            ok = engine.verify_header_signature(h, sig, bm,
                                                lane=sched.Lane.CONSENSUS)
        check(ok is True and lanes == [("agg_verify",
                                        sched.Lane.CONSENSUS)]
              and len(flushes) == n_flushes + 1,
              f"verify_header_signature on CONSENSUS: {ok}, {lanes}")
        check_flushes(flushes, "the header check")
    part("replay through the engine", replay)
    log(f"[{card}] engine replay of {len(items)} headers ({REPLAY_DISTINCT} "
        f"distinct, each {REPLAY_REPEAT} times; one forged, one below "
        f"quorum): first call {replay_ms['first']:.3f} ms, the same batch "
        f"again {replay_ms['again']:.3f} ms (the forged repeats checked "
        f"again), the {len(items) - REPLAY_REPEAT} verified from the cache "
        f"{replay_ms['cached']:.3f} ms (no launch); direct "
        f"agg_verify_batch_on_device of the same {len(items)} "
        f"{replay_ms['direct']:.3f} ms; verdicts as the host reference's")

    # -- an FBFT round: 10 nodes of 20 keys ---------------------------------
    keysets = [MB.PrivateKeys.from_keys(
        keys[n * KEYS_PER_NODE:(n + 1) * KEYS_PER_NODE]) for n in range(NODES)]
    cfg = FB.RoundConfig(committee=committee, block_num=2001, view_id=2001)

    def decider():
        return Q.Decider(Q.Policy.UNIFORM, committee)

    t0 = time.perf_counter()
    leader = FB.Leader(keysets[0], cfg, decider())
    validators = [FB.Validator(ks, cfg, decider()) for ks in keysets[1:]]
    own = FB.Validator(leader.keys, cfg, leader.decider)
    built_s = time.perf_counter() - t0
    block = b"harmony shard 0 block 2001 seed %d" % seed
    block_hash = keccak256(block)
    round_out = {}

    def fbft():
        t0 = time.perf_counter()
        with recorded_lanes() as lanes:
            announce = leader.announce(block_hash, block)
            prepares = [v.on_announce(announce) for v in validators]
            votes = [leader.on_prepare(p) for p in prepares]
            prepared = leader.try_prepared(block_hash)
            commits = [v.on_prepared(prepared) for v in validators + [own]]
            votes += [leader.on_commit(c) for c in commits]
            committed = leader.try_committed(block_hash)
            accepted = [v.on_committed(committed) for v in validators]
        round_out["s"] = time.perf_counter() - t0
        check(all(votes) and len(votes) == 2 * NODES - 1,
              f"the leader rejected a vote: {votes}")
        check(prepared.payload[96:] == b"\xff" * 25 and all(
            c is not None for c in commits) and all(accepted),
              "the round did not commit with all 200 slots")
        tampered = FBFTMessage(
            msg_type=MsgType.COMMITTED, view_id=cfg.view_id,
            block_num=cfg.block_num, block_hash=keccak256(b"other block"),
            sender_pubkeys=committed.sender_pubkeys,
            payload=committed.payload)
        with recorded_lanes() as more:
            check(validators[0].on_committed(tampered) is False,
                  "a tampered proof was accepted")
        lanes += more
        aggs = [lane for name, lane in lanes if name == "agg_verify"]
        singles = [lane for name, lane in lanes if name == "verify_single"]
        check(aggs == [sched.Lane.CONSENSUS] * (2 * (NODES - 1) + 2)
              and singles == [sched.Lane.CONSENSUS] * (2 * NODES - 1)
              and len(lanes) == len(aggs) + len(singles),
              f"the round's checks and lanes: {lanes}")
        check_flushes(flushes, "the FBFT round")
        round_out["prepared"] = prepared
    part("the FBFT round", fbft)
    prepared = round_out["prepared"]
    log(f"[{card}] FBFT round, {NODES} nodes of {KEYS_PER_NODE} keys: "
        f"announce to every validator's COMMITTED check "
        f"{round_out['s']:.3f} s ({NODES - 1} prepare and {NODES} commit "
        f"votes, each one single check; {2 * (NODES - 1) + 1} proof checks, "
        f"each one sched.agg_verify on CONSENSUS; the nodes built in "
        f"{built_s:.3f} s); a tampered proof rejected")

    # -- view change: NEWVIEW with the round's PREPARED proof embedded ------
    view_id = cfg.view_id + 1

    def view_change():
        coll = VC.ViewChangeCollector(committee, decider(), view_id)
        voters = keysets[:VIEW_CHANGE_VOTERS]
        msgs = [VC.construct_viewchange(ks, view_id, cfg.block_num,
                                        block_hash, prepared.payload)
                for ks in voters[:4]]
        msgs += [VC.construct_viewchange(ks, view_id, cfg.block_num)
                 for ks in voters[4:]]
        check(all(coll.on_viewchange(m) for m in msgs),
              "a view-change vote was rejected")
        nv = coll.try_new_view(cfg.block_num, keysets[1])
        check(nv is not None and nv.m2_agg_sig and nv.m1_payload ==
              VC.m1_payload(block_hash, prepared.payload),
              "no NEWVIEW with the PREPARED proof and NIL votes formed")
        before, sums = launches(), D.COUNTERS["masked_pubkey_sum"]
        with recorded_lanes() as lanes:
            ok = VC.verify_new_view(nv, committee, decider())
        made, sums = since(before), D.COUNTERS["masked_pubkey_sum"] - sums
        check(ok is True, "a valid NEWVIEW was rejected")
        check(made["g1_masked_sum"] == sums == 3,
              f"NEWVIEW's three aggregate_public calls (M3, NIL, the "
              f"PREPARED proof) made {sums} sums and {made['g1_masked_sum']} "
              f"g1_masked_sum launches")
        check(lanes == [("verify_single", sched.Lane.CONSENSUS)] * 3,
              f"NEWVIEW's checks: {lanes}")
        nv.view_id += 1
        check(VC.verify_new_view(nv, committee, decider()) is False,
              "a NEWVIEW for another view was accepted")
        check_flushes(flushes, "view change")
    part("view change", view_change)

    # -- Handel: one honest and one forged partial --------------------------
    def handel():
        agg = AGG.Aggregator(
            committee, list(range(KEYS_PER_NODE)),
            quorum_check=decider().is_quorum_achieved_by_mask,
            emit=lambda *a: None, committee_points=leader.committee_points)
        payload = prepare_payload(block_hash)
        slots = range(KEYS_PER_NODE, 2 * KEYS_PER_NODE)
        bits = sum(1 << i for i in slots)
        honest = keysets[1].sign_hash_aggregated(payload).bytes
        forged = keysets[1].sign_hash_aggregated(keccak256(b"x")).bytes
        with recorded_lanes() as lanes:
            good = agg._verify(payload, bits, honest)
            bad = agg._verify(payload, bits, forged)
        check(good is not None and bad is None,
              f"Handel: honest partial {good}, forged {bad}")
        check(lanes == [("agg_verify", sched.Lane.CONSENSUS)] * 2,
              f"Handel's checks: {lanes}")
        check_flushes(flushes, "Handel")
    part("Handel", handel)

    # -- cross-links: one batch of the committee's block headers ------------
    def crosslinks():
        links, prev_link = [], bytes(32)
        for j in range(CROSSLINKS):
            h = Header(shard_id=0, block_num=3000 + j, epoch=EPOCH,
                       view_id=3000 + j, parent_hash=prev_link)
            prev_link = h.hash()
            sig, bm = sign_header(h, quorum_signers())
            links.append(CL.CrossLink(
                shard_id=0, block_num=h.block_num, view_id=h.view_id,
                epoch=EPOCH, block_hash=h.hash(), signature=sig, bitmap=bm))
        # a link presenting its neighbour's proof
        links[CROSSLINK_FORGED] = dataclasses.replace(
            links[CROSSLINK_FORGED],
            signature=links[CROSSLINK_FORGED - 1].signature)
        # the host reference: each link's signers' key sum and pairing
        # check in the port's ref
        points = [k.pub.point for k in keys]
        ref = []
        for link in links:
            agg = None
            for i, bit in enumerate(bits_from_bytes(link.bitmap, COMMITTEE)):
                if bit:
                    agg = RG1.add(agg, points[i])
            ref.append(RB.verify(agg, CL.crosslink_commit_payload(link),
                                 RB.sig_from_bytes(link.signature)))
        check(ref == [j != CROSSLINK_FORGED for j in range(CROSSLINKS)],
              f"the host reference's cross-link verdicts: {ref}")
        before, n0 = launches(), len(flushes)
        with recorded_lanes() as lanes:
            got = CL.verify_crosslinks_batch(ENG.Engine(provider), links)
        check(got == ref, f"cross-link verdicts {got}, the host's {ref}")
        check(lanes == [("agg_verify_many", sched.Lane.SYNC)]
              and [(k, n) for k, n, _ in flushes[n0:]]
              == [("agg", CROSSLINKS)], f"the cross-links' checks: "
              f"{lanes}, flushes {flushes[n0:]}")
        check(since(before) == WINDOW_LAUNCHES, f"the cross-link batch "
              f"launched {since(before)}")
    part("cross-links", crosslinks)

    # -- the sidecar server -------------------------------------------------
    server = SidecarServer().start()
    client = SidecarClient(server.address)
    sidecar_ms = {}
    qc_signers = rng.sample(range(COMMITTEE), QUORUM)
    qc_payload = b"harmony shard 0 commit 2002 seed %d" % seed
    qc_sig = signed(qc_payload, qc_signers)
    qc_bm = bitmap(qc_signers)
    wrong_bm = bitmap(qc_signers[1:])
    batch, batch_want = [], []
    for k in range(SIDECAR_ITEMS):
        i = rng.randrange(COMMITTEE)
        msg = b"harmony tx %d seed %d" % (k, seed)
        signer = (i + 1) % COMMITTEE if k == 3 else i
        batch.append((committee[i], msg, keys[signer].sign_hash(msg).bytes))
        batch_want.append(k != 3)

    def sidecar():
        client.set_committee(EPOCH, 0, committee)
        with recorded_lanes() as lanes:
            got = [client.agg_verify(EPOCH, 0, qc_payload, bm, qc_sig)
                   for bm in (qc_bm, wrong_bm)]
            check(got == [True, False], f"sidecar QC checks: {got}")
            check(client.verify_batch(batch) == batch_want,
                  "sidecar verify_batch verdicts")
        check(lanes == [("agg_verify", sched.Lane.CONSENSUS)] * 2,
              f"the sidecar's quorum checks: {lanes}")
        check_flushes(flushes, "the sidecar's scheduled route")
        sidecar_engine = ENG.Engine(provider, backend=client)
        check(sidecar_engine.verify_headers_batch(items) == want
              and sidecar_engine.verify_headers_batch(items) == want,
              "the replay through the sidecar differs from the host's")
        check_flushes(flushes, "the replay through the sidecar")
    part("the sidecar, scheduled", sidecar)

    def exec_lock():
        sched.configure(enabled=False)
        try:
            ok = client.agg_verify(EPOCH, 0, qc_payload, qc_bm, qc_sig)
        finally:
            sched.configure(enabled=True)
        check(ok is True, "the exec-lock route rejected a valid QC")
    part("the sidecar, exec lock", exec_lock)

    def direct():
        D.use_device(False)
        try:
            check(not D.device_enabled() and server._accelerated(),
                  "the direct branch is not the route")
            ok = client.agg_verify(EPOCH, 0, qc_payload, qc_bm, qc_sig)
            bad = client.agg_verify(EPOCH, 0, qc_payload, wrong_bm, qc_sig)
            verdicts = client.verify_batch(batch)
        finally:
            D.use_device(None)
        check(ok is True and bad is False and verdicts == batch_want,
              f"the direct branch: {ok}, {bad}, {verdicts}")
    part("the sidecar, direct", direct)
    for name, agg_checks, singles in (
            ("the sidecar, exec lock", 1, 0), ("the sidecar, direct", 2, 1)):
        made = parts[name][0]
        check(made == {k: (agg_checks if k == "g1_masked_sum" else
                           agg_checks + singles) if k in PATH_KERNELS else 0
                       for k in made},
              f"{name}: launched {made}")
    check(all(parts["the sidecar, scheduled"][0][k] > 0
              for k in PATH_KERNELS), "the scheduled sidecar route missed a "
          "kernel")

    # a QC check's round trip through the sidecar against the direct call
    table = server._get_table(EPOCH, 0).dv_table()
    qc_bits = bits_from_bytes(qc_bm, COMMITTEE)
    qc_pt = RB.sig_from_bytes(qc_sig)

    def through_the_sidecar():
        return client.agg_verify(EPOCH, 0, qc_payload, qc_bm, qc_sig)

    def direct_call():
        return D.agg_verify_on_device(table, qc_bits, qc_payload, qc_pt)

    sidecar_ms["sidecar"] = median_ms(through_the_sidecar, want=True)
    sidecar_ms["direct"] = median_ms(direct_call, want=True)
    client.close()
    server.stop()
    node_clean("the sidecar's round trips")
    sched.reset()
    check_flushes(flushes, "the consumers phase")
    total = launches()
    for name in PATH_KERNELS:
        check(total[name] > 0, f"the consumers phase never launched {name}")
    seconds = time.perf_counter() - started
    log(f"[{card}] sidecar: QC check round trip {sidecar_ms['sidecar'][0]:.3f}"
        f" ms (median of {MEDIAN_CALLS}; {sidecar_ms['sidecar'][1]:.3f} to "
        f"{sidecar_ms['sidecar'][2]:.3f}) against the direct "
        f"agg_verify_on_device {sidecar_ms['direct'][0]:.3f} ms "
        f"({sidecar_ms['direct'][1]:.3f} to {sidecar_ms['direct'][2]:.3f})")
    for name, (made, secs) in parts.items():
        log(f"consumers, {name}: {secs:.3f} s, launches " + ", ".join(
            f"{n} {k}" for k, n in made.items() if n))
    by_kind = collections.Counter(kind for kind, _, _ in flushes)
    log(f"[{card}] consumers phase took {seconds:.3f} s; "
        f"{by_kind['agg']} aggregate and {by_kind['single']} single-check "
        "flushes, each launching its path's kernels once; launches " +
        ", ".join(f"{n} {k}" for k, n in total.items()))
    return {"launches": total, "seconds": seconds, "replay_ms": replay_ms,
            "round_s": round_out["s"], "sidecar_ms": sidecar_ms,
            "parts": {k: v[0] for k, v in parts.items()}}


# the port's Node itself: a localnet of NODES nodes of KEYS_PER_NODE keys
# (200 slots, bucket 256) on the port's chain, tx pool and in-process
# gossip; the live part runs Node.run_forever at the mainnet block period
LOCALNET_CHAIN_ID = 2
LOCALNET_EPOCH_BLOCKS = 32768  # Harmony mainnet's blocks per epoch
LOCALNET_LIVE_BLOCKS = 5
LOCALNET_LIVE_BUDGET_S = 120.0
LOCALNET_BLOCK_TIME = 2.0  # the mainnet period (node.py run_forever)


def localnet_phase(seed):
    """The port's Node on the card: NODES nodes of KEYS_PER_NODE keys on
    InProcessNetwork, each Blockchain wired to an Engine (a committee
    provider over committee_for_epoch), so every insert re-checks its
    commit proof on CONSENSUS.  Three rounds by a manual pump (an empty
    block, a transfer, a create-validator whose proof of possession the
    pool checks on INGRESS; a forged copy refused), one view change whose
    NEWVIEW carries the PREPARED proof, and live rounds on run_forever
    threads (the Handel overlay's round at 200 slots is the chaos phase's
    wan_committee_200).  Launch counts start from zero; every flush is
    held to its exact launches; node_clean and no dropped message after
    every part."""
    import statistics

    from harmony_tpu_torch import bls as B
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import multibls as MB
    from harmony_tpu_torch import sched
    from harmony_tpu_torch.chain import engine as ENG
    from harmony_tpu_torch.config.chain import ChainConfig
    from harmony_tpu_torch.consensus import view_change as VC
    from harmony_tpu_torch.consensus.messages import FBFTMessage, MsgType, \
        decode_message, encode_message, sign_message
    from harmony_tpu_torch.core import rawdb
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import Genesis
    from harmony_tpu_torch.core.kv import MemKV
    from harmony_tpu_torch.core.tx_pool import PoolError, TxPool
    from harmony_tpu_torch.core.types import Directive, StakingTransaction, \
        Transaction
    from harmony_tpu_torch.crypto_ecdsa import ECDSAKey
    from harmony_tpu_torch.node.ingress import MessageCategory, \
        pack_envelope, parse_envelope
    from harmony_tpu_torch.node.node import Node
    from harmony_tpu_torch.node.registry import Registry
    from harmony_tpu_torch.p2p import InProcessNetwork
    from harmony_tpu_torch.p2p.stream import SyncClient, SyncServer
    from harmony_tpu_torch.ref.params import R_ORDER
    from harmony_tpu_torch.sched.scheduler import LANE_NAMES
    from harmony_tpu_torch.ref import native as NB
    from harmony_tpu_torch.shard.committee import Committee, Slot, State
    from harmony_tpu_torch.sync import Downloader

    check(D._FORCED is None and D.device_enabled(),
          "device_enabled() is not True by AUTO on the card")
    # the nodes sign and hash on the host: the native library, as a node
    # runs it
    check(NB.available(), "the native host library did not load")
    node_clean("before the localnet phase")
    started = time.perf_counter()
    card = card_line()
    chain_id = LOCALNET_CHAIN_ID
    committee_size = NODES * KEYS_PER_NODE
    rng = random.Random(seed + 15)
    keys = [B.PrivateKey(rng.randrange(1, R_ORDER))
            for _ in range(committee_size)]
    sender = ECDSAKey.from_seed(b"localnet sender %d" % seed)
    staker = ECDSAKey.from_seed(b"localnet staker %d" % seed)
    genesis = Genesis(
        config=ChainConfig(chain_id=chain_id, leader_rotation_epoch=0),
        shard_id=0,
        alloc={sender.address(): 10**24, staker.address(): 10**24},
        committee=[k.pub.bytes for k in keys])
    # each node one operator of KEYS_PER_NODE slots: with the
    # LeaderRotation gate on (as on mainnet), views rotate over operators
    operators = State(epoch=0, shards=[Committee(shard_id=0, slots=[
        Slot(ecdsa_address=bytes([1 + i // KEYS_PER_NODE]) * 20,
             bls_pubkey=k.pub.bytes) for i, k in enumerate(keys)])])
    s, flushes = counted_scheduler()
    # each request's enqueue-to-dispatch wait, by lane
    lane_waits = {name: [] for name in LANE_NAMES.values()}
    observe = s._observe_waits

    def observed(batch):
        now = s._clock()
        for req in batch:
            lane_waits[LANE_NAMES[req.lane]].append(now - req.enqueued_at)
        observe(batch)
    s._observe_waits = observed
    reset_launches()
    parts, nets = {}, []
    to = b"\x0a" * 20

    def localnet():
        net = InProcessNetwork()
        nodes = []
        for i in range(NODES):
            cell = []
            engine = ENG.Engine(lambda shard, epoch, cell=cell:
                                ENG.EpochContext(
                                    cell[0].committee_for_epoch(epoch)))
            db = MemKV()
            rawdb.write_shard_state(db, 0, operators)
            chain = Blockchain(db, genesis, engine=engine,
                               blocks_per_epoch=LOCALNET_EPOCH_BLOCKS)
            cell.append(chain)
            reg = Registry(blockchain=chain,
                           txpool=TxPool(chain_id, 0, chain.state),
                           host=net.host(f"node{i}"))
            nodes.append(Node(reg, MB.PrivateKeys.from_keys(
                keys[i * KEYS_PER_NODE:(i + 1) * KEYS_PER_NODE])))
        check(all(n.chain.engine is not None and n.chain.engine.device
                  is True for n in nodes),
              "a node's chain has no engine on the device path")
        nets.append(nodes)
        return nodes, net

    def pump(nodes, rounds=400):
        for _ in range(rounds):
            if not any(n.process_pending() for n in nodes):
                return

    def leader_of(nodes):
        leaders = [n for n in nodes if n.is_leader]
        check(len(leaders) == 1, f"{len(leaders)} leaders")
        return leaders[0]

    def agreed(nodes, height, what):
        """Every node at ``height`` with the same head, commit proof and
        balances."""
        heads = {n.chain.head_number for n in nodes}
        check(heads == {height}, f"{what}: heads {sorted(heads)}, not "
              f"{height}")
        for num in range(1, height + 1):
            seen = {(n.chain.block_by_number(num).hash(),
                     n.chain.read_commit_sig(num)) for n in nodes}
            check(len(seen) == 1 and None not in next(iter(seen)),
                  f"{what}: the nodes differ at height {num}")
        balances = {(n.chain.state().balance(sender.address()),
                     n.chain.state().balance(to)) for n in nodes}
        check(len(balances) == 1, f"{what}: balances differ {balances}")

    def part(name, fn):
        """One part: its launches, time and flushes; node_clean and no
        dropped message after it."""
        before, t0, n0 = launches(), time.perf_counter(), len(flushes)
        out = fn()
        parts[name] = (since(before), time.perf_counter() - t0,
                       len(flushes) - n0)
        log(f"localnet, {name}: {parts[name][1]:.3f} s, {parts[name][2]} "
            "flushes, launches " + ", ".join(
                f"{n} {k}" for k, n in parts[name][0].items() if n))
        check_flushes(flushes[n0:], f"localnet, {name}")
        node_clean(f"localnet, {name}")
        dropped = [n.dropped_messages for nodes in nets for n in nodes]
        check(not any(dropped), f"localnet, {name}: dropped messages "
              f"{dropped} (a device fault hidden as a stall)")
        return out

    nodes, net = localnet()
    round_s = []

    def commit_round(height, add=None):
        leader = leader_of(nodes)
        if add is not None:
            add(leader)
        t0 = time.perf_counter()
        check(leader.start_round_if_leader() is not None,
              f"round {height}: the leader proposed nothing")
        pump(nodes)
        round_s.append(time.perf_counter() - t0)
        agreed(nodes, height, f"round {height}")

    def manual():
        commit_round(1)

        def transfer(leader):
            leader.pool.add(Transaction(
                nonce=0, gas_price=1, gas_limit=25_000, shard_id=0,
                to_shard=0, to=to, value=777).sign(sender, chain_id))
        commit_round(2, transfer)
        check(nodes[0].chain.state().balance(to) == 777,
              "the transfer did not land")
        new_key = B.PrivateKey(rng.randrange(1, R_ORDER))
        forged = B.proof_of_possession(B.PrivateKey(rng.randrange(1,
                                                                  R_ORDER)))

        def create(nonce, proof):
            return StakingTransaction(
                nonce=nonce, gas_price=1, gas_limit=50_000,
                directive=Directive.CREATE_VALIDATOR,
                fields={"amount": 10**20, "min_self_delegation": 10**18,
                        "bls_keys": new_key.pub.bytes,
                        "bls_key_sigs": proof}).sign(staker, chain_id)

        def stake(leader):
            ingress = len(lane_waits["ingress"])
            leader.pool.add(create(0, B.proof_of_possession(new_key)),
                            is_staking=True)
            try:
                leader.pool.add(create(1, forged), is_staking=True)
                refused = False
            except PoolError as e:
                refused = "proof of possession" in str(e)
            check(refused, "a forged proof of possession was admitted")
            check(len(lane_waits["ingress"]) - ingress == 2,
                  "the proofs of possession were not checked on INGRESS")
        commit_round(3, stake)
        check(all(n.chain.state().validator(staker.address()) is not None
                  for n in nodes), "the validator was not created")
    part("manual rounds", manual)

    # one view change: the leader is lost after PREPARED, the NEWVIEW
    # carries the prepared block and its proof
    vc_out = {}

    def view_change():
        leader = leader_of(nodes)
        validators = [n for n in nodes if n is not leader]
        # the retrying sender's re-publishes off in this manual pump, as
        # in the pumped tests: each copy of a VIEWCHANGE or NEWVIEW cost a
        # sender check on every node (1,128-1,290 of the part's flushes,
        # 35-53 s); the chaos phase's view_change_storm runs a view change
        # with them on, on run_forever threads
        for n in nodes:
            n.sender.RETRY_INTERVAL = n.sender.SLOW_INTERVAL = 3600.0
        wire = []
        for n in validators:
            publish = n.host.publish

            def recorded(topic, payload, publish=publish):
                wire.append(payload)
                return publish(topic, payload)
            n.host.publish = recorded
        t0 = time.perf_counter()
        proposed = leader.start_round_if_leader()
        for v in validators:
            v.process_pending()
        leader.process_pending()
        for v in validators:
            v.process_pending()
        net.partitioned.add(leader.host.name)
        check(all(v._prepared_proof is not None for v in validators),
              "a validator holds no PREPARED proof")
        proof = validators[0]._prepared_proof
        for v in validators:
            v.start_view_change()
        pump(validators)
        new_leader = leader_of(validators)
        check(new_leader is not leader and new_leader._reproposal is not None,
              "the new leader carries no prepared block")
        new_leader.start_round_if_leader()
        pump(validators)
        vc_out["s"] = time.perf_counter() - t0
        agreed(validators, 4, "the view change")
        committed = validators[0].chain.block_by_number(4)
        check(committed.hash() == proposed.hash(), "the re-proposed block "
              "is not the prepared one")
        newviews = []
        for payload in wire:
            category, _, body = parse_envelope(payload)
            if category != MessageCategory.CONSENSUS:
                continue
            msg = decode_message(body)
            if msg.msg_type == MsgType.NEWVIEW:
                newviews.append(VC.decode_newview(msg.payload))
        check(newviews and all(nv.m1_payload == VC.m1_payload(
            proposed.hash(), proof) for nv in newviews),
              "the NEWVIEW does not carry the PREPARED proof")
        # the old leader rejoins: the block from a peer, its seal checked
        # on SYNC, then the round re-derived from the head
        net.partitioned.discard(leader.host.name)
        peer = validators[0].chain
        check(leader.chain.insert_chain(
            [peer.block_by_number(4)], commit_sigs=[peer.read_commit_sig(4)],
            verify_seals=True, lane=sched.Lane.SYNC) == 1,
              "the old leader did not take the block")
        leader._vc = 0
        leader._new_round()  # as the node's own sync rejoin does
        pump(nodes)  # the votes it held for block 4 are stale now
        agreed(nodes, 4, "the old leader's rejoin")
        for n in nodes:
            del n.sender.RETRY_INTERVAL, n.sender.SLOW_INTERVAL
    part("view change", view_change)

    # live: run_forever threads until LOCALNET_LIVE_BLOCKS more commit
    live_out = {}

    def live():
        start = min(n.chain.head_number for n in nodes)
        goal = start + LOCALNET_LIVE_BLOCKS
        # the nodes sat idle between the manual parts: restart their
        # round clocks, or a pause longer than the view-change timeout
        # (27 s) opens the live part with a view change on every node
        for n in nodes:
            n._round_start = time.monotonic()
        t0 = time.perf_counter()
        threads = [n.run_forever(block_time=LOCALNET_BLOCK_TIME)
                   for n in nodes]
        try:
            deadline = time.monotonic() + LOCALNET_LIVE_BUDGET_S
            while time.monotonic() < deadline and min(
                    n.chain.head_number for n in nodes) < goal:
                time.sleep(0.05)
            live_out["s"] = time.perf_counter() - t0
        finally:
            for n in nodes:
                n.stop()
            for t in threads:
                t.join(timeout=30.0)
        check(not any(t.is_alive() for t in threads),
              "a pump thread outlived stop()")
        reached = min(n.chain.head_number for n in nodes)
        check(reached >= goal, f"live: {reached - start} blocks committed "
              f"in {LOCALNET_LIVE_BUDGET_S} s, not {LOCALNET_LIVE_BLOCKS}")
        for num in range(1, reached + 1):
            seen = {(n.chain.block_by_number(num).hash(),
                     n.chain.read_commit_sig(num)) for n in nodes}
            check(len(seen) == 1, f"live: the nodes differ at height {num}")
        live_out["blocks"] = reached - start
        live_out["views"] = sorted({n.view_id for n in nodes})
    part("live rounds", live)

    # a behind node: no keys, a registry downloader over a sync server of
    # node 0's chain, every synced seal checked on the card
    behind_out = {}

    def behind():
        head = nodes[0].chain.head_number
        cell = []
        db = MemKV()
        rawdb.write_shard_state(db, 0, operators)
        chain = Blockchain(db, genesis, engine=ENG.Engine(
            lambda shard, epoch: ENG.EpochContext(
                cell[0].committee_for_epoch(epoch))),
            blocks_per_epoch=LOCALNET_EPOCH_BLOCKS)
        cell.append(chain)
        check(chain.engine.device is True, "the behind node's engine is "
              "not on the device path")
        server = SyncServer(nodes[0].chain)
        reg = Registry(blockchain=chain,
                       txpool=TxPool(chain_id, 0, chain.state),
                       host=net.host("late"))
        late = Node(reg, MB.PrivateKeys.from_keys([]))
        reg.set("downloader", Downloader(chain, [SyncClient(server.port)],
                                         verify_seals=True))
        nets.append([late])
        try:
            # a run of gossip for the network's next round: this node is
            # behind, and spins up its downloader
            stranger = MB.PrivateKeys.from_keys(
                [B.PrivateKey(rng.randrange(1, R_ORDER))])
            msg = sign_message(FBFTMessage(
                msg_type=MsgType.ANNOUNCE, view_id=nodes[0].view_id,
                block_num=head + 1, block_hash=b"\x01" * 32,
                sender_pubkeys=[k.pub.bytes for k in stranger]), stranger)
            env = pack_envelope(MessageCategory.CONSENSUS,
                                int(msg.msg_type), encode_message(msg))
            t0 = time.perf_counter()
            for _ in range(late.ahead_threshold):
                late._handle(env)
            check(late._syncing or late._sync_done.is_set(),
                  "the behind node did not spin up its downloader")
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                late.process_pending()
                if late.chain.head_number == head and not late._syncing:
                    break
                time.sleep(0.02)
            behind_out["s"] = time.perf_counter() - t0
            behind_out["blocks"] = head
            check(late.chain.head_number == head and late.sync_spinups == 1
                  and late.block_num == head + 1
                  and late.block_num == nodes[0].block_num,
                  f"the behind node: head {late.chain.head_number} of "
                  f"{head}, {late.sync_spinups} spin-ups, round "
                  f"{late.block_num} (the network's {nodes[0].block_num})")
            for num in range(1, head + 1):
                check((late.chain.block_by_number(num).hash(),
                       late.chain.read_commit_sig(num))
                      == (nodes[0].chain.block_by_number(num).hash(),
                          nodes[0].chain.read_commit_sig(num)),
                      f"the behind node differs at height {num}")
        finally:
            late.stop()
            server.close()
            if late._sync_thread is not None:
                late._sync_thread.join(timeout=30.0)
        check(late._sync_thread is None or not late._sync_thread.is_alive(),
              "the behind node's sync thread outlived it")
        return head
    behind_before = launches()
    behind_head = part("the behind node's sync", behind)
    behind_windows = -(-behind_head // SYNC_WINDOW)
    check(since(behind_before) == {k: behind_windows * n for k, n in
                                   WINDOW_LAUNCHES.items()},
          f"the behind node's sync of {behind_head} blocks launched "
          f"{since(behind_before)}, not {behind_windows} windows' worth")

    sched.reset()
    check_flushes(flushes, "the localnet phase")
    total = launches()
    for name in PATH_KERNELS:
        check(total[name] > 0, f"the localnet phase never launched {name}")
    by_kind = collections.Counter(kind for kind, _, _ in flushes)
    waits = {k: (statistics.median(w) * 1e3 if w else None, len(w))
             for k, w in lane_waits.items()}
    seconds = time.perf_counter() - started
    log(f"[{card}] localnet of {NODES} nodes of {KEYS_PER_NODE} keys "
        f"({committee_size} slots), each chain's seal checked on insert: "
        "manual rounds " + ", ".join(f"{t:.3f}" for t in round_s) +
        f" s (empty, transfer, create-validator); the view change and its "
        f"round {vc_out['s']:.3f} s; live {live_out['blocks']} blocks in "
        f"{live_out['s']:.3f} s ({live_out['s'] / live_out['blocks']:.3f} s "
        f"a block, block time {LOCALNET_BLOCK_TIME} s; views "
        f"{live_out['views']}); a behind node synced {behind_out['blocks']}"
        f" blocks, every seal checked, and rejoined at the network's round "
        f"in {behind_out['s']:.3f} s")
    log(f"[{card}] localnet flushes: {by_kind['agg']} aggregate, "
        f"{by_kind['single']} single-check, each launching its path's "
        "kernels once; median wait in the queue " + ", ".join(
            f"{k} {w:.3f} ms over {n}" if w is not None else f"{k} none"
            for k, (w, n) in waits.items()))
    log(f"[{card}] localnet phase took {seconds:.3f} s; launches " +
        ", ".join(f"{n} {k}" for k, n in total.items()))
    return {"launches": total}


# the node's sync (sync_phase): a serving chain of SYNC_BLOCKS sealed
# blocks at mainnet width (200 slots, bucket 256, the localnet's
# operators), synced by the staged downloader over p2p/stream.py in
# windows of SYNC_WINDOW, every window's seals checked on the card
SYNC_BLOCKS = 256
SYNC_WINDOW = 64  # sync/staged.py BATCH
SYNC_TAIL = 4  # blocks the serving chain grows after the fast syncs
SYNC_FORGED_AT = 150  # a block of the third window (129-192)
BEACON_EPOCH_BLOCKS = 16
# a SYNC flush waits this long for its batch to fill; the default 2 ms
# could split a window's 64 checks, which the engine submits one by one,
# over two flushes when the host is slow
SYNC_FLUSH_WINDOW_S = 0.02
# a window's seal checks (one flush: a batch, or a lone check) launch
# each kernel of the quorum check once
WINDOW_LAUNCHES = {k: int(k in PATH_KERNELS) for k in KERNELS}


def sync_phase(seed):
    """The node's sync on the card: a serving Blockchain of SYNC_BLOCKS
    empty blocks (the last SYNC_TAIL carry a transfer) at mainnet width,
    each sealed by a 150-of-200 commit proof the host signs (one
    signature by the signers' key sum), served by SyncServer on loopback.
    Fresh chains sync it through the staged Downloader: a full replay in
    windows of SYNC_WINDOW (every window one batched seal check through
    Engine.verify_headers_batch on the SYNC lane); the same headers again
    on a chain sharing the engine (its verified cache: no launch); a
    window with a forged proof refused, twice (the forgery re-checked,
    the verified ones cached), then healed; fast_sync with its
    seal-checked windows, state download and receipts tail; the snapshot
    bootstrap from the served pages; both built with state_retention=1
    and then taking SYNC_TAIL more blocks through insert_chain; one beacon
    epoch header into an EpochChain by the epoch feed.  Every part's
    launches are exact; every synced chain equals the serving chain."""
    import statistics

    from harmony_tpu_torch import bls as B
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import sched
    from harmony_tpu_torch.chain import engine as ENG
    from harmony_tpu_torch.config.chain import ChainConfig
    from harmony_tpu_torch.consensus.mask import bits_from_bytes
    from harmony_tpu_torch.consensus.signature import \
        construct_commit_payload
    from harmony_tpu_torch.core import rawdb
    from harmony_tpu_torch.core.blockchain import Blockchain, ChainError
    from harmony_tpu_torch.core.epochchain import EpochChain
    from harmony_tpu_torch.core.genesis import Genesis
    from harmony_tpu_torch.core.kv import MemKV
    from harmony_tpu_torch.core.tx_pool import TxPool
    from harmony_tpu_torch.core.types import Transaction
    from harmony_tpu_torch.crypto_ecdsa import ECDSAKey
    from harmony_tpu_torch.node.worker import Worker
    from harmony_tpu_torch.p2p.stream import SyncClient, SyncServer
    from harmony_tpu_torch.ref import bls as RB
    from harmony_tpu_torch.ref import native as NB
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2
    from harmony_tpu_torch.ref.keccak import keccak256
    from harmony_tpu_torch.ref.params import R_ORDER
    from harmony_tpu_torch.shard.committee import Committee, Slot, State
    from harmony_tpu_torch.sync import Downloader
    from harmony_tpu_torch.sync.epoch_feed import EpochFeed

    check(D._FORCED is None and D.device_enabled(),
          "device_enabled() is not True by AUTO on the card")
    check(NB.available(), "the native host library did not load")
    node_clean("before the sync phase")
    started = time.perf_counter()
    card = card_line()
    rng = random.Random(seed + 16)
    keys = [B.PrivateKey(rng.randrange(1, R_ORDER)) for _ in range(COMMITTEE)]
    committee = [k.pub.bytes for k in keys]
    sender = ECDSAKey.from_seed(b"sync sender %d" % seed)
    to = b"\x0b" * 20
    genesis = Genesis(
        config=ChainConfig(chain_id=LOCALNET_CHAIN_ID, leader_rotation_epoch=0),
        shard_id=0, alloc={sender.address(): 10**24}, committee=committee)
    operators = State(epoch=0, shards=[Committee(shard_id=0, slots=[
        Slot(ecdsa_address=bytes([1 + i // KEYS_PER_NODE]) * 20,
             bls_pubkey=k) for i, k in enumerate(committee)])])
    s, flushes = counted_scheduler(flush_window_s=SYNC_FLUSH_WINDOW_S)
    reset_launches()
    parts, servers = {}, []

    def bitmap(signers):
        out = bytearray((COMMITTEE + 7) >> 3)
        for i in signers:
            out[i >> 3] |= 1 << (i & 7)
        return bytes(out)

    def seal(chain, header, payload=None):
        """150 of the 200 keys' commit proof: one signature by the sum of
        their secret keys, as a multi-key node signs."""
        if payload is None:
            payload = construct_commit_payload(
                header.hash(), header.block_num, header.view_id,
                chain.config.is_staking(header.epoch))
        signers = rng.sample(range(COMMITTEE), QUORUM)
        sig = RB.sig_to_bytes(RB.sign(
            sum(keys[i].scalar for i in signers) % R_ORDER, payload))
        return sig + bitmap(signers)

    def make_chain(engine=None, db=None, **kw):
        db = MemKV() if db is None else db
        rawdb.write_shard_state(db, 0, operators)
        return Blockchain(db, genesis, engine=engine,
                          blocks_per_epoch=LOCALNET_EPOCH_BLOCKS, **kw)

    def card_engine(chain_of):
        engine = ENG.Engine(lambda shard, epoch: ENG.EpochContext(
            chain_of().committee_for_epoch(epoch)))
        check(engine.device is True, "a sync engine is not on the device "
              "path")
        return engine

    def checked_chain(engine=None, **kw):
        cell = []
        chain = make_chain(engine or card_engine(lambda: cell[0]), **kw)
        cell.append(chain)
        return chain

    def grow(chain, n, transfers=0):
        """n blocks on ``chain``, the last ``transfers`` with one transfer
        each; each sealed, its proof stored (the next header carries
        it)."""
        pool = TxPool(LOCALNET_CHAIN_ID, 0, chain.state)
        worker = Worker(chain, pool)
        for i in range(n):
            if i >= n - transfers:
                pool.add(Transaction(
                    nonce=chain.state().nonce(sender.address()),
                    gas_price=1, gas_limit=25_000, shard_id=0, to_shard=0,
                    to=to, value=1000 + chain.head_number,
                ).sign(sender, LOCALNET_CHAIN_ID))
            block = worker.propose_block(view_id=chain.head_number + 1)
            check(chain.insert_chain([block], verify_seals=False) == 1,
                  f"the serving chain refused its block {block.block_num}")
            chain.write_commit_sig(block.block_num, seal(chain,
                                                         block.header))
            pool.drop_applied()

    def stored(chain, upto=None):
        """Per height: the stored hash, state root and commit proof; the
        head's state root."""
        upto = chain.head_number if upto is None else upto
        return [(rawdb.read_canonical_hash(chain.db, n),
                 rawdb.read_header(chain.db, n).root,
                 rawdb.read_commit_sig(chain.db, n))
                for n in range(1, upto + 1)]

    def equal_to_serving(chain, what):
        check(chain.head_number == serving.head_number
              and rawdb.read_head_number(chain.db) == chain.head_number,
              f"{what}: head {chain.head_number} (stored "
              f"{rawdb.read_head_number(chain.db)}), not "
              f"{serving.head_number}")
        check(stored(chain) == stored(serving), f"{what}: the synced "
              "blocks, roots or proofs differ from the serving chain's")
        check(chain.state().root() == serving.state().root(),
              f"{what}: the head's state root differs")

    def windows_of(chain, method="insert_chain"):
        """Record each call of ``chain.<method>`` (a window): its blocks,
        launches and seconds."""
        calls = []
        fn = getattr(chain, method)

        def recorded(blocks, *a, **k):
            before, t0 = launches(), time.perf_counter()
            try:
                return fn(blocks, *a, **k)
            finally:
                calls.append((len(blocks), since(before),
                              time.perf_counter() - t0))
        setattr(chain, method, recorded)
        return calls

    def part(name, fn, want):
        """One part: its launches must be ``want`` windows' worth (each
        kernel of the quorum check ``want`` times, no other kernel);
        every flush launches its path's kernels once; node_clean."""
        before, t0, n0 = launches(), time.perf_counter(), len(flushes)
        out = fn()
        made = since(before)
        parts[name] = (made, time.perf_counter() - t0, len(flushes) - n0)
        log(f"sync, {name}: {parts[name][1]:.3f} s, {parts[name][2]} "
            "flushes, launches " + ", ".join(
                f"{n} {k}" for k, n in made.items() if n))
        check(made == {k: want * n for k, n in WINDOW_LAUNCHES.items()},
              f"sync, {name}: launched {made}, not {want} windows' worth")
        check_flushes(flushes[n0:], f"sync, {name}")
        node_clean(f"sync, {name}")
        return out

    # -- the serving chain ---------------------------------------------------
    t0 = time.perf_counter()
    serving = make_chain()
    grow(serving, SYNC_BLOCKS, transfers=SYNC_TAIL)
    setup_s = time.perf_counter() - t0
    check(serving.head_number == SYNC_BLOCKS
          and serving.state().balance(to) > 0, "the serving chain is not "
          "as built")
    server = SyncServer(serving)
    servers.append(server)
    out, downloaders = {}, {}
    try:
        # -- a full replay, every window's seals on the card -----------------
        replay = checked_chain()
        replay_windows = windows_of(replay)
        seal_ms = []
        verify = replay.engine.verify_headers_batch

        def timed_verify(items, *a, **k):
            t = time.perf_counter()
            try:
                return verify(items, *a, **k)
            finally:
                seal_ms.append(1e3 * (time.perf_counter() - t))
        replay.engine.verify_headers_batch = timed_verify
        n_windows = SYNC_BLOCKS // SYNC_WINDOW

        def full_replay():
            dl = Downloader(replay, [SyncClient(server.port)],
                            batch=SYNC_WINDOW, verify_seals=True)
            with recorded_lanes() as lanes:
                t = time.perf_counter()
                res = dl.sync_once()
                out["replay_s"] = time.perf_counter() - t
            check(res.inserted == SYNC_BLOCKS and not res.errors,
                  f"the full replay: {res}")
            equal_to_serving(replay, "the full replay")
            check([(n, made) for n, made, _ in replay_windows] ==
                  [(SYNC_WINDOW, WINDOW_LAUNCHES)] * n_windows,
                  "the full replay's windows and their launches: "
                  f"{[(n, made) for n, made, _ in replay_windows]}")
            check(lanes == [("agg_verify_many", sched.Lane.SYNC)]
                  * n_windows, f"the full replay's lanes: {lanes}")
            check([(kind, n) for kind, n, _ in flushes[-n_windows:]]
                  == [("agg", SYNC_WINDOW)] * n_windows,
                  f"a window's checks were not one flush: {flushes}")
        part("full replay", full_replay, n_windows)
        out["seal_ms"] = list(seal_ms)

        # -- the same headers on a chain sharing the engine: all cached ------
        def cached():
            chain = checked_chain(engine=replay.engine)
            res = Downloader(chain, [SyncClient(server.port)],
                             batch=SYNC_WINDOW, verify_seals=True
                             ).sync_once()
            check(res.inserted == SYNC_BLOCKS and not res.errors,
                  f"the cached sync: {res}")
            equal_to_serving(chain, "the cached sync")
        part("the same headers, verified cache", cached, 0)

        # -- a forged window: refused, refused again, healed -----------------
        forged_payload = keccak256(b"a forged seal, seed %d" % seed)

        class ForgingClient(SyncClient):
            def get_blocks_by_number(self, start, count, deadline=None):
                return [(blk, seal(serving, blk.header, forged_payload)
                         if blk.block_num == SYNC_FORGED_AT else sig)
                        for blk, sig in super().get_blocks_by_number(
                            start, count, deadline)]

        forged = checked_chain()
        window_start = (SYNC_FORGED_AT - 1) // SYNC_WINDOW * SYNC_WINDOW + 1
        refusal = [f"insert failed at {window_start}: bad commit signature "
                   f"on block {SYNC_FORGED_AT}"]

        def refused():
            res = Downloader(forged, [ForgingClient(server.port)],
                             batch=SYNC_WINDOW, verify_seals=True
                             ).sync_once()
            check(res.errors == refusal, f"the forged window: {res}")
            check(forged.head_number == window_start - 1
                  and rawdb.read_head_number(forged.db) == window_start - 1
                  and stored(forged) == stored(serving, window_start - 1),
                  f"the forged window: head {forged.head_number}, or what "
                  "it kept differs from the serving chain")
        # the first run checks the windows up to the forged one's
        part("a forged window", refused, window_start // SYNC_WINDOW + 1)
        # again: only the forgery is checked (the engine caches verified
        # seals only), one lone check
        part("the forged window again", refused, 1)

        def healed():
            res = Downloader(forged, [SyncClient(server.port)],
                             batch=SYNC_WINDOW, verify_seals=True
                             ).sync_once()
            check(not res.errors, f"the healed sync: {res}")
            equal_to_serving(forged, "the healed sync")
        # the forged block's honest seal alone, then the last window
        part("the forged window healed", healed,
             n_windows - window_start // SYNC_WINDOW)

        # -- fast sync: seal-checked windows, state, receipts tail -----------
        fast = checked_chain(state_retention=1)
        fast_windows = windows_of(fast, "insert_headers_fast")

        def fast_sync():
            dl = Downloader(fast, [SyncClient(server.port)],
                            batch=SYNC_WINDOW, verify_seals=True)
            t = time.perf_counter()
            res = dl.fast_sync(receipts_tail=SYNC_WINDOW)
            out["fast_s"] = time.perf_counter() - t
            check(res.inserted == SYNC_BLOCKS and not res.errors,
                  f"fast sync: {res}")
            equal_to_serving(fast, "fast sync")
            check([(n, made) for n, made, _ in fast_windows] ==
                  [(SYNC_WINDOW, WINDOW_LAUNCHES)] * n_windows,
                  f"fast sync's windows: {fast_windows}")
            tail = range(SYNC_BLOCKS - SYNC_TAIL + 1, SYNC_BLOCKS + 1)
            check(all(rawdb.read_receipts(fast.db, n)
                      and rawdb.read_receipts(fast.db, n)
                      == rawdb.read_receipts(serving.db, n) for n in tail),
                  "fast sync's receipts tail differs from the serving "
                  "chain's")
            downloaders["fast"] = dl
        part("fast sync", fast_sync, n_windows)

        # -- the snapshot bootstrap: install_snapshot from the served pages --
        boot = checked_chain(state_retention=1)

        def bootstrap():
            dl = Downloader(boot, [SyncClient(server.port)],
                            batch=SYNC_WINDOW, verify_seals=True,
                            snapshot_threshold=SYNC_WINDOW)
            t = time.perf_counter()
            res = dl.sync_once()
            out["boot_s"] = time.perf_counter() - t
            check(dl.snapshot_bootstraps == 1
                  and dl.last_snapshot_block == SYNC_BLOCKS
                  and res.inserted == SYNC_BLOCKS and not res.errors,
                  f"the snapshot bootstrap: {res}, "
                  f"{dl.snapshot_bootstraps} bootstraps")
            check(boot.head_number == SYNC_BLOCKS
                  and boot.state().root() == serving.state().root()
                  and rawdb.read_canonical_hash(boot.db, SYNC_BLOCKS)
                  == rawdb.read_canonical_hash(serving.db, SYNC_BLOCKS),
                  "the snapshot bootstrap's head differs")
            downloaders["boot"] = dl
        part("snapshot bootstrap", bootstrap, 0)

        # -- SYNC_TAIL more blocks into both, under state_retention=1 --------
        grow(serving, SYNC_TAIL, transfers=SYNC_TAIL)

        def tail():
            for chain, dl in ((fast, downloaders["fast"]),
                              (boot, downloaders["boot"])):
                res = dl.sync_once()
                check(res.inserted == SYNC_TAIL and not res.errors,
                      f"the tail: {res}")
                check(chain.head_number == serving.head_number
                      and rawdb.read_head_number(chain.db)
                      == chain.head_number
                      and chain.state().root() == serving.state().root(),
                      "the tail: a retained chain differs from the "
                      "serving chain")
                try:
                    chain.state_at(SYNC_BLOCKS)
                    pruned = False
                except ChainError:
                    pruned = True
                check(pruned, "state_retention=1 kept an old state")
        part("the tail into the fast-synced and bootstrapped chains", tail, 2)

        # -- one beacon epoch header into an EpochChain -----------------------
        beacon_db = MemKV()
        rawdb.write_shard_state(beacon_db, 1, operators)
        beacon = Blockchain(beacon_db, genesis,
                            blocks_per_epoch=BEACON_EPOCH_BLOCKS)
        grow(beacon, BEACON_EPOCH_BLOCKS)
        beacon_server = SyncServer(beacon)
        servers.append(beacon_server)

        def epoch_feed():
            cell = []
            ec = EpochChain(MemKV(), lambda shard: committee,
                            engine=ENG.Engine(
                                lambda shard, epoch: ENG.EpochContext(
                                    cell[0].committee_for(shard, epoch))))
            cell.append(ec)
            feed = EpochFeed(ec, SyncClient(beacon_server.port),
                             blocks_per_epoch=BEACON_EPOCH_BLOCKS)
            check(feed.feed_once() == 1 and ec.head_epoch() == 0
                  and ec.committee_for(0, 1) == committee
                  and ec.header_for_epoch(0).hash()
                  == beacon.header_by_number(BEACON_EPOCH_BLOCKS - 1).hash(),
                  "the epoch feed did not follow the beacon's epoch 0")
        part("the epoch feed", epoch_feed, 1)
    finally:
        for srv in servers:
            srv.close()

    # the launches of the sync path, before the direct call's timing
    total = launches()
    # the direct entry point on the full replay's first window
    table = replay.engine.epoch_context(0, 0).committee_table()
    first = [(serving.header_by_number(n), rawdb.read_commit_sig(
        serving.db, n)) for n in range(1, SYNC_WINDOW + 1)]
    bits = [bits_from_bytes(p[96:], COMMITTEE) for _, p in first]
    hs = [hash_to_g2(construct_commit_payload(
        h.hash(), h.block_num, h.view_id, True)) for h, _ in first]
    sigs = [RB.sig_from_bytes(p[:96]) for _, p in first]
    direct_ms = median_ms(D.agg_verify_batch_on_device, table, bits, hs,
                          sigs, want=[True] * SYNC_WINDOW)
    node_clean("the sync phase's direct calls")
    sched.reset()
    seconds = time.perf_counter() - started
    log(f"[{card}] sync of {SYNC_BLOCKS} blocks at {COMMITTEE} slots "
        f"(150-of-200 seals) in windows of {SYNC_WINDOW}: full replay "
        f"{out['replay_s']:.3f} s ({SYNC_BLOCKS / out['replay_s']:.1f} "
        f"blocks/s; {out['replay_s'] / n_windows:.3f} s a window; each "
        "window's insert " + ", ".join(
            f"{t:.3f}" for _, _, t in replay_windows) + " s, its "
        "seal check " + ", ".join(f"{t:.1f}" for t in out["seal_ms"]) +
        " ms); "
        f"fast sync {out['fast_s']:.3f} s; snapshot bootstrap "
        f"{out['boot_s']:.3f} s; direct agg_verify_batch_on_device of one "
        f"window's {SYNC_WINDOW} seals {direct_ms[0]:.3f} ms (median of "
        f"{MEDIAN_CALLS}; {direct_ms[1]:.3f} to {direct_ms[2]:.3f}); the "
        f"serving chain built in {setup_s:.3f} s; the scheduler's flush "
        f"window {SYNC_FLUSH_WINDOW_S * 1e3:.0f} ms")
    log(f"[{card}] sync phase took {seconds:.3f} s; launches " +
        ", ".join(f"{n} {k}" for k, n in total.items()))
    return {"launches": total}


MAINNET_KEYS = 150  # the era-0 genesis committee of a mainnet shard


def mainnet_genesis_phase(seed):
    """mainnet_genesis(0) boots a port Blockchain; ref.herumi decodes its
    150 real keys (the mainnet wire format), and their masked sum under a
    seeded bitmap of two thirds of them, computed on the card by
    device.masked_pubkey_sum (one g1_masked_sum launch), must equal the
    host reference's sum bit for bit."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import mainnet_genesis
    from harmony_tpu_torch.core.kv import MemKV
    from harmony_tpu_torch.ref import herumi as HM
    from harmony_tpu_torch.ref.curve import g1

    node_clean("before the mainnet genesis")
    gen = mainnet_genesis(shard_id=0)
    chain = Blockchain(MemKV(), gen, blocks_per_epoch=LOCALNET_EPOCH_BLOCKS)
    check(len(gen.committee) == MAINNET_KEYS and chain.head_number == 0
          and chain.committee_for_epoch(0) == gen.committee,
          "mainnet_genesis(0) did not boot a chain with its committee")
    points = [HM.g1_deserialize(k) for k in gen.committee]
    check(None not in points
          and [HM.g1_serialize(p) for p in points] == gen.committee,
          "a mainnet genesis key did not decode and re-encode")
    rng = random.Random(seed + 17)
    signers = set(rng.sample(range(MAINNET_KEYS), 2 * MAINNET_KEYS // 3))
    bits = [int(i in signers) for i in range(MAINNET_KEYS)]
    want = None
    for i in sorted(signers):
        want = g1.add(want, points[i])

    def no_host_answer():
        check(False, "the mainnet key sum was answered on the host")

    before = launches()
    got = D.masked_pubkey_sum(points, bits, no_host_answer)
    made = since(before)
    check(got == want, "the card's masked sum of the mainnet keys differs "
          "from the host reference's")
    check(made == {k: int(k == "g1_masked_sum") for k in made},
          f"the mainnet key sum launched {made}")
    node_clean("the mainnet genesis")
    log(f"mainnet genesis: shard 0's {MAINNET_KEYS} herumi keys decoded; "
        f"the masked sum of {len(signers)} on the card (one g1_masked_sum, "
        "bucket 256) equals the host reference's")


SIGN_KERNELS = ("scalar_mul_g1", "scalar_mul_g2", "g2_masked_sum")
SIGN_KEYS = 256  # keys derived and signatures made on the card
# lanes the ladders are timed at (the G2 sum's shapes: G2_SUM_TIMED)
SIGN_TIMED_LANES = (1, 8, 64, 256)


def ladder_work(name, points, bits):
    """(ms, what bounds it) of scalar_mul_g1 or scalar_mul_g2 on these
    points (..., 3, [2,] 32) and bits (L,) or (..., L): read each point
    and the bits (once where shared), write each result; the products of
    the double-and-add on each lane's bits (the table above WORK)."""
    from harmony_tpu_torch.ops import fp

    dbl, (add, add_z_one) = LADDER_PRODUCTS[name]
    e = 1 if name == "scalar_mul_g1" else 2
    pts = points.reshape(-1, 3, e, 32).cpu()
    rows = bits.reshape(-1, bits.shape[-1]).cpu().tolist()
    products = 0
    for lane in range(len(pts)):
        row = rows[lane % len(rows)]
        ones = [j for j, b in enumerate(row) if b == 1]
        if not ones:
            continue
        z_one = bool((pts[lane, 2, 0] == fp.ONE_MONT).all()
                     and (pts[lane, 2, 1:] == 0).all())
        products += (len(row) - 1 - ones[0]) * dbl + (len(ones) - 1) * (
            add_z_one if z_one else add)
    nbytes = 2 * pts.numel() * 4 + bits.numel() * 4
    return roofline(nbytes, products * MONT_IMAD)


def g2_sum_work(points, mask):
    """(ms, what bounds it) of g2_masked_sum on these Jacobian points (N,
    3, 2, 32) and mask: read them, write the sum; the products of the tree
    on this data (sum_tree)."""
    from harmony_tpu_torch.ops import fp
    from harmony_tpu_torch.ops import interop as I

    rows = points.cpu()
    keys = [I.arr_to_g2_affine(r) for r in rows]
    z_one = [bool((r[2, 0] == fp.ONE_MONT).all() and (r[2, 1] == 0).all())
             for r in rows]
    products, _ = sum_tree((keys, z_one), mask.cpu().tolist(), "g2")
    nbytes = points.numel() * 4 + mask.numel() * 4 + 3 * 2 * 128
    return roofline(nbytes, products * MONT_IMAD)


def g2_chain(rng, n):
    """n distinct G2 points P + i D (P, D random multiples of the
    generator), Jacobian with Z = 1 on the card: quicker on the host than
    n scalar multiplications."""
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref.curve import G2_GEN, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    p, d = (g2.mul(G2_GEN, rng.randrange(1, R_ORDER)) for _ in range(2))
    aff = [p]
    while len(aff) < n:
        aff.append(g2.add(aff[-1], d))
    return B._affine_to_jacobian_g2(I.g2_batch_affine(aff).cuda())


# g2_masked_sum is timed on a quorum's 150 of 200 signatures (bucket 256)
# and on 700 of 1,024 (the widest bucket)
G2_SUM_TIMED = {"200 points": (COMMITTEE, QUORUM),
                "1024 points": (1024, 700)}


def g2_sum_timing(seed):
    """g2_masked_sum at G2_SUM_TIMED's shapes, each held bit for bit
    against the plain version first: wrapper-inclusive ms by CUDA events,
    the kernel's device time by torch.profiler, the bound from this run's
    inputs, the wrapper's host cost per call, the plain version's ms (one
    call), and, where the kernel has one (kernels/g2_masked_sum.py
    phase_clocks), the timed build's record: the ns of each part of the
    adds of the block that wrote the sum, summed over its levels, at the
    SM clock of the run.  Also its ptxas line and SASS instructions.  It
    imports harmony_tpu_torch as it finds it, so it times another tree's
    kernel too: ``import chip_smoke`` from this file with that tree's
    root first on sys.path, build, call this.  Returns {shape: timings}."""
    import torch

    from harmony_tpu_torch.kernels import g2_masked_sum as KG2
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref import native as NB
    from harmony_tpu_torch.ref.curve import G2_GEN
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 25)
    card = card_line()
    log(f"[{card}] ptxas, g2_masked_sum: {ptxas_report()['g2_masked_sum']}; "
        f"{sass_sizes()['g2_masked_sum']} SASS instructions")
    # independent random signatures, as aggregate_sigs sums them (Z = 1):
    # no two partial sums meet equal, so no add doubles
    check(NB.available(), "the native host library is not loaded")
    sigs = [NB.g2_mul(G2_GEN, rng.randrange(1, R_ORDER))
            for _ in range(max(n for n, _ in G2_SUM_TIMED.values()))]
    sigs = B._affine_to_jacobian_g2(I.g2_batch_affine(sigs).cuda())
    out = {}
    for shape, (n, chosen) in G2_SUM_TIMED.items():
        jac = sigs[:n].contiguous()
        mask = [0] * n
        for i in rng.sample(range(n), chosen):
            mask[i] = 1
        mask = torch.tensor(mask, dtype=torch.int32).cuda()
        with plain_fp():
            want, plain_ms = once_ms(
                lambda: CV.masked_sum_reference(jac, mask, CV.FP2_OPS))

        def kernel(jac=jac, mask=mask):
            return KG2.g2_masked_sum(jac, mask)

        _compare(f"g2_masked_sum, {chosen} of {n} points (timed)", kernel(),
                 want, {"max_abs_err": 0})
        try:
            device_ms = 1e-3 * device_us(kernel, "g2_masked_sum", 3)
        except AssertionError as e:
            log(f"g2_masked_sum at {shape}: device time not measured: {e}")
            device_ms = None
        bound_ms, bound_by = g2_sum_work(jac, mask)
        t = out[shape] = {
            "points": n, "selected": chosen, "ms": cuda_ms(kernel, 5),
            "device_ms": device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "host_us_per_call": host_us(kernel, 10),
            "plain_ms": plain_ms}
        device = "not measured" if device_ms is None else \
            f"{device_ms:.6f} ms"
        log(f"[{card}] g2_masked_sum at {shape} ({chosen} selected): "
            f"{t['ms']:.6f} ms with the wrapper, {device} on the device, "
            f"bound {bound_ms:.6f} ms ({bound_by}), host "
            f"{t['host_us_per_call']:.3f} us per call; plain version "
            f"{plain_ms:.3f} ms")
        if not hasattr(KG2, "phase_clocks"):
            continue
        KG2.phase_clocks(jac, mask)  # warm
        got, clocks = KG2.phase_clocks(jac, mask)
        _compare(f"g2_masked_sum's timed build, {chosen} of {n} points", got,
                 want, {"max_abs_err": 0})
        c = clocks.cpu().tolist()
        levels, stages, cycles, ns = c[:4]
        check(levels == (n - 1).bit_length() and stages > 0 and cycles > 0
              and ns > 0, f"g2_masked_sum's clocks {c[:4]}")
        ghz = cycles / ns
        t["timed"] = {"levels": levels, "stages": stages, "ns": ns,
                      "sm_ghz": ghz, "parts_ns": {
                          part: c[4 + i] / ghz
                          for i, part in enumerate(KG2.PARTS)}}
        log(f"[{card}] g2_masked_sum's timed build at {shape}: the block "
            f"that wrote the sum ran {levels} levels in {stages} stages in "
            f"{ns / 1e3:.3f} us (SM clock {ghz:.4f} GHz); ns by part: "
            + ", ".join(f"{part} {v:.1f}" for part, v
                        in t["timed"]["parts_ns"].items()))
    return out


def once_ms(fn):
    """(result, device ms) of one call of fn(), by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sign_kernels_phase(seed, stats):
    """scalar_mul_g1, scalar_mul_g2 and g2_masked_sum against their plain
    versions (plain PyTorch on the card, no hand kernel launched), bit for
    bit: the ladders on 4 lanes of 32-bit scalars (a zero scalar, one of
    all ones, a random one, one with words other than 0 and 1; a point at
    infinity; Z != 1), per lane and shared, and one lane at full width
    each (a 255-bit key; its plain run timed once); the G2 sum on a point
    twice, a point and its negative and infinity under masks of every,
    none and one point and words other than 0 and 1 (5 points, 1 and 0),
    on 150 of 200 signatures, on 1,024 points, at 17 and 513 points (the
    kernel's partition over blocks uneven), and with equal operands in
    the last block's levels (at 200 and 1,024 points).  Returns the plain
    versions' ms at full width."""
    import torch

    from harmony_tpu_torch.kernels import g2_masked_sum as KG2
    from harmony_tpu_torch.kernels import scalar_mul as KS
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 21)
    started = time.perf_counter()
    plain_ms = {}
    fields = {
        "scalar_mul_g1": (KS.scalar_mul_g1, CV.FP_OPS, g1, G1_GEN,
                          I.g1_affine_to_jacobian_arr),
        "scalar_mul_g2": (KS.scalar_mul_g2, CV.FP2_OPS, g2, G2_GEN,
                          I.g2_affine_to_jacobian_arr)}
    for name, (kernel, ops, group, gen, arr) in fields.items():
        pts = [group.mul(gen, rng.randrange(1, R_ORDER)) for _ in range(4)]
        pts[1] = None
        with plain_fp():  # doubled once: Z != 1
            p = CV.dbl(torch.stack([arr(x) for x in pts]).cuda(), ops)
        bits = torch.tensor(
            [[0] * 32, [1] * 32, [rng.randrange(2) for _ in range(32)],
             [rng.choice((0, 1, 1, 2, -1)) for _ in range(32)]],
            dtype=torch.int32).cuda()
        for b, what in ((bits, "per lane"), (bits[2], "shared")):
            with plain_fp():
                want = CV.scalar_mul_reference(p, b, ops)
            _compare(f"{name}, 4 lanes of 32 bits, {what}", kernel(p, b),
                     want, stats[name])
        k = rng.randrange(1, R_ORDER)
        full = torch.tensor([[(k >> (254 - j)) & 1 for j in range(255)]],
                            dtype=torch.int32).cuda()
        with plain_fp():
            want, plain_ms[name] = once_ms(
                lambda: CV.scalar_mul_reference(p[:1], full, ops))
        _compare(f"{name}, 1 lane of 255 bits", kernel(p[:1], full), want,
                 stats[name])
        log(f"{name}: plain version at 1 lane of 255 bits "
            f"{plain_ms[name]:.3f} ms")

    def sums(points, masks, what):
        for mask in masks:
            with plain_fp():
                want = CV.masked_sum_reference(points, mask, CV.FP2_OPS)
            _compare(f"g2_masked_sum, {what}, mask {mask.tolist()[:8]}",
                     KG2.g2_masked_sum(points, mask), want,
                     stats["g2_masked_sum"])

    pts = [g2.mul(G2_GEN, rng.randrange(1, R_ORDER)) for _ in range(5)]
    pts[1], pts[3], pts[4] = None, pts[0], g2.neg(pts[2])
    with plain_fp():
        p = CV.dbl(torch.stack([I.g2_affine_to_jacobian_arr(x)
                                for x in pts]).cuda(), CV.FP2_OPS)
    masks = torch.tensor([[1, 1, 1, 1, 1], [0, 0, 0, 0, 0], [0, 0, 1, 0, 0],
                          [1, 0, 0, 1, 0], [1, 2, 1, -1, 0],
                          [1, 1, 1, 0, 1]], dtype=torch.int32).cuda()
    for n in (5, 1, 0):
        sums(p[:n], masks[:, :n], f"{n} points")
    keys = [g2.mul(G2_GEN, rng.randrange(1, R_ORDER)) for _ in range(16)]
    for n, chosen in ((COMMITTEE, QUORUM), (1024, 700)):
        aff = I.g2_batch_affine([keys[i % 16] for i in range(n)]).cuda()
        jac = B._affine_to_jacobian_g2(aff)
        mask = [0] * n
        for i in rng.sample(range(n), chosen):
            mask[i] = 1
        sums(jac, torch.tensor([mask], dtype=torch.int32).cuda(),
             f"{chosen} of {n} points, each key {n // 16} times")
    # the kernel's partition: uneven at 17 points (8 blocks of 4 leaves,
    # 2, then one of 2) and 513 (256 blocks, 64, 16, 4, then one of 4);
    # and equal operands in the last block's levels: P at leaves 0 and 1
    # and Q at 16 and 17 alone (P and Q meet at half 16, before the last
    # stage, whose inputs hold the leaves 0, 1, 2 and 3 mod 4) make its
    # partials 0 and 1 both P + Q, which it doubles; P at 0 and 1 alone
    # meet on the last level
    chain = g2_chain(rng, 1024)
    for n in (17, 513):
        mask = torch.tensor([[rng.choice((1, 1, 1, 0, 2, -1))
                              for _ in range(n)]], dtype=torch.int32).cuda()
        sums(chain[:n].contiguous(), mask, f"{n} points, uneven partition")
    for n in (COMMITTEE, 1024):
        pts = chain[:n].clone()
        pts[1], pts[17] = pts[0], pts[16]
        masks = torch.zeros(2, n, dtype=torch.int32)
        masks[0, [0, 1, 16, 17]] = 1
        masks[1, [0, 1]] = 1
        sums(pts, masks.cuda(), f"{n} points, equal operands in the last "
             f"block")
    log(f"the signing kernels against their plain versions: "
        f"{time.perf_counter() - started:.3f} s")
    return plain_ms


def ladder_phases(seed):
    """Each ladder's step by phase: the timed build of its kernel
    (kernels/scalar_mul.py phase_clocks) on one lane of a 255-bit key,
    its result held bit for bit against the kernel's, block 0's clock64()
    cycles of each phase summed over the steps, in ns per step at the SM
    clock of the run (the ladder's cycles over its %globaltimer ns), and
    the kernel's own step (CUDA events), which the timed build's readings
    lengthen.  Returns, per ladder, the phases' kinds and ns, the timed
    step's ns and the kernel's."""
    import torch

    from harmony_tpu_torch.kernels import scalar_mul as KS
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref.curve import G2_GEN, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 24)
    bits = torch.from_numpy(B.sk_to_bits([rng.randrange(1, R_ORDER)])).cuda()
    points = {"scalar_mul_g1": B.CV.G1_GEN.cuda()[None],
              "scalar_mul_g2": I.g2_affine_to_jacobian_arr(
                  g2.mul(G2_GEN, 7)).cuda()[None]}
    card = card_line()
    out = {}
    for name, p in points.items():
        want = getattr(KS, name)(p, bits)
        KS.phase_clocks(name, p, bits)  # warm
        got, clocks = KS.phase_clocks(name, p, bits)
        torch.cuda.synchronize()
        _compare(f"{name}'s timed build, 1 lane of 255 bits", got, want,
                 {"max_abs_err": 0})
        c = clocks.cpu().tolist()
        n, steps, cycles, ns = c[:4]
        check(0 < n <= KS.MAX_PHASES and steps == 255 and cycles > 0
              and ns > 0, f"{name}'s clocks {c[:4]}")
        ghz = cycles / ns
        phases = []
        for i in range(n):
            kind = c[4 + KS.MAX_PHASES + i]
            phases.append({
                "kind": ("products" if kind >= 65536 else "adds"),
                "tasks": kind % 65536,
                "ns": c[4 + i] / steps / ghz})
        step_ns = ns / steps
        kernel_ns = 1e6 * cuda_ms(lambda: getattr(KS, name)(p, bits),
                                  3) / steps
        out[name] = {"phases": phases, "step_ns": step_ns, "sm_ghz": ghz,
                     "kernel_step_ns": kernel_ns}
        log(f"[{card}] {name} step by phase, ns per step (1 lane, 255 bits, "
            f"SM clock {ghz:.4f} GHz): " + ", ".join(
                f"{i + 1} {ph['kind'][0]}{ph['tasks']} {ph['ns']:.1f}"
                for i, ph in enumerate(phases))
            + f"; phases {sum(ph['ns'] for ph in phases):.1f}, step "
            f"{step_ns:.1f} ns (the kernel alone {kernel_ns:.1f})")
    return out


def sign_timing_phase(seed, plain_ms):
    """Each ladder's step by phase (ladder_phases); the ladders at 1, 8, 64
    and 256 lanes of 255-bit keys (sign's and derive_pubkeys' shapes), the
    cofactor's 507 bits at 1 lane: wrapper-inclusive ms by CUDA events,
    the kernel's own device time by torch.profiler, the bound from this
    run's inputs, and the wrapper's host cost per call; each held bit for
    bit first, against the plain version where it was run; then the G2
    sum of 150 of 200 and of 700 of 1,024 signatures (g2_sum_timing)."""
    import torch

    from harmony_tpu_torch.kernels import scalar_mul as KS
    from harmony_tpu_torch.ops import _constants as C
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref.curve import G2_GEN, g2
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 23)
    started = time.perf_counter()
    timings = {name: {} for name in SIGN_KERNELS}
    for name, by_phase in ladder_phases(seed).items():
        timings[name]["step by phase"] = by_phase
    sks = [rng.randrange(1, R_ORDER) for _ in range(max(SIGN_TIMED_LANES))]
    bits = torch.from_numpy(B.sk_to_bits(sks)).cuda()
    gen = B.CV.G1_GEN.cuda()
    h = I.g2_affine_to_jacobian_arr(g2.mul(G2_GEN, 7)).cuda()
    cases = []
    for lanes in SIGN_TIMED_LANES:
        g1_pts = gen.expand(lanes, 3, 32).contiguous()
        g2_pts = h.expand(lanes, 3, 2, 32).contiguous()
        cases.append(("scalar_mul_g1", f"{lanes} lanes", lanes,
                      lambda p=g1_pts, b=bits[:lanes]: KS.scalar_mul_g1(p, b),
                      ladder_work("scalar_mul_g1", g1_pts, bits[:lanes])))
        cases.append(("scalar_mul_g2", f"{lanes} lanes", lanes,
                      lambda p=g2_pts, b=bits[:lanes]: KS.scalar_mul_g2(p, b),
                      ladder_work("scalar_mul_g2", g2_pts, bits[:lanes])))
    h2 = B._H2_BITS.cuda()
    cases.append(("scalar_mul_g2", "1 lane, 507 bits", 1,
                  lambda: KS.scalar_mul_g2(h[None], h2),
                  ladder_work("scalar_mul_g2", h[None], h2)))
    card = card_line()
    for op, shape, n, kernel, (bound_ms, bound_by) in cases:
        try:
            device_ms = 1e-3 * device_us(kernel, op, 3)
        except AssertionError as e:
            # torch.profiler dropped this kernel in every session; the time
            # by CUDA events stands, the device time is not measured
            log(f"{op} at {shape}: device time not measured: {e}")
            device_ms = None
        t = timings[op][shape] = {
            "lanes": n,
            "ms": cuda_ms(kernel, 5),
            "device_ms": device_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "host_us_per_call": host_us(kernel, 10),
        }
        device = "not measured" if device_ms is None else \
            f"{device_ms:.6f} ms"
        log(f"[{card}] {op} at {shape}: {t['ms']:.6f} ms with the "
            f"wrapper, {device} on the device, bound {bound_ms:.6f} ms "
            f"({bound_by}), host {t['host_us_per_call']:.3f} us per call")
    for op, shape in (("scalar_mul_g1", "1 lanes"), ("scalar_mul_g2",
                                                      "1 lanes")):
        timings[op][shape]["plain_ms"] = plain_ms[op]
    timings["g2_masked_sum"].update(g2_sum_timing(seed))
    check(C.H2.bit_length() == len(h2) == 507, "the cofactor's bits")
    log(f"the signing kernels timed: {time.perf_counter() - started:.3f} s")
    return timings


def signing_phase(seed):
    """The device signing ops through ops/bls.py at mainnet width, their
    launch counts from zero: 256 keys derived (derive_pubkeys), one
    payload mapped to the twist on the host and its cofactor cleared on
    the card (clear_cofactor_g2), 256 signatures (sign), the aggregate of
    150 of 200 (aggregate_sigs); every lane in affine (made so on the
    host: the card inverts nothing secret-derived) equal to the host's
    (native library); the aggregate verified by agg_verify_hashed_on_device
    against a committee table of the derived keys, and an aggregate with
    one forged lane rejected; every call held to its exact launches."""
    import torch

    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.ops import _constants as C
    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ref import native as NB
    from harmony_tpu_torch.ref.curve import G1_GEN
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2, map_to_twist
    from harmony_tpu_torch.ref.params import R_ORDER

    rng = random.Random(seed + 22)
    started = time.perf_counter()
    sks = [rng.randrange(1, R_ORDER) for _ in range(SIGN_KEYS)]
    payload = b"harmony shard 0 commit, seed %d" % seed
    tw = map_to_twist(payload)
    calls = {}

    def call(what, want, fn, *args):
        torch.cuda.synchronize()
        before, t0 = launches(), time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        made = since(before)
        check(made == {k: want.get(k, 0) for k in made},
              f"{what} launched {made}, not {want}")
        calls[what] = (ms, {k: n for k, n in made.items() if n})
        log(f"{what}: {ms:.3f} ms, launches " + ", ".join(
            f"{n} {k}" for k, n in made.items() if n))
        return out

    qc = {k: 1 for k in PATH_KERNELS}
    reset_launches()
    bits = torch.from_numpy(B.sk_to_bits(sks)).cuda()
    pks = call("derive_pubkeys, 256 keys", {"scalar_mul_g1": 1},
               B.derive_pubkeys, bits)
    h = call("clear_cofactor_g2, 1 payload", {"scalar_mul_g2": 1},
             B.clear_cofactor_g2, I.g2_affine_to_jacobian_arr(tw)[None].cuda())
    sigs = call("sign, 256 lanes", {"scalar_mul_g2": 1}, B.sign,
                h.expand(SIGN_KEYS, 3, 2, 32), bits)
    t0 = time.perf_counter()
    pk_aff = [I.arr_to_g1_affine(r) for r in pks.cpu()]
    h_aff = I.arr_to_g2_affine(h[0].cpu())
    sig_aff = [I.arr_to_g2_affine(r) for r in sigs.cpu()]
    check(NB.available(), "the native host library is not loaded")
    check(h_aff == hash_to_g2(payload) == NB.g2_mul(tw, C.H2),
          "clear_cofactor_g2 differs from the host's hash_to_g2")
    for i, sk in enumerate(sks):
        check(pk_aff[i] == NB.g1_mul(G1_GEN, sk),
              f"derive_pubkeys lane {i} differs from the host")
        check(sig_aff[i] == NB.g2_mul(h_aff, sk),
              f"sign lane {i} differs from the host")
    log(f"every lane == the host (native g1_mul, g2_mul, hash_to_g2; made "
        f"affine on the host in {time.perf_counter() - t0:.3f} s): "
        f"{SIGN_KEYS} keys, the hashed payload, {SIGN_KEYS} signatures")

    bitmap = [0] * COMMITTEE
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bitmap[i] = 1
    bm = torch.tensor(bitmap, dtype=torch.int32).cuda()
    agg = call("aggregate_sigs, 150 of 200", {"g2_masked_sum": 1},
               B.aggregate_sigs, I.g2_batch_affine(sig_aff[:COMMITTEE]).cuda(),
               bm)
    agg_aff = I.arr_to_g2_affine(agg.cpu())
    check(agg_aff == NB.g2_sum([s for s, b in zip(sig_aff, bitmap) if b]),
          "aggregate_sigs differs from the host's g2_sum")
    table = D.CommitteeTable(pk_aff[:COMMITTEE])
    ok = call("agg_verify_hashed_on_device, the aggregate", qc,
              D.agg_verify_hashed_on_device, table, bitmap, h_aff, agg_aff)
    check(ok is True, "the aggregate of the card's signatures was rejected")
    j = bitmap.index(1)
    forged = list(sig_aff[:COMMITTEE])
    forged[j] = NB.g2_mul(h_aff, (sks[j] + 1) % R_ORDER)
    bad = call("aggregate_sigs, one lane forged", {"g2_masked_sum": 1},
               B.aggregate_sigs, I.g2_batch_affine(forged).cuda(), bm)
    ok = call("agg_verify_hashed_on_device, the forged aggregate", qc,
              D.agg_verify_hashed_on_device, table, bitmap, h_aff,
              I.arr_to_g2_affine(bad.cpu()))
    check(ok is False, "an aggregate with a forged lane was accepted")
    node_clean("the signing phase")
    path = launches()
    for name in SIGN_KERNELS:
        check(path[name] > 0, f"the signing path never launched {name}")
    seconds = time.perf_counter() - started
    log(f"signing path: {seconds:.3f} s, launches " + ", ".join(
        f"{n} {k}" for k, n in path.items() if n))
    return {"launches": path, "calls": calls, "seconds": seconds,
            "pks": pks, "pk_aff": pk_aff, "sig_aff": sig_aff,
            "h_aff": h_aff, "agg_aff": agg_aff, "bitmap": bitmap}


def mesh_phase(signing):
    """parallel/mesh.py on the card: a NCCL process group of world size 1
    (the machine has one card, so no scaling is measured), each sharded_*
    against the unsharded call on the same inputs: the masked sum of the
    signing phase's 200 Jacobian keys under its bitmap, 8 single checks
    with a forged lane, the pairing product of two of them, and the
    quorum check of the card's aggregate and of a forged one."""
    import socket

    import torch
    import torch.distributed as dist

    from harmony_tpu_torch.ops import bls as B
    from harmony_tpu_torch.ops import curve as CV
    from harmony_tpu_torch.ops import interop as I
    from harmony_tpu_torch.ops import pairing as PR
    from harmony_tpu_torch.parallel import mesh as M

    started = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = M.make_mesh("cuda", init_method=f"tcp://127.0.0.1:{port}",
                       world_size=1, rank=0)
    try:
        check((mesh.size, mesh.rank, dist.get_backend()) == (1, 0, "nccl"),
              "the mesh is not one NCCL rank")
        keys = signing["pks"][:COMMITTEE]
        bits = torch.tensor(signing["bitmap"], dtype=torch.int32).cuda()
        got = M.sharded_masked_sum(mesh)(keys, bits)
        check(torch.equal(got, CV.masked_sum(keys, bits, CV.FP_OPS)),
              "sharded_masked_sum differs from masked_sum")
        pk = I.g1_batch_affine(signing["pk_aff"][:8]).cuda()
        h = I.g2_affine_to_arr(signing["h_aff"]).cuda()
        sig = I.g2_batch_affine(signing["sig_aff"][:8]).cuda()
        sig[3] = sig[4]
        h8 = h.expand(8, 2, 2, 32)
        got = M.sharded_verify(mesh)(pk, h8, sig)
        check(torch.equal(got, B.verify(pk, h8, sig))
              and got.tolist() == [True] * 3 + [False] + [True] * 4,
              f"sharded_verify: {got.tolist()}")
        got = M.sharded_pairing_product(mesh)(pk[:2, None], sig[:2, None])
        check(torch.equal(got, PR.pairing_product(pk[:2, None],
                                                  sig[:2, None])),
              "sharded_pairing_product differs from pairing_product")
        agg = I.g2_affine_to_arr(signing["agg_aff"]).cuda()
        table = I.g1_batch_affine(signing["pk_aff"][:COMMITTEE]).cuda()
        for what, s, want in (("the aggregate", agg, True),
                              ("a forged aggregate", sig[0], False)):
            got = M.sharded_agg_verify(mesh)(keys, bits, h, s)
            check(bool(got) is want
                  and bool(B.agg_verify(table, bits, h, s)) is want,
                  f"sharded_agg_verify of {what}: {bool(got)}")
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - started
    log(f"mesh: NCCL at world size 1, every sharded_* == the unsharded "
        f"call; {seconds:.3f} s")
    return seconds


SERVING_FAMILIES = ("harmony_aot_", "harmony_device_", "harmony_sched_",
                    "harmony_governor_", "harmony_health_", "harmony_prof_")


def qc_inputs(seed):
    """A 200-slot committee's table, the bitmap of a quorum of 150, the
    payload's hash and the quorum's aggregate signature, from ``seed``;
    and the committee's keys."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2

    rng = random.Random(seed)
    sks, pks = build_committee(rng)
    bits = [0] * COMMITTEE
    for i in rng.sample(range(COMMITTEE), QUORUM):
        bits[i] = 1
    h = hash_to_g2(b"harmony shard 0 serving block seed %d" % seed)
    table = D.CommitteeTable(pks)
    check((table.n, table.size) == (COMMITTEE, 256), "committee bucket")
    return table, bits, h, agg_sign(sks, bits, h), (sks, pks)


def serving_child(mode, seed):
    """One fresh process of the serving phase (``--serving-child warm``,
    ``split`` or ``cold``), which imports only the port: with ``warm``,
    ``aot.startup_warmup()`` first; with ``split``, the kernel library's
    load (``_build.build()``) and then the first launch of each kernel of
    the path alone, on one lane of zeros, each timed (after the CUDA
    context's start); then the first quorum check at 200 slots (bucket
    256) on the card, its wall ms and the JIT counters it moved, the
    second's wall ms, and the median of MEDIAN_CALLS more.  Prints what
    it saw as one JSON line, last."""
    import torch

    from harmony_tpu_torch import aot
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.kernels import _build

    out = {"mode": mode}
    if mode == "split":
        from harmony_tpu_torch.kernels import final_exp, fp12_mul, \
            g1_masked_sum, miller_loop

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _build.build()
        out["load_ms"] = 1e3 * (time.perf_counter() - t0)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device="cuda")

        f, p1, q1 = z(1, *_build.FP12), z(1, 2, 32), z(1, 2, 2, 32)
        keys, mask = z(8, 2, 32), z(8)
        out["first_launch_ms"] = {}
        for name, run in (
                ("g1_masked_sum",
                 lambda: g1_masked_sum.g1_masked_sum(keys, mask)),
                ("miller_loop", lambda: miller_loop.miller_loop(p1, q1)),
                ("fp12_mul", lambda: fp12_mul.fp12_mul(f, f)),
                ("final_exp", lambda: final_exp.final_exp(f))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out["first_launch_ms"][name] = 1e3 * (time.perf_counter() - t0)
    if mode == "warm":
        t0 = time.perf_counter()
        out["stats"] = aot.startup_warmup()
        out["warmup_s"] = time.perf_counter() - t0
        out["cache_events"] = {dict(k)["event"]: v for k, v
                               in aot.CACHE_EVENTS._values.items()}
        out["fallbacks"] = {dict(k)["reason"]: v for k, v
                            in aot.FALLBACKS._values.items()}
        out["after_warmup"] = (D.COUNTERS["ref_fallback"], D.BREAKER.state,
                               D.BREAKER._failures)
    table, bits, h, sig, _ = qc_inputs(seed)
    fn = D.agg_verify_hashed_on_device
    torch.cuda.synchronize()
    jit = dict(D.JIT.items())
    t0 = time.perf_counter()
    ok = fn(table, bits, h, sig)
    torch.cuda.synchronize()
    out["first_ms"] = 1e3 * (time.perf_counter() - t0)
    check(ok is True, "the first quorum check rejected a valid certificate")
    out["jit"] = {k: n - jit[k] for k, n in D.JIT.items()}
    t0 = time.perf_counter()
    check(fn(table, bits, h, sig) is True, "the second quorum check "
          "rejected a valid certificate")
    torch.cuda.synchronize()
    out["second_ms"] = 1e3 * (time.perf_counter() - t0)
    out["median_ms"] = median_ms(fn, table, bits, h, sig, want=True)
    out["clean"] = (D.COUNTERS["ref_fallback"], D.BREAKER.state)
    print(json.dumps(out), flush=True)
    return 0


def run_serving_child(mode, seed):
    """Run ``serving_child`` in a fresh process; what it saw."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--seed",
           str(seed), "--serving-child", mode]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    check(done.returncode == 0, f"the serving child ({cmd[-1]}) failed "
          f"({done.returncode}):\n{done.stdout[-4000:]}\n"
          f"{done.stderr[-4000:]}")
    out = json.loads(done.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def serving_phase(seed):
    """The node's serving surface around the card.  Fresh process A runs
    ``aot.startup_warmup()`` (every program of the manifest on the card),
    then its first quorum check, which must count a JIT hit and no miss;
    fresh process B makes the same first check without warmup, and C
    after the kernel library's load and each kernel's first launch alone
    (which splits B's).  In this process: a governor whose samples force
    PRESSURED, then CRITICAL, then NORMAL after its dwell; an INGRESS and
    a SYNC check bound for the card fail with DeviceError as governor
    sheds and launch nothing, while a CONSENSUS flush launches exactly its
    4 kernels; /readyz over loopback reads 200, 503, 200; /metrics carries
    the families of the port's modules; ``prof.capture`` around one quorum
    check writes a trace that parses."""
    import tempfile
    import urllib.error
    import urllib.request

    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import governor as GV
    from harmony_tpu_torch import metrics as MT
    from harmony_tpu_torch import prof, sched
    from harmony_tpu_torch.ref.curve import g2
    from harmony_tpu_torch.sched.scheduler import SHED, Lane

    started = time.perf_counter()
    warm = run_serving_child("warm", seed)
    stats = warm["stats"]
    check(stats is not None and stats["mode"] == "cuda"
          and stats["programs"] == stats["warmed"] == 43
          and stats["failed"] == 0, f"warmup: {stats}")
    check(warm["after_warmup"] == [0, "closed", 0],
          f"warmup left (ref_fallback, breaker, failures) "
          f"{warm['after_warmup']}")
    check(warm["jit"] == {"hit": 1, "miss": 0},
          f"the warmed first quorum check moved the JIT counters "
          f"{warm['jit']}")
    cold = run_serving_child("cold", seed)
    split = run_serving_child("split", seed)
    for child in (cold, split):
        check(child["jit"] == {"hit": 0, "miss": 1},
              f"the {child['mode']} first quorum check moved the JIT "
              f"counters {child['jit']}")
    for child in (warm, cold, split):
        check(child["clean"] == [0, "closed"],
              f"a serving child ended with {child['clean']}")
    log(f"serving: warmup of {stats['warmed']} of {stats['programs']} "
        f"programs in {warm['warmup_s']:.3f} s wall ({stats['wall_s']} s "
        f"in startup_warmup; library {stats['cached']} cached, "
        f"{stats['compiled']} compiled, nvcc {stats['compile_s']:.3f} s; "
        f"cache events {warm['cache_events']}, fallbacks "
        f"{warm['fallbacks']}); first quorum check (200 slots, bucket 256) "
        f"{warm['first_ms']:.3f} ms warmed, {cold['first_ms']:.3f} ms "
        f"cold; the second {warm['second_ms']:.3f}, "
        f"{cold['second_ms']:.3f} ms; median of {MEDIAN_CALLS} more "
        f"{warm['median_ms'][0]:.3f} ms warmed, "
        f"{cold['median_ms'][0]:.3f} ms cold; split: the library's load "
        f"{split['load_ms']:.3f} ms, each kernel's first launch alone "
        + ", ".join(f"{k} {v:.3f}" for k, v
                    in split["first_launch_ms"].items())
        + f" ms, then the first check {split['first_ms']:.3f} ms, the "
        f"second {split['second_ms']:.3f}; processes "
        f"{warm['process_s']:.3f}, {cold['process_s']:.3f}, "
        f"{split['process_s']:.3f} s")

    table, bits, h, sig, (sks, pks) = qc_inputs(seed)
    single_sig = g2.mul(h, sks[0])
    s, flushes = counted_scheduler()
    now, feed = [0.0], [{"queue_depth": 0}]
    gov = GV.install(GV.ResourceGovernor(
        GV.Limits(queue_pressured=10, queue_critical=20, dwell_s=1.0),
        sample_fn=lambda: feed[0], clock=lambda: now[0]))
    srv = MT.MetricsServer(MT.Registry(), port=0).start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                        timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def tier(depth, advance=0.0):
        now[0] += advance
        feed[0] = {"queue_depth": depth}
        return GV.TIER_NAMES[gov.sample_once()]

    def shed_on_card(submit, lane):
        before = (launches(), D.COUNTERS["ref_fallback"],
                  SHED.value(lane=lane, reason="governor"))
        try:
            submit().result(30)
        except D.DeviceError as e:
            check("governor" in str(e), f"a {lane} shed failed with {e}")
        else:
            raise AssertionError(f"a {lane} check bound for the card was "
                                 f"not shed at {GV.TIER_NAMES[gov.state()]}")
        check(since(before[0]) == {k: 0 for k in before[0]}
              and D.COUNTERS["ref_fallback"] == before[1]
              and SHED.value(lane=lane, reason="governor") == before[2] + 1,
              f"the {lane} shed launched {since(before[0])} or reached the "
              f"host")

    readyz = []
    try:
        readyz.append((tier(15), get("/readyz")[0]))
        shed_on_card(lambda: s.submit_single(pks[0], h, single_sig),
                     "ingress")
        readyz.append((tier(25), get("/readyz")[0]))
        shed_on_card(lambda: s.submit_agg(table, bits, h, sig,
                                          lane=Lane.SYNC), "sync")
        flushes.clear()
        check(s.submit_agg(table, bits, h, sig,
                           lane=Lane.CONSENSUS).result(30) is True,
              "a CONSENSUS quorum check at CRITICAL rejected a valid "
              "certificate")
        check(len(flushes) == 1, f"{len(flushes)} flushes for one check")
        check_flushes(flushes, "the serving phase's CONSENSUS check")
        with tempfile.TemporaryDirectory() as tmp:
            with prof.capture(tmp) as cap:
                check(D.agg_verify_hashed_on_device(table, bits, h, sig)
                      is True, "the captured quorum check rejected a valid "
                      "certificate")
            with open(cap.path) as f:
                events = json.load(f)["traceEvents"]
        kernels = sorted({k for e in events if e.get("cat") == "kernel"
                          for k in PATH_KERNELS if symbol(k) in e["name"]})
        tier(0, 1.0)
        readyz.append((tier(0, 1.0), get("/readyz")[0]))
        status, text = get("/metrics")
        check(status == 200 and all(f in text for f in SERVING_FAMILIES),
              f"/metrics ({status}) lacks "
              f"{[f for f in SERVING_FAMILIES if f not in text]}")
        check(get("/healthz")[0] == 200, "/healthz is not 200")
    finally:
        srv.stop()
        GV.uninstall()
        sched.reset()
    check(readyz == [("pressured", 200), ("critical", 503),
                     ("normal", 200)], f"/readyz by tier: {readyz}")
    node_clean("the serving phase", sheds=2)
    seconds = time.perf_counter() - started
    log(f"serving: /readyz {readyz}; the INGRESS and SYNC checks bound for "
        f"the card shed with DeviceError, no launch; the CONSENSUS flush "
        f"launched {flushes[0][2]}; /metrics carries "
        f"{', '.join(SERVING_FAMILIES)}; prof.capture wrote "
        f"{len(events)} trace events, kernels seen: "
        f"{', '.join(kernels) if kernels else 'none (not measured)'}; "
        f"{seconds:.3f} s")
    return {"warm": warm, "cold": cold, "split": split, "readyz": readyz,
            "captured_kernels": kernels, "seconds": seconds}


# -- the node binary ---------------------------------------------------------

BOOT_NODES = 4
BOOT_KEYS = COMMITTEE  # dev keys: Harmony mainnet's 200 slots
BOOT_SPAN = BOOT_KEYS // BOOT_NODES  # each process one multi-key validator
BOOT_BLOCKS = 8  # every node commits at least this many
BOOT_RESTART_AT = 4  # node 3 gets SIGTERM once every node is here
BOOT_BLOCK_TIME = 2.0  # the mainnet period
BOOT_BUDGET_S = 240.0  # the most any wait of part A may take
BOOT_EXIT_S = 20.0  # a child's SIGTERM-to-exit limit
BOOT_SOLO_BLOCKS = 5
BOOT_SOLO_BLOCK_TIME = 1.0
BOOT_RPC_CALLS = 25
BOOT_TRANSFER = 4242
# what one committed block of a solo node holding every key launches:
# the PREPARED proof (consensus/fbft.py:304) and the insert's seal check
# (chain/engine.py:340 via core/blockchain.py:591) one aggregate flush
# each, the leader's own COMMIT vote, signed once by its keys' sum
# (consensus/fbft.py:152), one single flush; one after another on the
# consensus thread, so no window merges them
BOOT_FLUSHES = ("agg", "single", "agg")
BOOT_BLOCK_LAUNCHES = {k: sum(int(k in FLUSH_LAUNCHES[kind])
                              for kind in BOOT_FLUSHES) for k in KERNELS}


def free_ports(n):
    """``n`` distinct loopback ports that were free a moment ago."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def http_json(port, path, body=None, timeout=30.0):
    """(status, parsed JSON) of a GET (``body`` None) or a JSON POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, data.decode(errors="replace")
    finally:
        conn.close()


def rpc(port, method, *params):
    status, out = http_json(port, "/", {"jsonrpc": "2.0", "id": 1,
                                        "method": method,
                                        "params": list(params)})
    check(status == 200 and isinstance(out, dict) and "error" not in out,
          f"{method}{list(params)} on :{port}: {status} {out}")
    return out["result"]


class BootNode:
    """One ``python -m harmony_tpu_torch.cli`` process of the boot phase:
    its ports, config file, datadir and log."""

    def __init__(self, index, work, sink, boot_port, extra=None):
        self.index = index
        self.work = work
        self.sink = sink
        self.boot_port = boot_port
        self.rpc, self.metrics, self.p2p, self.sync, self.ws = free_ports(5)
        self.extra = dict(extra or {})
        self.datadir = work / f"node{index}"
        self.proc = None
        self.runs = 0

    @property
    def log_path(self):
        return self.work / f"node{self.index}.{self.runs}.log"

    def spawn(self, sync_peer=None):
        self.runs += 1
        conf = self.work / f"node{self.index}.toml"
        conf.write_text("".join(f"{k} = {v}\n" for k, v in
                                {"ws_port": self.ws, **self.extra}.items()))
        cmd = [sys.executable, "-m", "harmony_tpu_torch.cli",
               "--config", str(conf), "--datadir", str(self.datadir),
               "--rpc-port", str(self.rpc),
               "--metrics-port", str(self.metrics),
               "--p2p-port", str(self.p2p), "--sync-port", str(self.sync),
               "--bootnode", f"127.0.0.1:{self.boot_port}",
               "--dev-keys", str(BOOT_KEYS),
               "--dev-key-index", str(BOOT_SPAN * self.index),
               "--dev-key-span", str(BOOT_SPAN),
               "--block-time", str(BOOT_BLOCK_TIME), "--skip-ntp-check",
               "--trace", "--span-sink-dir", str(self.sink)]
        if sync_peer is not None:
            cmd += ["--sync-peer", f"127.0.0.1:{sync_peer}"]
        self.seen = []
        self.spawned = time.perf_counter()
        self.spawned_wall = time.time()
        self.up_s = None
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT,
                cwd=Path(__file__).resolve().parent)
        return self

    def text(self):
        """This run's log so far."""
        try:
            return self.log_path.read_text(errors="replace")
        except OSError:
            return ""

    def poll_up(self):
        """True once the ``node up`` line is out; fails if it exited."""
        if self.up_s is None and "harmony-tpu node up" in self.text():
            self.up_s = time.perf_counter() - self.spawned
        check(self.up_s is not None or self.proc.poll() is None,
              f"node {self.index} exited ({self.proc.returncode}) before "
              f"it was up:\n{self.text()[-4000:]}")
        return self.up_s is not None

    def head(self):
        """The node's head over RPC; each new one's first sighting kept."""
        head = rpc(self.rpc, "hmyv2_blockNumber")
        if not self.seen or head > self.seen[-1][1]:
            self.seen.append((time.perf_counter(), head))
        return head

    def block_s(self):
        """Seconds a block over the heads this run saw after its first."""
        (t0, h0), (t1, h1) = self.seen[0], self.seen[-1]
        return (t1 - t0) / (h1 - h0) if h1 > h0 else None

    def stop(self):
        """SIGTERM; its exit code and seconds to exit."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(BOOT_EXIT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            rc = None
        return rc, time.perf_counter() - t0


def wait_for(what, pred, budget=BOOT_BUDGET_S, every=0.2):
    deadline = time.perf_counter() + budget
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() >= deadline:
            raise AssertionError(f"{what}: not within {budget:.0f} s")
        time.sleep(every)


class HeadWatcher:
    """A WebSocket ``eth_subscribe("newHeads")`` client: every pushed
    head's (number, hash), on a thread of its own."""

    def __init__(self, port):
        import base64
        import socket

        from harmony_tpu_torch.rpc.ws import read_frame, write_frame

        self._read = read_frame
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=30)
        key = base64.b64encode(b"chip smoke heads").decode()
        self.sock.sendall(
            f"GET / HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self.sock.recv(4096)
            check(chunk, "the WebSocket handshake was cut")
            data += chunk
        check(b" 101 " in data.split(b"\r\n")[0],
              f"the WebSocket handshake: {data[:200]!r}")
        write_frame(self.sock, json.dumps({
            "jsonrpc": "2.0", "id": 1, "method": "eth_subscribe",
            "params": ["newHeads"]}).encode())
        _, payload = read_frame(self.sock)
        self.sub = json.loads(payload)["result"]
        self.heads = []
        self.errors = []
        self.sock.settimeout(None)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while True:
                op, payload = self._read(self.sock)
                if op == 0x8:
                    return
                note = json.loads(payload)
                if note.get("params", {}).get("subscription") == self.sub:
                    head = note["params"]["result"]
                    self.heads.append((int(head["number"], 16),
                                       head["hash"]))
        except (OSError, ValueError) as e:
            self.errors.append(repr(e))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
        self.thread.join(10)


def log_events(text, msg):
    """The JSON log records of one message, in order."""
    out = []
    for line in text.splitlines():
        if f'"msg":"{msg}"' in line:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def metric_values(text, name):
    """{labels: value} of one family's samples in Prometheus text."""
    out = {}
    for line in text.splitlines():
        m = re.match(rf"^{name}(\{{[^}}]*\}})? (\S+)$", line)
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


def boot_localnet(seed, work):
    """Part A of the boot phase: a bootnode and BOOT_NODES processes of
    the node binary on one card (see ``boot_phase``)."""
    import statistics

    from harmony_tpu_torch import obs
    from harmony_tpu_torch.core import rawdb
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import dev_genesis
    from harmony_tpu_torch.core.kv_native import NativeKV
    from harmony_tpu_torch.core.types import Transaction

    genesis, ecdsa_keys, _ = dev_genesis(n_keys=BOOT_KEYS)
    chain_id = genesis.config.chain_id
    sink = work / "spans"
    sink.mkdir()
    boot_port, = free_ports(1)
    out = {}
    with open(work / "bootnode.log", "w") as f:
        bootnode = subprocess.Popen(
            [sys.executable, "-m", "harmony_tpu_torch.p2p.discovery",
             "--port", str(boot_port)], stdout=f, stderr=subprocess.STDOUT,
            cwd=Path(__file__).resolve().parent)
    nodes = []
    watcher = None
    try:
        explorer_port, rosetta_port = free_ports(2)
        apis = {"explorer_port": explorer_port, "rosetta_port": rosetta_port}
        nodes = [BootNode(i, work, sink, boot_port,
                          extra=apis if i == 1 else None)
                 for i in range(BOOT_NODES)]
        for n in nodes:
            # every node can pull from a neighbour: one that missed a
            # round's COMMITTED recovers by the consensus-timeout sync
            n.spawn(sync_peer=nodes[(n.index + 1) % BOOT_NODES].sync)
        wait_for("the nodes' `node up` lines",
                 lambda: all([n.poll_up() for n in nodes]))
        out["up_s"] = [n.up_s for n in nodes]
        watcher = HeadWatcher(nodes[2].ws)
        subscribed_at = nodes[2].head()

        # a transfer signed with a dev-genesis key, in over RPC
        sender, to = ecdsa_keys[0], b"\x0b" * 20
        tx = Transaction(nonce=0, gas_price=1, gas_limit=25_000,
                         shard_id=0, to_shard=0, to=to,
                         value=BOOT_TRANSFER).sign(sender, chain_id)
        tx_hash = "0x" + tx.hash(chain_id).hex()
        before = [int(rpc(n.rpc, "eth_getBalance",
                          "0x" + sender.address().hex(), "latest"), 16)
                  for n in nodes]
        t0 = time.perf_counter()
        check(rpc(nodes[0].rpc, "hmy_sendRawTransaction",
                  "0x" + rawdb.encode_tx(tx, chain_id).hex()) == tx_hash,
              "hmy_sendRawTransaction returned another hash")
        receipt = wait_for("the transfer's receipt", lambda: rpc(
            nodes[0].rpc, "eth_getTransactionReceipt", tx_hash))
        out["receipt_s"] = time.perf_counter() - t0
        check(receipt["status"] == "0x1", f"the transfer failed: {receipt}")
        landed = int(receipt["blockNumber"], 16)

        # node 3 stops once every node is at BOOT_RESTART_AT, and comes
        # back on its datadir, syncing from node 0
        wait_for(f"every node at block {BOOT_RESTART_AT}", lambda: min(
            [n.head() for n in nodes]) >= BOOT_RESTART_AT)
        rc, exit_s = nodes[3].stop()
        check(rc == 0, f"node 3 exited {rc} on SIGTERM")
        db = NativeKV(str(nodes[3].datadir / "shard0.db"))
        try:
            on_disk = Blockchain(db, genesis, blocks_per_epoch=32768)
            stopped_at = on_disk.head_number
            disk_hash = "0x" + on_disk.current_header().hash().hex()
        finally:
            db.close()
        check(stopped_at >= BOOT_RESTART_AT,
              f"node 3's datadir holds {stopped_at} blocks")
        check(rpc(nodes[0].rpc, "hmy_getBlockByNumber", hex(stopped_at),
                  False)["hash"] == disk_hash,
              f"node 3's block {stopped_at} on disk is not node 0's")
        nodes[3].spawn(sync_peer=nodes[0].sync)
        wait_for("the restarted node's `node up` line", nodes[3].poll_up)

        def caught_up():
            head = nodes[3].head()
            return head if head >= min(n.head() for n in nodes[:3]) else 0
        target = wait_for("the restarted node's catch-up", caught_up)
        out["catch_up_s"] = time.perf_counter() - nodes[3].spawned
        # the first pass is build_node's, before consensus starts; later
        # ones are the node's own spin-up syncs while it rejoins
        start = log_events(nodes[3].text(), "sync start")
        done = log_events(nodes[3].text(), "sync pass done")
        check(start and start[0]["head"] == stopped_at,
              f"the restarted node did not reopen its {stopped_at} blocks "
              f"and sync: {start}")
        check(done and done[0]["errors"] == 0 and done[0]["inserted"] > 0,
              f"the restarted node's sync pass: {done}")
        out["reopen_s"] = start[0]["ts"] - nodes[3].spawned_wall
        out["sync_s"] = done[0]["ts"] - start[0]["ts"]
        out["synced"] = done[0]["inserted"]
        out["restart"] = {"stopped_at": stopped_at, "exit_s": exit_s,
                          "target": target, "up_s": nodes[3].up_s,
                          "passes": len(start)}

        # and stays at the network's head while every node commits two
        # more blocks (by its own spin-up syncs where it missed a round's
        # ANNOUNCE; its votes are counted, not required)
        wait_for(f"every node at block {BOOT_BLOCKS}", lambda: min(
            [n.head() for n in nodes]) >= max(BOOT_BLOCKS, target + 2))
        out["block_s"] = [n.block_s() for n in nodes]
        out["restart"]["votes"] = len(log_events(nodes[3].text(),
                                                 "prepare vote sent"))
        heights = min(n.head() for n in nodes)
        for num in range(1, heights + 1):
            hashes = {rpc(n.rpc, "hmy_getBlockByNumber", hex(num),
                          False)["hash"] for n in nodes}
            check(len(hashes) == 1, f"the nodes differ at block {num}: "
                  f"{hashes}")
        out["heights"] = heights
        after = [(int(rpc(n.rpc, "eth_getBalance",
                          "0x" + sender.address().hex(), "latest"), 16),
                  int(rpc(n.rpc, "eth_getBalance", "0x" + to.hex(),
                          "latest"), 16)) for n in nodes]
        gas = int(receipt["gasUsed"], 16)
        check(len(set(after)) == 1 and len(set(before)) == 1
              and after[0] == (before[0] - BOOT_TRANSFER - gas,
                               BOOT_TRANSFER),
              f"balances before {before}, after {after}, gas {gas}")

        # the pushes cover every head from the subscription on
        top = nodes[2].head()
        wait_for("the WebSocket's pushes", lambda: any(
            num >= top for num, _ in watcher.heads), budget=30)
        pushed = [num for num, _ in watcher.heads]
        check(not watcher.errors and pushed == list(range(
            pushed[0], pushed[-1] + 1)) and pushed[0] <= subscribed_at + 1,
              f"newHeads pushed {pushed} from head {subscribed_at} "
              f"({watcher.errors})")
        for num, h in watcher.heads[:3] + watcher.heads[-3:]:
            check(rpc(nodes[2].rpc, "hmy_getBlockByNumber", hex(num),
                      False)["hash"] == h, f"newHeads pushed block {num} "
                  f"with another hash")
        out["pushed"] = len(pushed)

        # the explorer and Rosetta on node 1 agree with its RPC
        def same_head():
            h_rpc = nodes[1].head()
            _, ex = http_json(explorer_port, "/height")
            _, ro = http_json(rosetta_port, "/network/status", {})
            h_ro = ro["current_block_identifier"]["index"]
            return (h_rpc, ro) if h_rpc == ex["height"] == h_ro else None
        h, ro = wait_for("the explorer's, Rosetta's and RPC's heads",
                         same_head, budget=30, every=0.05)
        _, ex_blocks = http_json(explorer_port, f"/blocks?from={h}&to={h}")
        _, ro_block = http_json(rosetta_port, "/block",
                                {"block_identifier": {"index": h}})
        want = rpc(nodes[1].rpc, "hmy_getBlockByNumber", hex(h),
                   False)["hash"]
        check(ex_blocks[0]["hash"] == ro["current_block_identifier"]["hash"]
              == ro_block["block"]["block_identifier"]["hash"] == want,
              f"the explorer's and Rosetta's block {h} is not RPC's")

        # RPC latency on a validator
        def median_rpc(method, *params):
            times = []
            for _ in range(BOOT_RPC_CALLS):
                t0 = time.perf_counter()
                rpc(nodes[1].rpc, method, *params)
                times.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(times)
        out["rpc_ms"] = {
            "hmyv2_blockNumber": median_rpc("hmyv2_blockNumber"),
            "hmy_getBlockByNumber": median_rpc("hmy_getBlockByNumber",
                                               hex(landed), True),
            "eth_getBalance": median_rpc("eth_getBalance",
                                         "0x" + to.hex(), "latest")}

        # each node's metrics and readiness
        for n in nodes:
            status, text = http_json(n.metrics, "/metrics")
            checks = metric_values(text, "harmony_device_checks_total")
            quorum = (checks.get('{kind="agg_verify"}', 0)
                      + checks.get('{kind="batch_verify"}', 0))
            check(status == 200 and quorum > 0, f"node {n.index} made "
                  f"{quorum} quorum checks on the card: {checks}")
            check(checks.get('{kind="ref_fallback"}') == 0,
                  f"node {n.index}: host fallbacks {checks}")
            check(metric_values(text, "harmony_device_kernel_twin")
                  == {"": 0}, f"node {n.index} ran the kernel twins")
            check("harmony_round_phase_seconds_bucket" in text,
                  f"node {n.index} renders no harmony_round_phase_seconds")
            status, _ = http_json(n.metrics, "/readyz")
            check(status == 200, f"node {n.index}'s /readyz is {status}")
    finally:
        if watcher is not None:
            watcher.close()
        codes = []
        for n in nodes:
            if n.proc is not None and n.proc.poll() is None:
                codes.append((n.index, *n.stop()))
            elif n.proc is not None:
                codes.append((n.index, n.proc.returncode, 0.0))
        import signal

        bootnode.send_signal(signal.SIGTERM)
        try:
            boot_rc = bootnode.wait(BOOT_EXIT_S)
        except subprocess.TimeoutExpired:
            bootnode.kill()
            boot_rc = bootnode.wait(10)
    check(all(rc == 0 for _, rc, _ in codes) and boot_rc == 0,
          f"exit codes on SIGTERM (node, rc, s): {codes}, bootnode "
          f"{boot_rc}")
    out["exit_s"] = [s for _, _, s in codes]
    for log_path in sorted(work.glob("*.log")):
        text = log_path.read_text(errors="replace")
        check("Traceback" not in text and "native kv unavailable"
              not in text, f"{log_path.name}:\n{text[-4000:]}")
    spans = obs.read_spans(sorted(str(p) for p in sink.glob("*.jsonl*")))
    timelines = obs.build_timelines(spans)
    check(timelines, f"no committed round in {len(spans)} spans")
    out["rounds"] = len(timelines)
    out["phase_ms"] = {p: 1e3 * statistics.median(
        tl.phases.get(p, 0.0) for tl in timelines) for p in obs.PHASES}
    out["round_ms"] = 1e3 * statistics.median(tl.wall_s for tl in timelines)
    return out


def boot_solo(work):
    """Part B of the boot phase: ``cli.build_node`` in this process, one
    solo node holding all BOOT_KEYS dev keys on its native-KV datadir,
    its services started; BOOT_SOLO_BLOCKS committed blocks, each held
    to BOOT_BLOCK_LAUNCHES, its flushes to BOOT_FLUSHES."""
    from harmony_tpu_torch import cli, sched
    from harmony_tpu_torch.core.kv_native import NativeKV
    from harmony_tpu_torch.sched.scheduler import SHED

    sheds = SHED.total()  # the serving phase's, made on purpose
    s, flushes = counted_scheduler()
    cfg = cli.load_config(None, {"dev_keys": BOOT_KEYS})
    cfg.update(datadir=str(work / "solo"), rpc_port=0, metrics_port=0,
               p2p_port=0, sync_port=0, block_time=BOOT_SOLO_BLOCK_TIME)
    reset_launches()
    node, manager, _, rpc_srv, _ = cli.build_node(cfg)
    check(isinstance(node.chain.db, NativeKV),
          f"the solo node's chain is on {type(node.chain.db).__name__}")
    blocks = []
    insert = node.chain.insert_chain
    mark = [launches(), 0]

    def counted_insert(*args, **kwargs):
        head = node.chain.head_number
        done = insert(*args, **kwargs)
        if node.chain.head_number > head:
            blocks.append((node.chain.head_number, since(mark[0]),
                           [kind for kind, _, _ in flushes[mark[1]:]]))
            mark[:] = [launches(), len(flushes)]
        return done
    node.chain.insert_chain = counted_insert
    t0 = time.perf_counter()
    manager.start_services()
    try:
        wait_for(f"the solo node's {BOOT_SOLO_BLOCKS} blocks",
                 lambda: len(blocks) >= BOOT_SOLO_BLOCKS, budget=120)
        seconds = time.perf_counter() - t0
        check(rpc(rpc_srv.port, "hmyv2_blockNumber") >= BOOT_SOLO_BLOCKS,
              "the solo node's RPC is behind its chain")
    finally:
        manager.stop_services()
        node.chain.db.close()
        sched.reset()
    total = {k: 0 for k in KERNELS}
    for num, made, kinds in blocks[:BOOT_SOLO_BLOCKS]:
        check(made == BOOT_BLOCK_LAUNCHES and tuple(kinds) == BOOT_FLUSHES,
              f"solo block {num} launched {made} in flushes {kinds}")
        for k, n in made.items():
            total[k] += n
    check_flushes(flushes, "the solo node")
    node_clean("the solo node", sheds=sheds)
    return {"launches": total, "seconds": seconds,
            "blocks": len(blocks)}


def boot_phase(seed):
    """The node binary (``python -m harmony_tpu_torch.cli``) on the card.

    Part A: a bootnode and BOOT_NODES processes of the binary, each
    holding BOOT_SPAN of BOOT_KEYS dev keys (Harmony's 200 slots), each
    on its own native-KV datadir (fsync "batch"), tracing into one span
    sink directory, all on this one card; every node commits BOOT_BLOCKS
    blocks with the same hash at every height; a dev-genesis transfer
    in over hmy_sendRawTransaction lands with the same balances on every
    node; node 2's WebSocket newHeads pushes every head, node 1's explorer
    and Rosetta agree with its RPC; node 3 stops on SIGTERM at block
    BOOT_RESTART_AT and comes back on its datadir with a sync peer, syncs
    the blocks it missed (their seals on the card) and keeps the network's
    head; every
    node's /metrics shows quorum checks on the card, no host fallback, no
    twin and the round-phase family, /readyz 200; every child exits 0 on
    SIGTERM, no log holds a traceback or a native-KV fallback.  Part B:
    the same wiring in this process (``boot_solo``), at exact launches.
    Prints each child's seconds to `node up`, seconds a block, the RPC
    medians, the transfer's seconds to its receipt, the restart's, and
    the committed rounds' median split by phase from the span files."""
    import shutil
    import tempfile

    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.core import kv_native

    check(D._FORCED is None and D.device_enabled(),
          "device_enabled() is not True by AUTO on the card")
    t0 = time.perf_counter()
    kv_native.build_native()
    check(kv_native.available(), "the native KV store did not load")
    log(f"built {kv_native.library_path().name} from "
        f"{kv_native.SOURCE.name} (g++) in {time.perf_counter() - t0:.3f} s")
    card = card_line()
    started = time.perf_counter()
    keep = Path(__file__).resolve().parent / "boot_phase_logs"
    with tempfile.TemporaryDirectory(prefix="boot_phase_") as tmp:
        work = Path(tmp)
        try:
            net = boot_localnet(seed, work)
        finally:
            shutil.rmtree(keep, ignore_errors=True)
            keep.mkdir(parents=True, exist_ok=True)
            for path in work.glob("*.log"):
                shutil.copy(path, keep / path.name)
            # the nodes' span files, for the tools phase's round forensics
            if (work / "spans").is_dir():
                shutil.copytree(work / "spans", keep / "spans")
        net_s = time.perf_counter() - started
        solo = boot_solo(work)
    phases = ", ".join(f"{p} {ms:.3f}" for p, ms in net["phase_ms"].items())
    log(f"[{card}] boot: {BOOT_NODES} node processes of {BOOT_SPAN} keys "
        f"({BOOT_KEYS} slots) up in "
        + ", ".join(f"{s:.3f}" for s in net["up_s"])
        + " s from spawn; seconds a block "
        + ", ".join("n/a" if s is None else f"{s:.3f}"
                    for s in net["block_s"])
        + " (node 3's after its restart); every node at "
        f"{net['heights']} blocks, one hash at each; the transfer's "
        f"receipt in {net['receipt_s']:.3f} s; medians of "
        f"{BOOT_RPC_CALLS} calls "
        + ", ".join(f"{m} {ms:.3f} ms" for m, ms in net["rpc_ms"].items())
        + f"; newHeads pushed {net['pushed']} heads")
    r = net["restart"]
    log(f"[{card}] boot: node 3 stopped at block {r['stopped_at']} "
        f"(exit in {r['exit_s']:.3f} s); after its respawn it had reopened "
        f"its datadir and began to sync at {net['reopen_s']:.3f} s, synced "
        f"{net['synced']} blocks in {net['sync_s']:.3f} s, was up at "
        f"{r['up_s']:.3f} s and at the network's head ({r['target']}) at "
        f"{net['catch_up_s']:.3f} s ({r['passes']} sync passes in all, "
        f"{r['votes']} prepare votes sent); "
        f"SIGTERM to exit "
        + ", ".join(f"{s:.3f}" for s in net["exit_s"]) + " s")
    log(f"[{card}] boot: {net['rounds']} committed rounds over the "
        f"{BOOT_NODES} nodes' span files, median {net['round_ms']:.3f} ms "
        f"a round, by phase (ms): {phases}")
    log(f"[{card}] boot: solo build_node of {BOOT_KEYS} keys, "
        f"{BOOT_SOLO_BLOCKS} blocks at {BOOT_BLOCK_LAUNCHES} launches each "
        f"({solo['seconds']:.3f} s); the phase took "
        f"{time.perf_counter() - started:.3f} s (part A {net_s:.3f} s)")
    return {"launches": solo["launches"], "localnet": net, "solo": solo,
            "span_files": sorted(str(p) for p in
                                 (keep / "spans").glob("*.jsonl*"))}


# the JAX package's adversarial scenarios, each in its quick form (the
# scenarios' own cut of their windows and floors), on the card
CHAOS_SCENARIOS = ("view_change_storm", "byz_double_voter_slashed",
                   "wan_committee_200")
SHED_REASONS = ("breaker_open", "queue_full", "deadline", "expired",
                "governor")


def chaos_want(kind, n):
    """The launches of one unit of device work in the chaos runs, by the
    code's lines.  A flush of ``n`` aggregate checks against one table
    (sched/scheduler.py ``_run_agg``): a lone one through
    agg_verify_hashed_on_device, one launch of each quorum kernel; more
    through agg_verify_batch_on_device, which dispatches one chunk per
    BATCH_BUCKETS_GPU[-1] (256) lanes, one launch of each quorum kernel a
    chunk (device.py agg_verify_batch_on_device).  A flush of ``n`` single
    checks (``_run_single``): verify_many_on_device, the same chunks, one
    launch each of miller_loop, fp12_mul and final_exp a chunk.  A check
    that found no scheduler running (``_run_inline``) is one of either,
    n = 1.  A masked_pubkey_sum (Mask.aggregate_public on the NEWVIEW
    path): one g1_masked_sum (its affine form in the same launch)."""
    from harmony_tpu_torch import device as D

    if kind == "sum":
        return {k: int(k == "g1_masked_sum") for k in KERNELS}
    chunks = -(-n // D.BATCH_BUCKETS_GPU[-1])
    return {k: chunks * int(k in FLUSH_LAUNCHES[kind]) for k in KERNELS}


@contextlib.contextmanager
def chaos_accounting():
    """For the length of the block, every unit of device work the chaos
    runs make is recorded with the launches it made: each scheduler flush
    (``_run_agg``, ``_run_single``, and ``_run_inline`` for a check that
    found no scheduler running), hooked on the class, since the runner
    builds its own scheduler (``sched.reset()``, ``sched.configure(...)``,
    runner.py), and each ``device.masked_pubkey_sum``.  One lock runs the
    units one at a time, so each unit's launch delta is its own: the pump
    threads' masked sums would otherwise land inside a flush's.  Also
    recorded: each twin answer (``device.kernel_twin_active`` True) and
    each consensus message a node dropped for a DeviceError.  Yields
    {"units": [(kind, n, device type, launches)], "unit_s": [(kind, wall
    s of the unit, lock wait included)], "twin": [...],
    "device_drops": [...]}."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.node.node import Node
    from harmony_tpu_torch.sched.scheduler import VerifyScheduler

    lock = threading.Lock()
    rec = {"units": [], "unit_s": [], "twin": [], "device_drops": []}

    def flush_hook(attr):
        run = getattr(VerifyScheduler, attr)

        def counted(self, arg):
            if attr == "_run_inline":
                kind, n = arg.kind, 1
            else:
                kind, n = ("agg" if attr == "_run_agg" else "single"), len(arg)
            t0 = time.perf_counter()
            with lock:
                before = launches()
                try:
                    return run(self, arg)
                finally:
                    rec["units"].append((kind, n, self.device().type,
                                         since(before)))
                    rec["unit_s"].append((kind, time.perf_counter() - t0))
        return run, counted

    masked_sum, twin_active = D.masked_pubkey_sum, D.kernel_twin_active
    handle = Node._handle_verified

    def summed(*args, **kwargs):
        t0 = time.perf_counter()
        with lock:
            before = launches()
            try:
                return masked_sum(*args, **kwargs)
            finally:
                rec["units"].append(("sum", 1, D.resolve_device(
                    kwargs.get("device")).type, since(before)))
                rec["unit_s"].append(("sum", time.perf_counter() - t0))

    def twin(device=None):
        on = twin_active(device)
        if on:
            rec["twin"].append(str(device))
        return on

    def handled(self, msg):
        try:
            return handle(self, msg)
        except D.DeviceError as e:
            rec["device_drops"].append((self.host.name, str(e)))
            raise

    hooks = {attr: flush_hook(attr)
             for attr in ("_run_agg", "_run_single", "_run_inline")}
    for attr, (_, counted) in hooks.items():
        setattr(VerifyScheduler, attr, counted)
    D.masked_pubkey_sum, D.kernel_twin_active = summed, twin
    Node._handle_verified = handled
    try:
        yield rec
    finally:
        for attr, (run, _) in hooks.items():
            setattr(VerifyScheduler, attr, run)
        D.masked_pubkey_sum, D.kernel_twin_active = masked_sum, twin_active
        Node._handle_verified = handle


def lane_sheds():
    """The scheduler's sheds so far, by (lane, reason)."""
    from harmony_tpu_torch.sched import Lane
    from harmony_tpu_torch.sched.scheduler import LANE_NAMES, SHED

    return {(LANE_NAMES[ln], why): SHED.value(lane=LANE_NAMES[ln],
                                              reason=why)
            for ln in Lane for why in SHED_REASONS}


def check_units(what, rec, made, sums0):
    """The gates on what ``chaos_accounting`` recorded over a run that
    launched ``made``: no message dropped for a DeviceError, no twin
    answer, each quorum kernel launched, and every launch in a unit of
    device work at that unit's exact launches (``chaos_want``), the
    masked sums the ones counted since ``sums0``.  Returns the units and
    the checks in them, by kind."""
    from harmony_tpu_torch import device as D

    check(not rec["device_drops"], f"{what}: messages dropped for a "
          f"DeviceError: {rec['device_drops'][:4]}")
    check(not rec["twin"] and not D.kernel_twin_active(),
          f"{what}: {len(rec['twin'])} twin answers")
    for k in PATH_KERNELS:
        check(made[k] > 0, f"{what}: {k} was never launched")
    # every launch belongs to a unit of device work, each unit's launches
    # are exactly its kind's (chaos_want), and the phase's delta is their
    # sum: the flushes plus one g1_masked_sum per masked_pubkey_sum
    units = rec["units"]
    wrong = [(kind, n, dev, got) for kind, n, dev, got in units
             if dev != "cuda" or got != chaos_want(kind, n)]
    check(not wrong, f"{what}: {len(wrong)} of {len(units)} units "
          f"off the card or off their launches, e.g. {wrong[:3]}")
    sums = sum(1 for kind, _, _, _ in units if kind == "sum")
    check(sums == D.COUNTERS["masked_pubkey_sum"] - sums0,
          f"{what}: {sums} masked sums hooked, "
          f"{D.COUNTERS['masked_pubkey_sum'] - sums0} counted")
    total = {k: sum(got[k] for _, _, _, got in units) for k in KERNELS}
    check(made == total, f"{what}: launched {made}, its units "
          f"account for {total}")
    flushes = collections.Counter(kind for kind, _, _, _ in units)
    checks = collections.Counter()
    for kind, n, _, _ in units:
        checks[kind] += n
    return flushes, checks


def chaos_scenario(name, card, dumps):
    """One scenario of CHAOS_SCENARIOS (quick) through the port's
    chaostest.run on the card, its launch counts from zero, held to its
    gates; returns its launches by kernel."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch.chaostest import run
    from harmony_tpu_torch.chaostest.scenarios import SCENARIOS

    scenario = SCENARIOS[name](quick=True)
    sheds0, sums0 = lane_sheds(), D.COUNTERS["masked_pubkey_sum"]
    reset_launches()
    t0 = time.perf_counter()
    with chaos_accounting() as rec:
        result = run(scenario)
    wall = time.perf_counter() - t0
    made = launches()
    shed = {k: n - sheds0[k] for k, n in lane_sheds().items()
            if n > sheds0[k]}
    m = {k: v["value"] for k, v in result.metrics.items()}
    if not result.passed:
        log(f"chaos, {name}: violations {result.violations}; dumps: "
            + (", ".join(result.violation_dumps) or "none written")
            + f" (under {dumps})")
    check(result.passed and not result.violations,
          f"chaos, {name}: {len(result.violations)} violations: "
          f"{[v['invariant'] for v in result.violations]}")
    check(D.COUNTERS["ref_fallback"] == 0,
          f"chaos, {name}: {D.COUNTERS['ref_fallback']} checks fell back to "
          "the host path")
    check(D.BREAKER.state == "closed",
          f"chaos, {name}: the device breaker is {D.BREAKER.state}")
    check(m["consensus_sheds"] == 0 and not any(
        lane == "consensus" for lane, _ in shed),
        f"chaos, {name}: consensus sheds {shed}")
    check(not any(why == "breaker_open" for _, why in shed),
          f"chaos, {name}: sheds for an open breaker {shed}")
    flushes, checks = check_units(f"chaos, {name}", rec, made, sums0)
    inbound = m.get("leader_inbound_msgs_per_round")
    unit_s = {k: sorted(t for kind, t in rec["unit_s"] if kind == k)
              for k in flushes}
    log(f"[{card}] chaos, {name} (quick, seed {scenario.seed}): passed in "
        f"{wall:.3f} s (run_s {m['run_s']} of its {scenario.window_s} s "
        f"window); heads {result.heads} (blocks_min {m['blocks_min']}, "
        f"floor {scenario.invariants.min_blocks}); rounds p50 "
        f"{m['round_p50_s']} s, p99 {m['round_p99_s']} s (bound "
        f"{scenario.invariants.round_p99_s}); view changes "
        f"{m['view_changes']}, NEWVIEWs adopted {m['new_views_adopted']}; "
        "units " + ", ".join(f"{k} {flushes[k]} ({checks[k]} checks)"
                             for k in sorted(flushes))
        + "; units' wall s (median, sum) " + ", ".join(
            f"{k} {v[len(v) // 2]:.4f}, {sum(v):.3f}"
            for k, v in sorted(unit_s.items()))
        + "; launches " + ", ".join(f"{k} {n}" for k, n in made.items() if n)
        + (f"; leader inbound {inbound} msgs/round" if inbound is not None
           else "") + (f"; other sheds {shed}" if shed else ""))
    extra = {k: v for k, v in m.items() if k.startswith((
        "round_phase_", "byz_", "wan200_", "netem_"))}
    if extra:
        log(f"chaos, {name}: " + ", ".join(f"{k} {v}"
                                           for k, v in extra.items()))
    return made


def chaos_phase(seed):
    """The port's chaostest on the card (runner.py ``run``): the JAX
    package's adversarial scenarios view_change_storm (the leader
    black-holed under an ingress flood, the committee changes view, the
    ex-leader resyncs), byz_double_voter_slashed (a staked external
    validator double-votes, every honest validator re-checks the evidence
    before voting, finalization slashes it) and wan_committee_200 (200
    slots over four nodes of 50 keys, a WAN matrix of 50-150 ms RTT with
    0.5% loss, the Handel overlay), each in its quick form, with
    HARMONY_CHAOS_REAL_KERNELS=1: every vote, quorum proof, seal and
    slashing evidence the honest nodes check goes through the kernels.
    Gates, each scenario: passed with no violation; no host fallback, the
    breaker closed, no consensus shed and no shed for an open breaker; no
    message dropped for a DeviceError; no twin answer; each quorum kernel
    launched; every launch accounted for by a unit of device work at its
    exact launches (chaos_want).  Violation dumps go to the git-ignored
    chaos_phase_dumps/.  ``seed`` is unused: each scenario carries its
    own (the JAX package's)."""
    import os
    import shutil

    from harmony_tpu_torch import device as D

    del seed
    card = card_line()
    check(D.COUNTERS["ref_fallback"] == 0 and D.BREAKER.state == "closed",
          "before the chaos phase: a host fallback or an open breaker")
    dumps = Path(__file__).resolve().parent / "chaos_phase_dumps"
    shutil.rmtree(dumps, ignore_errors=True)
    dumps.mkdir(parents=True, exist_ok=True)
    saved = {k: os.environ.get(k) for k in ("HARMONY_CHAOS_REAL_KERNELS",
                                            "HARMONY_TPU_TRACE_DIR")}
    os.environ["HARMONY_CHAOS_REAL_KERNELS"] = "1"
    os.environ["HARMONY_TPU_TRACE_DIR"] = str(dumps)
    started = time.perf_counter()
    out = {}
    try:
        for name in CHAOS_SCENARIOS:
            out[name] = chaos_scenario(name, card, dumps)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    total = {k: sum(made[k] for made in out.values()) for k in KERNELS}
    log(f"[{card}] chaos: {len(out)} scenarios passed on the card in "
        f"{time.perf_counter() - started:.3f} s; launches "
        + ", ".join(f"{k} {n}" for k, n in total.items() if n))
    return {"launches": total}


# the operator tools at their own configurations (four nodes of one key,
# check.sh's arguments): mainnet width stays with the earlier phases
TOOLS_CRASH_STRIDE = 4  # the crash sweep's byte stride (check.sh's is 1)
TOOLS_RESTARTS = ("leader_kill_restart", "rolling_restart")
TOOLS_LOCALNET = ("--nodes", "4", "--blocks", "3", "--device-path",
                  "--device-real")
TOOLS_CHILD_S = 300.0  # a child tool's time limit


def run_tool(name, *argv):
    """``harmony_tpu_torch.tools.<name>.main(argv)`` in this process, its
    standard output captured: (rc, output, wall s).  A SystemExit is a
    failure, its message the output's last line."""
    import importlib
    import io

    tool = importlib.import_module(f"harmony_tpu_torch.tools.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            rc = tool.main(list(argv))
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if e.code is not None and not isinstance(e.code, int):
                print(e.code)
    return rc, out.getvalue(), time.perf_counter() - t0


def last_json(out):
    """The last JSON object line of a tool's output."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(lines, f"no JSON line in:\n{out[-2000:]}")
    return json.loads(lines[-1])


def accounted_tool(name, card, *argv):
    """One in-process tool on the card, its launch counts, the tracer's
    spans and the fill counter from zero, under ``chaos_accounting``:
    its rc 0 (its own checks), every launch in a unit of device work (a
    scheduler flush or a masked_pubkey_sum) at that unit's exact
    launches (``chaos_want``), each quorum kernel
    launched, no twin answer, no message dropped for a DeviceError, no
    host fallback, the breaker closed, no consensus shed and no shed for
    an open breaker.  Returns (launches, output, wall s, the other sheds
    it made: INGRESS and SYNC under its floods, which its checks allow)."""
    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import trace
    from harmony_tpu_torch.sched.scheduler import FILL

    # what a tool reads of its process (the tracer's spans, the fill
    # ratio on /metrics) starts empty, as in the tool's own process
    trace.reset()
    FILL["items"] = FILL["slots"] = 0
    sheds0, sums0 = lane_sheds(), D.COUNTERS["masked_pubkey_sum"]
    reset_launches()
    with chaos_accounting() as rec:
        rc, out, wall = run_tool(name, *argv)
    made = launches()
    shed = {k: n - sheds0[k] for k, n in lane_sheds().items()
            if n > sheds0[k]}
    check(rc == 0, f"tools, {name}: rc {rc}:\n{out[-4000:]}")
    check(D.COUNTERS["ref_fallback"] == 0,
          f"tools, {name}: {D.COUNTERS['ref_fallback']} checks fell back "
          "to the host path")
    check(D.BREAKER.state == "closed",
          f"tools, {name}: the device breaker is {D.BREAKER.state}")
    check(not any(lane == "consensus" or why == "breaker_open"
                  for lane, why in shed),
          f"tools, {name}: consensus or open-breaker sheds {shed}")
    flushes, checks = check_units(f"tools, {name}", rec, made, sums0)
    log(f"[{card}] tools, {name} {' '.join(argv)}: passed in {wall:.3f} s; "
        "units " + ", ".join(f"{k} {flushes[k]} ({checks[k]} checks)"
                             for k in sorted(flushes))
        + "; launches " + ", ".join(f"{k} {n}" for k, n in made.items() if n)
        + (f"; other sheds {shed}" if shed else ""))
    return made, out, wall, sum(shed.values())


def child_tool(name, card, logs, *argv):
    """One tool in a fresh process (``python -m
    harmony_tpu_torch.tools.<name>``): rc 0 and no traceback in its
    output; (output, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"harmony_tpu_torch.tools.{name}", *argv],
        capture_output=True, text=True, timeout=TOOLS_CHILD_S,
        cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    (logs / f"{name}.out").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"tools, {name}: rc {proc.returncode}:\n"
          f"{(proc.stdout + proc.stderr)[-4000:]}")
    check("Traceback" not in proc.stdout + proc.stderr,
          f"tools, {name}: a traceback in its output ({logs / name}.out)")
    log(f"[{card}] tools, {name} {' '.join(argv)}: rc 0 in {wall:.3f} s")
    return proc.stdout, wall


def tools_phase(seed, boot):
    """The port's operator tools (``harmony_tpu_torch/tools/``) on the card
    with the real kernels, each at its own configuration (the JAX
    package's operators' four nodes of one key and check.sh's arguments;
    mainnet width stays with the localnet, sync, boot and chaos phases).
    In this process, each under ``accounted_tool``: obs_smoke (one traced
    round, seals through the sidecar; /metrics and /debug/trace valid),
    sched_smoke (rounds, replay and an ingress flood through one
    scheduler: fill ratio above its floor, no consensus shed), loadgen
    --duration 5 --check (1,500 transfers/s, floor 1,000, 20 proofs of
    possession/s, 4 nodes, 2 rounds), soak --quick --check (22 s at 300
    tx/s, 4 rounds; the slopes of RSS, fds, threads, queue and pool in
    their bounds) and chaos_sweep --quick --check over TOOLS_RESTARTS
    (the chaos phase's hooks and HARMONY_CHAOS_REAL_KERNELS=1): each
    passes its own --check with every launch accounted for.  crash_sweep
    --check at stride TOOLS_CRASH_STRIDE (the FileKV's kv.commit points,
    byte truncations, the native KV's parity; storage only, no launch):
    no failure.  round_forensics --check over the boot phase's span
    files: each phase's median over its committed rounds equals the boot
    phase's ``phase_ms`` (to the report's 1e-6 s).  In fresh processes:
    compile_surface_smoke (no first use after warmup across the width
    change 5 -> 12) and localnet TOOLS_LOCALNET (a bootnode and four
    node processes checking on the card, no twin and no host fallback on
    any /metrics).  No traceback in any child's output; node_clean
    after.  ``seed`` is unused: each tool carries its own keys."""
    import os
    import shutil
    import statistics

    from harmony_tpu_torch import device as D
    from harmony_tpu_torch import obs, sched
    from harmony_tpu_torch.sched.scheduler import SHED

    del seed
    card = card_line()
    check(D.COUNTERS["ref_fallback"] == 0 and D.BREAKER.state == "closed",
          "before the tools phase: a host fallback or an open breaker")
    logs = Path(__file__).resolve().parent / "tools_phase_logs"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    sheds0 = SHED.total()
    started = time.perf_counter()
    out = {"launches": {k: 0 for k in KERNELS}, "seconds": {}, "sheds": 0}

    def add(name, made, wall, sheds):
        out["seconds"][name] = wall
        out["sheds"] += sheds
        for k, n in made.items():
            out["launches"][k] += n

    made, text, wall, sheds = accounted_tool("obs_smoke", card)
    log("tools, obs_smoke: " + " | ".join(
        ln for ln in text.splitlines() if ln.startswith("obs_smoke:")))
    add("obs_smoke", made, wall, sheds)
    made, text, wall, sheds = accounted_tool("sched_smoke", card)
    log("tools, sched_smoke: " + " | ".join(
        ln for ln in text.splitlines() if ln.startswith("sched_smoke:")))
    add("sched_smoke", made, wall, sheds)
    made, text, wall, sheds = accounted_tool("loadgen", card, "--duration",
                                              "5", "--check")
    load = last_json(text)
    check(all(load["meta"]["checks"].values()), f"loadgen: {load['meta']}")
    log(f"tools, loadgen: {json.dumps(load)}")
    add("loadgen", made, wall, sheds)
    made, text, wall, sheds = accounted_tool("soak", card, "--quick",
                                              "--check")
    soak = last_json(text)
    check(all(soak["meta"]["checks"].values()), f"soak: {soak['meta']}")
    log(f"tools, soak: {json.dumps(soak)}")
    add("soak", made, wall, sheds)

    saved = {k: os.environ.get(k) for k in ("HARMONY_CHAOS_REAL_KERNELS",
                                            "HARMONY_TPU_TRACE_DIR")}
    os.environ["HARMONY_CHAOS_REAL_KERNELS"] = "1"
    os.environ["HARMONY_TPU_TRACE_DIR"] = str(logs / "chaos_dumps")
    try:
        argv = ["--quick", "--check"]
        for name in TOOLS_RESTARTS:
            argv += ["--scenario", name]
        made, text, wall, sheds = accounted_tool("chaos_sweep", card,
                                                  *argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sweep = last_json(text)
    check(sweep["value"] == len(TOOLS_RESTARTS)
          and not sweep["meta"]["violations"], f"chaos_sweep: {sweep['meta']}")
    log(f"tools, chaos_sweep: {json.dumps(sweep)}")
    add("chaos_sweep", made, wall, sheds)

    reset_launches()
    rc, text, wall = run_tool("crash_sweep", "--check", "--stride",
                              str(TOOLS_CRASH_STRIDE))
    crash = last_json(text)
    check(rc == 0 and not crash["meta"]["failures"],
          f"crash_sweep: rc {rc}, {crash['meta']}")
    check(not any(launches().values()), "crash_sweep launched a kernel")
    log(f"[{card}] tools, crash_sweep --check --stride {TOOLS_CRASH_STRIDE}: "
        f"passed in {wall:.3f} s: {json.dumps(crash)}")
    out["seconds"]["crash_sweep"] = wall

    # round forensics over the boot phase's span files
    report_path = logs / "round_forensics.json"
    rc, text, wall = run_tool("round_forensics", *boot["span_files"],
                              "--check", "--out", str(report_path))
    check(rc == 0, f"round_forensics: rc {rc}:\n{text[-2000:]}")
    report = json.loads(report_path.read_text())
    rounds = [r for r in report["rounds"] if r["committed"]]
    want = boot["localnet"]["phase_ms"]
    got = {p: 1e3 * statistics.median(r["phases"].get(p, 0.0)
                                      for r in rounds) for p in obs.PHASES}
    check(len(rounds) == boot["localnet"]["rounds"]
          and all(abs(got[p] - want[p]) <= 1e-3 for p in obs.PHASES),
          f"round_forensics: {len(rounds)} rounds, medians {got} (ms); the "
          f"boot phase's {boot['localnet']['rounds']}, {want}")
    agg = report["aggregate"]
    log(f"[{card}] tools, round_forensics --check over the boot phase's "
        f"{len(boot['span_files'])} span files: passed in {wall:.3f} s; "
        f"{agg['rounds']} committed rounds, {agg['attributed_fraction']} "
        f"attributed, dominant phase {agg['dominant_phase']}; phase medians "
        "(ms) " + ", ".join(f"{p} {got[p]:.3f}" for p in obs.PHASES)
        + ", the boot phase's to 0.001 ms")
    out["seconds"]["round_forensics"] = wall

    sched.reset()
    text, wall = child_tool("compile_surface_smoke", card, logs)
    check("0 post-warmup compiles" in text and "mode=cuda" in text,
          f"compile_surface_smoke: {text[-2000:]}")
    log("tools, compile_surface_smoke: " + text.strip().splitlines()[-1])
    out["seconds"]["compile_surface_smoke"] = wall
    data = logs / "localnet"
    text, wall = child_tool("localnet", card, logs, *TOOLS_LOCALNET,
                            "--data-dir", str(data))
    check("localnet OK" in text and "device-path checks per node" in text,
          f"localnet: {text[-2000:]}")
    for path in sorted(data.glob("*.log")):
        check("Traceback" not in path.read_text(errors="replace"),
              f"localnet, {path.name}: a traceback")
    log("tools, localnet: " + " | ".join(text.strip().splitlines()[-3:]))
    out["seconds"]["localnet"] = wall

    node_clean("the tools phase", sheds=sheds0 + out["sheds"])
    log(f"[{card}] tools: 9 tools passed on the card in "
        f"{time.perf_counter() - started:.3f} s ("
        + ", ".join(f"{k} {s:.3f}" for k, s in out["seconds"].items())
        + " s); launches " + ", ".join(f"{k} {n}" for k, n in
                                     out["launches"].items() if n)
        + f"; {out['sheds']:g} INGRESS and SYNC sheds under the floods")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1673)
    ap.add_argument("--serving-child", choices=("warm", "split", "cold"),
                    help="run one fresh process of the serving phase")
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
    if args.serving_child:
        return serving_child(args.serving_child, args.seed)

    started = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # the native host library (g++) builds beside the kernels (nvcc)
    from harmony_tpu_torch.ref import native as NB
    native_s = []
    native = threading.Thread(target=lambda: native_s.append(
        (NB.available(), time.perf_counter() - t0)))
    native.start()
    _build.build()
    log(f"built {_build.library_path().name} from "
        f"{', '.join(src.name for src in _build.SOURCES)} in "
        f"{time.perf_counter() - t0:.3f} s")
    native.join()
    check(native_s and native_s[0][0], "the native host library did not "
          "build or load")
    log(f"built {NB.library_path().name} from {NB.SOURCE.name} (g++) in "
        f"{native_s[0][1]:.3f} s")
    ptxas = ptxas_report()
    sass = sass_sizes()
    for kernel, line in ptxas.items():
        log(f"ptxas, {kernel}: {line}; {sass[kernel]} SASS instructions")
    # the phase plans and rounds keep every index into a register array
    # constant
    for kernel in ("fp12_mul", "fp12_cyclo_sqr", "miller_loop",
                   "g1_masked_sum", "final_exp", "scalar_mul_g1",
                   "scalar_mul_g2", "g2_masked_sum"):
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
    final_exp_in = final_exp_phase(args.seed, stats["final_exp"])
    timings = timing_phase(args.seed)
    timings.update(tower_timing_phase(args.seed))
    timings.update(loop_timing_phase(args.seed, qc_keys, qc_mask,
                                     stats["g1_masked_sum"]))
    timings.update(final_exp_timing_phase(final_exp_in))

    # the main path: launch counts start from zero here
    reset_launches()
    _, entry_calls = slice_phase(args.seed)
    node_clean("the slice phase")
    path = launches()
    for name in PATH_KERNELS:
        check(path[name] > 0, f"the main path never launched the {name} "
              f"kernel")
    log("main path: " + ", ".join(f"{n} {name}" for name, n in path.items())
        + " launches")
    gt_phase(args.seed)
    profile_phase(args.seed, entry_calls)
    node_clean("the profile phase")
    # the node's verification layer: its launch counts start from zero
    node = node_phase(args.seed)
    log("node path: " + ", ".join(f"{n} {name}" for name, n
                                  in node["launches"].items()) + " launches")
    # the consumers of the checks: their launch counts start from zero
    consumers = consumers_phase(args.seed)
    # the node itself: a localnet of Nodes, its launch counts from zero
    localnet = localnet_phase(args.seed)
    # the node's sync: the staged downloader over p2p/stream.py, every
    # window's seals on the card, its launch counts from zero
    sync = sync_phase(args.seed)
    mainnet_genesis_phase(args.seed)
    # the signing ops: their kernels against the plain versions and timed,
    # then their path through ops/bls.py, its counts from zero; the mesh
    plain_ms = sign_kernels_phase(args.seed, stats)
    timings.update(sign_timing_phase(args.seed, plain_ms))
    signing = signing_phase(args.seed)
    mesh_phase(signing)
    # the serving surface: warmup in a fresh process, the governor, the
    # metrics server, prof.capture
    serving_phase(args.seed)
    # the node binary: four processes on this card, then its wiring in
    # this process at exact launches, its counts from zero
    boot = boot_phase(args.seed)
    # the adversarial scenarios on the card with the real kernels, each
    # one's counts from zero
    chaos = chaos_phase(args.seed)
    # the operator tools on the card, the in-process ones' counts from zero
    tools = tools_phase(args.seed, boot)

    def entry(name, source, replaces, op, shape, described, kept,
              counted=path):
        t = timings[op][shape]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counted[name],
            "consumers_launches": consumers["launches"][name],
            "node_launches": localnet["launches"][name],
            "sync_launches": sync["launches"][name],
            "signing_launches": signing["launches"][name],
            "boot_launches": boot["launches"][name],
            "chaos_launches": chaos["launches"][name],
            "tools_launches": tools["launches"][name],
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
              "fp12_mul", "1 lanes",
              "1 lane, a quorum check's fp12_tree_reduce", ("fp12_mul",)),
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
        entry("final_exp", "harmony_tpu_torch/csrc/final_exp.cu",
              "none: fuses harmony_tpu/ops/pairing.py:218-246 "
              "final_exponentiation (jnp and scans, fused by XLA)",
              "final_exp", "1 lanes",
              "1 lane, a quorum check's final exponentiation",
              ("final_exp",)),
        entry("scalar_mul_g1", "harmony_tpu_torch/csrc/scalar_mul.cu",
              "none: fuses harmony_tpu/ops/curve.py:195-218 scalar_mul "
              "over FP_OPS (scan, fused by XLA)", "scalar_mul_g1", "1 lanes",
              "1 lane of a 255-bit key (derive_pubkeys); launches: the "
              "signing path", ("scalar_mul_g1",), signing["launches"]),
        entry("scalar_mul_g2", "harmony_tpu_torch/csrc/scalar_mul.cu",
              "none: fuses harmony_tpu/ops/curve.py:195-218 scalar_mul "
              "over FP2_OPS (scan, fused by XLA)", "scalar_mul_g2",
              "1 lanes", "1 lane of a 255-bit key (sign); launches: the "
              "signing path", ("scalar_mul_g2",), signing["launches"]),
        entry("g2_masked_sum", "harmony_tpu_torch/csrc/g2_masked_sum.cu",
              "none: fuses harmony_tpu/ops/curve.py:235-262 masked_sum "
              "over FP2_OPS (jnp, fused by XLA)", "g2_masked_sum",
              "200 points", "150 of 200 signatures, bucket 256 "
              "(aggregate_sigs); launches: the signing path",
              ("g2_masked_sum",), signing["launches"]),
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
