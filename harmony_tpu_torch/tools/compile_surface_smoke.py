"""Compile-surface smoke: ZERO first uses after warmup across a
committee-width change.

check.sh's compile-surface stage.  The first NEWVIEW at a new committee
width once paid a program's first use on the consensus pump thread and
wedged every validator for about 90 s.  This smoke proves the warmup
manifest actually covers the serving surface:

  1. ``aot.startup_warmup()`` warms every program of the port's
     manifest (``aot.load_manifest``: the pinned bucket registries'
     shape set) — on the card, the kernel library's load and each
     program's first launches at its shape;
  2. every device entry family (agg_verify, batched replay, single
     verify, continuous-batch verify_many) is driven at committee
     width 5 (bucket 8) and AGAIN at width 12 (bucket 16 — the width
     change that wedged the pump);
  3. the device first-use counter (``device._program_first_use``,
     ``device.JIT["miss"]``) must not move: every program the drive
     dispatched was already warm, and every program it touched is in
     the manifest.

On the card this needs a fresh process (nothing may be warm before
step 1).  With ``--cpu`` it runs the twin kernels: first-use
accounting is identical on the twin path — ``_program_first_use`` fires
per program name whatever the backend — so a manifest gap shows up as
a first use in seconds.

Usage: python -m harmony_tpu_torch.tools.compile_surface_smoke [--cpu]
(exit 0 = gate passed)

The port's copy of the JAX package's ``tools/compile_surface_smoke.py``.
"""

from __future__ import annotations

import argparse
import sys

from . import add_cpu_flag, device_checks


def fail(msg: str) -> None:
    print(f"compile_surface_smoke FAIL: {msg}", flush=True)
    sys.exit(1)


def drive_width(n_keys: int) -> list:
    """Every serving-path device entry family at one committee width;
    returns the program names dispatched (from the seen-set)."""
    from .. import bls as B
    from .. import device as DV
    from ..ref.hash_to_curve import hash_to_g2

    payload = b"compile-surface-smoke-payload-32"
    keys = [B.PrivateKey.generate(bytes([30 + n_keys + i]))
            for i in range(n_keys)]
    sigs = [k.sign_hash(payload) for k in keys]
    agg = B.aggregate_sigs(sigs)
    h = hash_to_g2(payload)
    table = DV.CommitteeTable([k.pub.point for k in keys])

    # fused quorum check (consensus pump shape), accept AND reject
    ok = DV.agg_verify_hashed_on_device(
        table, [1] * n_keys, h, agg.point)
    if not ok:
        fail(f"agg_verify accept failed at width {n_keys}")
    if DV.agg_verify_hashed_on_device(
            table, [1] * (n_keys - 1) + [0], h, agg.point):
        fail(f"agg_verify reject failed at width {n_keys}")

    # batched replay (sync/catch-up shape)
    batch = DV.agg_verify_batch_on_device(
        table, [[1] * n_keys] * 3, [h] * 3, [agg.point] * 3)
    if batch != [True, True, True]:
        fail(f"agg_verify_batch failed at width {n_keys}: {batch}")

    # single check (view-change vote shape)
    if not DV.verify_on_device(keys[0].pub.point, payload,
                               sigs[0].point):
        fail(f"verify_single failed at width {n_keys}")

    # continuous-batch independent checks (scheduler coalesce shape)
    many = DV.verify_many_on_device(
        [k.pub.point for k in keys], [h] * n_keys,
        [s.point for s in sigs])
    if many != [True] * n_keys:
        fail(f"verify_many failed at width {n_keys}: {many}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from .. import aot
    from .. import device as DV

    with device_checks(args.cpu):
        manifest = aot.load_manifest()
        names = aot.manifest_names(manifest)
        if not names:
            fail("the port's manifest (aot.load_manifest) is empty")
        covered = set(names) | {"verify_w1"}

        stats = aot.startup_warmup()
        # the twins off the card, the kernels on it
        want_mode = "twin" if args.cpu else "cuda"
        if not stats or stats["mode"] != want_mode:
            fail(f"warmup did not run in {want_mode} mode: {stats}")
        # the twin mode marks the width-1 single check too
        want_warmed = len(names) + (want_mode == "twin")
        if stats["warmed"] < want_warmed or stats["failed"]:
            fail(f"warmup marked {stats['warmed']} programs "
                 f"({stats['failed']} failed), manifest has "
                 f"{want_warmed}")

        miss0, hit0 = DV.JIT["miss"], DV.JIT["hit"]
        drive_width(5)    # committee bucket 8
        drive_width(12)   # committee bucket 16 — the width change
        misses = DV.JIT["miss"] - miss0
        hits = DV.JIT["hit"] - hit0

    if misses:
        cold = sorted(DV._SEEN_PROGRAMS - covered)
        fail(f"{misses} post-warmup first use(s); programs "
             f"outside the manifest: {cold}")
    if hits <= 0:
        fail("drive dispatched no warm programs — smoke drove nothing")
    uncovered = sorted(DV._SEEN_PROGRAMS - covered)
    if uncovered:
        fail(f"programs dispatched outside the manifest: {uncovered}")

    print(
        "compile_surface_smoke OK: committee width 5 -> 12 (bucket "
        f"8 -> 16), {hits} warm dispatches, 0 post-warmup compiles "
        f"({stats['warmed']} programs warmed, mode={stats['mode']})",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
