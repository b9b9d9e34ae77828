"""Storage crash-point sweep: kill a block commit at every point,
reopen, machine-check the consistency invariants.

The durability gate (check.sh's crash-consistency stage).  Three sweeps, all
over REAL chain workloads (dev-genesis chain, worker-proposed blocks,
commit proofs stored, ``require_commit_sigs=True`` on reopen):

1. **Fault-point sweep** — ``FileKV.write_batch`` fires the
   ``kv.commit`` faultinject point before the BEGIN marker, before
   every record, and before the COMMIT marker.  For every point k the
   sweep arms a one-shot crash at k, inserts the next block, lets the
   injected crash kill the write, abandons the store un-closed (writes
   are unbuffered — exactly a SIGKILL's disk state), reopens the
   chain, and asserts: head rolled back to the pre-insert block with
   header + state + commit sig all present, and re-inserting the same
   block succeeds with NO manual repair.

2. **Byte-truncation sweep** — the same insert's on-disk extent is cut
   at every byte offset (stride configurable) into a copy; reopening
   must yield the pre-insert head (torn batch discarded by replay) at
   every offset except the full length (committed batch visible), and
   the store must accept the re-insert.

3. **Native parity** — every truncated copy from (2) is also opened
   with the C++ store (same on-disk format: the port's own build of
   ``harmony_tpu_torch/native/kvstore.cpp``, ``core/kv_native.py``);
   its recovered head and head-record presence must agree with
   FileKV's verdict.  ``--no-native`` skips it.

Every reported number is tagged ``source: measured`` and named
``crash_*``.  Storage only: no signature is checked, so the sweep needs
no card.  ``--bench-out`` writes only the file the caller names.

Usage:
    python -m harmony_tpu_torch.tools.crash_sweep            # full sweep
    python -m harmony_tpu_torch.tools.crash_sweep --check    # the gate
    python -m harmony_tpu_torch.tools.crash_sweep --stride 7 --blocks 2
    python -m harmony_tpu_torch.tools.crash_sweep --check --bench-out OUT.json

The port's copy of the JAX package's ``tools/crash_sweep.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def _build_chain(path: str, blocks: int):
    """A durable chain with ``blocks`` committed blocks, each carrying
    a stored commit proof (the consensus shape recovery requires)."""
    from ..core.blockchain import Blockchain
    from ..core.genesis import dev_genesis
    from ..core.kv import FileKV

    genesis, _, _ = dev_genesis()
    chain = Blockchain(FileKV(path), genesis, blocks_per_epoch=64,
                       require_commit_sigs=True)
    _grow(chain, blocks)
    return chain, genesis


def _proof_for(chain, block) -> bytes:
    committee = chain.committee_for_epoch(
        chain.epoch_of(block.block_num)
    )
    nbytes = (len(committee) + 7) >> 3
    return b"\x01" * 96 + b"\xff" * nbytes


def _grow(chain, blocks: int):
    from ..node.worker import Worker

    worker = Worker(chain, None)
    for _ in range(blocks):
        block = worker.propose_block(view_id=chain.head_number + 1)
        n = chain.insert_chain(
            [block], commit_sigs=[_proof_for(chain, block)],
            verify_seals=False,
        )
        if n != 1:
            raise RuntimeError(f"insert failed at {block.block_num}")


def _next_block(chain):
    from ..node.worker import Worker

    block = Worker(chain, None).propose_block(
        view_id=chain.head_number + 1
    )
    return block, _proof_for(chain, block)


def _reopen(path: str, genesis):
    from ..core.blockchain import Blockchain
    from ..core.kv import FileKV

    return Blockchain(FileKV(path), genesis, blocks_per_epoch=64,
                      require_commit_sigs=True)


def _assert_consistent(chain, want_head: int, tag: str, failures: list):
    """The reopen invariant: head == want_head with header, state and
    commit sig all present and bound (Blockchain.__init__ already
    verified state-root binding; this re-checks the read surface)."""
    from ..core import rawdb

    ok = True
    if chain.head_number != want_head:
        failures.append(f"{tag}: head {chain.head_number} != {want_head}")
        ok = False
    header = chain.current_header()
    if header is None:
        failures.append(f"{tag}: no header at recovered head")
        return False
    if rawdb.read_state(chain.db, header.root) is None:
        failures.append(f"{tag}: no state at recovered head")
        ok = False
    if want_head > 0 and chain.read_commit_sig(chain.head_number) is None:
        failures.append(f"{tag}: no commit sig at recovered head")
        ok = False
    return ok


def sweep_fault_points(workdir: str, blocks: int, failures: list):
    """Sweep 1: enumerate every kv.commit crash point of one block
    insert; kill at each, reopen, verify, re-insert."""
    from .. import faultinject as FI

    base = os.path.join(workdir, "base.kv")
    chain, genesis = _build_chain(base, blocks)
    chain.db.close()

    # count the points: a sentinel rule that never fires arms the
    # registry so fire() counts hits during a dry-run insert
    dry = os.path.join(workdir, "dry.kv")
    shutil.copyfile(base, dry)
    FI.reset()
    FI.arm("kv.commit", key="__count_only__", after=10**9)
    chain = _reopen(dry, genesis)
    block, proof = _next_block(chain)
    before = FI.hits("kv.commit")
    chain.insert_chain([block], commit_sigs=[proof], verify_seals=False)
    points = FI.hits("kv.commit") - before
    chain.db.close()
    FI.reset()
    if points < 3:
        failures.append(f"fault-point sweep: only {points} crash "
                        "points enumerated (instrumentation broken?)")
        return 0

    for k in range(points):
        path = os.path.join(workdir, f"fp{k}.kv")
        shutil.copyfile(base, path)
        chain = _reopen(path, genesis)
        block, proof = _next_block(chain)
        FI.reset()
        FI.arm("kv.commit", key=path, after=k, times=1)
        crashed = False
        try:
            chain.insert_chain([block], commit_sigs=[proof],
                               verify_seals=False)
        except FI.FaultInjected:
            crashed = True
        except Exception as e:  # noqa: BLE001 — a different error IS
            # a finding: the commit path must only die at the armed
            # point, never wedge some other way
            failures.append(f"fault point {k}: unexpected {e!r}")
        FI.reset()
        if not crashed:
            failures.append(f"fault point {k}: crash never fired "
                            f"({points} points enumerated)")
        # abandon WITHOUT close: unbuffered writes = SIGKILL disk state
        reopened = _reopen(path, genesis)
        if _assert_consistent(reopened, blocks, f"fault point {k}",
                              failures):
            # zero manual repair: the same block must insert cleanly
            try:
                n = reopened.insert_chain(
                    [block], commit_sigs=[proof], verify_seals=False
                )
                if n != 1 or reopened.head_number != blocks + 1:
                    failures.append(
                        f"fault point {k}: re-insert after recovery "
                        f"landed {n} blocks (head "
                        f"{reopened.head_number})"
                    )
            except Exception as e:  # noqa: BLE001
                failures.append(f"fault point {k}: re-insert raised "
                                f"{e!r}")
        reopened.db.close()
        os.unlink(path)
    return points


def sweep_truncation(workdir: str, blocks: int, stride: int,
                     failures: list, native: bool):
    """Sweeps 2+3: cut the last block's on-disk extent at every byte
    offset; FileKV reopen must discard the torn batch, and the native
    store must agree."""
    from ..core import rawdb

    base = os.path.join(workdir, "tbase.kv")
    chain, genesis = _build_chain(base, blocks)
    size_before = os.path.getsize(base)
    block, proof = _next_block(chain)
    chain.insert_chain([block], commit_sigs=[proof], verify_seals=False)
    chain.db.close()
    size_after = os.path.getsize(base)

    native_kv = None
    if native:
        from ..core.kv_native import NativeKV, available

        if available():
            native_kv = NativeKV

    offsets = list(range(size_before, size_after, stride))
    offsets.append(size_after)  # the fully-committed extent
    swept = 0
    for off in offsets:
        path = os.path.join(workdir, "cut.kv")
        with open(base, "rb") as src, open(path, "wb") as dst:
            dst.write(src.read(off))
        want = blocks + 1 if off == size_after else blocks
        reopened = _reopen(path, genesis)
        tag = f"truncate@{off}"
        if _assert_consistent(reopened, want, tag, failures):
            if want == blocks:
                try:
                    n = reopened.insert_chain(
                        [block], commit_sigs=[proof], verify_seals=False
                    )
                    if n != 1:
                        failures.append(f"{tag}: re-insert landed {n}")
                except Exception as e:  # noqa: BLE001
                    failures.append(f"{tag}: re-insert raised {e!r}")
        reopened.db.close()

        if native_kv is not None:
            # parity: the C++ replay must reach the same verdict on
            # the SAME torn file (cut again — FileKV healed/extended
            # the first copy while recovering)
            with open(base, "rb") as src, open(path, "wb") as dst:
                dst.write(src.read(off))
            ndb = native_kv(path)
            nhead = rawdb.read_head_number(ndb)
            if nhead != want:
                failures.append(
                    f"{tag}: native head {nhead} != FileKV {want}"
                )
            elif rawdb.read_header(ndb, nhead) is None:
                failures.append(f"{tag}: native lost head header")
            ndb.close()
        os.unlink(path)
        swept += 1
    return swept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any crash point fails its "
                         "recovery invariant")
    ap.add_argument("--blocks", type=int, default=3,
                    help="committed blocks before the victim insert")
    ap.add_argument("--stride", type=int, default=1,
                    help="byte stride of the truncation sweep (1 = "
                         "every offset)")
    ap.add_argument("--no-native", action="store_true",
                    help="skip the native-store parity sweep")
    ap.add_argument("--bench-out", default=None,
                    help="write a BENCH round file carrying the sweep "
                         "metrics (ledger schema)")
    ap.add_argument("--bench-round", type=int, default=7)
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    failures: list = []
    workdir = tempfile.mkdtemp(prefix="harmony-crash-sweep-")
    try:
        fp = sweep_fault_points(workdir, args.blocks, failures)
        tr = sweep_truncation(workdir, args.blocks, args.stride,
                              failures, native=not args.no_native)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dur = time.monotonic() - t0

    total = fp + tr
    ok = total - len({f.split(":")[0] for f in failures})
    for f in failures:
        print(f"crash_sweep: FAIL {f}", file=sys.stderr, flush=True)
    print(
        f"crash_sweep: {total} crash points swept "
        f"({fp} fault-injection, {tr} byte-truncation incl. native "
        f"parity), {len(failures)} failure(s), {dur:.1f}s",
        file=sys.stderr, flush=True,
    )

    def _m(value, unit, **fields):
        out = {"value": value, "unit": unit, "source": "measured"}
        out.update(fields)
        return out

    extra = {
        "crash_points_swept": _m(total, "points", fault_points=fp,
                                 truncation_points=tr,
                                 stride=args.stride),
        "crash_recoveries_ok": _m(ok, "points", total=total),
        "crash_sweep_run_s": _m(round(dur, 2), "s"),
    }
    doc = {
        "metric": "crash_recoveries_ok",
        "value": ok,
        "unit": "points",
        "source": "measured",
        "extra": extra,
        "meta": {"blocks": args.blocks, "stride": args.stride,
                 "failures": failures[:50]},
    }
    print(json.dumps(doc), flush=True)
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump({
                "n": args.bench_round,
                "cmd": "python -m harmony_tpu_torch.tools.crash_sweep",
                "parsed": doc,
            }, f, indent=2)
            f.write("\n")
    return 1 if (args.check and failures) else 0


if __name__ == "__main__":
    sys.exit(main())
