"""Deterministic fixtures shared by the chaos runner and the
unit tiers (tests/test_staking_shard.py reuses the election fixtures so
the committee-rotation-at-epoch-boundary case and the
election-under-load scenario exercise the SAME wiring).

The port's copy of the JAX package's ``chaostest/fixtures.py``.
"""

from __future__ import annotations

import time


def paced_ticks(rate: float, stop, duration_s: float | None = None,
                ready=None):
    """Yield 0, 1, 2, ... paced at ``rate``/s until ``stop`` is set or
    ``duration_s`` elapses (None = unbounded — the caller bounds the
    iteration, e.g. by zipping a finite fixture).  ``ready`` (optional
    Event) gates the start; the pace clock begins after it opens.

    The ONE pacing loop every flood in the chaos runner, soak harness
    and their kin share — four hand-rolled copies of the
    sleep-to-target skeleton had already started to drift."""
    if ready is not None:
        ready.wait()
    start = time.monotonic()
    n = 0
    while not stop.is_set():
        now = time.monotonic()
        if duration_s is not None and now - start >= duration_s:
            return
        target = start + n / rate
        if now < target:
            # sleep in short chunks (stop-responsive) and re-check the
            # clock before yielding — a single capped sleep floors the
            # effective rate at ~1/chunk for slow tickers
            time.sleep(min(target - now, 0.05))
            continue
        yield n
        n += 1


def staking_finalizer(genesis, ecdsa_keys, *, shard_count: int = 1,
                      external_slots: int = 2):
    """A Finalizer whose harmony accounts are the dev genesis committee
    — the epoch-boundary election setup of tests/test_finalize.py, in
    one place."""
    from ..chain.finalize import FinalizeConfig, Finalizer

    harmony_accounts = [
        (k.address(), pub)
        for k, pub in zip(ecdsa_keys, genesis.committee)
    ]
    return Finalizer(FinalizeConfig(
        block_reward=28 * 10**18,
        shard_count=shard_count,
        external_slots_per_shard=external_slots,
        harmony_accounts=harmony_accounts,
    ))


def external_bls_key(seed: int, index: int = 0):
    """The i-th external validator key of a scenario seed."""
    from .. import bls as B

    return B.PrivateKey.generate(
        b"chaos-external-bls-%d-%d" % (seed, index)
    )


def observer_bls_key(seed: int, index: int = 0):
    """The i-th late-join OBSERVER key of a scenario seed:
    deterministic, never seated in any committee — the joining node
    validates and follows the chain but cannot vote, so its mid-run
    arrival never perturbs quorum arithmetic."""
    from .. import bls as B

    return B.PrivateKey.generate(
        b"chaos-observer-bls-%d-%d" % (seed, index)
    )


def external_validator_stake(staker_key, ext_bls, *, nonce: int = 0,
                             chain_id: int = 2):
    """A signed CREATE_VALIDATOR registering ``ext_bls`` with its BLS
    proof-of-possession — once committed and the election block passes,
    the epoch committee rotates to include the external key."""
    from .. import bls as B
    from ..core.types import Directive, StakingTransaction

    return StakingTransaction(
        nonce=nonce, gas_price=1, gas_limit=50_000,
        directive=Directive.CREATE_VALIDATOR,
        fields={
            "amount": 10**20,
            "min_self_delegation": 10**18,
            "bls_keys": ext_bls.pub.bytes,
            "bls_key_sigs": B.proof_of_possession(ext_bls),
        },
    ).sign(staker_key, chain_id)


def advance_with_full_bitmaps(chain, pool, n: int = 1):
    """Commit ``n`` worker-proposed blocks with full-participation
    commit proofs stored, so the next block's finalize consumes a real
    bitmap (the shape consensus produces live)."""
    from ..node.worker import Worker

    worker = Worker(chain, pool)
    for _ in range(n):
        block = worker.propose_block(view_id=chain.head_number + 1)
        if chain.insert_chain([block], verify_seals=False) != 1:
            raise RuntimeError(f"insert failed at {block.block_num}")
        committee = chain.committee_for_epoch(
            chain.epoch_of(block.block_num)
        )
        nbytes = (len(committee) + 7) >> 3
        full = bytearray([0xFF] * nbytes)
        extra = nbytes * 8 - len(committee)
        if extra:
            full[-1] &= 0xFF >> extra
        chain.write_commit_sig(
            block.block_num, b"\x01" * 96 + bytes(full)
        )
        pool.drop_applied()


def plain_transfers(count: int, tag: int):
    """Unsigned transfers + synthetic pre-recovered senders (the shape
    admission sees after signature recovery — loadgen's flood shape)."""
    from ..core.types import Transaction

    out = []
    per_sender = 16  # ACCOUNT_SLOTS: stay in the executable tier
    n_senders = (count + per_sender - 1) // per_sender
    for s in range(n_senders):
        sender = bytes([0x4c, tag, s // 256, s % 256]) + b"\x00" * 16
        for n in range(min(per_sender, count - s * per_sender)):
            out.append((Transaction(
                nonce=n, gas_price=1, gas_limit=21_000, shard_id=0,
                to_shard=0, to=b"\x2d" * 20, value=1,
            ), sender))
    return out


def overload_transfers(ecdsa_keys, *, depth: int = 80,
                       to_byte: int = 0x2e):
    """Funded-sender transfers, ``depth`` nonces deep per sender — the
    cycling overload/steady-state flood fixture (shared by
    the overload_storm scenario and harmony_tpu_torch.tools.soak so the
    two harnesses
    cannot silently diverge in the load they generate).  Depth must
    exceed the per-sender executable tier so a cycling flood can
    genuinely fill a pool's queue slots."""
    from ..core.types import Transaction

    out = []
    for key in ecdsa_keys:
        sender = key.address()
        for nonce in range(depth):
            out.append((Transaction(
                nonce=nonce, gas_price=1, gas_limit=21_000,
                shard_id=0, to_shard=0, to=bytes([to_byte]) * 20,
                value=1,
            ), sender))
    return out


def mainnet_roster(slots: int = 200, seed: int = 5,
                   committee_keys=()):
    """An EPoS auction roster at the reference's mainnet scale:
    exactly ``slots`` BLS keys spread
    over MULTI-KEY operators — the mainnet shape is ~200 slots/shard
    bound to far fewer operators.  ``committee_keys`` ride the FIRST
    operators at 16 keys apiece with the highest stakes: pass the
    wan_committee topology's live 64-key committee (dev_genesis
    keys, 4 nodes x 16 keys) and the election tier elects exactly the
    operator binding the live chaos scenario runs, inside a full
    200-slot roster.  The remaining slots belong to deterministic
    synthetic operators cycling 1..8 keys each (the election math
    never touches the curve, so their keys are hash-derived).

    Returns ``(orders, key_owner)``: ``orders`` feeds
    ``staking.effective`` / ``shard.committee``; ``key_owner`` maps
    every key to its operator address for binding assertions."""
    import hashlib

    from ..staking.effective import SlotOrder

    orders: dict = {}
    key_owner: dict = {}
    op = 0

    def add_operator(keys, stake_per_key: int):
        nonlocal op
        addr = b"op-%03d-" % op + hashlib.sha256(
            b"roster-op|%d|%d" % (seed, op)
        ).digest()[:12]
        orders[addr] = SlotOrder(
            stake=stake_per_key * len(keys),
            spread_among=list(keys), address=addr,
        )
        for k in keys:
            key_owner[k] = addr
        op += 1

    remaining = slots
    live = list(committee_keys)
    for i in range(0, len(live), 16):
        ks = live[i:i + 16]
        # strictly above every synthetic stake: the live committee
        # must win its slots
        add_operator(ks, (10_000 - op) * 10**18)
        remaining -= len(ks)
    if remaining < 0:
        raise ValueError("committee_keys exceed the roster size")
    cycle = 0
    while remaining > 0:
        n = min(1 + (cycle % 8), remaining)
        ks = [
            hashlib.sha256(
                b"roster-key|%d|%d|%d" % (seed, op, j)
            ).digest()[:24] * 2  # 48-byte pseudo pubkey
            for j in range(n)
        ]
        add_operator(ks, (5_000 - 7 * op) * 10**18)
        remaining -= n
        cycle += 1
    return orders, key_owner


def pop_submissions(count: int, tag: int, seed: int):
    """CREATE_VALIDATOR submissions whose BLS proofs-of-possession
    verify on the scheduler's INGRESS lane (2 keys each)."""
    from .. import bls as B
    from ..core.types import Directive, StakingTransaction

    out = []
    for i in range(count):
        group = i // 16
        sender = bytes([0x50, tag, group // 256, group % 256]
                       ) + b"\x00" * 16
        bks = [
            B.PrivateKey.generate(bytes([seed % 251, tag, i % 251, j]))
            for j in range(2)
        ]
        out.append((StakingTransaction(
            nonce=i % 16, gas_price=1, gas_limit=50_000,
            directive=Directive.CREATE_VALIDATOR,
            fields={
                "amount": 10**20, "min_self_delegation": 10**18,
                "bls_keys": b"".join(k.pub.bytes for k in bks),
                "bls_key_sigs": b"".join(
                    B.proof_of_possession(k) for k in bks
                ),
            },
        ), sender))
    return out
