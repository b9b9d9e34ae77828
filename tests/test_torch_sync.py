"""The port's sync against the JAX package's: ports of tests/test_node_net.py's
sync arcs (the stream, the staged download, fast sync with its forged
receipts and looping pages, committees harvested from sealed headers,
``adopt_state``, account-range paging) and seal-checked windows, a forged
one among them; the behind node and the epoch chain are in
tests/test_torch_sync_node.py.

Each scenario runs on both packages with the same inputs (``dev_genesis``
keys, fixed transactions, commit proofs signed by the dev committee) and
returns what it produced: heads, block hashes, state roots, receipts, the
sync results' errors, verdicts.  The two must be equal.  The JAX package
checks seals on its host route.  The port checks them on its host route
and, where a case says so, in device mode: every window's seals through
``Engine.verify_headers_batch``, the scheduler and ``device.py`` on the
CPU by the bigint twins (``HARMONY_KERNEL_TWIN=1``).  A window bound for
CUDA on a machine without it raises ``DeviceError`` out of ``sync_once``
and commits nothing, as does a window the governor sheds; neither is ever
answered on the host.
"""

import importlib
import types

import pytest
import torch

CHAIN_ID = 2
_MODULES = {
    "B": "bls", "DV": "device", "BC": "core.blockchain",
    "GEN": "core.genesis", "KV": "core.kv", "POOL": "core.tx_pool",
    "TY": "core.types", "RAW": "core.rawdb", "ST": "core.state",
    "SP": "core.state_processor", "W": "node.worker",
    "STREAM": "p2p.stream", "SYNC": "sync", "ENG": "chain.engine",
    "FIN": "chain.finalize", "MASK": "consensus.mask",
    "SIG": "consensus.signature", "SCHED": "sched", "GV": "governor",
    # for tests/test_torch_sync_node.py
    "MB": "multibls", "NODE": "node.node", "REG": "node.registry",
    "P2P": "p2p", "FEED": "sync.epoch_feed", "EC": "core.epochchain",
    "HDR": "chain.header", "MSG": "consensus.messages",
    "ING": "node.ingress", "SHARD": "shard.committee",
}


def _package(root):
    return types.SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")
T_SHED = importlib.import_module("harmony_tpu_torch.sched.scheduler").SHED


@pytest.fixture(autouse=True)
def _host_unless_asked(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J.DV.use_device(False)
    T.DV.use_device(False)
    T.SCHED.reset()
    fallbacks = T.DV.COUNTERS["ref_fallback"]
    yield
    T.SCHED.reset()
    T.GV.uninstall()
    T.DV.use_device(None)
    J.DV.use_device(None)
    assert T.DV.COUNTERS["ref_fallback"] == fallbacks


def _device_mode(monkeypatch):
    """The port's checks through its scheduler and device.py, on the CPU
    by the twins."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T.DV.use_device(True, device="cpu")
    T.SCHED.reset()


def _both(scenario, *args):
    want = scenario(J, *args)
    got = scenario(T, *args)
    assert got == want
    return got


_JAX: dict = {}


def _jax(scenario, *args):
    """The JAX package's result of a scenario, computed once."""
    key = (scenario, args)
    if key not in _JAX:
        _JAX[key] = scenario(J, *args)
    return _JAX[key]


# -- chains to serve --------------------------------------------------------


def _chain_with_blocks(m, n=3):
    """n blocks of one transfer each, with placeholder commit proofs (the
    JAX tests' chain for unsealed sync)."""
    genesis, keys, _ = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    for i in range(n):
        pool.add(m.TY.Transaction(
            nonce=i, gas_price=1, gas_limit=25_000, shard_id=0,
            to_shard=0, to=b"\x05" * 20, value=100 + i,
        ).sign(keys[0], CHAIN_ID))
        block = worker.propose_block(view_id=i + 1)
        chain.insert_chain([block], verify_seals=False)
        chain.write_commit_sig(block.block_num, b"\x01" * 96 + b"\x0f")
        pool.drop_applied()
    return chain, genesis


def _proof(m, chain, header, bls_keys, signers, payload=None):
    """[aggregate signature || bitmap] of ``signers`` over the header's
    commit payload (or over ``payload``)."""
    if payload is None:
        payload = m.SIG.construct_commit_payload(
            header.hash(), header.block_num, header.view_id,
            chain.config.is_staking(header.epoch))
    agg = m.B.aggregate_sigs([bls_keys[i].sign_hash(payload)
                              for i in signers])
    mask = m.MASK.Mask([k.pub.point for k in bls_keys])
    for i in signers:
        mask.set_bit(i, True)
    return agg.bytes + mask.mask_bytes()


def _sealed_chain(m, n=5, bpe=16, finalizer=None):
    """n blocks of one transfer each, every block sealed by a commit proof
    of three of the four dev keys; block i+1's header carries block i's
    proof."""
    genesis, keys, bls_keys = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=bpe,
                            finalizer=finalizer)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    for i in range(n):
        pool.add(m.TY.Transaction(
            nonce=i, gas_price=1, gas_limit=25_000, shard_id=0,
            to_shard=0, to=b"\x05" * 20, value=100 + i,
        ).sign(keys[0], CHAIN_ID))
        block = worker.propose_block(view_id=i + 1)
        chain.insert_chain([block], verify_seals=False)
        chain.write_commit_sig(block.block_num, _proof(
            m, chain, block.header, bls_keys, (0, 1, 3)))
        pool.drop_applied()
    return chain, genesis, bls_keys


def _engine(m, cell, device=False):
    """An Engine over the chain's own committees, as the node's boot wires
    it; ``device=None`` resolves as the node does (the port's device mode
    then takes the device path)."""
    return m.ENG.Engine(lambda shard, epoch: m.ENG.EpochContext(
        cell[0].committee_for_epoch(epoch)), device=device)


def _checked_chain(m, genesis, device=False, **kw):
    cell = []
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16,
                            engine=_engine(m, cell, device), **kw)
    cell.append(chain)
    return chain


def _digest(chain):
    out = []
    for num in range(1, chain.head_number + 1):
        h = chain.header_by_number(num)
        out.append((h.hash(), h.root, h.receipt_root,
                    chain.read_commit_sig(num)))
    return out, chain.state().root()


# -- the stream and the staged download --------------------------------------


def _stream_and_download(m):
    serving, genesis = _chain_with_blocks(m, 3)
    srv = m.STREAM.SyncServer(serving)
    try:
        cli = m.STREAM.SyncClient(srv.port)
        head, head_hash = cli.get_head()
        assert head == 3 and head_hash == serving.current_header().hash()
        hashes = cli.get_block_hashes(1, 3)
        blocks = cli.get_blocks_by_number(1, 2)
        assert [b.block_num for b, _ in blocks] == [1, 2]
        assert blocks[0][0].hash() == hashes[0] and blocks[0][1]
        fresh = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        res = m.SYNC.Downloader(fresh, [m.STREAM.SyncClient(srv.port)],
                                batch=2, verify_seals=False).sync_once()
        cli.close()
        return hashes, res.inserted, res.errors, _digest(fresh)
    finally:
        srv.close()


def test_sync_stream_and_staged_download():
    hashes, inserted, errors, _ = _both(_stream_and_download)
    assert len(hashes) == 3 and inserted == 3 and not errors


def _fast_sync(m):
    serving, genesis = _chain_with_blocks(m, 4)
    srv = m.STREAM.SyncServer(serving)
    try:
        fresh = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        dl = m.SYNC.Downloader(fresh, [m.STREAM.SyncClient(srv.port)],
                               batch=2, verify_seals=False)
        # fast sync must not execute: poison the processor
        dl.chain.processor = None
        res = dl.fast_sync(receipts_tail=2)
        assert fresh.state().root() == serving.state().root()
        tail = [[r.encode() for r in m.RAW.read_receipts(fresh.db, n)]
                for n in (2, 3, 4)]
        assert tail[1:] == [[r.encode() for r in m.RAW.read_receipts(
            serving.db, n)] for n in (3, 4)]
        fresh.processor = m.SP.StateProcessor(CHAIN_ID, 0)
        return res.inserted, res.errors, fresh.head_number, tail, \
            fresh.state().root()
    finally:
        srv.close()


def test_fast_sync_joins_head_without_replay():
    inserted, errors, head, tail, _ = _both(_fast_sync)
    assert inserted == 4 and not errors and head == 4
    assert not tail[0] and tail[1] and tail[2]


def _forged_receipts(m):
    serving, genesis = _chain_with_blocks(m, 3)
    srv = m.STREAM.SyncServer(serving)

    class ForgingClient(m.STREAM.SyncClient):
        def get_receipts(self, start, count, deadline=None):
            per_block = super().get_receipts(start, count, deadline)
            for receipts in per_block:
                for r in receipts:
                    r.status = 0
            return per_block

    try:
        fresh = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        res = m.SYNC.Downloader(fresh, [ForgingClient(srv.port)], batch=2,
                                verify_seals=False).fast_sync(
                                    receipts_tail=2)
        refused = m.RAW.read_receipts(fresh.db, 3)
        m.SYNC.Downloader(fresh, [m.STREAM.SyncClient(srv.port)], batch=2,
                          verify_seals=False).fast_sync(receipts_tail=2)
        return fresh.head_number, res.errors, refused
    finally:
        srv.close()


def test_fast_sync_rejects_forged_receipts():
    head, errors, refused = _both(_forged_receipts)
    assert head == 3 and not refused
    assert any("receipts commitment mismatch" in e for e in errors)


def _looping_pages(m):
    serving, genesis = _chain_with_blocks(m, 3)
    srv = m.STREAM.SyncServer(serving)

    class LoopingClient(m.STREAM.SyncClient):
        def get_account_range(self, num, start, deadline=None):
            return super().get_account_range(num, b"")

    try:
        fresh = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        res = m.SYNC.Downloader(
            fresh, [LoopingClient(srv.port), m.STREAM.SyncClient(srv.port)],
            batch=2, verify_seals=False).fast_sync(receipts_tail=1)
        assert fresh.state().root() == serving.state().root()
        return res.inserted, res.errors, fresh.state().root()
    finally:
        srv.close()


def test_fast_sync_rotates_on_non_advancing_account_pages():
    inserted, errors, _ = _both(_looping_pages)
    assert inserted == 3 and not errors


def _finalizer(m, genesis, ecdsa_keys):
    return m.FIN.Finalizer(m.FIN.FinalizeConfig(
        block_reward=28 * 10**18, shard_count=1, external_slots_per_shard=2,
        harmony_accounts=[(k.address(), pub) for k, pub in
                          zip(ecdsa_keys, genesis.committee)]))


def _harvest(m, device=False):
    """Fast sync across an election: the next epoch's committee comes from
    the sealed election header, never from a peer's epoch-state blob; a
    corrupted seal in the window refuses the whole fast sync."""
    genesis, ecdsa_keys, bls_keys = m.GEN.dev_genesis()

    def checked():
        cell = []
        chain = m.BC.Blockchain(
            m.KV.MemKV(), genesis, blocks_per_epoch=4,
            finalizer=_finalizer(m, genesis, ecdsa_keys),
            engine=_engine(m, cell, device))
        cell.append(chain)
        return chain

    serving = checked()
    worker = m.W.Worker(serving, None)
    for i in range(5):  # block 3 elects epoch 1's committee
        block = worker.propose_block(view_id=i + 1)
        serving.insert_chain([block], verify_seals=False)
        serving.write_commit_sig(block.block_num, _proof(
            m, serving, block.header, bls_keys, range(4)))
    assert serving.header_by_number(3).shard_state
    srv = m.STREAM.SyncServer(serving)
    try:
        fresh = checked()
        client = m.STREAM.SyncClient(srv.port)
        client.get_epoch_state = None  # the trustless path never asks
        res = m.SYNC.Downloader(fresh, [client], batch=2,
                                verify_seals=True).fast_sync(receipts_tail=1)
        assert fresh.committee_for_epoch(1) == serving.committee_for_epoch(1)
        blob = serving.read_commit_sig(2)
        serving.write_commit_sig(2, blob[:10] + b"\x00" * 86 + blob[96:])
        refused = checked()
        res2 = m.SYNC.Downloader(refused, [m.STREAM.SyncClient(srv.port)],
                                 batch=5, verify_seals=True).fast_sync()
        serving.write_commit_sig(2, blob)
        return (res.inserted, res.errors, _digest(fresh),
                fresh.committee_for_epoch(1), bool(res2.errors),
                refused.head_number)
    finally:
        srv.close()


@pytest.mark.parametrize("mode", ("host", "device"))
def test_fast_sync_harvests_committees_from_sealed_headers(mode,
                                                           monkeypatch):
    want = _jax(_harvest)
    if mode == "device":
        _device_mode(monkeypatch)
        before = T.DV.COUNTERS["batch_verify"]
    got = _harvest(T, device=None if mode == "device" else False)
    assert got == want
    assert got[0] == 5 and not got[1] and got[4] and got[5] == 0
    if mode == "device":
        assert T.DV.COUNTERS["batch_verify"] > before


def _adopt_forged(m):
    serving, _ = _chain_with_blocks(m, 2)
    forged = m.ST.StateDB({b"\x07" * 20: serving.state().account(
        b"\x07" * 20)})
    forged.add_balance(b"\x07" * 20, 10**18)
    with pytest.raises(m.BC.ChainError) as e:
        serving.adopt_state(2, forged)
    return str(e.value), serving.head_number


def test_adopt_state_rejects_forged_accounts():
    _both(_adopt_forged)


def _paging(m):
    serving, _ = _chain_with_blocks(m, 3)
    srv = m.STREAM.SyncServer(serving)
    try:
        cli = m.STREAM.SyncClient(srv.port)
        start, got = b"", []
        while True:
            page = cli.get_account_range(3, start, limit=2)
            got.extend(page)
            if not page:
                break
            start = page[-1][0]
        live = dict(serving.state_at(3)._live_accounts())
        assert [a for a, _ in got] == sorted(live)
        assert all(blob == live[a].encode() for a, blob in got)
        cli.close()
        return got
    finally:
        srv.close()


def test_account_range_pagination_covers_state():
    _both(_paging)


# -- seal-checked windows ---------------------------------------------------

FORGED_AT = 3


def _sealed_sync(m, device=False):
    """A full replay in two windows of 2 with every seal checked, then a
    window whose proof is a signature over the wrong payload: refused,
    and nothing after it is inserted."""
    serving, genesis, bls_keys = _sealed_chain(m, 4)
    srv = m.STREAM.SyncServer(serving)

    class ForgingClient(m.STREAM.SyncClient):
        def get_blocks_by_number(self, start, count, deadline=None):
            items = super().get_blocks_by_number(start, count, deadline)
            return [(blk, _proof(m, serving, blk.header, bls_keys,
                                 (0, 1, 3), payload=b"\x42" * 32)
                     if blk.block_num == FORGED_AT else sig)
                    for blk, sig in items]

    try:
        fresh = _checked_chain(m, genesis, device)
        res = m.SYNC.Downloader(fresh, [m.STREAM.SyncClient(srv.port)],
                                batch=2, verify_seals=True).sync_once()
        forged = _checked_chain(m, genesis, device)
        bad = m.SYNC.Downloader(forged, [ForgingClient(srv.port)], batch=2,
                                verify_seals=True).sync_once()
        assert m.RAW.read_head_number(forged.db) == forged.head_number
        return (res.inserted, res.errors, _digest(fresh),
                _digest(serving) == _digest(fresh), bad.inserted,
                bad.errors, forged.head_number)
    finally:
        srv.close()


@pytest.mark.parametrize("mode", ("host", "device"))
def test_sync_checks_every_windows_seals(mode, monkeypatch):
    want = _jax(_sealed_sync)
    if mode == "device":
        _device_mode(monkeypatch)
        before = T.DV.COUNTERS["batch_verify"]
    got = _sealed_sync(T, device=None if mode == "device" else False)
    assert got == want
    inserted, errors, _, same, bad_inserted, bad_errors, head = got
    assert inserted == 4 and not errors and same
    assert bad_inserted == 2 and head == 2
    assert bad_errors == [f"insert failed at {FORGED_AT}: bad commit "
                          f"signature on block {FORGED_AT}"]
    if mode == "device":
        # windows [1, 2] and [3, 4]: the full replay's two and the forged
        # run's two, each one batch of the device path
        assert T.DV.COUNTERS["batch_verify"] - before == 4


@pytest.fixture
def bound_for_the_card(monkeypatch):
    """The node's device set to CUDA on a machine without it; committee
    tables keep their keys on the meta device but report CUDA, so a check
    reaches its dispatch, which fails here."""
    init = T.DV.CommitteeTable._init

    def on_meta(self, arr, n, device, points):
        init(self, arr, n, "meta", points)
        self.device = torch.device("cuda")

    from harmony_tpu_torch import resilience as RS

    monkeypatch.setattr(T.DV.CommitteeTable, "_init", on_meta)
    monkeypatch.setattr(T.DV, "_TABLE_CACHE", {})
    monkeypatch.setattr(T.DV, "BREAKER", RS.CircuitBreaker("device", 100,
                                                           30.0))
    T.DV.use_device(True, device="cuda")
    T.SCHED.reset()


def _window_bound_for_the_card():
    serving, genesis, _ = _sealed_chain(T, 2)
    srv = T.STREAM.SyncServer(serving)
    try:
        fresh = _checked_chain(T, genesis, device=None)
        assert fresh.engine.device is True
        with pytest.raises(T.DV.DeviceError):
            T.SYNC.Downloader(fresh, [T.STREAM.SyncClient(srv.port)],
                              batch=2, verify_seals=True).sync_once()
        assert fresh.head_number == 0
        assert T.RAW.read_head_number(fresh.db) == 0
        assert fresh.read_commit_sig(1) is None
    finally:
        srv.close()


def test_a_window_bound_for_the_card_commits_nothing(bound_for_the_card):
    """The window's seal batch raises DeviceError out of sync_once; the
    chain and its store keep head 0; no check falls back to the host."""
    fallbacks = T.DV.COUNTERS["ref_fallback"]
    _window_bound_for_the_card()
    assert T.DV.COUNTERS["ref_fallback"] == fallbacks


def test_a_window_the_governor_sheds_fails(bound_for_the_card):
    """Under a CRITICAL governor the SYNC lane sheds; bound for the card,
    the shed is a DeviceError (a failed window), never a host answer."""
    gov = T.GV.ResourceGovernor(sample_fn=lambda: {})
    gov._state = T.GV.Tier.CRITICAL
    T.GV.install(gov)
    sheds = T_SHED.total()
    _window_bound_for_the_card()
    assert T_SHED.total() > sheds
