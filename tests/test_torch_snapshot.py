"""The port's state pruning and snapshots against the JAX package's: the
fault of an insert under ``state_retention`` (the port had no
``core/snapshot.py``: the store's head moved and the chain's did not),
and ports of tests/test_snapshot.py's prune, retention, export and import
tests and its serve-and-import path over ``p2p/stream.py``.

Each scenario runs on both packages with the same inputs (``dev_genesis``
keys, fixed transactions) and returns what it produced: heads, block
hashes, state roots, the raised errors, the snapshot files' bytes.  The
two must be equal.  Seal checks are off here, as in the JAX tests; the
seal-checked sync is in tests/test_torch_sync.py.
"""

import importlib
import threading
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "RAW": "core.rawdb", "SN": "core.snapshot", "BC": "core.blockchain",
    "GEN": "core.genesis", "KV": "core.kv", "POOL": "core.tx_pool",
    "TY": "core.types", "W": "node.worker", "CX": "node.cross_shard",
    "STREAM": "p2p.stream", "SYNC": "sync.staged", "PROF": "prof",
}


def _package(root):
    return types.SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


def _both(scenario, *args):
    """scenario(m, *args) on each package; the two results must be
    equal."""
    want = scenario(J, *args)
    got = scenario(T, *args)
    assert got == want
    return got


def _grow(m, chain, keys, n, start_nonce=0):
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    for i in range(n):
        pool.add(m.TY.Transaction(
            nonce=start_nonce + i, gas_price=1, gas_limit=25_000,
            shard_id=0, to_shard=0, to=b"\x07" * 20, value=50 + i,
        ).sign(keys[0], CHAIN_ID))
        block = worker.propose_block(view_id=chain.head_number + 1)
        chain.insert_chain([block], verify_seals=False)
        pool.drop_applied()


def _fresh_chain(m, db=None, **kw):
    genesis, keys, _ = m.GEN.dev_genesis()
    return m.BC.Blockchain(db or m.KV.MemKV(), genesis,
                           blocks_per_epoch=16, **kw), keys


def _missing(m, fn):
    """The chain error a pruned read raises, or None."""
    try:
        fn()
    except m.BC.ChainError as e:
        return str(e)
    return None


# -- the fault: an insert under state_retention -----------------------------


def _retained_inserts(m):
    """Three inserts in a row on a chain that keeps one state: after each,
    the store's head and the chain's agree.  The empty blocks share one
    state root, so the retained window keeps it (the pruned read is
    whatever the reference gives)."""
    genesis, _, _ = m.GEN.dev_genesis()
    db = m.KV.MemKV()
    chain = m.BC.Blockchain(db, genesis, blocks_per_epoch=16,
                            state_retention=1)
    worker = m.W.Worker(chain)
    heads = []
    for view in (1, 2, 3):
        block = worker.propose_block(view_id=view)
        assert chain.insert_chain([block], verify_seals=False) == 1
        assert m.RAW.read_head_number(db) == chain.head_number
        heads.append((chain.head_number, block.hash(),
                      chain.state().root()))
    return heads, _missing(m, lambda: chain.state_at(1))


def test_insert_under_state_retention_moves_both_heads():
    heads, _ = _both(_retained_inserts)
    assert [h for h, _, _ in heads] == [1, 2, 3]


# -- prune and retention ----------------------------------------------------


def _bulk_prune(m):
    chain, keys = _fresh_chain(m)
    _grow(m, chain, keys, 6)
    dropped = m.SN.prune_states(chain, retain=3)
    assert dropped > 0
    kept = [chain.state_at(n).root() for n in range(4, 7)]
    headers = [chain.header_by_number(n).hash() for n in range(7)]
    return (dropped, kept, headers, _missing(m, lambda: chain.state_at(2)),
            chain.state_at(0).root())


def test_bulk_prune_drops_old_states_keeps_window():
    out = _both(_bulk_prune)
    assert "missing state" in out[3]


def _retention(m):
    chain, keys = _fresh_chain(m, state_retention=2)
    _grow(m, chain, keys, 6)
    return (chain.state_at(6).root(), chain.state_at(5).root(),
            _missing(m, lambda: chain.state_at(3)))


def test_incremental_retention_on_insert():
    assert "missing state" in _both(_retention)[2]


def _shared_root(m):
    chain, keys = _fresh_chain(m)
    _grow(m, chain, keys, 2)
    h1, h2 = chain.header_by_number(1), chain.header_by_number(2)
    pruned = m.SN.prune_state_at(chain, 1)
    assert pruned == (h1.root != h2.root)
    return pruned, chain.state_at(2).root()


def test_shared_root_never_lost():
    _both(_shared_root)


# -- export and import ------------------------------------------------------


def _roundtrip(m, path):
    chain, keys = _fresh_chain(m)
    _grow(m, chain, keys, 5)
    assert m.SN.export_snapshot(chain, path) == 5
    blob = open(path, "rb").read()
    m.SN.prune_states(chain, retain=1)
    m.RAW.delete_state(chain.db, chain.current_header().root)
    db = chain.db
    with pytest.raises(m.BC.ChainError, match="missing state"):
        _fresh_chain(m, db=db)
    # a maintenance-shaped object: the damaged store cannot build a chain
    maint = types.SimpleNamespace(
        db=db, config=chain.config, _insert_lock=threading.RLock(),
        head_number=5, _committee_cache={})
    assert m.SN.import_snapshot(maint, path) == 5
    again, keys = _fresh_chain(m, db=db)
    assert again.head_number == 5
    _grow(m, again, keys, 1, start_nonce=5)
    return blob, again.head_number, again.current_header().hash()


def test_snapshot_roundtrip_restores_pruned_node(tmp_path):
    """The snapshot files are equal byte for byte, and each package's
    restored chain extends to the same block."""
    _both(lambda m: _roundtrip(m, str(tmp_path / f"{m.name}.snap")))


def _forged(m, path):
    chain, keys = _fresh_chain(m)
    _grow(m, chain, keys, 3)
    m.SN.export_snapshot(chain, path)
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(m.SN.SnapshotError) as e:
        m.SN.import_snapshot(chain, path)
    return str(e.value)


def test_snapshot_import_rejects_forged_accounts(tmp_path):
    _both(lambda m: _forged(m, str(tmp_path / f"{m.name}.snap")))


def _trust(m, path):
    chain, keys = _fresh_chain(m)
    _grow(m, chain, keys, 3)
    m.SN.export_snapshot(chain, path)
    fresh, _ = _fresh_chain(m)
    with pytest.raises(m.SN.SnapshotError, match="trust"):
        m.SN.import_snapshot(fresh, path)
    assert m.SN.import_snapshot(fresh, path, trust=True) == 3
    assert fresh.state().root() == chain.state().root()
    return fresh.head_number, fresh.state().root()


def test_snapshot_import_fresh_node_requires_trust(tmp_path):
    _both(lambda m: _trust(m, str(tmp_path / f"{m.name}.snap")))


def _cx_marks(m, tmp):
    g0, keys, _ = m.GEN.dev_genesis()
    g1 = m.GEN.Genesis(config=g0.config, shard_id=1, alloc=dict(g0.alloc),
                       committee=list(g0.committee))
    c0 = m.BC.Blockchain(m.KV.MemKV(), g0, blocks_per_epoch=16)
    c1 = m.BC.Blockchain(m.KV.MemKV(), g1, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, c0.state)
    pool.add(m.TY.Transaction(
        nonce=0, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=1,
        to=b"\x0c" * 20, value=555).sign(keys[0], CHAIN_ID))
    assert c0.insert_chain([m.W.Worker(c0, pool).propose_block(view_id=1)],
                           verify_seals=False) == 1
    proofs = m.CX.export_receipts(c0, 1, shard_count=2)
    b1 = m.W.Worker(c1, None).propose_block(
        view_id=1, incoming_receipts=[proofs[1]])
    assert c1.insert_chain([b1], verify_seals=False) == 1
    assert m.RAW.is_cx_spent(c1.db, 0, 1)
    path = f"{tmp}/{m.name}-s1.snap"
    assert m.SN.export_snapshot(c1, path) == 1
    m.RAW.delete_state(c1.db, c1.current_header().root)
    assert m.SN.import_snapshot(c1, path) == 1
    spent = (m.RAW.is_cx_spent(c1.db, 0, 1), m.RAW.cx_spender(c1.db, 0, 1))
    path0 = f"{tmp}/{m.name}-s0.snap"
    assert m.SN.export_snapshot(c0, path0) == 1
    m.RAW.delete_state(c0.db, c0.current_header().root)
    assert m.SN.import_snapshot(c0, path0) == 1
    assert m.CX.export_receipts(c0, 1, shard_count=2) == proofs
    return (c1.state().balance(b"\x0c" * 20), spent,
            [r.encode() for r in m.RAW.read_receipts(c0.db, 1)])


def test_snapshot_import_preserves_cx_marks(tmp_path):
    balance, spent, receipts = _both(_cx_marks, str(tmp_path))
    assert balance == 555 and spent == (True, 1) and receipts


# -- the served snapshot: a late joiner's bootstrap over p2p/stream ----------


def _serve_import(m, n_accounts):
    """Export, serve, import: a late joiner bootstraps from the served
    pages (``install_snapshot``) and replays a tail whose cross-shard
    receipts it re-derives."""
    genesis, keys, _ = m.GEN.dev_genesis(n_accounts=n_accounts,
                                         flat_root=True)
    serving = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    _grow(m, serving, keys, 3)
    srv = m.STREAM.SyncServer(serving)
    try:
        joiner = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16,
                                 state_retention=1)
        dl = m.SYNC.Downloader(joiner, [m.STREAM.SyncClient(srv.port)],
                               batch=2, verify_seals=False,
                               snapshot_threshold=2)
        first = dl.sync_once()
        assert dl.snapshot_bootstraps == 1
        assert dl.last_snapshot_block == 3
        head = (joiner.head_number, joiner.current_header().hash(),
                joiner.state().root())
        assert head == (3, serving.current_header().hash(),
                        serving.state().root())
        pool = m.POOL.TxPool(CHAIN_ID, 0, serving.state)
        pool.add(m.TY.Transaction(
            nonce=3, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=1,
            to=b"\x0c" * 20, value=777).sign(keys[0], CHAIN_ID))
        block = m.W.Worker(serving, pool).propose_block(view_id=4)
        serving.insert_chain([block], verify_seals=False)
        tail = dl.sync_once()
        want = m.RAW.read_receipts(serving.db, 4)
        assert want and m.RAW.read_receipts(joiner.db, 4) == want
        assert (m.CX.export_receipts(joiner, 4, shard_count=2)
                == m.CX.export_receipts(serving, 4, shard_count=2))
        return (first.inserted, first.errors, tail.inserted, head,
                joiner.head_number, joiner.state().root(),
                [r.encode() for r in want])
    finally:
        srv.close()


def test_snapshot_serve_import_roundtrip():
    """At 500 accounts (the JAX test's 10^4 cut for time), under
    ``state_retention=1`` on the joiner."""
    out = _both(_serve_import, 500)
    assert out[4] == 4


def _resync(m):
    serving, keys = _fresh_chain(m)
    _grow(m, serving, keys, 4)
    pruned, _ = _fresh_chain(m)
    srv = m.STREAM.SyncServer(serving)
    try:
        dl = m.SYNC.Downloader(pruned, [m.STREAM.SyncClient(srv.port)],
                               batch=2, verify_seals=False)
        dl.sync_once()
        assert pruned.head_number == 4
        m.SN.prune_states(pruned, retain=1)
        gone = _missing(m, lambda: pruned.state_at(2))
        _grow(m, serving, keys, 1, start_nonce=4)
        dl.sync_once()
        return (gone, pruned.head_number, pruned.current_header().hash()
                == serving.current_header().hash())
    finally:
        srv.close()


def test_pruned_node_resyncs_history_state():
    gone, head, same = _both(_resync)
    assert gone is not None and head == 5 and same


# -- prof.stage around export and install ------------------------------------


def test_snapshot_stages_record_only_when_profiling(tmp_path):
    """The port's ``prof.stage("snapshot.export")`` and
    ``("snapshot.install")`` record nothing while the profiler is off and
    one observation each while it is on."""
    P = T.PROF
    P.reset()
    try:
        P.configure(enabled=False)
        chain, keys = _fresh_chain(T)
        _grow(T, chain, keys, 1)
        path = str(tmp_path / "p.snap")
        fresh, _ = _fresh_chain(T)
        T.SN.export_snapshot(chain, path)
        T.SN.import_snapshot(fresh, path, trust=True)
        assert not {"snapshot.export", "snapshot.install"} & set(
            P.stage_summary())
        P.configure(enabled=True)
        fresh, _ = _fresh_chain(T)
        T.SN.export_snapshot(chain, path)
        T.SN.import_snapshot(fresh, path, trust=True)
        summary = P.stage_summary()
        assert summary["snapshot.export"]["count"] == 1
        assert summary["snapshot.install"]["count"] == 1
    finally:
        P.reset()
