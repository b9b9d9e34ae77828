"""The port's chain core against the JAX package's: ports of
tests/test_core_chain.py's ECDSA, KV store, state, transaction, tx pool,
state processor, blockchain and rawdb tests, and a datadir carried
between the packages.

Each scenario runs on both packages with the same inputs (seeded keys,
fixed transactions) and returns what it produced; the two must be equal
byte for byte: signatures, hashes, state roots and serialized state,
receipts, codec bytes, pool orderings, verdicts.  The seal checks run on
the host route in both packages, and in the port also through its
device path on the CPU (the twins).  The carried datadir shows that
``rawdb``, ``kv`` and the state encoding are one format: a ``FileKV``
written by the JAX package's chain opens in the port's, and back.
"""

import importlib
import os
import time
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "B": "bls", "DV": "device", "E": "crypto_ecdsa", "ENG": "chain.engine",
    "RAW": "core.rawdb", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "ST": "core.state", "SP": "core.state_processor",
    "POOL": "core.tx_pool", "TY": "core.types", "W": "node.worker",
    "MASK": "consensus.mask", "SIG": "consensus.signature",
    "MB": "multibls", "NODE": "node.node", "REG": "node.registry",
    "P2P": "p2p", "SCHED": "sched",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(autouse=True)
def _host_unless_asked(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J.DV.use_device(False)
    T.DV.use_device(False)
    T.SCHED.reset()
    fallbacks = T.DV.COUNTERS["ref_fallback"]
    yield
    T.SCHED.reset()
    T.DV.use_device(None)
    J.DV.use_device(None)
    assert T.DV.COUNTERS["ref_fallback"] == fallbacks


def _both(scenario, *args):
    """scenario(m, *args) on each package; the two results must be
    equal."""
    want = scenario(J, *args)
    got = scenario(T, *args)
    assert got == want
    return got


def _transfer(m, key, nonce, to, value, gas_price=1, shard=0,
              to_shard=None):
    return m.TY.Transaction(
        nonce=nonce, gas_price=gas_price, gas_limit=25_000,
        shard_id=shard, to_shard=shard if to_shard is None else to_shard,
        to=to, value=value,
    ).sign(key, CHAIN_ID)


def _staking(m, key, nonce, directive, fields):
    return m.TY.StakingTransaction(
        nonce=nonce, gas_price=1, gas_limit=50_000,
        directive=getattr(m.TY.Directive, directive), fields=fields,
    ).sign(key, CHAIN_ID)


# -- ecdsa ------------------------------------------------------------------


def _ecdsa(m):
    key = m.E.ECDSAKey.from_seed(b"alice")
    digest = bytes(range(32))
    sig = key.sign(digest)
    assert len(sig) == 65
    assert m.E.pub_to_address(m.E.recover(digest, sig)) == key.address()
    assert m.E.verify(digest, sig, key.address())
    assert key.sign(digest) == sig
    assert not m.E.verify(bytes(32), sig, key.address())
    assert int.from_bytes(sig[32:64], "big") <= m.E.N // 2
    high = bytearray(key.sign(b"\x07" * 32))
    high[32:64] = (m.E.N - int.from_bytes(high[32:64], "big")).to_bytes(
        32, "big")
    high[64] ^= 1
    with pytest.raises(ValueError):
        m.E.recover(b"\x07" * 32, bytes(high))
    return sig, key.address()


def test_ecdsa_sign_recover_and_high_s():
    _both(_ecdsa)


def test_transaction_sender_recovery():
    def scenario(m):
        key = m.E.ECDSAKey.from_seed(b"carol")
        tx = _transfer(m, key, 0, b"\x09" * 20, 5)
        assert tx.sender(CHAIN_ID) == key.address()
        out = (tx.hash(CHAIN_ID), m.RAW.encode_tx(tx, CHAIN_ID))
        tx.value = 6
        try:
            tampered = tx.sender(CHAIN_ID)
            assert tampered != key.address()
        except ValueError:
            tampered = None
        return out, tampered
    _both(scenario)


# -- kv ---------------------------------------------------------------------


def _filekv(m, path):
    db = m.KV.FileKV(path)
    db.put(b"a", b"1")
    db.put(b"b", b"2")
    db.put(b"a", b"3")
    db.delete(b"b")
    assert db.get(b"a") == b"3" and db.get(b"b") is None
    db.close()
    db = m.KV.FileKV(path)
    assert db.get(b"a") == b"3" and not db.has(b"b")
    db.put(b"c", b"4")
    db.flush()
    db.close()
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00\x00")  # a torn record at the tail
    db = m.KV.FileKV(path)
    assert db.get(b"c") == b"4"
    db.put(b"d", b"5")
    assert db.get(b"d") == b"5"
    db.close()
    with open(path, "rb") as f:
        return f.read()


def test_filekv_roundtrip_reopen_and_torn_tail(tmp_path):
    """The same operations leave the same log bytes; each package reads
    the other's log."""
    logs = _both(lambda m: _filekv(m, str(tmp_path / f"{id(m)}.log")))
    for m, other in ((T, J), (J, T)):
        path = str(tmp_path / f"cross-{id(m)}.log")
        with open(path, "wb") as f:
            f.write(logs)
        db = m.KV.FileKV(path)
        assert [db.get(k) for k in (b"a", b"b", b"c", b"d")] == \
            [b"3", None, b"4", b"5"]
        db.close()


def test_memkv_write_batch():
    def scenario(m):
        db = m.KV.MemKV()
        db.put(b"x", b"0")
        batch = m.KV.WriteBatch()
        batch.put(b"y", b"1")
        batch.delete(b"x")
        assert db.get(b"y") is None  # nothing lands before the commit
        m.KV.commit_batch(db, batch)
        return db.get(b"x"), db.get(b"y")
    assert _both(scenario) == (None, b"1")


# -- state ------------------------------------------------------------------


def _state(m):
    s = m.ST.StateDB()
    a, b = b"\x01" * 20, b"\x02" * 20
    s.add_balance(a, 100)
    s.add_balance(b, 50)
    s.set_nonce(a, 7)
    w = m.ST.ValidatorWrapper(address=b, bls_keys=[b"\x0b" * 48])
    w.delegations.append(m.ST.Delegation(b, 1000, [(5, 3)], reward=9))
    s.set_validator(w)
    root = s.root()
    s2 = m.ST.StateDB()
    s2.set_validator(w)
    s2.add_balance(b, 50)
    s2.set_nonce(a, 7)
    s2.add_balance(a, 100)
    assert s2.root() == root
    blob = s.serialize()
    s3 = m.ST.StateDB.deserialize(blob)
    assert s3.root() == root and s3.balance(a) == 100 and s3.nonce(a) == 7
    assert s3.validator(b).delegations[0].undelegations == [(5, 3)]
    s.balance(b"\x03" * 20)
    s.account(b"\x04" * 20)
    assert s.root() == root
    return root, blob


def test_state_root_and_serialization():
    root, blob = _both(_state)
    for m in (J, T):
        assert m.ST.StateDB.deserialize(blob).root() == root


# -- tx pool ----------------------------------------------------------------


def _pool_ordering(m):
    key1, key2 = (m.E.ECDSAKey.from_seed(s) for s in (b"p1", b"p2"))
    state = m.ST.StateDB()
    state.add_balance(key1.address(), 10**9)
    state.add_balance(key2.address(), 10**9)
    pool = m.POOL.TxPool(CHAIN_ID, 0, lambda: state)
    to = b"\x08" * 20
    pool.add(_transfer(m, key1, 0, to, 1, gas_price=5))
    pool.add(_transfer(m, key1, 1, to, 1, gas_price=5))
    pool.add(_transfer(m, key2, 0, to, 1, gas_price=9))
    pool.add(_transfer(m, key2, 2, to, 1, gas_price=9))
    pending = [t.hash(CHAIN_ID) for t, _ in pool.pending()]
    assert len(pending) == 3
    with pytest.raises(m.POOL.PoolError):
        pool.add(_transfer(m, key1, 0, to, 2, gas_price=5))
    pool.add(_transfer(m, key1, 0, to, 2, gas_price=6))
    state.set_nonce(key1.address(), 1)
    with pytest.raises(m.POOL.PoolError):
        pool.add(_transfer(m, key1, 0, to, 1, gas_price=50))
    pool.drop_applied()
    return pending, len(pool), pool.stats()


def test_tx_pool_ordering_and_replacement():
    _both(_pool_ordering)


def _pool_tiers(m):
    key = m.E.ECDSAKey.from_seed(b"tier")
    state = m.ST.StateDB()
    state.add_balance(key.address(), 10**9)
    pool = m.POOL.TxPool(CHAIN_ID, 0, lambda: state)
    to = b"\x08" * 20
    for n in (0, 1, 5):
        pool.add(_transfer(m, key, n, to, 1))
    split = pool.stats(), [t.nonce for t, _ in pool.queued()]
    for n in (2, 3, 4):
        pool.add(_transfer(m, key, n, to, 1))
    keys = [m.E.ECDSAKey.from_seed(bytes([i])) for i in range(3)]
    for k in keys:
        state.add_balance(k.address(), 10**12)
    capped = m.POOL.TxPool(CHAIN_ID, 0, lambda: state, cap=3)
    capped.add(_transfer(m, keys[0], 0, to, 1, gas_price=5))
    capped.add(_transfer(m, keys[1], 7, to, 1, gas_price=2))
    capped.add(_transfer(m, keys[2], 9, to, 1, gas_price=8))
    with pytest.raises(m.POOL.PoolError):
        capped.add(_transfer(m, keys[0], 1, to, 1, gas_price=1))
    capped.add(_transfer(m, keys[0], 1, to, 1, gas_price=6))
    queued = sorted(t.hash(CHAIN_ID) for t, _ in capped.queued())
    stale = m.POOL.TxPool(CHAIN_ID, 0, lambda: state, lifetime=10.0)
    stale.add(_transfer(m, key, 0, to, 1))
    stale.add(_transfer(m, key, 9, to, 1))
    stale.evict_stale(now=time.monotonic() + 11.0)
    return split, pool.stats(), capped.evicted, queued, stale.stats()


def test_pool_tiers_pressure_and_lifetime():
    got = _both(_pool_tiers)
    assert got[0] == ((2, 1), [5]) and got[1] == (6, 0)
    assert got[2] == 1 and got[4] == (1, 0)


def test_pool_account_slot_caps():
    def scenario(m):
        key = m.E.ECDSAKey.from_seed(b"caps")
        state = m.ST.StateDB()
        state.add_balance(key.address(), 10**15)
        pool = m.POOL.TxPool(CHAIN_ID, 0, lambda: state)
        for i in range(m.POOL.ACCOUNT_QUEUE):
            pool.add(_transfer(m, key, 1000 + i, b"\x08" * 20, 1))
        with pytest.raises(m.POOL.PoolError):
            pool.add(_transfer(m, key, 5000, b"\x08" * 20, 1))
        return m.POOL.ACCOUNT_QUEUE, pool.stats()
    _both(scenario)


# -- state processor --------------------------------------------------------


def _processor_transfer(m):
    key = m.E.ECDSAKey.from_seed(b"proc")
    state = m.ST.StateDB()
    state.add_balance(key.address(), 10**9)
    proc = m.SP.StateProcessor(CHAIN_ID, 0)
    to = b"\x07" * 20
    r, cx = proc.apply_transaction(
        state, _transfer(m, key, 0, to, 1000), block_num=1,
        cumulative_gas=0)
    assert r.status == 1 and cx is None
    r2, cx2 = proc.apply_transaction(
        state, _transfer(m, key, 1, to, 500, to_shard=1), 2, r.gas_used)
    assert cx2 is not None and cx2.to_shard == 1 and cx2.amount == 500
    m.SP.StateProcessor(CHAIN_ID, 1).apply_incoming_receipt(state, cx2)
    assert state.balance(to) == 1500
    with pytest.raises(m.SP.ExecutionError):
        proc.apply_transaction(state, _transfer(m, key, 5, to, 1), 3, 0)
    return r.encode(), r2.encode(), m.RAW.encode_cx(cx2), state.root()


def test_processor_transfer_and_cx():
    _both(_processor_transfer)


def _processor_staking(m):
    val, dlg = (m.E.ECDSAKey.from_seed(s) for s in (b"val", b"del"))
    state = m.ST.StateDB()
    state.add_balance(val.address(), 10**9)
    state.add_balance(dlg.address(), 10**9)
    proc = m.SP.StateProcessor(CHAIN_ID, 0)
    roots = []
    steps = [
        (val, 0, "CREATE_VALIDATOR", {"amount": 10**6,
                                      "min_self_delegation": 10**5,
                                      "bls_keys": b"\x0c" * 48}, 0),
        (dlg, 0, "DELEGATE", {"validator": val.address(), "amount": 5000},
         0),
        (dlg, 1, "UNDELEGATE", {"validator": val.address(),
                                "amount": 2000}, 1),
    ]
    for key, nonce, directive, fields, epoch in steps:
        proc.apply_staking_transaction(
            state, _staking(m, key, nonce, directive, fields),
            epoch=epoch, cumulative_gas=0)
        roots.append(state.root())
    proc.payout_undelegations(state, epoch=8)
    roots.append(state.root())
    w = state.validator(val.address())
    d = [d for d in w.delegations if d.delegator == dlg.address()][0]
    assert d.amount == 3000
    d.reward = 777
    before = state.balance(dlg.address())
    proc.apply_staking_transaction(
        state, _staking(m, dlg, 2, "COLLECT_REWARDS", {}), epoch=8,
        cumulative_gas=0)
    assert state.balance(dlg.address()) == before + 777 - 21_000
    with pytest.raises(m.SP.ExecutionError):
        proc.apply_staking_transaction(
            state, _staking(m, val, 1, "CREATE_VALIDATOR", {
                "amount": 10**6, "bls_keys": b"\x0d" * 48}),
            epoch=2, cumulative_gas=0)
    roots.append(state.root())
    return roots


def test_processor_staking_lifecycle():
    _both(_processor_staking)


# -- blockchain -------------------------------------------------------------


def _tip_proof(m, header, bls_keys):
    payload = m.SIG.construct_commit_payload(
        header.hash(), header.block_num, header.view_id, True)
    agg = m.B.aggregate_sigs([k.sign_hash(payload) for k in bls_keys])
    mask = m.MASK.Mask([k.pub.point for k in bls_keys])
    for i in range(len(bls_keys)):
        mask.set_bit(i, True)
    return agg.bytes + mask.mask_bytes()


def _insert_and_reload(m, path):
    genesis, ecdsa_keys, _ = m.GEN.dev_genesis()
    db = m.KV.FileKV(path)
    chain = m.BC.Blockchain(db, genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    to = b"\x06" * 20
    pool.add(_transfer(m, ecdsa_keys[0], 0, to, 12345))
    block = m.W.Worker(chain, pool).propose_block(view_id=1, timestamp=1000)
    assert chain.insert_chain([block], verify_seals=False) == 1
    pool.drop_applied()
    assert len(pool) == 0
    db.flush()
    db.close()
    chain2 = m.BC.Blockchain(m.KV.FileKV(path), genesis, blocks_per_epoch=16)
    assert chain2.head_number == 1
    assert chain2.state().balance(to) == 12345
    assert chain2.block_by_hash(block.hash()).block_num == 1
    bad = m.W.Worker(chain2, None).propose_block(view_id=2)
    bad.header.parent_hash = bytes(32)
    with pytest.raises(m.BC.ChainError):
        chain2.insert_chain([bad], verify_seals=False)
    h = chain2.current_header()
    return h.hash(), h.root, h.receipt_root, [
        r.encode() for r in m.RAW.read_receipts(chain2.db, 1)]


def test_blockchain_insert_and_reload(tmp_path):
    _both(lambda m: _insert_and_reload(m, str(tmp_path / f"{id(m)}.log")))


def _seals(m, proofs_from=None):
    """Two blocks inserted with their commit proofs, each seal checked;
    a forged proof refused.  ``proofs_from`` gives the other package's
    proofs for the same headers."""
    genesis, _, bls_keys = m.GEN.dev_genesis()
    engine = m.ENG.Engine(
        lambda shard, epoch: m.ENG.EpochContext(genesis.committee))
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, engine=engine,
                            blocks_per_epoch=16)
    worker = m.W.Worker(chain, None)
    b1 = worker.propose_block(view_id=1)
    p1 = proofs_from[0] if proofs_from else _tip_proof(m, b1.header,
                                                       bls_keys)
    assert chain.insert_chain([b1], commit_sigs=[p1]) == 1
    b2 = m.W.Worker(chain, None).propose_block(view_id=2)
    b2.header.last_commit_sig, b2.header.last_commit_bitmap = p1[:96], \
        p1[96:]
    p2 = proofs_from[1] if proofs_from else _tip_proof(m, b2.header,
                                                       bls_keys)
    assert chain.insert_chain([b2], commit_sigs=[p2]) == 1
    b3 = worker.propose_block(view_id=3)
    forged = bytearray(_tip_proof(m, b3.header, bls_keys))
    forged[10] ^= 0xFF
    with pytest.raises(m.BC.ChainError):
        chain.insert_chain([b3], commit_sigs=[bytes(forged)])
    assert chain.head_number == 2
    return [p1, p2], chain.current_header().hash()


@pytest.mark.parametrize("mode", ("host", "device"))
def test_blockchain_insert_with_seal_verification(mode, monkeypatch):
    """Equal proofs and head in both packages; each accepts the other's
    proofs.  In device mode the port's seal checks run through its
    scheduler and device.py (the twins)."""
    want = _seals(J)
    if mode == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
        before = T.DV.COUNTERS["agg_verify"]
    assert _seals(T) == want
    assert _seals(T, proofs_from=want[0]) == want
    if mode == "device":
        assert T.DV.COUNTERS["agg_verify"] - before >= 4
    T.DV.use_device(False)
    assert _seals(J, proofs_from=_seals(T)[0]) == want


def test_rawdb_codecs_roundtrip():
    def scenario(m):
        key = m.E.ECDSAKey.from_seed(b"codec")
        tx = _transfer(m, key, 3, b"\x05" * 20, 42, to_shard=2)
        stx = _staking(m, key, 4, "DELEGATE",
                       {"validator": b"\x01" * 20, "amount": 99})
        return m.RAW.encode_tx(tx, CHAIN_ID), m.RAW.encode_staking_tx(
            stx, CHAIN_ID)
    tx_blob, stx_blob = _both(scenario)
    for m in (J, T):
        tx = m.RAW.decode_tx(tx_blob)
        assert tx.sender(CHAIN_ID) == \
            m.E.ECDSAKey.from_seed(b"codec").address()
        assert m.RAW.encode_tx(tx, CHAIN_ID) == tx_blob
        stx = m.RAW.decode_staking_tx(stx_blob)
        assert m.RAW.encode_staking_tx(stx, CHAIN_ID) == stx_blob


def _revert(m):
    genesis, keys, _ = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    to = b"\x0e" * 20
    hashes = {}
    for i in range(4):
        pool.add(_transfer(m, keys[0], i, to, 10))
        block = worker.propose_block(view_id=i + 1)
        chain.insert_chain([block], verify_seals=False)
        pool.drop_applied()
        hashes[i + 1] = block.hash()
    assert chain.revert_to(2) == 2
    assert chain.state().balance(to) == 20
    assert chain.current_header().hash() == hashes[2]
    assert chain.block_by_number(3) is None
    assert m.RAW.read_canonical_hash(chain.db, 4) is None
    assert chain.revert_to(2) == 0 and chain.revert_to(99) == 0
    pool.add(_transfer(m, keys[0], 2, to, 10))
    chain.insert_chain([worker.propose_block(view_id=3)], verify_seals=False)
    assert chain.state().balance(to) == 30
    return hashes, chain.current_header().hash()


def test_revert_to_rolls_back_head_and_state():
    _both(_revert)


# -- a datadir carried between the packages ---------------------------------


def _solo_node(m, path, genesis, bls_keys):
    """A one-key committee's node on a FileKV datadir, its chain wired to
    an Engine: each commit re-checks its own proof on insert."""
    cell = []
    chain = m.BC.Blockchain(
        m.KV.FileKV(path), genesis, blocks_per_epoch=16,
        engine=m.ENG.Engine(lambda s, e: m.ENG.EpochContext(
            cell[0].committee_for_epoch(e))))
    cell.append(chain)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    reg = m.REG.Registry(blockchain=chain, txpool=pool,
                         host=m.P2P.InProcessNetwork().host("solo"))
    return m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(bls_keys))


def _head(chain):
    h = chain.current_header()
    return (chain.head_number, h.hash(), h.root,
            chain.read_commit_sig(chain.head_number))


def _commit_transfer(m, node, keys, nonce, value):
    node.pool.add(_transfer(m, keys[0], nonce, b"\x0d" * 20, value))
    node.start_round_if_leader()


def test_filekv_datadir_passes_between_the_packages(tmp_path):
    """The JAX package's chain commits blocks 1-2 into a FileKV datadir;
    the port's Blockchain opens it with the same head hash, state root and
    commit proof, commits block 3 on it, and the JAX package's chain,
    reopened, reads block 3 back."""
    path = str(tmp_path / "shard0.db")
    genesis, keys, bls_keys = J.GEN.dev_genesis(n_keys=1)
    jnode = _solo_node(J, path, genesis, bls_keys)
    _commit_transfer(J, jnode, keys, 0, 11)
    _commit_transfer(J, jnode, keys, 1, 22)
    assert jnode.chain.head_number == 2
    jax_head = _head(jnode.chain)
    jnode.chain.db.close()

    tgen, tkeys, tbls = T.GEN.dev_genesis(n_keys=1)
    tnode = _solo_node(T, path, tgen, tbls)
    assert _head(tnode.chain) == jax_head
    assert tnode.chain.state().balance(b"\x0d" * 20) == 33
    assert tnode.chain.read_commit_sig(1) is not None
    _commit_transfer(T, tnode, tkeys, 2, 44)
    assert tnode.chain.head_number == 3
    port_head = _head(tnode.chain)
    port_block = T.RAW.encode_block(tnode.chain.block_by_number(3), CHAIN_ID)
    tnode.chain.db.close()

    cell = []
    again = J.BC.Blockchain(
        J.KV.FileKV(path), genesis, blocks_per_epoch=16,
        engine=J.ENG.Engine(lambda s, e: J.ENG.EpochContext(
            cell[0].committee_for_epoch(e))))
    cell.append(again)
    assert _head(again) == port_head
    assert J.RAW.encode_block(again.block_by_number(3), CHAIN_ID) == \
        port_block
    assert again.state().balance(b"\x0d" * 20) == 77
    # the JAX package's engine accepts the port's stored proof for block 3
    assert again.engine.verify_headers_batch(
        [(again.block_by_number(3).header, port_head[3][:96],
          port_head[3][96:])], [True]) == [True]
    again.db.close()
    assert os.path.getsize(path) > 0
