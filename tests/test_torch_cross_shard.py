"""The port's cross-shard transfers against the JAX package's: a port of
tests/test_cross_shard.py's end-to-end transfer (debit on the source
shard, the proof's export and transport, the destination's check,
inclusion and credit, the double spend and the tampered receipt) and of
its fabricated-receipt rejections, the last of them through an
engine-wired pool whose seal check runs on the port's device path in
device mode (the twins).

Both packages run each scenario with the same keys; the exported proofs,
the encoded batches, the blocks and state roots, and every verdict must
be equal byte for byte, and each package decodes and checks the other's
proof.
"""

import importlib
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "DV": "device", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "POOL": "core.tx_pool", "TY": "core.types",
    "RAW": "core.rawdb", "CX": "node.cross_shard", "W": "node.worker",
    "ENG": "chain.engine", "K": "ref.keccak", "SCHED": "sched",
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


def _two_shards(m):
    g0, ecdsa_keys, _ = m.GEN.dev_genesis(shard_id=0)
    g1 = m.GEN.Genesis(config=g0.config, shard_id=1, alloc=dict(g0.alloc),
                       committee=list(g0.committee))
    return (m.BC.Blockchain(m.KV.MemKV(), g0, blocks_per_epoch=16),
            m.BC.Blockchain(m.KV.MemKV(), g1, blocks_per_epoch=16),
            ecdsa_keys)


def _send_cross_shard(m, c0, sender, to, value):
    pool0 = m.POOL.TxPool(CHAIN_ID, 0, c0.state)
    pool0.add(m.TY.Transaction(
        nonce=0, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=1,
        to=to, value=value).sign(sender, CHAIN_ID))
    block0 = m.W.Worker(c0, pool0).propose_block(view_id=1)
    assert c0.insert_chain([block0], verify_seals=False) == 1
    return block0


def _end_to_end(m):
    c0, c1, keys = _two_shards(m)
    to = b"\x0c" * 20
    block0 = _send_cross_shard(m, c0, keys[0], to, 9999)
    assert c0.state().balance(to) == 0
    proofs = m.CX.export_receipts(c0, 1, shard_count=2)
    assert list(proofs) == [1] and proofs[1].receipts[0].amount == 9999
    assert m.BC.verify_cx_proof(proofs[1], 1, None, c1.config)
    blob = m.CX.encode_cx_batch(proofs[1])
    assert m.CX.decode_cx_batch(blob).receipts[0].amount == 9999
    assert m.CX.cx_topic("localnet", 1).endswith("/1/cx")
    pool = m.CX.CXPool(shard_id=1, config=c1.config)
    assert pool.add_batch(blob) == 1
    assert pool.add_batch(blob) == 0
    incoming = pool.drain()
    block1 = m.W.Worker(c1, None).propose_block(
        view_id=1, incoming_receipts=incoming)
    assert block1.incoming_receipts
    assert c1.insert_chain([block1], verify_seals=False) == 1
    assert c1.state().balance(to) == 9999 and len(pool) == 0
    block2 = m.W.Worker(c1, None).propose_block(
        view_id=2, incoming_receipts=incoming)
    with pytest.raises(m.BC.ChainError):
        c1.insert_chain([block2], verify_seals=False)
    c1b = m.BC.Blockchain(m.KV.MemKV(), m.GEN.Genesis(
        config=c1.config, shard_id=1, alloc=dict(c1.genesis.alloc),
        committee=list(c1.genesis.committee)), blocks_per_epoch=16)
    tampered = m.W.Worker(c1b, None).propose_block(
        view_id=1, incoming_receipts=incoming)
    tampered.incoming_receipts[0].receipts[0].amount = 10**18
    with pytest.raises(m.BC.ChainError):
        c1b.insert_chain([tampered], verify_seals=False)
    return (block0.hash(), blob, block1.hash(), c1.state().root(),
            m.RAW.encode_block(block1, CHAIN_ID))


def test_cross_shard_transfer_end_to_end():
    got, want = _end_to_end(T), _end_to_end(J)
    assert got == want
    # each package decodes and checks the other's exported proof
    for m in (J, T):
        _, c1, _ = _two_shards(m)
        proof = m.CX.decode_cx_batch(want[1])
        assert m.BC.verify_cx_proof(proof, 1, None, c1.config)
        assert m.CX.CXPool(shard_id=1, config=c1.config).add_batch(
            got[1]) == 1


def _fabricated(m):
    c0, c1, keys = _two_shards(m)
    _send_cross_shard(m, c0, keys[0], b"\x0c" * 20, 50)
    proof = m.CX.make_cx_proof(c0, 1, 1, shard_count=2)
    pool = m.CX.CXPool(shard_id=1, config=c1.config)
    evil = m.CX.decode_cx_batch(proof.encode())
    evil.receipts[0].amount = 10**18
    verdicts = [pool.add_batch(evil.encode())]
    evil.shard_hashes = [m.TY.cx_group_root(evil.receipts)]
    evil.shard_ids = [1]
    verdicts.append(pool.add_batch(evil.encode()))
    engine = m.ENG.Engine(lambda shard, epoch: m.ENG.EpochContext(
        c0.committee_for_epoch(epoch)))
    hdr = m.RAW.decode_header(evil.header_bytes)
    hdr.out_cx_root = m.K.keccak256(
        (1).to_bytes(4, "little") + m.TY.cx_group_root(evil.receipts))
    evil.header_bytes = m.RAW.encode_header(hdr)
    sealed = m.CX.CXPool(shard_id=1, engine=engine, config=c1.config)
    verdicts.append(sealed.add_batch(evil.encode()))
    verdicts.append(sealed.add_batch(proof.encode()))
    assert verdicts == [0, 0, 0, 0]
    return proof.encode(), evil.encode(), verdicts


@pytest.mark.parametrize("mode", ("host", "device"))
def test_fabricated_receipts_rejected(mode, monkeypatch):
    """Fabricated batches mint nothing: a bumped amount, rebuilt roots,
    and a forged header without a committee seal are all refused, as is
    an honest proof from an unsealed block by a seal-enforcing pool."""
    if mode == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
    assert _fabricated(T) == _fabricated(J)
