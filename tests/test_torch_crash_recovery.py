"""Crash-consistent storage in the port against the JAX package: ports of
tests/test_crash_recovery.py (atomic block commits, recovery on open,
the kv.commit crash-point matrix, the durable safety store) and of
tests/test_kv_corruption.py (every torn tail, torn value, torn batch and
implausible header on the ``FileKV`` and on the native store).

Each scenario runs on both packages with the same inputs and returns
what it saw (heads, rollbacks, verdicts, crash-point counts, the bytes
left on disk); the two must be equal.  Block hashes carry the
proposal's time, so they are compared within a package, not across.
The JAX package's native binding is pointed at the port's build of the
same ``kvstore.cpp`` (as in tests/test_torch_kv_native.py), so this
file never runs the JAX package's ``make``."""

from __future__ import annotations

import importlib
import os
import shutil
import types

import pytest

import kv_corruption as KC
from harmony_tpu.core import kv_native as J_KVN
from harmony_tpu_torch.core import kv_native as T_KVN

CHAIN_ID = 2
_MODULES = {
    "FI": "faultinject", "SAFE": "consensus.safety", "RAW": "core.rawdb",
    "BC": "core.blockchain", "GEN": "core.genesis", "KV": "core.kv",
    "W": "node.worker", "POOL": "core.tx_pool", "TY": "core.types",
    "CX": "node.cross_shard", "SN": "core.snapshot",
    "MSG": "consensus.messages", "MB": "multibls", "NODE": "node.node",
    "REG": "node.registry", "P2P": "p2p", "ING": "node.ingress",
    "DV": "device",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(scope="module")
def library():
    """The port's native KV library, built (or found) once."""
    return T_KVN.build_native()


@pytest.fixture
def natives(library, monkeypatch):
    """Each package's NativeKV, the JAX binding over the port's build."""
    monkeypatch.setattr(J_KVN, "_LIB_PATH", str(library))
    monkeypatch.setattr(J_KVN, "_lib", None)
    return {id(J): J_KVN.NativeKV, id(T): T_KVN.NativeKV}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    for m in (J, T):
        m.FI.reset()
    T.DV.use_device(False)
    J.DV.use_device(False)
    yield
    for m in (J, T):
        m.FI.reset()
    T.DV.use_device(None)
    J.DV.use_device(None)


def _both(scenario, tmp_path, *args):
    """scenario(m, directory, *args) on each package in its own
    directory; the two results must be equal."""
    want = scenario(J, tmp_path / "jax", *args)
    got = scenario(T, tmp_path / "port", *args)
    assert got == want
    return got


def _dir(d):
    d.mkdir(parents=True, exist_ok=True)
    return d


def _proof(chain, num):
    committee = chain.committee_for_epoch(chain.epoch_of(num))
    return b"\x01" * 96 + b"\xff" * ((len(committee) + 7) >> 3)


def _grow(m, chain, n, with_proofs=True):
    worker = m.W.Worker(chain, None)
    blocks = []
    for _ in range(n):
        block = worker.propose_block(view_id=chain.head_number + 1)
        sigs = [_proof(chain, block.block_num)] if with_proofs else None
        assert chain.insert_chain(
            [block], commit_sigs=sigs, verify_seals=False) == 1
        blocks.append(block)
    return blocks


def _open(m, path, genesis, **kw):
    kw.setdefault("blocks_per_epoch", 16)
    return m.BC.Blockchain(m.KV.FileKV(str(path)), genesis, **kw)


# -- atomic block commits ----------------------------------------------------


def _atomic_insert(m, d):
    path = _dir(d) / "chain.kv"
    genesis, _, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    _grow(m, chain, 2)
    chain.db.close()
    # enumerate this insert's crash points with a counting-only rule
    m.FI.arm("kv.commit", key="__none__", after=10**9)
    chain = _open(m, path, genesis)
    block = m.W.Worker(chain, None).propose_block(view_id=3)
    before = m.FI.hits("kv.commit")
    chain.insert_chain([block], commit_sigs=[_proof(chain, 3)],
                       verify_seals=False)
    points = m.FI.hits("kv.commit") - before
    chain.db.close()
    seen = []
    for k in range(points):
        p = str(d / f"fp{k}.kv")
        shutil.copyfile(path, p)
        c = m.BC.Blockchain(m.KV.FileKV(p), genesis, blocks_per_epoch=16)
        c.revert_to(2)
        blk = m.W.Worker(c, None).propose_block(view_id=3)
        m.FI.reset()
        m.FI.arm("kv.commit", key=p, after=k, times=1)
        with pytest.raises(m.FI.FaultInjected):
            c.insert_chain([blk], commit_sigs=[_proof(c, 3)],
                           verify_seals=False)
        m.FI.reset()
        # abandon without close (unbuffered writes = SIGKILL state)
        r = m.BC.Blockchain(m.KV.FileKV(p), genesis, blocks_per_epoch=16,
                            require_commit_sigs=True)
        seen.append((r.head_number, r.current_header() is not None,
                     r.read_commit_sig(2) is not None,
                     r.insert_chain([blk], commit_sigs=[_proof(r, 3)],
                                    verify_seals=False)))
        r.db.close()
    return points, seen


def test_block_insert_is_one_atomic_batch(tmp_path):
    points, seen = _both(_atomic_insert, tmp_path)
    assert points >= 3  # BEGIN + records + COMMIT at minimum
    assert seen == [(2, True, True, 1)] * points


def _clean_reopen(m, d):
    path = _dir(d) / "chain.kv"
    genesis, _, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    blocks = _grow(m, chain, 3)
    chain.db.close()
    re = _open(m, path, genesis, require_commit_sigs=True)
    out = (re.head_number, re.current_header().hash() == blocks[-1].hash(),
           re.recovered_blocks)
    re.db.close()
    return out


def test_reopen_after_clean_insert(tmp_path):
    assert _both(_clean_reopen, tmp_path) == (3, True, 0)


# -- recovery-on-open --------------------------------------------------------


def _torn_head(m, d):
    path = _dir(d) / "chain.kv"
    genesis, _, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    _grow(m, chain, 3)
    # the legacy tear: head says 4, but only a header made it
    fake = m.RAW.encode_header(chain.current_header())
    chain.db.put(b"h" + (4).to_bytes(8, "little"), fake)
    m.RAW.write_head_number(chain.db, 4)
    chain.db.close()
    re = _open(m, path, genesis, require_commit_sigs=True)
    first = (re.head_number, re.recovered_blocks)
    re.db.close()
    re2 = _open(m, path, genesis, require_commit_sigs=True)
    second = (re2.head_number, re2.recovered_blocks)
    re2.db.close()
    return first, second


def test_torn_head_rolls_back_on_open(tmp_path):
    assert _both(_torn_head, tmp_path) == ((3, 1), (3, 0))


def _missing_sig(m, d):
    path = _dir(d) / "chain.kv"
    genesis, _, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    _grow(m, chain, 3)
    chain.db.delete(b"s" + (3).to_bytes(8, "little"))
    chain.db.close()
    re = _open(m, path, genesis, require_commit_sigs=True)
    required = re.head_number
    re.db.close()
    c2 = _open(m, d / "chain2.kv", genesis)
    _grow(m, c2, 2, with_proofs=False)
    c2.db.close()
    re2 = _open(m, d / "chain2.kv", genesis)
    proofless = re2.head_number
    re2.db.close()
    return required, proofless


def test_missing_commit_sig_rolls_back_when_required(tmp_path):
    assert _both(_missing_sig, tmp_path) == (2, 2)


def _pruned_state(m, d):
    path = _dir(d) / "chain.kv"
    genesis, _, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    _grow(m, chain, 2)
    m.RAW.delete_state(chain.db, chain.current_header().root)
    chain.db.close()
    with pytest.raises(m.BC.ChainError, match="missing state") as e:
        _open(m, path, genesis)
    return str(e.value)


def test_pruned_state_still_raises_missing_state(tmp_path):
    _both(_pruned_state, tmp_path)


def _corrupt_state(m, d):
    path = _dir(d) / "chain.kv"
    genesis, ecdsa_keys, _ = m.GEN.dev_genesis()
    chain = _open(m, path, genesis)
    for n in range(2):
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        pool.add(m.TY.Transaction(
            nonce=n, gas_price=1, gas_limit=21_000, shard_id=0,
            to_shard=0, to=b"\x2d" * 20, value=1 + n,
        ).sign(ecdsa_keys[0], CHAIN_ID))
        block = m.W.Worker(chain, pool).propose_block(
            view_id=chain.head_number + 1)
        assert chain.insert_chain(
            [block], commit_sigs=[_proof(chain, block.block_num)],
            verify_seals=False) == 1
    h1, h2 = chain.header_by_number(1), chain.header_by_number(2)
    chain.db.put(b"S" + h2.root, b"\xff\xff\xff\xffgarbage")
    chain.db.close()
    re = _open(m, path, genesis, require_commit_sigs=True)
    out = (h1.root != h2.root, h1.root, h2.root, re.head_number)
    re.db.close()
    return out


def test_corrupt_state_blob_rolls_back(tmp_path):
    distinct, _, _, head = _both(_corrupt_state, tmp_path)
    assert distinct and head == 1


def _revert_unspends(m, d):
    g0, ecdsa_keys, _ = m.GEN.dev_genesis(shard_id=0)
    g1 = m.GEN.Genesis(config=g0.config, shard_id=1, alloc=dict(g0.alloc),
                       committee=list(g0.committee))
    c0 = m.BC.Blockchain(m.KV.MemKV(), g0, blocks_per_epoch=16)
    c1 = m.BC.Blockchain(m.KV.MemKV(), g1, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, c0.state)
    pool.add(m.TY.Transaction(
        nonce=0, gas_price=1, gas_limit=25_000, shard_id=0,
        to_shard=1, to=b"\x0c" * 20, value=777,
    ).sign(ecdsa_keys[0], CHAIN_ID))
    b0 = m.W.Worker(c0, pool).propose_block(view_id=1)
    assert c0.insert_chain([b0], verify_seals=False) == 1
    proofs = m.CX.export_receipts(c0, 1, shard_count=2)
    b1 = m.W.Worker(c1, None).propose_block(
        view_id=1, incoming_receipts=[proofs[1]])
    assert c1.insert_chain([b1], verify_seals=False) == 1
    out = [m.RAW.is_cx_spent(c1.db, 0, 1), m.RAW.cx_spender(c1.db, 0, 1),
           c1.state().balance(b"\x0c" * 20), c1.revert_to(0),
           m.RAW.is_cx_spent(c1.db, 0, 1), c1.head_number,
           m.RAW.read_header(c1.db, 1) is None]
    # the SAME block re-inserts after the revert
    out += [c1.insert_chain([b1], verify_seals=False),
            m.RAW.cx_spender(c1.db, 0, 1), c1.state().balance(b"\x0c" * 20)]
    return out


def test_revert_is_atomic_and_unspends_cx(tmp_path):
    assert _both(_revert_unspends, tmp_path) == [
        True, 1, 777, 1, False, 0, True, 1, 1, 777]


# -- the durable safety store ------------------------------------------------


def _safety_rules(m, d):
    S = m.SAFE
    s = S.SafetyStore(m.KV.MemKV())
    pk = b"\x11" * 48
    h_a, h_b = b"\xaa" * 32, b"\xbb" * 32
    out = [s.record([pk], 5, 6, S.PHASE_PREPARE, h_a),
           s.may_sign(pk, 5, 6, S.PHASE_PREPARE, h_a),
           s.may_sign(pk, 5, 6, S.PHASE_PREPARE, h_b),
           s.record([pk], 5, 6, S.PHASE_COMMIT, h_b), s.refused,
           s.record([pk], 5, 6, S.PHASE_COMMIT, h_a),
           s.may_sign(pk, 5, 5, S.PHASE_PREPARE, h_b),
           s.may_sign(pk, 5, 9, S.PHASE_PREPARE, h_b),
           s.may_sign(pk, 4, 9, S.PHASE_PREPARE, h_b),
           s.may_sign(pk, 6, 7, S.PHASE_PREPARE, h_b),
           s.record([pk], 5, 8, S.PHASE_VIEWCHANGE, bytes(32)),
           s.may_sign(pk, 5, 8, S.PHASE_PREPARE, h_b),
           s.last(pk)[3] == h_a, s.watermark(pk), s.min_view(5),
           s.restart_floor(5), s.min_view(99)]
    return out


def test_safety_store_rules(tmp_path):
    assert _both(_safety_rules, tmp_path) == [
        True, True, False, False, 1, True, True, True, False, True, True,
        True, True, (5, 8), 6, 8, 0]


def _safety_reopen(m, d):
    path = str(_dir(d) / "safety.kv")
    db = m.KV.FileKV(path)
    s = m.SAFE.SafetyStore(db)
    pk = b"\x22" * 48
    out = [s.record([pk], 3, 4, m.SAFE.PHASE_PREPARE, b"\xcc" * 32)]
    db.close()
    db2 = m.KV.FileKV(path)
    s2 = m.SAFE.SafetyStore(db2)
    s2.load_keys([pk])
    out += [s2.last(pk),
            s2.may_sign(pk, 3, 4, m.SAFE.PHASE_PREPARE, b"\xdd" * 32),
            s2.min_view(3)]
    db2.close()
    return out, open(path, "rb").read()


def test_safety_store_survives_reopen(tmp_path):
    out, _ = _both(_safety_reopen, tmp_path)
    assert out == [True, (3, 4, T.SAFE.PHASE_PREPARE, b"\xcc" * 32),
                   False, 4]


def _no_double_sign(m, d):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=4)
    path = str(_dir(d) / "val.kv")
    net = m.P2P.InProcessNetwork()

    def build(host_name):
        chain = m.BC.Blockchain(m.KV.FileKV(path), genesis,
                                blocks_per_epoch=16)
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        reg = m.REG.Registry(blockchain=chain, txpool=pool,
                             host=net.host(host_name))
        # view 1 -> committee[1 % 4] = key 1 leads; key 2 votes
        return m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([bls_keys[2]]))

    leader_chain = m.BC.Blockchain(m.KV.MemKV(), genesis,
                                   blocks_per_epoch=16)
    leader = m.NODE.Node(
        m.REG.Registry(blockchain=leader_chain,
                       txpool=m.POOL.TxPool(CHAIN_ID, 0, leader_chain.state),
                       host=net.host("leader")),
        m.MB.PrivateKeys.from_keys([bls_keys[1]]))
    val = build("val")
    block_a = leader.start_round_if_leader()
    consumed = val.process_pending()
    rec = val.safety.last(bls_keys[2].pub.bytes)
    out = [consumed >= 1, rec[:3],
           rec[3] == block_a.hash()]
    # hard kill: abandon the node, reopen the SAME file
    val.stop()
    val2 = build("val2")
    out.append(val2.safety.last(bls_keys[2].pub.bytes)[3] == block_a.hash())
    block_b = m.W.Worker(leader_chain, None).propose_block(
        view_id=1, leader_extra=b"equivocate")
    announce_b = m.MSG.sign_message(m.MSG.FBFTMessage(
        msg_type=m.MSG.MsgType.ANNOUNCE, view_id=1, block_num=1,
        block_hash=block_b.hash(),
        sender_pubkeys=[bls_keys[1].pub.bytes],
        payload=b"", block=m.RAW.encode_block(block_b, CHAIN_ID),
    ), m.MB.PrivateKeys.from_keys([bls_keys[1]]))
    env = m.ING.pack_envelope(
        m.ING.MessageCategory.CONSENSUS, int(m.MSG.MsgType.ANNOUNCE),
        m.MSG.encode_message(announce_b))
    out.append(val2.view_id)
    val2._handle(env)
    out += [val2._announce_voted is None,
            val2.safety.last(bls_keys[2].pub.bytes)[3] == block_a.hash(),
            block_b.hash() != block_a.hash(),
            val2.safety.may_sign(bls_keys[2].pub.bytes, 1, 1,
                                 m.SAFE.PHASE_PREPARE, block_b.hash())]
    val2.stop()
    leader.stop()
    val2.chain.db.close()
    return out


def test_restarted_validator_cannot_double_sign(tmp_path):
    assert _both(_no_double_sign, tmp_path) == [
        True, (1, 1, T.SAFE.PHASE_PREPARE), True, True, 2, True, True,
        True, False]


def _snapshot_matrix(m, d):
    _dir(d)
    genesis, _, _ = m.GEN.dev_genesis()
    src = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    _grow(m, src, 5)
    snap = str(d / "head.snap")
    exported = m.SN.export_snapshot(src, snap)
    src_root = src.state().root()
    path = str(d / "import.kv")
    chain = _open(m, path, genesis)
    _grow(m, chain, 2)
    pre_root = chain.state().root()
    chain.db.close()
    probe = str(d / "probe.kv")
    shutil.copyfile(path, probe)
    m.FI.arm("kv.commit", key="__none__", after=10**9)
    c = m.BC.Blockchain(m.KV.FileKV(probe), genesis, blocks_per_epoch=16)
    before = m.FI.hits("kv.commit")
    imported = m.SN.import_snapshot(c, snap, trust=True)
    points = m.FI.hits("kv.commit") - before
    c.db.close()
    m.FI.reset()
    outcomes = []
    for k in range(points):
        p = str(d / f"snapfp{k}.kv")
        shutil.copyfile(path, p)
        c = m.BC.Blockchain(m.KV.FileKV(p), genesis, blocks_per_epoch=16)
        m.FI.reset()
        m.FI.arm("kv.commit", key=p, after=k, times=1)
        with pytest.raises(m.FI.FaultInjected):
            m.SN.import_snapshot(c, snap, trust=True)
        m.FI.reset()
        r = m.BC.Blockchain(m.KV.FileKV(p), genesis, blocks_per_epoch=16)
        head = r.head_number
        if head == 5:
            whole = (r.state().root() == src_root,
                     r.read_commit_sig(5) is not None)
        else:
            whole = (r.state().root() == pre_root, r.insert_chain(
                [m.W.Worker(r, None).propose_block(view_id=3)],
                commit_sigs=[_proof(r, 3)], verify_seals=False))
        outcomes.append((head, whole))
        r.db.close()
    return exported, imported, points, outcomes


def test_snapshot_import_crash_matrix(tmp_path):
    exported, imported, points, outcomes = _both(_snapshot_matrix, tmp_path)
    assert exported == imported == 5 and points >= 3
    assert {h for h, _ in outcomes} <= {2, 5} and 2 in {
        h for h, _ in outcomes}
    assert all(w == ((True, True) if h == 5 else (True, 1))
               for h, w in outcomes)


def _adopt_state(m, d):
    path = str(_dir(d) / "fast.kv")
    genesis, _, _ = m.GEN.dev_genesis()
    src = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    blocks = _grow(m, src, 3)
    dst = _open(m, path, genesis)
    out = [dst.insert_headers_fast(
        blocks, commit_sigs=[_proof(src, b.block_num) for b in blocks],
        verify_seals=False), dst.head_number]
    m.FI.arm("kv.commit", key=path, after=1, times=1)
    with pytest.raises(m.FI.FaultInjected):
        dst.adopt_state(3, src.state_at(3))
    m.FI.reset()
    r = _open(m, path, genesis, require_commit_sigs=True)
    out.append(r.head_number)
    r.adopt_state(3, src.state_at(3))
    out.append(r.head_number)
    r.db.close()
    dst.db.close()
    return out


def test_adopt_state_moves_head_and_state_together(tmp_path):
    assert _both(_adopt_state, tmp_path) == [3, 0, 0, 3]


# -- the KV stores: corruption and replay --------------------------------------


def _store(m, backend, natives):
    return m.KV.FileKV if backend == "filekv" else natives[id(m)]


def _corruption(m, d, backend, natives, tail, expect):
    """tests/kv_corruption.py's run_case on one package's store, with its
    own WriteBatch; returns what the reopened store read and the bytes it
    left on disk."""
    factory = _store(m, backend, natives)
    path = str(_dir(d) / "kv.db")
    db = factory(path)
    db.put(b"alpha", b"1")
    db.put(b"beta", b"22")
    batch = m.KV.WriteBatch()
    batch.put(b"gamma", b"333")
    batch.delete(b"beta")
    db.write_batch(batch)
    db.flush()
    db.close()
    with open(path, "ab") as f:
        f.write(tail)
    want = {**KC.BASELINE, **expect}
    db = factory(path)
    first = {k: db.get(k) for k in want}
    db.put(b"post", b"crash")
    db.flush()
    db.close()
    db = factory(path)
    second = {k: db.get(k) for k in (*want, b"post")}
    db.close()
    assert first == want and second == {**want, b"post": b"crash"}
    return first, second, open(path, "rb").read()


@pytest.mark.parametrize("backend", ("filekv", "native"))
@pytest.mark.parametrize("name,tail,expect", KC.CASES,
                         ids=[c[0] for c in KC.CASES])
def test_corruption_case(tmp_path, natives, backend, name, tail, expect):
    _both(_corruption, tmp_path, backend, natives, tail, expect)


def _batch_cross_read(m, d, backend, natives):
    path = str(_dir(d) / "x.kv")
    db = _store(m, backend, natives)(path)
    batch = m.KV.WriteBatch()
    batch.put(b"k1", b"v1")
    batch.put(b"k2", b"v2" * 100)
    batch.delete(b"k1")
    db.write_batch(batch)
    out = [db.get(b"k1"), db.get(b"k2")]
    db.flush()
    db.close()
    # every store of both packages reads it
    for reader in (J.KV.FileKV, T.KV.FileKV, natives[id(J)],
                   natives[id(T)]):
        other = reader(path)
        out.append((other.get(b"k2"), other.get(b"k1")))
        other.close()
    return out, open(path, "rb").read()


@pytest.mark.parametrize("backend", ("filekv", "native"))
def test_batch_atomic_and_cross_readable(tmp_path, natives, backend):
    out, _ = _both(_batch_cross_read, tmp_path, backend, natives)
    assert out == [None, b"v2" * 100] + [(b"v2" * 100, None)] * 4


def _empty_batch(m, d, backend, natives):
    path = str(_dir(d) / "e.kv")
    db = _store(m, backend, natives)(path)
    db.put(b"a", b"1")
    db.write_batch(m.KV.WriteBatch())
    db.flush()
    size = os.path.getsize(path)
    db.close()
    return size


@pytest.mark.parametrize("backend", ("filekv", "native"))
def test_empty_batch_is_noop(tmp_path, natives, backend):
    # no markers were written for the empty batch
    assert _both(_empty_batch, tmp_path, backend, natives) == 8 + 1 + 1


def _fsync_knob(m, d, backend, natives):
    out = []
    for policy in ("none", "batch", "always"):
        path = str(_dir(d) / f"f_{policy}.kv")
        db = _store(m, backend, natives)(path, fsync=policy)
        db.put(b"k", b"v")
        batch = m.KV.WriteBatch()
        batch.put(b"b", b"bb")
        db.write_batch(batch)
        out.append(db.get(b"b"))
        db.close()
        out.append(open(path, "rb").read())
    with pytest.raises(ValueError):
        m.KV.FileKV(str(d / "bad.kv"), fsync="sometimes")
    return out


@pytest.mark.parametrize("backend", ("filekv", "native"))
def test_fsync_policy_knob(tmp_path, natives, backend):
    out = _both(_fsync_knob, tmp_path, backend, natives)
    assert out[::2] == [b"bb"] * 3


def _context_manager(m, d, backend, natives):
    path = str(_dir(d) / "cm.kv")
    factory = _store(m, backend, natives)
    with factory(path) as db:
        db.put(b"k", b"v")
        out = [db.closed]
    out.append(db.closed)
    with factory(path) as db:
        out.append(db.get(b"k"))
    return out


@pytest.mark.parametrize("backend", ("filekv", "native"))
def test_context_manager(tmp_path, natives, backend):
    assert _both(_context_manager, tmp_path, backend, natives) == [
        False, True, b"v"]


def test_the_marker_grammar_is_the_fixtures():
    """The corruption fixtures' sentinels are both stores' own."""
    for m in (J, T):
        assert (m.KV._TOMB, m.KV._BATCH_BEGIN, m.KV._BATCH_COMMIT) == (
            KC._TOMB, KC._BEGIN, KC._COMMIT)
