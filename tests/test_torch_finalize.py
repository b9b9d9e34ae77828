"""The port's epoch finalizer, availability accounting and slashing on the
chain against the JAX package's: ports of tests/test_finalize.py (rewards,
the EPoS election, committee rotation, a lazy signer going inactive, a
fabricated parent proof), tests/test_availability_slash.py (signer splits,
the signing threshold, double-sign evidence and its economics) and the
chain arcs of tests/test_slash_pipeline.py (a slash applied through a
block, a duplicate dropped by the proposer and refused on insert, forged
and future evidence).

Each scenario runs on both packages with the same inputs (``dev_genesis``
keys, fixed staking transactions and evidence) and returns what it
produced: committees, validator records, balances, verdicts, the raised
errors.  The two must be equal.  A ``Blockchain`` takes the port's
``Finalizer`` through ``finalizer=``, as the JAX package's does.
"""

import dataclasses
import importlib
import types

import pytest

CHAIN_ID = 2
BPE = 4  # blocks per epoch
_MODULES = {
    "B": "bls", "FIN": "chain.finalize", "BC": "core.blockchain",
    "GEN": "core.genesis", "KV": "core.kv", "POOL": "core.tx_pool",
    "TY": "core.types", "RAW": "core.rawdb", "W": "node.worker",
    "AV": "staking.availability", "SL": "staking.slash",
    "SIG": "consensus.signature", "MASK": "consensus.mask",
    "MB": "multibls", "NODE": "node.node", "REG": "node.registry",
    "P2P": "p2p",
}


def _package(root):
    return types.SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


def _both(scenario, *args):
    want = scenario(J, *args)
    got = scenario(T, *args)
    assert got == want
    return got


def _raised(m, fn, *args):
    """The ChainError or SlashVerifyError message fn raises, or None."""
    try:
        fn(*args)
    except (m.BC.ChainError, m.SL.SlashVerifyError) as e:
        return type(e).__name__, str(e)
    return None


def _validator(w):
    return (w.status, w.blocks_to_sign, w.blocks_signed,
            w.total_delegation(),
            [(d.delegator, d.amount, d.reward) for d in w.delegations])


# -- the finalizer on a chain -----------------------------------------------


def _finalizer(m, genesis, ecdsa_keys):
    return m.FIN.Finalizer(m.FIN.FinalizeConfig(
        block_reward=28 * 10**18, shard_count=1, external_slots_per_shard=2,
        harmony_accounts=[(k.address(), pub) for k, pub in
                          zip(ecdsa_keys, genesis.committee)]))


def _setup(m, **genesis_kw):
    genesis, ecdsa_keys, bls_keys = m.GEN.dev_genesis(**genesis_kw)
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=BPE,
                            finalizer=_finalizer(m, genesis, ecdsa_keys))
    return chain, m.POOL.TxPool(CHAIN_ID, 0, chain.state), genesis, \
        ecdsa_keys


def _advance(m, chain, pool, n=1, bitmap_bytes=None):
    """Commit n blocks, each with a stored commit proof whose bitmap the
    next block's finalize reads (every slot, or ``bitmap_bytes``)."""
    worker = m.W.Worker(chain, pool)
    for _ in range(n):
        block = worker.propose_block(view_id=chain.head_number + 1)
        assert chain.insert_chain([block], verify_seals=False) == 1
        committee = chain.committee_for_epoch(chain.epoch_of(
            block.block_num))
        nbytes = (len(committee) + 7) >> 3
        full = bytearray((bitmap_bytes if bitmap_bytes is not None
                          else bytes([0xFF] * nbytes))[:nbytes])
        extra = nbytes * 8 - len(committee)
        if extra:
            full[-1] &= 0xFF >> extra
        chain.write_commit_sig(block.block_num, b"\x01" * 96 + bytes(full))
        pool.drop_applied()


def _create_validator(m, staker, ext_bls, pop=False):
    fields = {"amount": 10**20, "min_self_delegation": 10**18,
              "bls_keys": ext_bls.pub.bytes}
    if pop:
        fields["bls_key_sigs"] = m.B.proof_of_possession(ext_bls)
    return m.TY.StakingTransaction(
        nonce=0, gas_price=1, gas_limit=50_000,
        directive=m.TY.Directive.CREATE_VALIDATOR, fields=fields,
    ).sign(staker, CHAIN_ID)


def _election(m):
    chain, pool, genesis, ecdsa_keys = _setup(m)
    ext_bls = m.B.PrivateKey.generate(b"external-validator-key")
    staker = ecdsa_keys[0]
    pool.add(_create_validator(m, staker, ext_bls), is_staking=True)
    _advance(m, chain, pool, 3)
    assert chain.is_election_block(3)
    com = chain.shard_state_for_epoch(1).find_committee(0)
    keys = com.bls_pubkeys()
    assert ext_bls.pub.bytes in keys
    assert chain.committee_for_epoch(1) == keys
    assert chain.committee_for_epoch(0) == list(genesis.committee)
    before = _validator(chain.state().validator(staker.address()))
    _advance(m, chain, pool, 2)
    return (keys, [None if s.effective_stake is None else
                  str(s.effective_stake) for s in com.slots], before,
            _validator(chain.state().validator(staker.address())),
            chain.state().root())


def test_election_rotates_committee_and_pays_rewards():
    keys, stakes, before, after, _ = _both(_election)
    assert len(keys) == 5 and sum(s is not None for s in stakes) == 1
    assert before[1] == 0
    assert after[1:3] == (1, 1) and after[4][0][2] == 28 * 10**18


def _lazy_signer(m):
    chain, pool, genesis, ecdsa_keys = _setup(m)
    ext_bls = m.B.PrivateKey.generate(b"lazy-validator-key")
    staker = ecdsa_keys[1]
    pool.add(_create_validator(m, staker, ext_bls), is_staking=True)
    _advance(m, chain, pool, 3)
    seated = ext_bls.pub.bytes in chain.committee_for_epoch(1)
    _advance(m, chain, pool, 4, bitmap_bytes=bytes([0x0F]))
    return (seated, _validator(chain.state().validator(staker.address())),
            chain.committee_for_epoch(2))


def test_missing_signer_goes_inactive_at_election():
    seated, validator, committee = _both(_lazy_signer)
    assert seated and validator[0] == 1 and len(committee) == 4


def _short_bitmap(m):
    with pytest.raises(ValueError):
        m.MASK.bits_from_bytes(b"\x01", 9)
    return m.MASK.bits_from_bytes(b"\x01\x01", 9)


def test_bits_from_bytes_short_bitmap_raises_valueerror():
    assert _both(_short_bitmap) == [1, 0, 0, 0, 0, 0, 0, 0, 1]


def _fabricated_parent_proof(m):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=1)
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    reg = m.REG.Registry(blockchain=chain,
                         txpool=m.POOL.TxPool(CHAIN_ID, 0, chain.state),
                         host=net.host("solo"))
    node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(bls_keys))
    node.start_round_if_leader()
    assert chain.head_number == 1
    good = m.W.Worker(chain, None).propose_block(view_id=2)
    forged = m.W.Worker(chain, None).propose_block(view_id=2)
    forged.header.last_commit_bitmap = bytes(
        [forged.header.last_commit_bitmap[0] ^ 0x02]
    ) + forged.header.last_commit_bitmap[1:]
    return [node._validate_proposed_block(m.RAW.encode_block(b, CHAIN_ID))
            is not None for b in (good, forged)]


def test_fabricated_parent_proof_rejected_by_validator():
    assert _both(_fabricated_parent_proof) == [True, False]


# -- availability and double-sign evidence -----------------------------------


def _availability(m):
    keys = [bytes([i]) * 48 for i in range(10)]
    split = m.AV.block_signers(bytes([0b00000111, 0b00000010]), keys)
    with pytest.raises(ValueError):
        m.AV.block_signers(b"\x00", keys)
    counters = {}
    for _ in range(9):
        m.AV.increment_counts(counters, ["a", "b"], ["a", "b", "c"])
    snap = m.AV.Counters()
    below = [m.AV.compute_current_signing(snap, counters[k])
             .is_below_threshold for k in ("a", "c")]
    below += [m.AV.compute_current_signing(snap, m.AV.Counters(
        num_blocks_to_sign=9, num_blocks_signed=n)).is_below_threshold
        for n in (6, 7)]
    return (split, {k: (c.num_blocks_to_sign, c.num_blocks_signed)
                    for k, c in counters.items()}, below,
            str(m.AV.SIGNING_THRESHOLD))


def test_block_signers_counts_and_threshold():
    split, counts, below, _ = _both(_availability)
    assert len(split[0]) == 4 and len(split[1]) == 6
    assert counts["c"] == (9, 0) and below == [False, True, True, False]


def _record(m, key, height=100, view=7, epoch=3, offender=b"offender-addr",
            reporter=b"reporter-addr", h1=bytes([1]) * 32,
            h2=bytes([2]) * 32):
    votes = [m.SL.Vote(
        signer_pubkeys=[key.pub.bytes], block_header_hash=h,
        signature=key.sign_hash(m.SIG.construct_commit_payload(
            h, height, view)).bytes) for h in (h1, h2)]
    return m.SL.Record(
        evidence=m.SL.Evidence(
            moment=m.SL.Moment(epoch=epoch, shard_id=0, height=height,
                               view_id=view),
            first_vote=votes[0], second_vote=votes[1], offender=offender),
        reporter=reporter)


def _evidence(m):
    k = m.B.PrivateKey.generate(b"\x55")
    record = _record(m, k)
    committee = [k.pub.bytes]
    ev = record.evidence
    cases = [
        record,
        m.SL.Record(evidence=dataclasses.replace(
            ev, second_vote=ev.first_vote), reporter=record.reporter),
        m.SL.Record(evidence=ev, reporter=ev.offender),
        m.SL.Record(evidence=dataclasses.replace(
            ev, second_vote=dataclasses.replace(
                ev.second_vote, signature=ev.first_vote.signature)),
            reporter=record.reporter),
    ]
    verdicts = [_raised(m, m.SL.verify_record, r, committee) for r in cases]
    verdicts.append(_raised(m, m.SL.verify_record, record, [
        m.B.PrivateKey.generate(b"\x66").pub.bytes]))
    ballots = {b"key1": b"hashA"}
    detected = [m.SL.detect_double_sign(ballots, *a) for a in (
        (b"key1", b"hashB"), (b"key1", b"hashA"), (b"key2", b"hashB"))]
    app = m.SL.apply_slash(stake=1000)
    return (verdicts, detected, app.total_slashed,
            app.total_beneficiary_reward,
            m.SL.encode_records([record]))


def test_double_sign_evidence_and_economics():
    verdicts, detected, slashed, reward, _ = _both(_evidence)
    assert verdicts[0] is None and all(verdicts[1:])
    assert detected == [b"hashA", None, None]
    assert (slashed, reward) == (20, 10)


# -- slashing through the chain ----------------------------------------------


def _staked_chain(m):
    """A staking chain past its first election with one staked external
    validator seated in the epoch-1 committee."""
    chain, pool, _, ecdsa_keys = _setup(m, n_accounts=5, n_keys=5)
    ext = m.B.PrivateKey.generate(b"chaos-external-bls-99-0")
    pool.add(_create_validator(m, ecdsa_keys[0], ext, pop=True),
             is_staking=True)
    _advance(m, chain, pool, 4)
    assert ext.pub.bytes in chain.committee_for_epoch(1)
    return chain, pool, ecdsa_keys, ext


def _staked_record(m, chain, ecdsa_keys, ext, height=4, view=9):
    return _record(m, ext, height=height, view=view,
                   epoch=chain.epoch_of(height),
                   offender=ecdsa_keys[0].address(),
                   reporter=ecdsa_keys[1].address())


def _slash_through_block(m):
    chain, pool, ecdsa_keys, ext = _staked_chain(m)
    rec = _staked_record(m, chain, ecdsa_keys, ext)
    offender, reporter = rec.evidence.offender, rec.reporter
    stake0 = chain.state().validator(offender).total_delegation()
    rep0 = chain.state().balance(reporter)
    block = m.W.Worker(chain, pool).propose_block(
        view_id=chain.head_number + 1, slashes=[rec])
    assert m.SL.decode_records(block.header.slashes) == [rec]
    assert chain.insert_chain([block], verify_seals=False) == 1
    w = chain.state().validator(offender)
    expect = m.SL.apply_slash(stake0)
    assert stake0 - w.total_delegation() == expect.total_slashed
    assert chain.state().balance(reporter) - rep0 == \
        expect.total_beneficiary_reward
    _advance(m, chain, pool, 8 - chain.head_number)
    return (w.status, _validator(w), block.header.slashes,
            ext.pub.bytes in chain.committee_for_epoch(2),
            chain.state().root())


def test_slash_applied_through_block():
    status, _, _, still_seated, _ = _both(_slash_through_block)
    assert status == 2 and not still_seated


def _duplicate_slash(m):
    chain, pool, ecdsa_keys, ext = _staked_chain(m)
    rec = _staked_record(m, chain, ecdsa_keys, ext)
    worker = m.W.Worker(chain, pool)
    b1 = worker.propose_block(view_id=chain.head_number + 1, slashes=[rec])
    assert chain.insert_chain([b1], verify_seals=False) == 1
    b2 = worker.propose_block(view_id=chain.head_number + 1, slashes=[rec])
    dropped = b2.header.slashes
    b2.header.slashes = m.SL.encode_records([rec])
    return dropped, _raised(m, chain.insert_chain, [b2], None, False), \
        chain.head_number


def test_duplicate_slash_rejected_and_proposer_drops_it():
    dropped, raised, head = _both(_duplicate_slash)
    assert dropped == b"" and "already banned" in raised[1] and head == 5


def _forged_and_future(m):
    chain, pool, ecdsa_keys, ext = _staked_chain(m)
    worker = m.W.Worker(chain, pool)
    block = worker.propose_block(view_id=chain.head_number + 1)
    block.header.slashes = b"\xff" * 40
    undecodable = _raised(m, chain.insert_chain, [block], None, False)
    bogus = _staked_record(m, chain, ecdsa_keys, ext)
    bogus.evidence.second_vote.signature = bytes(96)
    block2 = worker.propose_block(view_id=chain.head_number + 1)
    block2.header.slashes = m.SL.encode_records([bogus])
    invalid = _raised(m, chain.insert_chain, [block2], None, False)
    future = _raised(m, chain.apply_slash_records, chain.state().copy(),
                     [_staked_record(m, chain, ecdsa_keys, ext,
                                     height=chain.head_number + 5)],
                     chain.head_number + 1)
    return undecodable, invalid, future, chain.head_number


def test_forged_and_future_evidence_rejected():
    undecodable, invalid, future, head = _both(_forged_and_future)
    assert "bad slash payload" in undecodable[1]
    assert "invalid slash record" in invalid[1]
    assert "future" in future[1] and head == 4
