"""The port's mainnet genesis and herumi wire format against the JAX
package's: the fault of ``mainnet_genesis`` (the port had no
``config/genesis_accounts.py``), and ports of tests/test_mainnet_genesis.py
(bech32, the gate table, the schedule's eras, the foundational accounts
and the genesis committee) and tests/test_herumi.py (the mainnet BLS wire
format: little-endian fields, the parity flag in the top bit, the
BLS_SWAP_G base point, the map conventions), with the herumi-produced
vectors of tests/vectors_herumi_localnet.py.

Each case runs the same inputs through both packages and compares what
they give: keys, points, bytes, verdicts and the raised errors.
"""

import importlib
import itertools
import types

import pytest

_MODULES = {
    "BECH": "accounts.bech32", "GA": "config.genesis_accounts",
    "CFG": "config.chain", "SHD": "config.sharding", "H": "ref.herumi",
    "CURVE": "ref.curve", "PARAMS": "ref.params", "BC": "core.blockchain",
    "GEN": "core.genesis", "KV": "core.kv", "ENG": "chain.engine",
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


def _raises(fn, *args):
    """The type name and message of what fn raises, or its result."""
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return (type(e).__name__, str(e))


# -- the fault: mainnet_genesis ---------------------------------------------


def _genesis(m, shard):
    g = m.GEN.mainnet_genesis(shard_id=shard)
    chain = m.BC.Blockchain(m.KV.MemKV(), g, blocks_per_epoch=16384)
    assert chain.committee_for_epoch(0) == g.committee
    return (g.committee, sorted(g.alloc.items()), g.shard_id,
            chain.current_header().hash(), chain.head_number)


@pytest.mark.parametrize("shard", (0, 3))
def test_mainnet_genesis_gives_the_jax_packages_committee(shard):
    committee, _, shard_id, _, head = _both(_genesis, shard)
    assert len(committee) == 150 and shard_id == shard and head == 0


def test_mainnet_genesis_shards_are_disjoint():
    g0 = T.GEN.mainnet_genesis(shard_id=0)
    g3 = T.GEN.mainnet_genesis(shard_id=3)
    assert set(g3.committee).isdisjoint(g0.committee)


def test_the_data_file_is_the_ports_own_copy():
    import gzip
    import os

    path = T.GA._ARTIFACT
    assert os.path.dirname(path).endswith(os.path.join(
        "harmony_tpu_torch", "config"))
    with gzip.open(path, "rb") as a, gzip.open(J.GA._ARTIFACT, "rb") as b:
        assert a.read() == b.read()


# -- bech32 ------------------------------------------------------------------


def _bech32(m):
    good = [m.BECH.bech32_decode(v) for v in (
        "A12UEL5L", "an83characterlonghumanreadablepartthatcontains"
        "thenumber1andtheexcludedcharactersbio1tt5tgs")]
    bad = [_raises(m.BECH.bech32_decode, v) for v in (
        "A12UEL5X", "one1y0xcf40fg65n2ehm8fx5vda4thrkymhpg45ecq",
        "split1cheo2y9e2w")]
    one = "one1y0xcf40fg65n2ehm8fx5vda4thrkymhpg45ecj"
    raw = m.BECH.one_to_address(one)
    return good, bad, raw, m.BECH.address_to_one(raw)


def test_bech32_vectors_and_one_addresses():
    good, bad, raw, one = _both(_bech32)
    assert all(hrp for hrp, _ in good) and all(k != "ok" for k, _ in bad)
    assert len(raw) == 20 and one.startswith("one1")


# -- the gate table and the schedule ------------------------------------------


def _gates(m):
    c, t = m.CFG.mainnet_config(), m.CFG.testnet_config()
    probes = [c.is_active("istanbul", 313), c.is_active("istanbul", 314),
              c.is_active("allowlist", 999_999),
              c.is_active("sha3_epoch", 725), c.accepts_cross_tx(28),
              c.accepts_cross_tx(29)]
    return (c.chain_id, c.eth_compatible_chain_id, c.staking_epoch,
            c.hip30_epoch, c.one_second_epoch, c.cross_shard_epoch,
            sorted(c.gate_table().items()), probes, t.chain_id,
            t.staking_epoch)


def test_mainnet_gates_transcribed():
    out = _both(_gates)
    assert out[:4] == (1, 1666600000, 186, 1673) and len(out[6]) >= 40


def _eras(m):
    out = []
    for epoch in (0, 1, 5, 12, 54, 208, 231, 530, 725, 998, 999, 1673,
                  2152):
        inst = m.SHD.MAINNET.instance_for_epoch(epoch)
        out.append((inst.num_shards, inst.slots_per_shard,
                    inst.harmony_nodes_per_shard, inst.slots_limit(),
                    str(inst.harmony_vote_percent)))
    return out


def test_mainnet_schedule_eras():
    eras = _both(_eras)
    assert eras[0][:3] == (4, 150, 112) and eras[-1][:3] == (2, 200, 2)


# -- the foundational accounts and the committee ------------------------------


def _tables(m):
    counts = {name: len(m.GA.table(name)) for name in m.GA.table_names()}
    inst = m.SHD.MAINNET.instance_for_epoch(0)
    shards = [m.GA.committee_slots(inst, s) for s in range(4)]
    return counts, shards


def test_tables_and_round_robin_committees():
    counts, shards = _both(_tables)
    assert counts["FoundationalNodeAccounts"] == 152
    assert counts["HarmonyAccounts"] == 804
    assert [len(c) for c in shards] == [150] * 4
    hmy = T.GA.table("HarmonyAccounts")
    assert shards[2][3][:2] == hmy[2 + 4 * 3]
    assert len({bls for com in shards for _, bls, _ in com}) == 600


def _genesis_keys_decode(m):
    committee = m.GEN.mainnet_genesis(shard_id=0).committee
    points = [m.H.g1_deserialize(k) for k in committee]
    assert all(p is not None for p in points)
    assert [m.H.g1_serialize(p) for p in points] == committee
    return points


def test_foundational_keys_decode_as_herumi_points():
    """All 150 of the era-0 committee's keys decode to the same G1 points
    in both packages and re-serialize to their bytes."""
    assert len(_both(_genesis_keys_decode)) == 150


def _engine_context(m):
    return _raises(m.ENG.EpochContext, m.GEN.mainnet_genesis(0).committee)


def test_the_engine_refuses_herumi_bytes_as_the_reference_does():
    """The engine decodes committee keys in the ZCash encoding; the
    mainnet genesis keys are herumi's, and both packages refuse them
    alike."""
    kind, _ = _both(_engine_context)
    assert kind == "ValueError"


# -- herumi: the reference's vectors ------------------------------------------

SK_HEX = "c6d7603520311f7a4e6aac0b26701fc433b75b38df504cd416ef2b900cd66205"
PK_HEX = ("30b2c38b1316da91e068ac3bd8751c0901ef6c02a1d58bc712104918302c6ed0"
          "3d5894671d0c816dad2b4d303320f202")


def _keypair(m):
    sk = m.H.fr_from_bytes(bytes.fromhex(SK_HEX))
    pk = m.H.pubkey(sk)
    assert m.H.g1_serialize(pk).hex() == PK_HEX
    assert m.H.g1_deserialize(bytes.fromhex(PK_HEX)) == pk
    assert m.H.fr_to_bytes(sk).hex() == SK_HEX
    g1 = m.CURVE.g1
    assert g1.mul(m.H.HERUMI_G1, m.PARAMS.R_ORDER) is None
    assert m.H.HERUMI_G1 != (m.PARAMS.G1_X, m.PARAMS.G1_Y)
    return sk, pk, m.H.HERUMI_G1


def test_reference_keypair_and_base_point():
    _both(_keypair)


def _localnet_vectors(m):
    from vectors_herumi_localnet import SK_PK_VECTORS

    return [m.H.g1_serialize(m.H.pubkey(m.H.fr_from_bytes(
        bytes.fromhex(sk)))).hex() for sk, _ in SK_PK_VECTORS]


def test_localnet_keyfile_vectors_pin_base_point():
    from vectors_herumi_localnet import SK_PK_VECTORS

    assert _both(_localnet_vectors) == [pk for _, pk in SK_PK_VECTORS]


def _bad_points(m):
    p = m.PARAMS.P
    return (_raises(m.H.g1_deserialize, p.to_bytes(48, "little")),
            _raises(m.H.g1_deserialize, b"\x01" + bytes(46)),
            m.H.g1_deserialize(bytes(48)), m.H.g1_serialize(None),
            m.H.g2_deserialize(bytes(96)), m.H.g2_serialize(None))


def test_rejects_out_of_range_and_bad_points():
    out = _both(_bad_points)
    assert out[0][0] == out[1][0] == "ValueError"
    assert out[2] is None and out[4] is None


def _sign(m):
    g1, g2 = m.CURVE.g1, m.CURVE.g2
    sk = m.H.fr_from_bytes(bytes.fromhex(SK_HEX))
    pk = m.H.pubkey(sk)
    msg = b"\x22" * 32
    sig = m.H.sign_hash(sk, msg)
    data = m.H.g2_serialize(sig)
    assert m.H.g2_deserialize(data) == sig
    verdicts = [m.H.verify_hash(pk, msg, sig),
                m.H.verify_hash(pk, b"\x23" * 32, sig),
                m.H.verify_hash(pk, msg, g2.neg(sig))]
    sks = [m.H.fr_from_bytes(bytes([i + 1] * 32)) % m.PARAMS.R_ORDER or 1
           for i in range(3)]
    agg_sig = agg_pk = None
    for k in sks:
        agg_sig = g2.add(agg_sig, m.H.sign_hash(k, b"\x33" * 32))
        agg_pk = g1.add(agg_pk, m.H.pubkey(k))
    verdicts.append(m.H.verify_hash(agg_pk, b"\x33" * 32, agg_sig))
    return data, verdicts


def test_sign_verify_and_aggregate_over_the_herumi_suite():
    data, verdicts = _both(_sign)
    assert len(data) == 96 and verdicts == [True, False, False, True]


def _conventions(m):
    """Each convention's map of one message, and signatures over messages
    scanned until every pair of conventions is separated (at most 8)."""
    saved = dict(m.H.MAP_CONVENTION)
    sk = m.H.fr_from_bytes(bytes.fromhex(SK_HEX))
    convs = list(itertools.product(["algorithmic", "even", "odd"],
                                   ["h2", "heff"]))
    pairs = list(itertools.combinations(convs, 2))
    maps, sigs, separated = {}, [], set()
    try:
        for root, cof in convs:
            m.H.set_map_convention(root=root, cofactor=cof)
            h = m.H.map_to_g2_herumi(b"\x55" * 32)
            assert m.CURVE.g2.mul(h, m.PARAMS.R_ORDER) is None
            maps[(root, cof)] = h
        for i in range(8):
            by_conv = {}
            for root, cof in convs:
                m.H.set_map_convention(root=root, cofactor=cof)
                by_conv[(root, cof)] = m.H.sign_hash(
                    sk, bytes([0x60 + i]) * 32)
            sigs.append(by_conv)
            separated |= {(a, b) for a, b in pairs
                          if by_conv[a] != by_conv[b]}
            if len(separated) == len(pairs):
                break
    finally:
        m.H.MAP_CONVENTION.update(saved)
    return maps, sigs, len(separated) == len(pairs)


def test_map_conventions_agree_and_are_distinguishable():
    """Each carried (root, cofactor) convention maps and signs to the same
    points in both packages, and every pair of conventions is separated by
    some message."""
    _, _, all_separated = _both(_conventions)
    assert all_separated
