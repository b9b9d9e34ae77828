"""The port's explorer and Rosetta servers against the JAX package's.

The same chain (transfers over several blocks, in each package by the
same scenario) behind each package's ``ExplorerServer`` and
``RosettaServer``: every route, including bad parameters, paging, the
one1 address form and unknown routes, gives the same status and JSON;
the Rosetta construction flow from ``/construction/derive`` to
``/construction/submit`` (a transfer and a delegation, each signed
outside the server) gives the same answers at every step and lands the
same transaction in each package's pool."""

import http.client
import importlib
import json
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "BC": "core.blockchain", "GEN": "core.genesis", "KV": "core.kv",
    "POOL": "core.tx_pool", "TY": "core.types", "W": "node.worker",
    "HMY": "hmy.facade", "EX": "explorer", "RO": "rosetta",
    "B32": "accounts.bech32",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


PACKAGES = {"jax": _package("harmony_tpu"),
            "port": _package("harmony_tpu_torch")}
TO = b"\x0b" * 20


def _chain(m):
    genesis, keys, _ = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    for i in range(6):
        pool.add(m.TY.Transaction(
            nonce=i, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=0,
            to=TO, value=10 + i).sign(keys[0], CHAIN_ID))
        if i % 2:
            pool.add(m.TY.Transaction(
                nonce=i // 2, gas_price=1, gas_limit=25_000, shard_id=0,
                to_shard=0, to=keys[0].address(), value=3 + i,
            ).sign(keys[1], CHAIN_ID))
        block = worker.propose_block(view_id=chain.head_number + 1,
                                     timestamp=500 + i)
        chain.insert_chain([block], verify_seals=False)
        pool.drop_applied()
    return chain, keys


@pytest.fixture(scope="module")
def servers():
    out = {}
    for name, m in PACKAGES.items():
        chain, keys = _chain(m)
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        out[name] = types.SimpleNamespace(
            m=m, chain=chain, keys=keys, pool=pool,
            ex=m.EX.ExplorerServer(chain).start(),
            ro=m.RO.RosettaServer(m.HMY.Harmony(chain, pool)).start())
    yield out
    for s in out.values():
        s.ex.stop()
        s.ro.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    conn.close()
    return out


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn.request("POST", path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    conn.close()
    return out


def _explorer_paths(s):
    sender = "0x" + s.keys[0].address().hex()
    one = s.m.B32.address_to_one(s.keys[0].address())
    tx = s.chain.block_by_number(2).transactions[0]
    txh = "0x" + tx.hash(CHAIN_ID).hex()
    stx = "0x" + s.chain.block_by_number(4).transactions[1].hash(
        CHAIN_ID).hex()
    return [
        "/height", "/blocks", "/blocks?from=0&to=6", "/blocks?from=2&to=3",
        "/blocks?from=0&to=999", "/blocks?from=5&to=2",
        f"/tx?id={txh}", f"/tx?id={stx}", "/tx?id=0x" + "00" * 32,
        "/tx", "/tx?id=zz",
        f"/address?id={sender}", f"/address?id={one}",
        f"/address?id={one}&pageIndex=1&pageSize=2",
        f"/address?id={one}&pageIndex=0&pageSize=0",
        f"/address?id={sender}&pageIndex=-1",
        "/address?id=0x" + TO.hex(), "/address?id=0x" + "ee" * 20,
        "/address?id=nope", "/nothing",
    ]


def test_every_explorer_route_answers_as_the_jax_package(servers):
    seen = {name: [_get(s.ex.port, path) for path in _explorer_paths(s)]
            for name, s in servers.items()}
    assert seen["port"] == seen["jax"]
    statuses = [status for status, _ in seen["port"]]
    assert statuses.count(200) >= 12 and 400 in statuses \
        and 404 in statuses
    assert seen["port"][0][1] == {"height": 6}


def _rosetta_requests(s):
    to = "0x" + TO.hex()
    h3 = "0x" + s.chain.block_by_number(3).hash().hex()
    return [
        ("/network/list", {}), ("/network/status", {}),
        ("/network/options", {}),
        ("/block", {"block_identifier": {"index": 1}}),
        ("/block", {"block_identifier": {"index": 4}}),
        ("/block", {"block_identifier": {"hash": h3}}),
        ("/block", {}), ("/block", {"block_identifier": {"index": 99}}),
        ("/account/balance", {"account_identifier": {"address": to}}),
        ("/account/balance", {"account_identifier": {"address": to},
                              "block_identifier": {"index": 2}}),
        ("/account/balance", {}), ("/nope", {}),
        ("/construction/derive", {"public_key": {"hex_bytes": "zz"}}),
        ("/construction/hash", {"signed_transaction": "0x00"}),
        ("/construction/submit", {"signed_transaction": "0x1234"}),
        ("/network/status", b"{not json"),
    ]


def test_every_rosetta_data_route_answers_as_the_jax_package(servers):
    seen = {name: [_post(s.ro.port, path, body)
                   for path, body in _rosetta_requests(s)]
            for name, s in servers.items()}
    assert seen["port"] == seen["jax"]
    status = seen["port"][1][1]
    assert status["current_block_identifier"]["index"] == 6


def _transfer_ops(s, value):
    sender = "0x" + s.keys[0].address().hex()
    currency = {"symbol": "ONE", "decimals": 18}
    return [
        {"operation_identifier": {"index": 0}, "type": "NativeTransfer",
         "account": {"address": sender},
         "amount": {"value": f"-{value}", "currency": currency}},
        {"operation_identifier": {"index": 1}, "type": "NativeTransfer",
         "account": {"address": "0x" + TO.hex()},
         "amount": {"value": str(value), "currency": currency}},
    ]


def _delegate_ops(s):
    return [{
        "operation_identifier": {"index": 0}, "type": "Delegate",
        "account": {"address": "0x" + s.keys[2].address().hex()},
        "amount": {"value": "-100000000000000000000",
                   "currency": {"symbol": "ONE", "decimals": 18}},
        "metadata": {"validatorAddress": "0x" + "1a" * 20},
    }]


def _construction(s, ops, key):
    """The flow from derive to submit, signed by ``key``; every (status,
    answer)."""
    port = s.ro.port
    steps = []

    def post(path, body):
        out = _post(port, path, body)
        steps.append((path, out))
        return out[1]

    pub = "04" + key.pub[0].to_bytes(32, "big").hex() + key.pub[1].to_bytes(
        32, "big").hex()
    post("/construction/derive", {"public_key": {"hex_bytes": pub}})
    comp = bytes([2 + (key.pub[1] & 1)]) + key.pub[0].to_bytes(32, "big")
    post("/construction/derive", {"public_key": {"hex_bytes": comp.hex()}})
    pre = post("/construction/preprocess", {"operations": ops})
    meta = post("/construction/metadata", {"options": pre["options"]})
    pay = post("/construction/payloads", {"operations": ops,
                                          "metadata": meta["metadata"]})
    post("/construction/parse", {"transaction": pay["unsigned_transaction"],
                                 "signed": False})
    post("/construction/combine", {
        "unsigned_transaction": pay["unsigned_transaction"],
        "signatures": []})
    sig = key.sign(bytes.fromhex(pay["payloads"][0]["hex_bytes"]))
    comb = post("/construction/combine", {
        "unsigned_transaction": pay["unsigned_transaction"],
        "signatures": [{"hex_bytes": sig.hex()}]})
    post("/construction/parse", {"transaction": comb["signed_transaction"],
                                 "signed": True})
    post("/construction/hash",
         {"signed_transaction": comb["signed_transaction"]})
    post("/construction/submit",
         {"signed_transaction": comb["signed_transaction"]})
    post("/construction/submit",
         {"signed_transaction": comb["signed_transaction"]})
    return steps


@pytest.mark.parametrize("flow", ("transfer", "delegate"))
def test_the_construction_flow_answers_as_the_jax_package(servers, flow):
    seen, pools = {}, {}
    for name, s in servers.items():
        ops, key = ((_transfer_ops(s, 777), s.keys[0]) if flow == "transfer"
                    else (_delegate_ops(s), s.keys[2]))
        seen[name] = _construction(s, ops, key)
        pools[name] = [(tx.hash(CHAIN_ID), staking)
                       for tx, staking in s.pool.pending(10)]
    assert seen["port"] == seen["jax"]
    assert pools["port"] == pools["jax"] and pools["port"]
    statuses = [out[0] for _, out in seen["port"]]
    assert statuses[:6] == [200] * 6 and statuses[6] == 500
    assert statuses[7:11] == [200] * 4 and statuses[11] == 500
    # a positive delegation is refused in both
    bad = [dict(_delegate_ops(servers["port"])[0], amount={
        "value": "100", "currency": {"symbol": "ONE", "decimals": 18}})]
    assert _post(servers["port"].ro.port, "/construction/preprocess",
                 {"operations": bad}) == _post(
        servers["jax"].ro.port, "/construction/preprocess",
        {"operations": bad})
