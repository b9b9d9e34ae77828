"""The port's JSON-RPC and WebSocket servers against the JAX package's.

One deterministic chain (transfers, a contract that logs, its call, a
validator in state, a pending transaction) is built in each package by
the same scenario, as ``tests/test_torch_core_chain.py`` does, and served
behind each package's ``Harmony`` and ``RPCServer``.  Every request --
the ``hmy``, ``hmyv2``, ``eth``, ``net``, ``web3`` and ``debug`` methods,
filters, transaction submission and malformed requests, over the
dispatcher and over HTTP -- gets the same JSON from both.  Over each
package's ``WSServer``, the ``newHeads``, ``logs`` and
``newPendingTransactions`` pushes carry the same payloads."""

import base64
import hashlib
import http.client
import importlib
import json
import socket
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "RAW": "core.rawdb", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "POOL": "core.tx_pool", "TY": "core.types",
    "ST": "core.state", "W": "node.worker", "HMY": "hmy",
    "RPC": "rpc.server", "WS": "rpc.ws",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")

# runtime: log1(0, 0, topic=0x77); stop
RUNTIME = bytes([0x60, 0x77, 0x60, 0x00, 0x60, 0x00, 0xA1, 0x00])
INIT = bytes([0x60, len(RUNTIME), 0x60, 0x0C, 0x60, 0x00, 0x39,
              0x60, len(RUNTIME), 0x60, 0x00, 0xF3]) + RUNTIME
TO = b"\x09" * 20
VALIDATOR = b"\x61" * 20
DELEGATOR = b"\x62" * 20


def _tx(m, key, nonce, to, value, gas=25_000, data=b""):
    return m.TY.Transaction(
        nonce=nonce, gas_price=1, gas_limit=gas, shard_id=0, to_shard=0,
        to=to, value=value, data=data).sign(key, CHAIN_ID)


def _stack(m):
    """The chain, its pool and an RPC server (not started) of package m;
    the keys and the contract's address."""
    genesis, keys, _ = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)

    def block(*txs):
        for tx in txs:
            pool.add(tx)
        blk = worker.propose_block(view_id=chain.head_number + 1,
                                   timestamp=1000 + chain.head_number)
        chain.insert_chain([blk], verify_seals=False)
        pool.drop_applied()

    block(_tx(m, keys[0], 0, TO, 5555), _tx(m, keys[1], 0, TO, 7))
    block(_tx(m, keys[0], 1, None, 0, gas=500_000, data=INIT))
    contract = _contract_address(m, chain, keys, 1)
    block(_tx(m, keys[0], 2, contract, 0, gas=200_000),
          _tx(m, keys[2], 0, TO, 11))
    block()
    state = chain.state()
    state.set_validator(m.ST.ValidatorWrapper(
        address=VALIDATOR, bls_keys=[b"\x07" * 48],
        delegations=[m.ST.Delegation(VALIDATOR, 1000),
                     m.ST.Delegation(DELEGATOR, 250, reward=9)]))
    pool.add(_tx(m, keys[3], 0, TO, 1))  # pending
    hmy = m.HMY.Harmony(chain, pool)
    return m.RPC.RPCServer(hmy, port=0), chain, keys, contract


def _contract_address(m, chain, keys, nonce):
    """The address of the contract keys[0] deployed at ``nonce``."""
    srv = m.RPC.RPCServer(m.HMY.Harmony(chain), port=0)
    deploy = _tx(m, keys[0], nonce, None, 0, gas=500_000, data=INIT)
    out = srv.dispatch({"id": 1, "method": "eth_getTransactionReceipt",
                        "params": ["0x" + deploy.hash(CHAIN_ID).hex()]})
    srv._httpd.server_close()
    return bytes.fromhex(out["result"]["contractAddress"][2:])


@pytest.fixture(scope="module")
def stacks():
    got = {"jax": _stack(J), "port": _stack(T)}
    yield got
    for srv, *_ in got.values():
        srv._httpd.server_close()


def _requests(chain, keys, contract):
    """(method, params) of every request, in order."""
    sender = "0x" + keys[0].address().hex()
    ca = "0x" + contract.hex()
    to = "0x" + TO.hex()
    h1 = "0x" + chain.block_by_number(1).hash().hex()
    transfer = "0x" + chain.block_by_number(1).transactions[0].hash(
        CHAIN_ID).hex()
    invoke = "0x" + chain.block_by_number(3).transactions[0].hash(
        CHAIN_ID).hex()
    deploy = "0x" + chain.block_by_number(2).transactions[0].hash(
        CHAIN_ID).hex()
    call = {"from": sender, "to": ca, "data": "0x"}
    return [
        ("hmy_blockNumber", []), ("hmyv2_blockNumber", []),
        ("eth_blockNumber", []), ("eth_chainId", []),
        ("hmyv2_chainId", []), ("net_version", []),
        ("web3_clientVersion", []), ("hmy_shardID", []),
        ("hmy_getEpoch", []), ("hmyv2_getEpoch", []),
        ("hmy_getBalance", [to]), ("hmyv2_getBalance", [to]),
        ("eth_getBalance", [to, "0x1"]), ("eth_getBalance", [to, "latest"]),
        ("eth_getTransactionCount", [sender]),
        ("hmyv2_getTransactionCount", [sender]),
        ("hmy_getBlockByNumber", ["0x1", True]),
        ("hmy_getBlockByNumber", ["0x3", False]),
        ("hmyv2_getBlockByNumber", [3, True]),
        ("eth_getBlockByNumber", ["latest", True]),
        ("hmy_getBlockByNumber", ["0x63", True]),
        ("hmy_getBlockByHash", [h1, True]),
        ("hmy_getTransactionByHash", [transfer]),
        ("hmyv2_getTransactionByHash", [invoke]),
        ("eth_getTransactionReceipt", [transfer]),
        ("eth_getTransactionReceipt", [deploy]),
        ("hmyv2_getTransactionReceipt", [invoke]),
        ("eth_getTransactionReceipt", ["0x" + "ab" * 32]),
        ("eth_getLogs", [{"fromBlock": "0x1", "toBlock": "latest",
                          "address": ca}]),
        ("eth_getLogs", [{"fromBlock": "0x1", "toBlock": "latest",
                          "topics": ["0x" + (0x77).to_bytes(
                              32, "big").hex()]}]),
        ("eth_newFilter", [{"fromBlock": "0x1", "address": ca}]),
        ("eth_getFilterLogs", [1]), ("eth_getFilterChanges", [1]),
        ("eth_newBlockFilter", []), ("eth_getFilterChanges", [2]),
        ("eth_newPendingTransactionFilter", []),
        ("eth_getFilterChanges", [3]), ("eth_uninstallFilter", [2]),
        ("eth_uninstallFilter", [2]), ("eth_getFilterChanges", [2]),
        ("eth_call", [call]), ("eth_estimateGas", [{"from": sender,
                                                   "to": ca}]),
        ("eth_getCode", [ca]), ("eth_getCode", [to]),
        ("eth_getStorageAt", [ca, "0x0"]), ("eth_gasPrice", []),
        ("hmy_pendingTransactions", []),
        ("hmyv2_pendingTransactions", []),
        ("hmy_pendingStakingTransactions", []),
        ("hmy_getAllValidatorAddresses", []),
        ("hmy_getValidatorInformation", ["0x" + VALIDATOR.hex()]),
        ("hmy_getTotalStaking", []), ("hmy_getCommittee", []),
        ("hmyv2_getCommittee", []), ("hmy_getBlockSigners", ["0x1"]),
        ("hmy_getDelegationsByDelegator", ["0x" + DELEGATOR.hex()]),
        ("hmy_getDelegationsByValidator", ["0x" + VALIDATOR.hex()]),
        ("hmy_getElectedValidatorAddresses", []),
        ("hmy_getMedianRawStakeSnapshot", []),
        ("hmy_getCXReceiptByHash", [transfer]),
        ("eth_getProof", [sender, [], "latest"]),
        ("eth_getProof", [ca, ["0x0"], "0x3"]),
        ("debug_traceTransaction", [invoke]),
        ("debug_traceTransaction", [invoke, {"tracer": "callTracer"}]),
        ("debug_traceBlockByNumber", ["0x3"]),
        # malformed requests and unknown methods
        ("hmy_noSuchMethod", []), ("nonsense", []), ("foo_blockNumber", []),
        ("eth_getBalance", []), ("hmy_getBlockByNumber", ["zz"]),
        ("hmy_getTransactionByHash", [7]),
    ]


def _answers(srv, requests):
    return [json.dumps(srv.dispatch({"jsonrpc": "2.0", "id": i,
                                     "method": method, "params": params}),
                       sort_keys=True)
            for i, (method, params) in enumerate(requests)]


def test_every_method_answers_as_the_jax_package(stacks):
    answers = {}
    for name, (srv, chain, keys, contract) in stacks.items():
        answers[name] = _answers(srv, _requests(chain, keys, contract))
    want, got = answers["jax"], answers["port"]
    methods = {m for m, _ in _requests(*stacks["port"][1:])}
    assert len(methods) >= 30 and len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, _requests(*stacks["port"][1:])[i])
    results = [json.loads(a) for a in got]
    assert results[6]["result"] == "harmony-tpu/0.1"
    assert sum("error" in r for r in results) == 7
    # the log-emitting call landed: one log in the receipt and eth_getLogs
    assert len(results[28]["result"]) == 1


def test_transactions_in_over_rpc_as_the_jax_package(stacks):
    """hmy_sendRawTransaction and eth_sendRawTransaction: a good one, a
    duplicate, a nonce gap, a bad signature and garbage bytes."""
    answers = {}
    for name, (srv, chain, keys, _) in stacks.items():
        m = {"jax": J, "port": T}[name]
        good = _tx(m, keys[3], 1, TO, 2)
        gap = _tx(m, keys[2], 9, TO, 2)
        blob = m.RAW.encode_tx(good, CHAIN_ID)
        bad = bytearray(m.RAW.encode_tx(_tx(m, keys[1], 1, TO, 3),
                                        CHAIN_ID))
        bad[-10] ^= 0xFF
        answers[name] = _answers(srv, [
            ("hmy_sendRawTransaction", ["0x" + blob.hex()]),
            ("eth_sendRawTransaction", ["0x" + blob.hex()]),
            ("hmy_sendRawTransaction",
             ["0x" + m.RAW.encode_tx(gap, CHAIN_ID).hex()]),
            ("hmy_sendRawTransaction", ["0x" + bytes(bad).hex()]),
            ("hmy_sendRawTransaction", ["0x1234"]),
            ("hmy_pendingTransactions", []),
        ])
    assert answers["port"] == answers["jax"]
    assert json.loads(answers["port"][0])["result"].startswith("0x")


def _post(port, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/", body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def test_http_batches_and_malformed_bodies_as_the_jax_package():
    seen = {}
    for name, m in (("jax", J), ("port", T)):
        genesis, _, _ = m.GEN.dev_genesis()
        chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        srv = m.RPC.RPCServer(m.HMY.Harmony(chain), port=0).start()
        limited = m.RPC.RPCServer(m.HMY.Harmony(chain), port=0,
                                  method_allowlist=["hmy_blockNumber"]
                                  ).start()
        try:
            batch = json.dumps([{"jsonrpc": "2.0", "id": i,
                                 "method": "hmy_blockNumber", "params": []}
                                for i in range(3)] + [7, {"id": 9}])
            seen[name] = [
                _post(srv.port, batch.encode()),
                _post(srv.port, b"{not json"),
                _post(srv.port, b"[]"),
                _post(srv.port, b'"a string"'),
                _post(srv.port, json.dumps({"id": 1, "method":
                                            "hmy_getCommittee"}).encode()),
                _post(limited.port, json.dumps(
                    {"id": 1, "method": "hmy_getCommittee"}).encode()),
                _post(limited.port, json.dumps(
                    {"id": 2, "method": "hmy_blockNumber"}).encode()),
            ]
        finally:
            srv.stop()
            limited.stop()
    assert seen["port"] == seen["jax"]
    assert [status for status, _ in seen["port"]] == [200] * 7


def _ws_connect(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    key = base64.b64encode(b"0123456789abcdef").decode()
    sock.sendall(
        f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
        f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
        f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
    data = b""
    while b"\r\n\r\n" not in data:
        data += sock.recv(4096)
    want = base64.b64encode(hashlib.sha1(
        key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
    assert b"101" in data.split(b"\r\n")[0] and want in data
    return sock


def _pushes(m):
    """Package m's WebSocket session: subscriptions, then a block with a
    log and a pending transaction; every frame with the subscription ids
    replaced by their kind."""
    genesis, keys, _ = m.GEN.dev_genesis()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    worker = m.W.Worker(chain, pool)
    pool.add(_tx(m, keys[0], 0, None, 0, gas=500_000, data=INIT))
    chain.insert_chain([worker.propose_block(view_id=1, timestamp=1000)],
                       verify_seals=False)
    pool.drop_applied()
    contract = _contract_address(m, chain, keys, 0)
    hmy = m.HMY.Harmony(chain, pool)
    ws = m.WS.WSServer(m.RPC.RPCServer(hmy), poll_interval=0.05).start()
    frames = []
    sock = _ws_connect(ws.port)
    sock.settimeout(10)
    try:
        def rpc(method, params, req_id):
            m.WS.write_frame(sock, json.dumps({
                "jsonrpc": "2.0", "id": req_id, "method": method,
                "params": params}).encode())
            _, payload = m.WS.read_frame(sock)
            return json.loads(payload)

        frames.append(rpc("hmyv2_blockNumber", [], 1))
        subs = {}
        for i, params in enumerate((["newHeads"], ["logs", {
                "address": "0x" + contract.hex()}],
                ["newPendingTransactions"], ["bogus"])):
            out = rpc("eth_subscribe", params, 10 + i)
            if "result" in out:
                subs[out["result"]] = params[0]
                out["result"] = params[0]
            frames.append(out)
        pending = _tx(m, keys[1], 0, TO, 5)
        hmy.send_raw_transaction(m.RAW.encode_tx(pending, CHAIN_ID))
        pool.add(_tx(m, keys[0], 1, contract, 0, gas=200_000))
        chain.insert_chain([worker.propose_block(view_id=2,
                                                 timestamp=1001)],
                           verify_seals=False)
        pool.drop_applied()
        notes = []
        while {n["params"]["subscription"] for n in notes} != set(subs) \
                or len(notes) < 4:
            _, payload = m.WS.read_frame(sock)
            notes.append(json.loads(payload))
        for note in notes:
            note["params"]["subscription"] = subs[
                note["params"]["subscription"]]
        frames.append(sorted(notes, key=lambda n: json.dumps(
            n, sort_keys=True)))
        for sub, kind in subs.items():
            out = rpc("eth_unsubscribe", [sub], 20)
            frames.append((kind, out))
        m.WS.write_frame(sock, b"ping", 0x9)
        frames.append(m.WS.read_frame(sock))
        m.WS.write_frame(sock, b"", 0x8)
        frames.append(m.WS.read_frame(sock)[0])
    finally:
        sock.close()
        ws.stop()
    return frames


def test_websocket_pushes_as_the_jax_package():
    got, want = _pushes(T), _pushes(J)
    assert got == want
    notes = got[5]
    assert sorted(n["params"]["subscription"] for n in notes) == [
        "logs", "newHeads", "newPendingTransactions",
        "newPendingTransactions"]
