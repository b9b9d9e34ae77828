"""The port's cross-links and webhooks against the JAX package's: ports of
tests/test_crosslink.py (one link, a batch across two shards with a proof
stolen from the other shard) and of the webhooks half of
tests/test_webhooks_ntp.py (a leader that sees a double sign fires
``double_sign`` with both votes; hooks never raise; the event log is
bounded; the HTTP hook posts its payload as JSON).

Each scenario runs on both packages with the same seeded keys and returns
its verdicts and payloads; the two must be equal.  The JAX package checks
cross-links on its host route, the port on its host route and in device
mode: ``verify_crosslinks_batch`` through ``Engine.verify_headers_batch``,
the scheduler and ``device.py``, on the CPU by the bigint twins
(``HARMONY_KERNEL_TWIN=1``).
"""

import importlib
import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

CHAIN_ID = 2
_MODULES = {
    "B": "bls", "DV": "device", "CL": "chain.crosslink",
    "ENG": "chain.engine", "MASK": "consensus.mask",
    "SIG": "consensus.signature", "MSG": "consensus.messages",
    "BC": "core.blockchain", "GEN": "core.genesis", "KV": "core.kv",
    "POOL": "core.tx_pool", "MB": "multibls", "NODE": "node.node",
    "REG": "node.registry", "P2P": "p2p", "WH": "webhooks",
    "SCHED": "sched",
}


def _package(root):
    return types.SimpleNamespace(name=root, **{
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
    want = scenario(J, *args)
    got = scenario(T, *args)
    assert got == want
    return got


# -- cross-links ------------------------------------------------------------


def _committees(m):
    return {shard: [m.B.PrivateKey.generate(bytes([50 + 10 * shard + i]))
                    for i in range(4)] for shard in (0, 1)}


def _link(m, committees, shard, block_num, signers):
    keys = committees[shard]
    block_hash = bytes([shard]) * 16 + block_num.to_bytes(16, "little")
    payload = m.SIG.construct_commit_payload(block_hash, block_num,
                                             block_num, True)
    agg = m.B.aggregate_sigs([keys[i].sign_hash(payload) for i in signers])
    mask = m.MASK.Mask([k.pub.point for k in keys])
    for i in signers:
        mask.set_bit(i, True)
    return m.CL.CrossLink(shard_id=shard, block_num=block_num,
                          view_id=block_num, epoch=1, block_hash=block_hash,
                          signature=agg.bytes, bitmap=mask.mask_bytes())


def _crosslinks(m, device=False):
    committees = _committees(m)
    engine = m.ENG.Engine(lambda shard, epoch: m.ENG.EpochContext(
        [k.pub.bytes for k in committees[shard]]), device=device)
    single = [m.CL.verify_crosslink(engine, _link(m, committees, 0, n, s))
              for n, s in ((500, [0, 1, 2, 3]), (501, [0, 1]))]
    links = [_link(m, committees, 0, 600, [0, 1, 2]),
             _link(m, committees, 1, 600, [1, 2, 3]),
             _link(m, committees, 0, 601, [0, 1, 2, 3])]
    stolen = m.CL.CrossLink(
        shard_id=0, block_num=600, view_id=600, epoch=1,
        block_hash=links[1].block_hash, signature=links[1].signature,
        bitmap=links[1].bitmap)
    return single, m.CL.verify_crosslinks_batch(engine, links + [stolen])


@pytest.mark.parametrize("mode", ("host", "device"))
def test_crosslinks_single_and_batch_across_shards(mode, monkeypatch):
    want = _crosslinks(J)
    if mode == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
        before = dict(T.DV.COUNTERS)
    got = _crosslinks(T, device=None if mode == "device" else False)
    assert got == want == ([True, False], [True, True, True, False])
    if mode == "device":
        # the batch's two committees: one device check group each
        assert T.DV.COUNTERS["agg_verify"] + T.DV.COUNTERS[
            "batch_verify"] > before["agg_verify"] + before["batch_verify"]


# -- webhooks ---------------------------------------------------------------


def _double_sign(m):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=4)
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    hooks = m.WH.Hooks()
    fired = []
    hooks.register("double_sign", fired.append)
    reg = m.REG.Registry(blockchain=chain,
                         txpool=m.POOL.TxPool(CHAIN_ID, 0, chain.state),
                         host=net.host("leader"), webhooks=hooks)
    node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([bls_keys[1]]))
    assert node.is_leader
    node.start_round_if_leader()

    def prepare(key, block_hash, payload=None):
        return m.MSG.FBFTMessage(
            msg_type=m.MSG.MsgType.PREPARE, view_id=node.view_id,
            block_num=node.block_num, block_hash=block_hash,
            sender_pubkeys=[key.pub.bytes],
            payload=payload or key.sign_hash(
                m.SIG.prepare_payload(block_hash)).bytes)

    rogue = bls_keys[2]
    announced = node.leader.current_block_hash
    counts = []
    for msg in (prepare(rogue, announced), prepare(rogue, b"\x66" * 32),
                prepare(bls_keys[0], b"\x55" * 32),
                prepare(rogue, b"\x77" * 32, payload=b"\x01" * 96)):
        node._on_prepare(msg)
        counts.append(len(node.pending_double_signs))
    drained = bool(node.drain_double_signs())
    return fired, counts, drained, len(node.pending_double_signs)


def test_leader_detects_double_sign_and_fires_webhook():
    """The equivocating key's second signed vote fires ``double_sign``
    with both votes; a late vote from another key and unsigned junk do
    not; the queue drains for the slash pipeline."""
    fired, counts, drained, left = _both(_double_sign)
    assert counts == [0, 1, 1, 1] and drained and left == 0
    assert len(fired) == 1 and fired[0]["second_hash"] == "66" * 32
    assert fired[0]["first_signature"]


def _hooks(m):
    hooks = m.WH.Hooks()
    hooks.register("view_change", lambda p: 1 / 0)
    hooks.fire("view_change", {"view": 5})
    first = list(hooks.fired)
    for i in range(1000):
        hooks.fire("view_change", {"view": i})
    with pytest.raises(ValueError) as e:
        hooks.register("nonsense", lambda p: None)
    return first, len(hooks.fired), hooks.fired[-1], str(e.value), \
        m.WH.Hooks.EVENTS


def test_hooks_never_raise_and_the_log_is_bounded():
    first, size, last, _, _ = _both(_hooks)
    assert first == [("view_change", {"view": 5})] and size == 256
    assert last == ("view_change", {"view": 999})


def _posted(m):
    """The JSON body, path and content type an HTTP hook posts to a
    loopback server."""
    got = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.append((self.path, self.headers["Content-Type"],
                        json.loads(body)))
            self.send_response(200)
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        hook = m.WH.http_post_hook(
            f"http://127.0.0.1:{srv.server_address[1]}/report", timeout=5.0)
        hook({"event": "double_sign", "keys": ["ab" * 48], "height": 7})
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        return got
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_hook_posts_the_payload_as_json():
    assert _both(_posted) == [("/report", "application/json", {
        "event": "double_sign", "keys": ["ab" * 48], "height": 7})]
