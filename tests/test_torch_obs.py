"""The port's round forensics (``obs/sink.py``, ``obs/timeline.py``)
against the JAX package's: the same spans give the same timelines, clock
offsets and phase split, and the span files one package's ``SpanSink``
writes read back equal in the other's ``read_spans``.

The spans are synthetic rounds (a skewed two-process round, an abandoned
round) and one real committed round of the port's in-process localnet
of four nodes on the host path, traced."""

import json
import os

import pytest

from harmony_tpu import health as J_HL
from harmony_tpu import obs as J_OBS
from harmony_tpu import trace as J_TR
from harmony_tpu_torch import health as T_HL
from harmony_tpu_torch import obs as T_OBS
from harmony_tpu_torch import trace as T_TR

CHAIN_ID = 2


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for TR, HL in ((J_TR, J_HL), (T_TR, T_HL)):
        TR.reset()
        HL.reset()
        TR.configure(dump_dir=str(tmp_path))
    yield
    for TR, HL in ((J_TR, J_HL), (T_TR, T_HL)):
        TR.reset()
        HL.reset()


def _skewed(skew_s):
    """A two-process round, the validator's clock off by ``skew_s``
    (tests/test_obs.py's synthetic trace)."""
    tid, mk = "cd" * 16, lambda i: f"{i:02x}" * 8

    def sp(i, name, ts, dur, pid, node, **attrs):
        attrs["node"] = node
        return {"trace_id": tid, "span_id": mk(i), "name": name,
                "ts": ts, "dur_s": dur, "pid": pid, "attrs": attrs}

    return [
        sp(1, "consensus.round", 0.0, 1.0, 1, "L", block=3),
        sp(2, "consensus.phase.announce", 0.0, 0.01, 1, "L"),
        sp(3, "consensus.phase.prepare_quorum", 0.01, 0.34, 1, "L"),
        sp(4, "consensus.phase.commit_quorum", 0.4, 0.4, 1, "L"),
        sp(5, "consensus.prepare", 0.3, 0.001, 1, "L"),
        sp(6, "sched.enqueue", 0.31, 0.02, 1, "L", lane="consensus"),
        sp(7, "device.dispatch", 0.33, 0.01, 1, "L", kind="agg_verify"),
        sp(8, "chain.finalize", 0.85, 0.1, 1, "L"),
        sp(9, "consensus.announce", 0.05 + skew_s, 0.1, 2, "V"),
    ]


def _abandoned():
    rnd = {"trace_id": "ab" * 16, "span_id": "01" * 8, "name":
           "consensus.round", "ts": 100.0, "dur_s": 0.8, "pid": 1,
           "attrs": {"node": "node0", "block": 7, "abandoned": True}}
    ann = {"trace_id": "ab" * 16, "span_id": "02" * 8, "name":
           "consensus.phase.announce", "ts": 100.0, "dur_s": 0.01,
           "pid": 1, "attrs": {"node": "node0"}}
    return [rnd, ann]


def _forensics(OBS, spans):
    """Everything the timeline module derives from ``spans``."""
    out = {"offsets": OBS.align_clocks(spans)}
    for label, kwargs in (("aligned", {}), ("raw", {"skew_align": False}),
                          ("all", {"committed_only": False})):
        tls = OBS.build_timelines(spans, **kwargs)
        out[label] = [tl.to_dict() for tl in tls]
        out[label + "_dominant"] = [tl.dominant_phase() for tl in tls]
    return out


@pytest.mark.parametrize("spans", [
    _skewed(0.0), _skewed(-2.0), _skewed(3.0), _abandoned(), []],
    ids=["causal", "behind", "ahead", "abandoned", "empty"])
def test_the_same_spans_give_the_same_forensics(spans):
    assert T_OBS.PHASES == J_OBS.PHASES
    assert _forensics(T_OBS, spans) == _forensics(J_OBS, spans)


def _traced_round():
    """One committed round of 4 in-process port nodes, traced; its spans
    as dicts."""
    from harmony_tpu_torch import device as DV
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import dev_genesis
    from harmony_tpu_torch.core.kv import MemKV
    from harmony_tpu_torch.core.tx_pool import TxPool
    from harmony_tpu_torch.multibls import PrivateKeys
    from harmony_tpu_torch.node.node import Node
    from harmony_tpu_torch.node.registry import Registry
    from harmony_tpu_torch.p2p import InProcessNetwork

    DV.use_device(False)
    T_TR.configure(enabled=True)
    genesis, _, bls_keys = dev_genesis(n_keys=4)
    net = InProcessNetwork()
    nodes = []
    try:
        for i in range(4):
            chain = Blockchain(MemKV(), genesis, blocks_per_epoch=16)
            reg = Registry(blockchain=chain,
                           txpool=TxPool(CHAIN_ID, 0, chain.state),
                           host=net.host(f"node{i}"))
            nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))
        next(n for n in nodes if n.is_leader).start_round_if_leader()
        for _ in range(50):
            if not any(n.process_pending() for n in nodes):
                break
        assert all(n.chain.head_number == 1 for n in nodes)
    finally:
        for n in nodes:
            n.stop()
        DV.use_device(None)
    return [s.to_dict() for s in T_TR.spans()]


def test_a_real_rounds_spans_give_the_same_timeline():
    spans = _traced_round()
    got = _forensics(T_OBS, spans)
    assert got == _forensics(J_OBS, spans)
    assert len(got["aligned"]) == 1
    tl = got["aligned"][0]
    assert tl["committed"] and tl["attributed_fraction"] >= 0.95
    assert {"node0", "node1", "node2", "node3"} <= set(tl["nodes"])
    summaries = []
    for OBS in (T_OBS, J_OBS):
        before = {p: h._total for p, h in OBS.ROUND_PHASE_SECONDS.items()}
        summary = OBS.observe_timelines(OBS.build_timelines(spans))
        after = {p: h._total - before[p]
                 for p, h in OBS.ROUND_PHASE_SECONDS.items()}
        summaries.append((summary, after))
    assert summaries[0] == summaries[1]
    assert summaries[0][0]["rounds"] == 1


def _sink_spans(TR, OBS, directory, node):
    """200 spans through one package's armed sink; its files."""
    TR.configure(enabled=True)
    TR.set_node(node)
    sink = OBS.SpanSink(str(directory), max_bytes=4096, keep=2).arm()
    try:
        for i in range(200):
            with TR.span("consensus.round", component="consensus",
                         block=i):
                pass
    finally:
        sink.close()
    assert sink.written == 200 and sink.dropped == 0
    return sink.files()


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_sink_files_read_the_same_in_both_packages(tmp_path, writer):
    TR, OBS = {"port": (T_TR, T_OBS), "jax": (J_TR, J_OBS)}[writer]
    files = _sink_spans(TR, OBS, tmp_path, f"node-{writer}")
    assert os.path.basename(files[0]) == f"spans_node-{writer}.jsonl"
    assert 1 < len(files) <= 3
    got = T_OBS.read_spans(files)
    assert got == J_OBS.read_spans(files)
    assert got and all(s["attrs"]["node"] == f"node-{writer}"
                       for s in got)
    # the same names and rotation in both packages' sinks
    other = {"port": (J_TR, J_OBS), "jax": (T_TR, T_OBS)}[writer]
    twin = _sink_spans(*other, tmp_path / "twin", f"node-{writer}")
    assert [os.path.basename(f) for f in twin] == [
        os.path.basename(f) for f in files]


def test_both_readers_survive_the_same_garbage(tmp_path):
    p = tmp_path / "spans_evil.jsonl"
    good = json.dumps({"trace_id": "aa" * 16, "span_id": "bb" * 8,
                       "name": "consensus.round", "ts": 1.0,
                       "dur_s": 0.5, "pid": 9, "attrs": {}})
    with open(p, "w") as f:
        f.write('{"trace_id": 12, "span_id": "x"}\n')
        f.write("{not json at all\n")
        f.write('{"a": "' + "x" * (128 * 1024) + '"}\n')
        f.write(good + "\n")
        f.write('{"trace_id": "cc"}')
    (tmp_path / "spans_bin.jsonl").write_bytes(bytes(range(256)) * 16)
    for path in (p, tmp_path / "spans_bin.jsonl",
                 tmp_path / "missing.jsonl"):
        assert T_OBS.read_spans(str(path)) == J_OBS.read_spans(str(path))
    assert len(T_OBS.read_spans(str(p))) == 1


def test_the_exposition_of_the_obs_families_matches():
    def heads(text):
        return [line for line in text.splitlines() if line.startswith("#")]
    assert heads(T_OBS.expose_metrics()) == heads(J_OBS.expose_metrics())
