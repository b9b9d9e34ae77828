"""The port's native KV store against the JAX package's.

The port builds its own copy of ``native/kvstore.cpp`` with g++ into
``harmony_tpu_torch/_build/`` (the one build of this file).  A store
written by the port's ``NativeKV`` opens under the JAX package's
``FileKV`` and under its ``NativeKV`` binding, and the other way round;
the torn-tail, torn-value, torn-batch and corruption cases of
``tests/test_kv_native.py`` (``tests/kv_corruption.py``) reach the same
verdicts in both packages.  The JAX package's binding is pointed at the
port's library (the same source, byte for byte), so that this file
never runs the JAX package's ``make``.
"""

import os
import shutil
from pathlib import Path

import pytest

import kv_corruption as KC
from harmony_tpu.core import kv as J_KV
from harmony_tpu.core import kv_native as J_KVN
from harmony_tpu_torch.core import kv as T_KV
from harmony_tpu_torch.core import kv_native as T_KVN

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def library():
    """The port's library, built (or found) once for this file."""
    return T_KVN.build_native()


@pytest.fixture
def jax_native(library, monkeypatch):
    """The JAX package's NativeKV over the port's build of the source."""
    monkeypatch.setattr(J_KVN, "_LIB_PATH", str(library))
    monkeypatch.setattr(J_KVN, "_lib", None)
    return J_KVN.NativeKV


def test_the_library_is_the_ports_own_build(library):
    assert (REPO / "harmony_tpu_torch/native/kvstore.cpp").read_bytes() \
        == (REPO / "native/kvstore.cpp").read_bytes()
    assert library.parent == REPO / "harmony_tpu_torch" / "_build"
    assert library.name.startswith("libharmony_kv_")
    assert T_KVN.library_path() == library and T_KVN.available()
    # never the JAX package's library under native/
    assert "native/libharmony_kv.so" not in str(library)


def _write(db, WriteBatch):
    db.put(b"a", b"1")
    db.put(b"b", b"22")
    db.put(b"a", b"333")
    db.delete(b"b")
    batch = WriteBatch()
    batch.put(b"c", b"4444")
    batch.put(b"d", b"5")
    batch.delete(b"d")
    db.write_batch(batch)
    db.flush()
    db.close()


def _read(db):
    out = {k: db.get(k) for k in (b"a", b"b", b"c", b"d", b"e")}
    out["has"] = [db.has(k) for k in (b"a", b"b", b"c", b"d")]
    out["len"] = len(db)
    db.close()
    return out


WANT = {b"a": b"333", b"b": None, b"c": b"4444", b"d": None, b"e": None,
        "has": [True, False, True, False], "len": 2}


@pytest.mark.parametrize("writer", ("port native", "jax native",
                                    "jax file", "port file"))
def test_a_store_opens_in_every_backend_of_both_packages(
        tmp_path, writer, jax_native):
    path = str(tmp_path / "kv.db")
    factory, WriteBatch = {
        "port native": (T_KVN.NativeKV, T_KV.WriteBatch),
        "jax native": (jax_native, J_KV.WriteBatch),
        "jax file": (J_KV.FileKV, J_KV.WriteBatch),
        "port file": (T_KV.FileKV, T_KV.WriteBatch),
    }[writer]
    _write(factory(path), WriteBatch)
    for reader in (T_KVN.NativeKV, jax_native, J_KV.FileKV, T_KV.FileKV):
        assert _read(reader(path)) == WANT, (writer, reader)
    # the port's native store compacts what another wrote; all read it
    db = T_KVN.NativeKV(path)
    before = os.path.getsize(path)
    db.compact()
    assert os.path.getsize(path) < before
    db.close()
    assert _read(J_KV.FileKV(path)) == _read(jax_native(path)) == WANT


def test_torn_tails_and_values_as_the_jax_packages(tmp_path, jax_native):
    """test_kv_native.py's torn-tail and torn-value cases: each package's
    native store drops the same bytes."""
    tails = {
        "header": b"\x09\x00\x00\x00\x05",
        "value": b"\x04\x00\x00\x00" + b"\x64\x00\x00\x00" + b"torn"
                 + b"abc",
        "klen": b"\xfe\xff\xff\xff" + b"\x01\x00\x00\x00" + b"xx",
    }
    for name, tail in tails.items():
        seen = {}
        for label, factory in (("port", T_KVN.NativeKV),
                               ("jax", jax_native)):
            path = str(tmp_path / f"{name}_{label}.db")
            db = factory(path)
            db.put(b"good", b"value")
            db.flush()
            db.close()
            with open(path, "ab") as f:
                f.write(tail)
            db = factory(path)
            got = (db.get(b"good"), db.get(b"torn"), db.get(b"xx"))
            db.put(b"after", b"tear")
            db.close()
            seen[label] = (got, open(path, "rb").read())
        assert seen["port"] == seen["jax"], name
        assert seen["port"][0] == (b"value", None, None)


def test_torn_batch_discarded_by_both_packages(tmp_path, jax_native):
    path = str(tmp_path / "batch.db")
    db = T_KVN.NativeKV(path)
    db.put(b"pre", b"existing")
    batch = T_KV.WriteBatch()
    batch.put(b"b1", b"v1")
    batch.put(b"pre", b"overwritten")
    batch.delete(b"b1")
    db.write_batch(batch)
    db.close()
    with open(path, "ab") as f:
        f.write(KC.marker(0xFFFFFFFE, 2) + KC.rec(b"lost", b"L"))
    for factory in (T_KVN.NativeKV, jax_native, J_KV.FileKV, T_KV.FileKV):
        copy = str(tmp_path / f"copy_{factory.__module__}_"
                   f"{factory.__name__}.db")
        shutil.copy(path, copy)
        db = factory(copy)
        assert db.get(b"lost") is None
        assert db.get(b"pre") == b"overwritten"
        assert db.get(b"b1") is None
        db.close()


@pytest.mark.parametrize("case", KC.CASES, ids=[c[0] for c in KC.CASES])
def test_shared_corruption_cases_as_the_jax_packages(tmp_path, case,
                                                     jax_native):
    """Every shared corruption fixture: the port's native store reaches
    the verdict the suite expects, and leaves the same bytes on disk as
    the JAX package's binding does."""
    name, tail, expect = case
    files = {}
    for label, factory in (("port", T_KVN.NativeKV), ("jax", jax_native)):
        path = str(tmp_path / f"{name}_{label}.db")
        KC.run_case(factory, path, tail, expect)
        files[label] = open(path, "rb").read()
    assert files["port"] == files["jax"]


def test_a_chain_on_the_ports_native_store_opens_in_the_jax_package(
        tmp_path, jax_native):
    from harmony_tpu.core.blockchain import Blockchain as J_Blockchain
    from harmony_tpu.core.genesis import dev_genesis as j_dev_genesis
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import dev_genesis
    from harmony_tpu_torch.node.worker import Worker

    genesis, _, _ = dev_genesis()
    path = str(tmp_path / "chain.db")
    chain = Blockchain(T_KVN.NativeKV(path, fsync="batch"), genesis,
                       blocks_per_epoch=16)
    blocks = []
    for view in (1, 2, 3):
        block = Worker(chain, None).propose_block(view_id=view)
        assert chain.insert_chain([block], verify_seals=False) == 1
        blocks.append(block.hash())
    chain.db.close()
    j_genesis, _, _ = j_dev_genesis()
    for db in (jax_native(path), J_KV.FileKV(path)):
        j_chain = J_Blockchain(db, j_genesis, blocks_per_epoch=16)
        assert j_chain.head_number == 3
        assert [j_chain.block_by_number(n).hash() for n in (1, 2, 3)] \
            == blocks
        db.close()
