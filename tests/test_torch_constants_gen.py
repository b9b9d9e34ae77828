"""The port's constants generator (``harmony_tpu_torch/ref/
constants_gen.py``): regenerating ``harmony_tpu_torch/ops/_constants.py``
gives the committed file byte for byte, and every value in it is the JAX
package's (whose file its own generator regenerates the same way)."""

from __future__ import annotations

import ast
from pathlib import Path

from harmony_tpu.ref import constants_gen as JG
from harmony_tpu_torch.ref import constants_gen as TG

REPO = Path(__file__).resolve().parents[1]
PORT_FILE = REPO / "harmony_tpu_torch" / "ops" / "_constants.py"
JAX_FILE = REPO / "harmony_tpu" / "ops" / "_constants.py"


def _values(text: str) -> dict:
    """Every top-level assignment of a generated file, evaluated."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.Assign):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_regenerating_leaves_the_ports_file_unchanged():
    assert PORT_FILE.read_text() == TG.generate()


def test_generator_writes_the_ports_file(tmp_path, monkeypatch):
    """main() writes ops/_constants.py beside the generator's package."""
    fake = tmp_path / "ref" / "constants_gen.py"
    (tmp_path / "ops").mkdir()
    monkeypatch.setattr(TG, "__file__", str(fake))
    TG.main()
    assert (tmp_path / "ops" / "_constants.py").read_text() == TG.generate()


def test_values_are_the_jax_packages():
    port, want = _values(TG.generate()), _values(JG.generate())
    assert port == want == _values(JAX_FILE.read_text())
    assert len(port) == 19
    assert TG.generate().startswith(
        '"""GENERATED by harmony_tpu_torch.ref.constants_gen')
