"""The port stands alone: nothing under harmony_tpu_torch/ and nothing in
chip_smoke.py or final_exp_parts.py imports JAX or the JAX package
(harmony_tpu)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "harmony_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "final_exp_parts.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "harmony_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_harmony_tpu_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_rule_sees_what_it_forbids():
    assert _forbidden("jax.numpy") and _forbidden("harmony_tpu.ref.params")
    assert not _forbidden("harmony_tpu_torch.ops.fp")
    src = "import jax\nfrom harmony_tpu.ops import fp\nfrom . import fp\n"
    tree = ast.parse(src)
    mods = [n.module if isinstance(n, ast.ImportFrom) else n.names[0].name
            for n in tree.body if getattr(n, "level", 0) == 0]
    assert [m for m in mods if _forbidden(m)] == ["jax", "harmony_tpu.ops"]
