"""The port stands alone: nothing under harmony_tpu_torch/ and nothing in
chip_smoke.py or final_exp_parts.py imports JAX or the JAX package
(harmony_tpu), nor the JAX package's operator tools (the top-level
``tools``), nor the ``cryptography`` package, which the card's machine
lacks."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "harmony_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "final_exp_parts.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "harmony_tpu", "cryptography", "tools")


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
    assert _forbidden("cryptography.hazmat.primitives.ciphers")
    assert _forbidden("tools.obs_smoke") and _forbidden("tools")
    assert not _forbidden("harmony_tpu_torch.ops.fp")
    assert not _forbidden("harmony_tpu_torch.tools.obs_smoke")
    src = ("import jax\nfrom harmony_tpu.ops import fp\nfrom . import fp\n"
           "from cryptography.hazmat.primitives import ciphers\n")
    tree = ast.parse(src)
    mods = [n.module if isinstance(n, ast.ImportFrom) else n.names[0].name
            for n in tree.body if getattr(n, "level", 0) == 0]
    assert [m for m in mods if _forbidden(m)] == [
        "jax", "harmony_tpu.ops", "cryptography.hazmat.primitives"]


# The node layer: each module at the JAX package's path.
NODE_LAYER = (
    "crypto_ecdsa", "config", "config.chain", "config.sharding", "core",
    "core.types", "core.kv", "core.trie", "core.state", "crypto_bn256",
    "core.vm", "core.state_processor", "core.rawdb", "core.genesis", "obs",
    "obs.replay", "staking.slash", "crypto_vrf", "core.blockchain",
    "core.tx_pool", "consensus.safety", "consensus.sender", "p2p",
    "p2p.gating", "p2p.groups", "p2p.host", "node", "node.registry",
    "node.services", "node.worker", "node.ingress", "node.cross_shard",
    "node.node", "core.snapshot", "accounts", "accounts.abi",
    "accounts.bech32", "accounts.hd", "config.genesis_accounts",
    "ref.herumi", "chain.crosslink", "staking.availability",
    "chain.finalize", "webhooks", "core.epochchain", "p2p.stream",
    "sync", "sync.epoch_feed", "sync.staged", "core.kv_native",
    "keystore", "blsgen_kms", "ntp", "p2p.discovery", "obs.sink",
    "obs.timeline", "hmy", "hmy.facade", "rpc", "rpc.server", "rpc.ws",
    "explorer", "rosetta", "cli", "ref.constants_gen", "vdf",
    "vdf_wesolowski", "crypto_vrf_p256", "accounts.keystore_v3",
    "chaostest.scenario", "chaostest.netem", "chaostest.fixtures",
    "chaostest.byzantine", "chaostest.runner", "chaostest.scenarios",
    "chaostest",
)


def test_node_layer_imports_without_jax_or_harmony_tpu():
    """In a fresh interpreter, every module of the node layer imports and
    neither JAX, the JAX package nor ``cryptography`` is loaded
    afterwards."""
    import subprocess
    import sys

    code = (
        "import importlib, sys\n"
        f"for m in {NODE_LAYER!r}:\n"
        "    importlib.import_module('harmony_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'harmony_tpu',\n"
        "                                    'cryptography'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _public(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _source(package: str, module: str) -> Path:
    base = REPO / package / Path(*module.split("."))
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


@pytest.mark.parametrize("module", NODE_LAYER)
def test_node_layer_mirrors_the_jax_packages_names(module):
    """Each copy keeps the JAX module's top-level public names."""
    port = _public(_source("harmony_tpu_torch", module))
    want = _public(_source("harmony_tpu", module))
    assert want <= port, sorted(want - port)


# The operator tools: each the JAX package's tools/<name>.py.
TOOLS = ("obs_smoke", "sched_smoke", "compile_surface_smoke", "loadgen",
         "soak", "crash_sweep", "chaos_sweep", "round_forensics",
         "localnet")


def test_the_tools_import_alone_and_set_nothing():
    """In a fresh interpreter every tool imports; none loads JAX, the JAX
    package, its tools or ``cryptography``, and none changes the
    environment or ``sys.path`` at import."""
    import subprocess
    import sys

    code = (
        "import importlib, os, sys\n"
        "env, path = dict(os.environ), list(sys.path)\n"
        "importlib.import_module('harmony_tpu_torch.tools')\n"
        f"for m in {TOOLS!r}:\n"
        "    importlib.import_module('harmony_tpu_torch.tools.' + m)\n"
        "assert dict(os.environ) == env, set(os.environ) ^ set(env)\n"
        "assert sys.path == path, sys.path\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'harmony_tpu',\n"
        "                                    'cryptography', 'tools'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _flags(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    return {a.value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("-")}


@pytest.mark.parametrize("tool", TOOLS)
def test_each_tool_keeps_the_jax_tools_names_and_flags(tool):
    """The same public names and flags as the JAX package's tool; the
    port adds ``--cpu`` (the twins off the card) and nothing else."""
    port = REPO / "harmony_tpu_torch" / "tools" / f"{tool}.py"
    jax = REPO / "tools" / f"{tool}.py"
    assert _public(jax) <= _public(port), sorted(_public(jax) - _public(port))
    text = port.read_text(encoding="utf-8")
    # --cpu comes from the package's add_cpu_flag: every tool but the
    # storage sweep, which checks no signature
    cpu = {"--cpu"} if "add_cpu_flag(" in text else set()
    assert bool(cpu) == (tool != "crash_sweep")
    assert _flags(port) | cpu == _flags(jax) | cpu
    assert "sys.path.insert" not in text and "os.environ[" not in text
