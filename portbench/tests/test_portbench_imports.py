"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (``spmm_denseblock_tpu_torch`` begins with
``spmm_denseblock_tpu``); only the adapters of ``systems/`` import the
port, and the reference and the models' files do not; and a whole dry
run loads neither."""

import ast
import subprocess
import sys

import pytest

from portbench import harness, spec

MODULES = sorted((spec.ROOT / "portbench").rglob("*.py"))
PORT = "spmm_denseblock_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.JAX_NAMES)


def test_only_the_system_and_the_tests_import_the_port():
    importers = {p.relative_to(spec.ROOT / "portbench").as_posix() for p in MODULES
                 if PORT in top_level_imports(p)}
    assert {p for p in importers if not p.startswith("tests/")} == {
        p.relative_to(spec.ROOT / "portbench").as_posix() for p in MODULES
        if p.parent.name == "systems"}
    for path in [spec.ROOT / "portbench" / "reference.py",
                 *(spec.ROOT / "portbench" / "models").glob("*.py")]:
        assert PORT not in top_level_imports(path)


def test_a_dry_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "harness.main(['--workload', 'gcn-arxiv.train', '--seed', '1',"
            " '--seconds', '0.2', '--trace', '1'], hook=harness.Hook());"
            "import spmm_denseblock_tpu_torch;"
            "print('LOADED', harness.loaded_jax())")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout
