"""What the benchmark may import, by whole top-level module name: nothing
of JAX, of the JAX package (``repro``) or of its harness
(``benchmarks``) anywhere under ``perfbench/``; and the reference
imports neither the port (``repro_torch``) nor any module of the
benchmark outside ``perfbench/reference``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py"))


def _imports(path: Path):
    """(top-level name, level, dotted name) of every import."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            yield mod.split(".")[0], node.level, mod


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_and_no_jax_package(rel):
    bad = {top for top, level, _ in _imports(PKG / rel)
           if level == 0 and top in FORBIDDEN}
    assert not bad, f"{rel} imports {sorted(bad)}"


@pytest.mark.parametrize("rel", [f for f in FILES
                                 if f.startswith("reference/")])
def test_reference_stands_alone(rel):
    for top, level, name in _imports(PKG / rel):
        assert top != "repro_torch" and top != "perfbench", (rel, name)
        assert level <= 1, (rel, name)     # within perfbench/reference


def test_a_loaded_harness_holds_no_jax():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}];"
            "import perfbench.harness, perfbench.program, perfbench.judge;"
            "import perfbench.traffic.table2, perfbench.traffic.open_loop;"
            "tops = {{m.split('.')[0] for m in sys.modules}};"
            "print(sorted(tops & set({bad!r})))").format(
        root=str(PKG.parent), src=str(PKG.parent / "src"),
        bad=sorted(FORBIDDEN))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_name_match_is_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
