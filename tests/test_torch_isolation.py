"""The PyTorch package stands alone: it imports neither jax nor the JAX
package ``repro``, and neither do ``chip_smoke.py`` and the example twins
(``examples/torch_*.py``).

* A fresh interpreter imports every ``repro_torch`` module and then checks
  ``sys.modules``: a transitive import would show there.
* An AST scan of every source file finds no ``import`` of ``jax`` or
  ``repro``/``repro.*`` (including imports inside functions, which only run
  on some paths).
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PKG = os.path.join(SRC, "repro_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    examples = os.path.join(REPO, "examples")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        if not path.startswith(PKG):
            continue
        rel = os.path.relpath(path, SRC)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_package_pulls_in_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {_modules()!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len({_modules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"
