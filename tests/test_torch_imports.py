"""The port stands alone: no file of cindm_tpu_torch/ nor chip_smoke.py
imports JAX, Flax, optax, orbax, ml_dtypes or the JAX package, directly or through another
module."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "cindm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN_TEXT = re.compile(r"\b(import|from) (jax|flax|optax|orbax)\b|ml_dtypes|\bcindm_tpu\.")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "cindm_tpu")


def test_port_has_files():
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_file_names_no_jax(path):
    text = path.read_text()
    assert not FORBIDDEN_TEXT.search(text), FORBIDDEN_TEXT.search(text).group(0)
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN_MODULES, (path, n)


def test_port_imports_without_jax_installed():
    """Import every module of the port with JAX and the JAX package made
    unimportable, in a fresh interpreter."""
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in FILES if p.name != "chip_smoke.py"
    ] + ["chip_smoke"]
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN_MODULES!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
