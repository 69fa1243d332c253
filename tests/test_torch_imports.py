"""The port stands alone: no module of distributed_plonk_tpu_torch and not
chip_smoke.py imports jax or anything of the JAX package (an AST scan),
and importing every module of the port in a fresh interpreter leaves
neither in sys.modules."""

import ast
import pathlib
import subprocess
import sys

import distributed_plonk_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(distributed_plonk_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "distributed_plonk_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_or_reference_package_imports():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += ["%s:%d %s" % (path.name, node.lineno, n)
                    for n in names if _forbidden(n)]
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(
        "distributed_plonk_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(len(%r), bad)\n"
        "sys.exit(1 if bad else 0)\n" % (mods, FORBIDDEN, mods))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
