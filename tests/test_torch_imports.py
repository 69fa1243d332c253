"""The port stands alone: no module of distributed_plonk_tpu_torch, not
chip_smoke.py and no `scripts/torch_*.py` script imports jax or anything
of the JAX package (an AST scan), the scripts read no environment either,
and importing every module of the port in a fresh interpreter leaves
neither in sys.modules. Two checks reach what an import scan cannot: no
string in the port names a module of the JAX package (a `python -m
distributed_plonk_tpu.runtime.worker` in a subprocess argument list), and
every relative import, the lazy ones inside functions included, resolves
to a module of the port and a name defined there."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

import distributed_plonk_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = pathlib.Path(distributed_plonk_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "distributed_plonk_tpu")


def _scripts():
    files = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) >= 6
    return files


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        _scripts()
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


def test_no_string_names_a_jax_package_module():
    pattern = re.compile(r"\bdistributed_plonk_tpu\.")
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    pattern.search(node.value):
                bad.append("%s:%d %r" % (path.name, node.lineno,
                                         node.value[:80]))
    assert bad == []


def _module_file(parts):
    """The port file of a dotted module path inside the port, or None."""
    base = PORT.joinpath(*parts)
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _top_level_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0]
                      for a in node.names}
    return names


def test_every_relative_import_resolves_inside_the_port():
    bad, seen = [], 0
    for path in sorted(PORT.rglob("*.py")):
        pkg = list(path.relative_to(PORT).parent.parts)
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom) or node.level == 0:
                continue
            seen += 1
            where = "%s:%d" % (path.relative_to(PORT), node.lineno)
            if node.level - 1 > len(pkg):
                bad.append(where + " climbs out of the port")
                continue
            base = pkg[:len(pkg) - (node.level - 1)]
            target = base + (node.module.split(".") if node.module else [])
            mod = _module_file(target)
            if mod is None:
                bad.append("%s no module %s" % (where, ".".join(target)))
                continue
            defined = _top_level_names(mod)
            for alias in node.names:
                if alias.name not in defined and \
                        _module_file(target + [alias.name]) is None:
                    bad.append("%s %s has no %s" % (
                        where, ".".join(target) or "the port", alias.name))
    assert seen > 100
    assert bad == []


def test_no_module_of_the_port_reads_the_environment():
    """The port's settings are constants or arguments: no module reads
    os.environ or os.getenv (the JAX package's DPT_* knobs have no
    counterpart, in parallel/ and circuits/ as elsewhere)."""
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in ("environ", "getenv", "environb"):
                bad.append("%s:%d %s" % (path.relative_to(PORT),
                                         node.lineno, node.attr))
    assert {p.parent.name for p in PORT.rglob("*.py")} >= {"parallel",
                                                            "circuits"}
    assert bad == []


@pytest.mark.parametrize("rel", ["runtime/membership.py",
                                 "runtime/supervisor.py",
                                 "service/autoscale.py"])
def test_the_elastic_fleet_modules_are_scanned(rel):
    """The elastic fleet's modules exist and are among the files the
    scans above read: no jax, nothing of the JAX package, no
    environment read (their settings are arguments and constants)."""
    path = PORT / rel
    assert path in _sources()
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names] + \
        [node.module or "" for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert names and not any(_forbidden(n) for n in names)
    assert not any(isinstance(node, ast.Attribute) and node.attr in (
        "environ", "getenv") for node in ast.walk(tree))


@pytest.mark.parametrize("rel,imports_torch", [
    ("obs/fleet.py", False), ("obs/profiling.py", True),
    ("backend/autotune.py", True), ("store/calibration.py", False)])
def test_the_observability_and_calibration_modules_stand_alone(
        rel, imports_torch):
    """The observability and calibration planes' modules are scanned by
    the checks above, import nothing of jax or the JAX package (their
    lazy imports inside functions included) and read no environment;
    the ones that compute import torch (obs/fleet.py is plain Python,
    store/calibration.py reaches torch through backend/autotune.py).
    Imported and used in a fresh interpreter (a fleet entry rendered, a
    stack profile taken, a kernel parameter resolved), they load no
    module of jax or of the JAX package."""
    path = PORT / rel
    assert path in _sources()
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names] + \
        [node.module or "" for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert not any(_forbidden(n) for n in names)
    assert ("torch" in names) == imports_torch
    assert not any(isinstance(node, ast.Attribute) and node.attr in (
        "environ", "getenv") for node in ast.walk(tree))
    mod = "distributed_plonk_tpu_torch." + rel[:-3].replace("/", ".")
    code = (
        "import sys, importlib\n"
        "m = importlib.import_module(%r)\n"
        "if %r.endswith('fleet'):\n"
        "    m.render_prom([{'index': 0, 'addr': 'a', 'reachable': True,"
        " 'suspect': False, 'snapshot': None}])\n"
        "elif %r.endswith('profiling'):\n"
        "    m.capture(5, kind='stacks')\n"
        "else:\n"
        "    from distributed_plonk_tpu_torch.backend import msm_torch\n"
        "    msm_torch.resolve_chunk(None, 8)\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in %r))\n" % (mod, mod, mod,
                                                     FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["torch_warmup.py", "torch_fleet.py",
                                  "torch_loadgen.py", "torch_autotune.py",
                                  "torch_warm_ab.py",
                                  "torch_service_contention.py",
                                  "torch_fleet_baseline.py",
                                  "torch_gen_proof_fixtures.py"])
def test_the_port_scripts_stand_alone(name):
    """Every scripts/torch_*.py is among the scanned sources, imports
    nothing of jax or of the JAX package (its lazy imports inside
    functions included) and reads no environment: its settings are flags
    and constants."""
    path = ROOT / "scripts" / name
    assert path in _sources()
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names] + \
        [node.module or "" for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert names and not any(_forbidden(n) for n in names)
    reads = ["%s:%d %s" % (name, node.lineno, node.attr)
             for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)
             and node.attr in ("environ", "getenv", "environb")]
    assert reads == []


_ANALYSIS_STDLIB = {"argparse", "ast", "glob", "json", "math", "operator",
                    "os", "re", "sys", "time"}


@pytest.mark.parametrize("rel", ["analysis/__init__.py",
                                 "analysis/__main__.py", "analysis/bounds.py",
                                 "analysis/values.py", "analysis/registry.py",
                                 "analysis/lint.py", "analysis/mutants.py"])
def test_the_analysis_modules_stand_alone(rel):
    """The port's static verifier is among the scanned sources; its
    modules (lazy imports inside functions included) import torch, numpy,
    the standard library and the port, never jax or anything of the JAX
    package (not even its poly oracle or its samplers), and read no
    environment."""
    path = PORT / rel
    assert path in _sources()
    tree = ast.parse(path.read_text(), filename=str(path))
    absolute = [a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names] + \
        [node.module or "" for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert not any(_forbidden(n) for n in absolute)
    tops = {n.split(".")[0] for n in absolute}
    assert tops <= {"torch", "numpy"} | _ANALYSIS_STDLIB, tops
    assert not any(isinstance(node, ast.Attribute) and node.attr in (
        "environ", "getenv", "environb") for node in ast.walk(tree))
