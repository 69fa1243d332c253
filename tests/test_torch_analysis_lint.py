"""The port's static verifier: its lints over the port, its seeded
mutants, and its CLI.

- run_lints() over distributed_plonk_tpu_torch/ is clean (every finding
  on the tree was fixed or carries `# analysis: ok(<reason>)`).
- The lock rules agree with the JAX package's: the same codes on the same
  lines for the JAX lock mutants and its LOCK01/02 cases.
- Every port mutant is rejected by the pass that owns its bug class, and
  every value-class mutant is bounds-clean.
- The CLI exits 0 on a clean selection and non-zero on a mutant registry.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_plonk_tpu.analysis import lint as JL
from distributed_plonk_tpu.analysis import mutants as JM
from distributed_plonk_tpu.runtime import protocol as jax_protocol
from distributed_plonk_tpu_torch.analysis import lint as L
from distributed_plonk_tpu_torch.analysis import mutants as M
from distributed_plonk_tpu_torch.analysis import registry as R
from distributed_plonk_tpu_torch.analysis.__main__ import main as cli_main
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.runtime import protocol

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_plonk_tpu_torch"


def test_port_lints_clean():
    assert [str(f) for f in L.run_lints()] == []


# --- the lock rules agree with the JAX package's ------------------------------

_LOCK_MUTANT = '''
import threading
class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self.entries = {}
    def put(self, k, v):
        with self._lock:
            self.entries[k] = v
    def evict_all(self):   # MUTANT: lock removed
        self.entries = {}
'''

_LOCK_CLEAN = _LOCK_MUTANT.replace(
    "    def evict_all(self):   # MUTANT: lock removed\n"
    "        self.entries = {}",
    "    def evict_all(self):\n"
    "        with self._lock:\n"
    "            self.entries = {}")

_LOCK02 = '''
import threading
class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self.stopping = False
    def gate(self):
        with self._lock:
            return self.stopping
    def stop(self):
        self.stopping = True
'''

_LOCK_HELPER = '''
import threading
class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self.seq = 0
    def bump(self):
        self.seq += 1          # only ever called under the lock
    def put(self):
        with self._lock:
            self.bump()
'''


def _lock_sites(findings):
    return sorted((f.code, f.line) for f in findings
                  if f.code.startswith("LOCK"))


@pytest.mark.parametrize("name,src", [
    ("LOCK03_MUTANT", JM.LOCK03_MUTANT),
    ("LOCK03_FIXED", JM.LOCK03_FIXED),
    ("LOCK03_SELF_MUTANT", JM.LOCK03_SELF_MUTANT),
    ("LOCK03_SELF_RLOCK", JM.LOCK03_SELF_MUTANT.replace(
        "threading.Lock()", "threading.RLock()")),
    ("LOCK01_MUTANT", _LOCK_MUTANT),
    ("LOCK01_CLEAN", _LOCK_CLEAN),
    ("LOCK02", _LOCK02),
    ("LOCK_HELPER", _LOCK_HELPER),
])
def test_lock_rules_agree_with_the_jax_lint(name, src):
    mine = _lock_sites(L.lint_source(src, kinds=("lock",)))
    want = _lock_sites(JL.lint_source(src))
    assert mine == want, name
    assert bool(mine) == name.endswith(("MUTANT", "LOCK02")), name


def test_the_lock_scope_covers_the_threaded_planes():
    """LOCK01-03 read every port module that takes a threading lock."""
    locked = set()
    for p in PORT.rglob("*.py"):
        rel = str(p.relative_to(PORT))
        if "threading" in p.read_text() and not rel.startswith("analysis"):
            locked.add(rel)
    assert len(locked) >= 27
    scoped = {r for r in locked if L._in_scope(r, L.LOCK_DIRS)}
    unscoped = locked - scoped
    # the only modules outside: the kernel modules' module-level plan and
    # table locks (no class state for the lock rules to read)
    assert unscoped <= {"backend/ntt_torch.py", "backend/msm_torch.py",
                        "backend/torch_backend.py", "backend/autotune.py",
                        "backend/fixed_base_torch.py", "trace.py",
                        "checkpoint.py"}, unscoped


def test_cache_key_lint():
    assert any(f.code == "CACHE01" and "scale" in f.message
               for f in L.lint_source(M.CACHE01_MUTANT, kinds=("cache",)))
    assert L.lint_source(M.CACHE01_FIXED, kinds=("cache",)) == []
    # a state table the function never looks up in is not a cache
    table = ('class D:\n    def mark(self, i, why):\n'
             '        self.bad[i] = why\n')
    assert L.lint_source(table, kinds=("cache",)) == []
    nested = ('import functools\n\ndef f(n, scale):\n'
              '    @functools.lru_cache(None)\n'
              '    def g(k):\n        return k * scale\n'
              '    return g(n)\n')
    assert any("scale" in f.message
               for f in L.lint_source(nested, kinds=("cache",)))


def test_pragma_suppresses_a_finding():
    src = "def k(x):\n    return x * 2.0\n"
    assert [f.code for f in L.lint_source(src, kinds=("prom",))] == \
        ["PROM01"]
    ok = src.replace("x * 2.0", "x * 2.0  # analysis: ok(host-only scale)")
    assert L.lint_source(ok, kinds=("prom",)) == []
    dtype = "import torch\ndef k(x):\n    return x.to(torch.float64)\n"
    assert [f.code for f in L.lint_source(dtype, kinds=("prom",))] == \
        ["PROM02"]


def test_environment_reads_are_findings():
    for src in ('import os\nv = os.environ.get("X")\n',
                'import os\nv = os.getenv("X")\n',
                'from os import environ\nv = environ["X"]\n'):
        assert [f.code for f in L.lint_source(src, kinds=("env",))], src
    assert L.lint_source("import os\nv = os.getcwd()\n",
                         kinds=("env",)) == []


def test_glossary_lints_read_the_port_glossaries():
    src = 'm.inc("fleet_reconnects")\nlog.emit("supervisor", "respawn")\n'
    assert L.lint_source(src, kinds=("obs", "log")) == []
    bad = 'm.inc("no_such_metric")\nlog.emit("nowhere", "x")\n'
    assert [f.code for f in L.lint_source(bad, kinds=("obs", "log"))] == \
        ["OBS01", "LOG01"]


def test_tags_without_a_codec_test_keep_the_reference_numbers():
    """Tags the port's worker and service dispatch: each has a handler
    branch in the port and the JAX package's wire number, so peers of
    either package agree on them."""
    handlers = {}
    for rel in ("runtime/worker.py", "service/server.py"):
        tree = ast.parse((PORT / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare) and isinstance(
                    node.comparators[0], ast.Attribute):
                handlers.setdefault(node.comparators[0].attr, set()).add(rel)
    for name, value in (("SHUTDOWN", protocol.SHUTDOWN),
                        ("FFT2_PREPARE", protocol.FFT2_PREPARE),
                        ("STATS", protocol.STATS),
                        ("STATUS", protocol.STATUS),
                        ("METRICS", protocol.METRICS),
                        ("WARMUP", protocol.WARMUP)):
        assert getattr(jax_protocol, name) == value, name
        assert protocol.TAG_NAMES[value] == name
        assert handlers.get(name), name
    assert L.tag_findings(M.TAG01_MUTANT, {"PING"}, "PING OK ERR")


# --- seeded mutants -----------------------------------------------------------

_KERNEL_MUTANTS = {m.name: m for m in M.build_mutants()}


@pytest.mark.parametrize("name", sorted(_KERNEL_MUTANTS))
def test_kernel_mutant_is_rejected_by_its_pass(name):
    m = _KERNEL_MUTANTS[name]
    bounds_v = m.entry.check(strict=True)
    if m.caught_by == "bounds":
        assert bounds_v
    else:
        assert bounds_v == []          # the interval pass's blind spot
        assert m.entry.check_values(strict=True)


def test_mutant_harness_every_bug_class_rejected():
    seen = []
    assert M.check_mutants(
        progress=lambda name, by, rejected: seen.append((name, rejected))
    ) == []
    assert len(seen) == 13 and all(r for _, r in seen)
    bugs = {m.bug for m in M.build_mutants()}
    assert bugs == {"dropped-carry", "off-by-one-limb-shift",
                    "wrong-modulus", "rotated-twiddle", "word-products",
                    "float-literal"}


def test_mutant_copy_without_defect_is_the_production_kernel():
    rng = np.random.default_rng(3)
    for spec in (F.FR, F.FQ):
        a, b = R._field_sampler(spec, [(6,), (6,)])(rng)
        assert torch.equal(M._mont_mul_mutant(spec, a, b),
                           F.mont_mul_ref(spec, a, b))


# --- the CLI ------------------------------------------------------------------

def test_cli_exit_zero_on_lint_and_the_field_family():
    assert cli_main(["--only", "lint", "-q", "--device", "cpu"]) == 0
    summary = {}
    assert cli_main(["--strict", "--device", "cpu", "--kernel", "field/",
                     "-q"], summary=summary) == 0
    assert summary["failures"] == 0 and summary["lint"] == 0
    assert summary["bounds"][0] >= 19 and summary["values_cpu"][0] >= 19


def test_cli_needs_a_card_for_the_card_half():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli_main(["--only", "values", "-q"]) == 2


def test_cli_exit_nonzero_on_a_mutant_registry(monkeypatch):
    mutants = [m.entry for m in M.build_mutants()]
    monkeypatch.setattr(R, "build_registry", lambda: mutants)
    assert cli_main(["--only", "bounds", "--strict", "-q",
                     "--device", "cpu"]) == 1
    assert cli_main(["--only", "values", "--strict", "-q",
                     "--device", "cpu"]) == 1
