"""Seeded known-bad kernels and sources: the verifier's self-test corpus
(the counterpart of the JAX package's analysis/mutants.py).

A verifier that has never rejected anything is indistinguishable from one
that checks nothing. Each kernel mutant below is a copy of a plain kernel
built here, with exactly ONE seeded defect (no production function
changes); `check_mutants()` asserts the pass that owns its bug class
rejects it under --strict, and that each value-class mutant is CLEAN
under the interval pass: those are the bugs intervals cannot see, which
is why the value pass exists.

  dropped-carry         mont_mul_ref's low half swept on its own: its
                        carry into column L is dropped. Every limb still
                        fits 16 bits.                      caught_by: value
  off-by-one-limb-shift the high half read from u[L-1 : 2L-1] instead of
                        u[L : 2L].                          caught_by: value
  wrong-modulus         mont_mul_ref over a FieldSpec whose modulus is
                        p + 2^16, with its own consistent -p^-1: a
                        well-formed reduction for the wrong field.
                                                            caught_by: value
  rotated-twiddle       an n = 32 NTT plan whose stage twiddle table is
                        rotated one lane.                   caught_by: value
  word-products         the multiply over 32-bit words: 32 x 32-bit
                        products summed in int64 columns overflow (in
                        int64 a skipped sweep of 16-bit columns would
                        not, so this is the bounds-class mutant).
                                                           caught_by: bounds
  float-literal         mont_mul_ref's result scaled by the literal 1.0
                        on its way back to int64: a float in the graph.
                                                           caught_by: bounds

Lint mutants (sources checked with lint.lint_source / lint.tag_findings):
a two-class lock-order cycle (LOCK03) and its fix, a self-deadlock on a
plain Lock (LOCK03), an unlocked write of locked state (LOCK01), a cache
keyed without a parameter its value depends on (CACHE01), a float literal
in kernel arithmetic (PROM01), an environment read (ENV01), and a wire tag
with no site and no test (TAG01).
"""

import torch

from . import lint as L
from . import registry as R
from .bounds import word_rows

I32 = R.I32


class Mutant:
    """One seeded defect: a registry Entry plus the pass that owns it.

    caught_by "value": Entry.check() (bounds) must be CLEAN and
    Entry.check_values() must reject. caught_by "bounds": Entry.check()
    must reject."""

    def __init__(self, entry, caught_by, bug):
        self.entry = entry
        self.caught_by = caught_by
        self.bug = bug

    @property
    def name(self):
        return self.entry.name


def _mont_mul_mutant(spec, a, b, drop_carry=False, off_by_one=False,
                     float_literal=False):
    """field_torch.mont_mul_ref re-assembled from its own helpers, with
    one switchable defect. With every switch off this IS the production
    body (so a mutant's verdict cannot be an artifact of the copy
    drifting from the kernel)."""
    from ..backend import field_torch as F
    a, b = torch.broadcast_tensors(a, b)
    nl = 2 * spec.n_words
    nd = a.dim()
    t = F._mul_cols(F._to16(a), F._to16(b), 2 * nl)
    m, _ = F._sweep16(F._mul_cols(t[:nl], F._col(spec.ninv16, nd, a.device),
                                  nl))
    cols = F._mul_cols(m, F._col(spec.mod16, nd, a.device), 2 * nl) + t
    if drop_carry:
        # MUTANT: the halves swept apart, the low half's carry dropped
        F._sweep16(cols[:nl])
        hi, c = F._sweep16(cols[nl:])
    else:
        u, c = F._sweep16(cols)
        hi = u[nl - 1:2 * nl - 1] if off_by_one else u[nl:]
    d, c2 = F._sweep16(hi + F._col(spec.negmod16, nd, a.device))
    take = (c2 != 0) | (c != 0)
    out = torch.where(take[None], d, hi)
    if float_literal:
        out = (out * 1.0).to(torch.int64)       # MUTANT: a float literal
    return F._from16(out)


def _mont_mul_word_products(spec, a, b):
    """mont_mul_ref's SOS with 32-bit words for limbs: exact integer
    arithmetic would still give a*b*R^-1 mod p, but the column products
    of two words reach 2^64 and the int64 sums wrap."""
    from ..backend import field_torch as F
    a, b = torch.broadcast_tensors(a, b)
    n, nd, dev = spec.n_words, a.dim(), a.device
    inv = sum(w << (16 * i) for i, w in enumerate(spec.ninv16))
    ninv = [(inv >> (32 * i)) & 0xFFFFFFFF for i in range(n)]
    t = F._mul_cols(F._wide(a), F._wide(b), 2 * n)   # MUTANT: word products
    m, _ = F._sweep32(F._mul_cols(t[:n], F._col(ninv, nd, dev), n))
    u, c = F._sweep32(F._mul_cols(m, F._col(spec.mod_words, nd, dev), 2 * n)
                      + t)
    hi = u[n:]
    d, c2 = F._sweep32(hi + F._col(spec.negmod_words, nd, dev))
    return F._narrow(torch.where(((c2 != 0) | (c != 0))[None], d, hi))


def _wrong_modulus_spec():
    """An internally consistent FieldSpec for the WRONG prime: Fr's
    modulus nudged up one 16-bit unit, with the matching -p^-1 mod R, so
    the Montgomery algebra is flawless and only the field is wrong."""
    from ..backend import field_torch as F
    p_bad = F.FR.mod + (1 << 16)
    R_ = 1 << (32 * F.FR.n_words)
    inv_bad = pow((-p_bad) % R_, -1, R_)
    return F.FieldSpec("FrBad", F.FR.index, p_bad, F.FR.n_words,
                       R_ % p_bad, R_ * R_ % p_bad, inv_bad,
                       inv_bad & 0xFFFFFFFF)


def _field_mutants():
    from ..backend import field_torch as F
    spec = F.FR
    pair = (word_rows(spec.n_words, 8),) * 2

    def entry(name, fn):
        return R.Entry(name, fn, pair, [I32], value=R.ValueObligation(
            R._field_sampler(spec, [(8,), (8,)]),
            R._mod_contract(spec, "mont_mul"), samples=2))

    bad = _wrong_modulus_spec()
    return [
        Mutant(entry("field/mutant_dropped_carry",
                     lambda a, b: _mont_mul_mutant(spec, a, b,
                                                   drop_carry=True)),
               "value", "dropped-carry"),
        Mutant(entry("field/mutant_off_by_one_limb_shift",
                     lambda a, b: _mont_mul_mutant(spec, a, b,
                                                   off_by_one=True)),
               "value", "off-by-one-limb-shift"),
        Mutant(entry("field/mutant_wrong_modulus",
                     lambda a, b: _mont_mul_mutant(bad, a, b)),
               "value", "wrong-modulus"),
        Mutant(entry("field/mutant_word_products",
                     lambda a, b: _mont_mul_word_products(spec, a, b)),
               "bounds", "word-products"),
        Mutant(entry("field/mutant_float_literal",
                     lambda a, b: _mont_mul_mutant(spec, a, b,
                                                   float_literal=True)),
               "bounds", "float-literal"),
    ]


def _ntt_mutant():
    from ..backend import ntt_torch as N
    # a fresh plan, not get_plan: the rotated table must not reach the
    # shared plan cache
    plan = N.NttPlan(32, "cpu")
    ps = plan.passes[False][0]
    ps.stage_table = torch.roll(ps.stage_table, 1, dims=1)   # MUTANT
    entry = R.Entry("ntt/mutant_rotated_twiddle_n32",
                    lambda v: N.ntt_ref(plan, v, False, False),
                    (word_rows(8, 1, 32),), [I32],
                    value=R._ntt_value(32, False, False))
    return Mutant(entry, "value", "rotated-twiddle")


def build_mutants():
    """All seeded kernel mutants (list of Mutant)."""
    return _field_mutants() + [_ntt_mutant()]


# -- lint-side mutants ---------------------------------------------------------

# Two classes, each calling into the other under its own lock: the AB/BA
# lock-order cycle LOCK03's graph closure must find.
LOCK03_MUTANT = '''
import threading


class Scheduler:
    def __init__(self, ledger):
        self._lock = threading.Lock()
        self.ledger = ledger
        self.active = 0

    def promote(self, job):
        with self._lock:
            self.active += 1
            self.ledger.record(job)   # MUTANT: held call into Ledger

    def drain(self):
        with self._lock:
            self.active = 0


class Ledger:
    def __init__(self, sched):
        self._lock = threading.Lock()
        self.sched = sched
        self.rows = 0

    def record(self, job):
        with self._lock:
            self.rows += 1

    def audit(self):
        with self._lock:
            self.sched.drain()        # back edge -> AB/BA cycle
'''

# The same classes with the back edge moved outside the lock: the cycle is
# broken, so LOCK03 must stay silent.
LOCK03_FIXED = LOCK03_MUTANT.replace(
    "        with self._lock:\n"
    "            self.sched.drain()        # back edge -> AB/BA cycle",
    "        with self._lock:\n"
    "            rows = self.rows\n"
    "        self.sched.drain()\n"
    "        return rows")

# A non-reentrant lock re-acquired through a held self-call.
LOCK03_SELF_MUTANT = '''
import threading


class Journal:
    def __init__(self):
        self._lock = threading.Lock()
        self.entries = 0

    def compact(self):
        with self._lock:
            self.truncate()           # MUTANT: re-acquires self._lock

    def truncate(self):
        with self._lock:
            self.entries = 0
'''

# Locked state written without the lock.
LOCK01_MUTANT = '''
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

# A memo keyed on n and the device whose value also depends on `scale`.
CACHE01_MUTANT = '''
import torch

_TABLES = {}


def table(n, device, scale):
    key = (n, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        hit = _TABLES[key] = torch.arange(n, device=device) * scale  # MUTANT
    return hit
'''

CACHE01_FIXED = CACHE01_MUTANT.replace("key = (n, str(device))",
                                       "key = (n, str(device), scale)")

PROM01_MUTANT = '''
def scale(x):
    return x * 2.0     # MUTANT: an int64 word tensor becomes float
'''

ENV01_MUTANT = '''
import os


def fanout():
    return int(os.environ.get("FANOUT", "4"))   # MUTANT
'''

# A protocol with a tag no site uses and no test names.
TAG01_MUTANT = '''
PING = 1
ECHO = 38   # MUTANT: no codec site, no test
OK = 100
ERR = 101
'''


def _lint_mutants():
    """(name, the code it must raise, findings on the mutant, findings on
    its fix or None)."""
    def codes(src, kinds):
        return [f.code for f in L.lint_source(src, kinds=kinds)]
    return [
        ("lint/lock03_cycle", "LOCK03", codes(LOCK03_MUTANT, ("lock",)),
         codes(LOCK03_FIXED, ("lock",))),
        ("lint/lock03_self_deadlock", "LOCK03",
         codes(LOCK03_SELF_MUTANT, ("lock",)),
         codes(LOCK03_SELF_MUTANT.replace("threading.Lock()",
                                          "threading.RLock()"), ("lock",))),
        ("lint/lock01_unlocked_write", "LOCK01",
         codes(LOCK01_MUTANT, ("lock",)), None),
        ("lint/cache01_stale_key", "CACHE01",
         codes(CACHE01_MUTANT, ("cache",)),
         codes(CACHE01_FIXED, ("cache",))),
        ("lint/prom01_float_literal", "PROM01",
         codes(PROM01_MUTANT, ("prom",)), None),
        ("lint/env01_environment_read", "ENV01",
         codes(ENV01_MUTANT, ("env",)), None),
        ("lint/tag01_untested_tag", "TAG01",
         [f.code for f in L.tag_findings(TAG01_MUTANT, {"PING"},
                                         "PING OK ERR")],
         None),
    ]


def check_mutants(progress=None):
    """Run every mutant through its passes under --strict and return a
    list of error strings: NON-EMPTY means the verifier lost a bug class
    it can catch (or a value-class mutant stopped being bounds-clean).
    progress(name, caught_by, rejected) is called once per mutant."""
    errors = []
    for m in build_mutants():
        bounds_v = m.entry.check(strict=True)
        if m.caught_by == "bounds":
            rejected = bool(bounds_v)
            if not rejected:
                errors.append("%s (%s): the bounds pass no longer rejects "
                              "this mutant" % (m.name, m.bug))
        else:
            value_v = m.entry.check_values(strict=True)
            rejected = bool(value_v)
            if bounds_v:
                errors.append("%s (%s): expected bounds-clean (intervals "
                              "cannot see this bug class) but got: %s"
                              % (m.name, m.bug, bounds_v[0]))
            if not value_v:
                errors.append("%s (%s): the value pass no longer rejects "
                              "this mutant" % (m.name, m.bug))
        if progress is not None:
            progress(m.name, m.caught_by, rejected)
    for name, code, got, fixed in _lint_mutants():
        rejected = code in got
        if not rejected:
            errors.append("%s: the lint no longer raises %s" % (name, code))
        if fixed is not None and code in fixed:
            errors.append("%s: the fixed source still raises %s"
                          % (name, code))
        if progress is not None:
            progress(name, "lint", rejected)
    return errors
