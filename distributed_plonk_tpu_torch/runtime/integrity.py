"""Result-integrity plane: detect and ATTRIBUTE silent wrong answers.

The fault-tolerance layers (the breaker and replan of
runtime/dispatcher.py) assume a worker either answers correctly or fails
loudly. The dangerous production failure in an
accelerator fleet is the quiet one — a flipped limb from a bad chip,
stale device state, a buggy kernel path — which returns a WELL-FORMED
wrong answer that sails under every CRC/SHA layer (those protect bytes
in flight and at rest, not the computation that produced them). This
module holds the math and policy for catching that class at the phase
boundary, with enough structure to name the lying worker:

  Sharded FFT / iNTT (Schwartz-Zippel): both directions of the 4-step
    transform are linear maps whose output power sum at a random point t
    has a CLOSED FORM over the input. With w the n-th root of unity,
    g the coset generator, u and s per mode
        forward:  u = t,       s = w,      pre_i = x_i * g^i,  post = 1
        inverse:  u = t / g,   s = w^-1,   pre_j = x_j,        post = 1/n
    and z_i = u * s^i, the served output y must satisfy
        sum_v y_v t^v  ==  post * sum_i pre_i * (u^n - 1) / (z_i - 1)
    (z_i == 1 contributes pre_i * n). A wrong output differs as a
    polynomial of degree < n, so it passes at a random t with
    probability <= (n-1)/|Fr| ~ 2^-230 — soundness error is negligible.
    ATTRIBUTION uses the same identity restricted to one worker's output
    panel: worker i owns flat indices {k1 + r*k2 : k1 in [cs_i, ce_i)},
    and the panel's true power sum is
        post * sum_j pre_j * geo(z_j; cs, ce) * geo(z_j^r; c)
    with geo the finite geometric sums — O(n) host muls per panel, paid
    only on a failed total. The mismatched panel names the liar.

  Distributed MSM (duplicate execution + group law): G1 partials are
    checked on-curve and in the order-r subgroup before the
    fold — a flipped coordinate limb almost never lands back on the
    curve. A wrong-but-on-curve partial (stale bases from an
    earlier provisioning) is caught by probabilistic duplicate execution: at
    rate MSM_DUP_RATE a range is recomputed by a second worker on
    FRESHLY pushed bases and the partials compared; a mismatch is
    attributed by a third worker's vote (or the host oracle for ranges
    up to REFEREE_MAX) and the liar quarantined.

  Distributed round-4 evaluation (duplicate execution + host referee):
    partial Horner sums are scalars, so the host referee is always
    affordable — attribution on mismatch is exact.

Detection feeds the quarantine machinery in runtime/dispatcher.py:
the attributed worker is marked SUSPECT (runtime/health.py — sticky:
probes do NOT re-admit it) and its work is recomputed on the others.
The plane is always on in the port.
"""

import random
import threading

from .. import curve as C
from ..constants import R_MOD, FR_GENERATOR
from ..fields import batch_inverse, fr_inv, fr_root_of_unity
from ..poly import poly_eval


class IntegrityError(RuntimeError):
    """An algebraic phase check failed: the served data is wrong. The
    suspects (fleet indices) have already been quarantined by the caller
    when attribution succeeded; the phase must recompute on survivors."""

    def __init__(self, msg, suspects=()):
        super().__init__(msg)
        self.suspects = tuple(suspects)


# --- power sums --------------------------------------------------------------

# sum_v values[v] * t^v mod r — exactly dense-poly Horner evaluation
power_sum = poly_eval


def rows_power_sum(values, t, rs, re, c_dim):
    """Power sum of the stage-1 row slice [rs, re): worker i's INPUT in
    the 4-step FFT is rows j2 in [rs, re), row j2 = values[j2::c_dim]
    (flat index j1*c_dim + j2)."""
    if re <= rs:
        return 0
    n = len(values)
    r_dim = n // c_dim
    tc = pow(t, c_dim, R_MOD)
    tot = 0
    tk = pow(t, rs, R_MOD)
    for j2 in range(rs, re):
        acc = 0
        for j1 in reversed(range(r_dim)):
            acc = (acc * tc + values[j1 * c_dim + j2]) % R_MOD
        tot = (tot + acc * tk) % R_MOD
        tk = tk * t % R_MOD
    return tot


def cols_power_sum(values, t, cs, ce, r_dim):
    """Power sum of the stage-2 column slice [cs, ce): worker i's OUTPUT
    covers flat indices {k1 + r_dim*k2 : k1 in [cs, ce)}."""
    if ce <= cs:
        return 0
    c_dim = len(values) // r_dim
    tr = pow(t, r_dim, R_MOD)
    tot = 0
    tk = pow(t, cs, R_MOD)
    for k1 in range(cs, ce):
        acc = 0
        for k2 in reversed(range(c_dim)):
            acc = (acc * tr + values[k1 + r_dim * k2]) % R_MOD
        tot = (tot + acc * tk) % R_MOD
        tk = tk * t % R_MOD
    return tot


# --- transform identities ----------------------------------------------------

def _mode_walk(x, t, inverse, coset):
    """(pre, post, u, step): the per-mode reindexing that makes every
    FFT/iNTT variant the same identity (module docstring). pre is the
    weighted input vector, z_i = u * step^i."""
    n = len(x)
    w = fr_root_of_unity(n)
    g = FR_GENERATOR if coset else 1
    if not inverse:
        u = t % R_MOD
        step = w
        if coset:
            pre = []
            gp = 1
            for v in x:
                pre.append(v * gp % R_MOD)
                gp = gp * g % R_MOD
        else:
            pre = [v % R_MOD for v in x]
        post = 1
    else:
        u = t * fr_inv(g) % R_MOD if coset else t % R_MOD
        step = fr_inv(w)
        pre = [v % R_MOD for v in x]
        post = fr_inv(n % R_MOD)
    return pre, post, u, step


def _safe_batch_inverse(dens):
    """batch_inverse tolerating zeros: zero denominators (z == 1, prob
    ~ n/2^255 at a random t, but the math must not crash) come back as
    None so the caller can substitute the limit form."""
    nz = [d if d else 1 for d in dens]
    invs = batch_inverse(nz, R_MOD)
    return [inv if d else None for d, inv in zip(dens, invs)]


def expected_output_eval(x, t, inverse, coset):
    """The closed-form value sum_v y_v t^v MUST take when y is the true
    (i)(coset)FFT of x — O(n) host muls + one batch inversion."""
    n = len(x)
    pre, post, u, step = _mode_walk(x, t, inverse, coset)
    un1 = (pow(u, n, R_MOD) - 1) % R_MOD
    zs = []
    z = u
    for _ in range(n):
        zs.append(z)
        z = z * step % R_MOD
    invs = _safe_batch_inverse([(z - 1) % R_MOD for z in zs])
    tot = 0
    for p, z, inv in zip(pre, zs, invs):
        geo = n % R_MOD if inv is None else un1 * inv % R_MOD
        tot = (tot + p * geo) % R_MOD
    return tot * post % R_MOD


def expected_panel_eval(x, t, cs, ce, r_dim, c_dim, inverse, coset):
    """The closed-form power sum of the TRUE output restricted to one
    worker's column panel {k1 + r_dim*k2 : k1 in [cs, ce)} — the
    bisection probe that attributes a failed total to a panel. O(n)
    host muls; only ever run after a failed check."""
    n = len(x)
    assert r_dim * c_dim == n
    if ce <= cs:
        return 0
    pre, post, u, step = _mode_walk(x, t, inverse, coset)
    return _panel_eval(pre, post, u, step, cs, ce, r_dim, c_dim, n)


def _panel_eval(pre, post, u, step, cs, ce, r_dim, c_dim, n):
    """Core of expected_panel_eval on a pre-walked mode: three parallel
    geometric walks give z_i^cs, z_i^ce, z_i^r for z_i = u*step^i with
    O(1) muls per i; z_i^n == u^n for every i (step^n == 1)."""
    un1 = (pow(u, n, R_MOD) - 1) % R_MOD
    za = pow(u, cs, R_MOD)
    sa = pow(step, cs, R_MOD)
    zb = pow(u, ce, R_MOD)
    sb = pow(step, ce, R_MOD)
    zr = pow(u, r_dim, R_MOD)
    sr = pow(step, r_dim, R_MOD)
    zs, zcs, zce, zrs = [], [], [], []
    z = u
    for _ in range(n):
        zs.append(z)
        zcs.append(za)
        zce.append(zb)
        zrs.append(zr)
        z = z * step % R_MOD
        za = za * sa % R_MOD
        zb = zb * sb % R_MOD
        zr = zr * sr % R_MOD
    inv1 = _safe_batch_inverse([(z - 1) % R_MOD for z in zs])
    invr = _safe_batch_inverse([(zr - 1) % R_MOD for zr in zrs])
    tot = 0
    for p, zc, zE, zr, i1, ir in zip(pre, zcs, zce, zrs, inv1, invr):
        # geo_range(z; cs, ce) = (z^ce - z^cs)/(z-1), limit ce-cs at z=1
        ga = (ce - cs) % R_MOD if i1 is None else (zE - zc) * i1 % R_MOD
        # geo over k2: sum (z^r)^k2 = (z^n - 1)/(z^r - 1), limit c_dim
        gb = c_dim % R_MOD if ir is None else un1 * ir % R_MOD
        tot = (tot + p * ga % R_MOD * gb) % R_MOD
    return tot * post % R_MOD


# --- G1 partial sanity -------------------------------------------------------

def g1_sane(p):
    """On-curve and in the order-r subgroup (G1's cofactor is > 1):
    [r]P == infinity, ~255 Jacobian double/adds of host big-int math —
    milliseconds per point, run only on the k per-MSM partials, never on
    the data plane. None (infinity) passes."""
    if p is None:
        return True
    if not C.g1_is_on_curve(p):
        return False
    acc = C.g1_to_jac(p)
    t = (1, 1, 0)
    k = R_MOD
    while k > 0:
        if k & 1:
            t = C.g1_jac_add(t, acc)
        acc = C.g1_jac_double(acc)
        k >>= 1
    return t[2] == 0


# --- policy object -----------------------------------------------------------

# duplicate-execution sampling rate for MSM partials and evaluation
# chunks; the largest MSM range the host oracle referees when no third
# worker can vote
MSM_DUP_RATE = 0.05
REFEREE_MAX = 2048


class FleetIntegrity:
    """Sampling state for the dispatcher's integrity plane: every sharded
    FFT and every offloaded NTT is checked, MSM partials always get the
    group-law check (on-curve and order-r subgroup), and duplicate
    execution runs at `msm_dup_rate` (MSM_DUP_RATE; a test sets it to 0
    or 1 to make the sampling certain).

    Thread-safety: the sampling rng is guarded by its own lock (MSM
    ranges are checked from executor threads)."""

    def __init__(self, metrics=None):
        from .health import NullMetrics
        self.metrics = metrics or NullMetrics()
        self._rng = random.Random()
        self._lock = threading.Lock()
        self.msm_dup_rate = MSM_DUP_RATE

    def draw_point(self):
        """A random Fr check point (never 0/1: t=0 checks only the
        constant term, t=1 only the plain sum)."""
        with self._lock:
            return self._rng.randrange(2, R_MOD)

    def sample_msm_dup(self):
        with self._lock:
            return self._rng.random() < self.msm_dup_rate

    # -- check implementations (detection cheap, attribution on failure) ---

    def check_transform(self, x, y, t, inverse, coset):
        """True iff y is the (i)(coset)FFT of x at random point t."""
        self.metrics.inc("integrity_checks")
        if power_sum(y, t) == expected_output_eval(x, t, inverse, coset):
            return True
        self.metrics.inc("integrity_failures")
        return False

    def attribute_fft(self, x, y, t, col_ranges, r_dim, c_dim, inverse,
                      coset, claimed=None, row_bounds=None):
        """After a failed total: name the worker(s) whose output panel
        disagrees with the closed-form per-panel expectation, plus any
        worker whose claimed input/output partials are inconsistent
        (SDC in its retained stage-1 input, or claim != served data).
        Returns a sorted fleet-index list (never empty when the total
        failed and the panels partition the output)."""
        suspects = set()
        claimed = claimed or {}
        for i, (cs, ce) in enumerate(col_ranges):
            if ce <= cs:
                continue
            got = cols_power_sum(y, t, cs, ce, r_dim)
            want = expected_panel_eval(x, t, cs, ce, r_dim, c_dim,
                                       inverse, coset)
            if got != want:
                suspects.add(i)
            b = claimed.get(i, (None, None))[1]
            if b is not None and b != got:
                # the worker's own claim disagrees with the panel it
                # served: inconsistent either way
                suspects.add(i)
        if row_bounds:
            for i, (rs, re) in row_bounds.items():
                a = claimed.get(i, (None, None))[0]
                if a is not None and \
                        a != rows_power_sum(x, t, rs, re, c_dim):
                    suspects.add(i)
        return sorted(suspects)
