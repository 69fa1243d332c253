"""TorchBackend's device caches are bounded as the JAX backend's are
(jax_backend._CACHE_CAP = 4, oldest entry evicted first): given five
distinct commit keys, proving keys, circuits and quotient domains, each
cache holds the last four. A fleet worker holds one MSM context per base
set it is sent; after five base sets its backend holds four.

The MSM context and the circuit tables are replaced by cheap stand-ins:
those caches key on the identity of the object they are given, which is
all this checks. The pk polynomials and the domain tables are real.
"""

import torch

from distributed_plonk_tpu_torch.backend import torch_backend as TB
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.poly import Domain
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.worker import WorkerState, _dispatch

torch.set_num_threads(1)


class _Ctx:
    """MsmContext stand-in: remembers its bases, commits to infinity."""

    def __init__(self, bases, device=None, layout="auto"):
        self.bases = bases
        self.n = len(bases)

    def at_chunk(self, chunk):
        return self

    def msm(self, scalars):
        return None


class _Pk:
    def __init__(self, i):
        self.selectors = [[i, 1], [2, i]]
        self.sigmas = [[i + 3]]


class _Conn:
    def __init__(self):
        self.sent = []

    def send(self, tag, payload=b""):
        self.sent.append((tag, payload))


def _keys(cache):
    return [entry[0] for entry in cache.values()]


def test_torch_backend_caches_hold_the_last_four(monkeypatch):
    monkeypatch.setattr(TB, "MsmContext", _Ctx)
    be = TorchBackend(device="cpu")
    monkeypatch.setattr(be, "_lift_circuit_tables",
                        lambda circuit: {"n": 1})
    assert be._CACHE_CAP == 4
    cks = [[None] * (i + 1) for i in range(5)]
    pks = [_Pk(i) for i in range(5)]
    circuits = [object() for _ in range(5)]
    for i in range(5):
        assert be.msm(cks[i], [1]) is None
        sel, sig = be.pk_polys(pks[i])
        assert len(sel) == 2 and len(sig) == 1
        be._circuit_tables(circuits[i])
        m = 8 << i
        be._domain_tables(m, m // 8, Domain(m).group_gen)
        if i == 2:
            # a hit neither grows a cache nor reorders it (first in,
            # first out, as in the JAX backend)
            be.msm(cks[0], [1])
            be.pk_polys(pks[0])
    assert _keys(be._msm_ctxs) == cks[1:]
    assert _keys(be._pk_polys) == pks[1:]
    assert _keys(be._circuit_tabs) == circuits[1:]
    assert list(be._domain_tabs) == [(8 << i, 1 << i) for i in range(1, 5)]
    # register_pk_polys (what preprocess seeds) shares the cap
    extra = _Pk(9)
    be.register_pk_polys(extra, [], [])
    assert _keys(be._pk_polys) == pks[2:] + [extra]
    be.register_pk_polys(extra, [], [])
    assert len(be._pk_polys) == 4


def test_worker_msm_contexts_are_bounded(monkeypatch):
    """Five INIT_BASES sets, each served an MSM: the worker keeps every
    base set (it may adopt ranges), its backend the last four contexts."""
    monkeypatch.setattr(TB, "MsmContext", _Ctx)
    state = WorkerState(TorchBackend(device="cpu"), stages=None)
    conn = _Conn()
    for set_id in range(5):
        bases = [None] * (set_id + 2)
        _dispatch(conn, state, protocol.INIT_BASES,
                  protocol.encode_init_bases(set_id, bases))
        _dispatch(conn, state, protocol.MSM,
                  protocol.encode_msm_request(set_id, [7] * len(bases)))
    assert [tag for tag, _ in conn.sent] == [protocol.OK] * 10
    assert protocol.decode_point(conn.sent[-1][1]) is None
    assert sorted(state.base_sets) == list(range(5))
    cached = _keys(state.backend._msm_ctxs)
    assert len(cached) == 4
    assert all(a is b for a, b in zip(
        cached, [state.base_sets[i] for i in range(1, 5)]))
    assert state.counters == {protocol.INIT_BASES: 5, protocol.MSM: 5}


def test_ntt_plan_cache_is_safe_under_concurrent_first_use():
    """A fleet worker serves each connection on its own thread: sixteen
    threads asking at once for a plan not built yet all get the one plan
    object, built once."""
    import sys
    import threading
    from distributed_plonk_tpu_torch.backend import ntt_torch as N

    key = (1 << 9, "cpu", 3)    # a geometry no other test builds
    N._PLANS.pop(key, None)
    built, got = [], []
    real = N.NttPlan

    class Counting(real):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    N.NttPlan = Counting
    try:
        threads = [threading.Thread(
            target=lambda: got.append(N.get_plan(1 << 9, "cpu", 3)))
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        N.NttPlan = real
        sys.setswitchinterval(old)
        N._PLANS.pop(key, None)
    assert len(built) == 1 and len(got) == 16
    assert all(p is got[0] for p in got)
