"""The port's kernel calibration on the CPU (the plain versions; a mirror
of tests/test_autotune.py at a small size), exact throughout.

- KernelPlan: JSON round trip through the store byte for byte, nearest
  cell lookup, a future version and a foreign fingerprint ignored;
- resolution: explicit argument > active plan cell > built-in constant,
  for kernel 2's pass split and tile (ntt_torch.plan_params, get_plan)
  and kernel 3's chunk (msm_torch.resolve_chunk, MsmContext, TorchBackend
  contexts after a plan reload);
- the Autotuner: candidates read back through the resolvers (NTT splits
  that build alike are measured once; tiles over the card's shared
  memory are not measured), a planted wrong candidate rejected by the
  bit-identity gate, a cell dropped when its default fails;
- store/calibration.load_or_run: off / load / run, a second start loading
  with zero measurement runs, two concurrent starters measuring once;
- `autotune:` plans pulled by store/remote.warm_sync, and picked up by a
  ProofService and a fleet worker at start;
- the test circuit proved under a non-default plan (chunk 8, 6 stages a
  pass) gives tests/fixtures/proof_small.hex byte for byte.
"""

import random
import threading

import pytest
import torch

from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.backend import autotune as AT
from distributed_plonk_tpu_torch.backend import msm_torch as M
from distributed_plonk_tpu_torch.backend import ntt_torch as N
from distributed_plonk_tpu_torch.constants import G1_GEN_X, G1_GEN_Y
from distributed_plonk_tpu_torch.poly import Domain
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.service.metrics import Metrics
from distributed_plonk_tpu_torch.store import ArtifactStore, calibration
from distributed_plonk_tpu_torch.store import remote as store_remote

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

FP = AT.machine_fingerprint("cpu")


@pytest.fixture(autouse=True)
def _clean_plan():
    """Every test starts plan-free and leaves the process plan as it
    found it."""
    prev = AT.active_plan()
    AT.set_active_plan(None)
    yield
    AT.set_active_plan(prev)


def _plan(cells):
    return AT.KernelPlan(FP, cells)


def _counters(m):
    return m.snapshot()["counters"]


def test_shapes_and_the_quotient_domain():
    assert calibration.parse_shapes("2^10, 2^14,4096") == [1024, 4096, 16384]
    for n in (4, 16, 1 << 13, 1 << 18):
        assert AT.quotient_size(n) == Domain(6 * (n + 1) + 1).size
    assert AT.quotient_size(1 << 13) == 1 << 16
    assert AT.Autotuner([16], device="cpu").cells() == [("ntt", 128),
                                                        ("msm", 16)]


def test_plan_store_roundtrip_byte_identical(tmp_path):
    store = ArtifactStore(str(tmp_path))
    plan = _plan({("ntt", 1 << 16): {"params": {"max_log_rows": 6,
                                                "tile_log_cols": 1}},
                  "msm:8192": {"chunk": 16}})
    plan.meta = {"budget_s": 1.0}
    digest = calibration.store_plan(store, plan)
    assert store.get(calibration.plan_store_key(FP)) == plan.to_json_bytes()
    back = calibration.load_plan(store, FP)
    assert back.to_json_bytes() == plan.to_json_bytes()
    assert back.cells == plan.cells and back.meta == plan.meta
    assert back.cell("msm", 8192) == {"params": {"chunk": 16}}
    assert calibration.store_plan(store, back) == digest


def test_nearest_cell_lookup():
    plan = _plan({("msm", 1 << 10): {"chunk": 8},
                  ("msm", 1 << 16): {"chunk": 64}})
    assert plan.lookup("msm", "chunk", 1 << 11) == 8
    assert plan.lookup("msm", "chunk", 8224) == 64     # tie: the larger
    assert plan.lookup("msm", "chunk", 1 << 20) == 64
    assert plan.lookup("msm", "chunk") == 64
    assert plan.lookup("ntt", "max_log_rows", 1 << 10) is None


def test_future_version_and_garbage_are_ignored(tmp_path):
    store = ArtifactStore(str(tmp_path))
    blob = _plan({}).to_json_bytes().replace(b'"version": 1',
                                             b'"version": 999')
    store.put(calibration.plan_store_key(FP), blob)
    assert calibration.load_plan(store, FP) is None
    assert AT.KernelPlan.from_json_bytes(b"not json") is None
    assert AT.KernelPlan.from_json_bytes(b"[1]") is None


def test_foreign_fingerprint_is_never_applied(tmp_path):
    store = ArtifactStore(str(tmp_path))
    # another card's plan under its own key, and one copied under ours
    calibration.store_plan(store, AT.KernelPlan("feedfacef00d", {
        ("msm", 16): {"chunk": 8}}))
    store.put(calibration.plan_store_key(FP), AT.KernelPlan(
        "feedfacef00d", {("msm", 16): {"chunk": 8}}).to_json_bytes())
    rep = calibration.load_or_run(store, mode="load", device="cpu")
    assert rep["source"] == "none" and AT.active_plan() is None
    assert M.resolve_chunk(None, 16) == M.CHUNK


def test_argument_beats_plan_beats_default():
    m = 1 << 16
    assert N.plan_params(m) == (N.MAX_LOG_ROWS, N.TILE_LOG_COLS)
    assert M.resolve_chunk(None, 8195) == M.CHUNK == 32
    AT.set_active_plan(_plan({
        ("ntt", m): {"max_log_rows": 6, "tile_log_cols": 1},
        ("msm", 1 << 13): {"chunk": 8}}))
    assert N.plan_params(m) == (6, 1)
    assert N.plan_params(m, 9, 0) == (9, 0)
    assert N.plan_params(m, tile_log_cols=3) == (6, 3)
    assert M.resolve_chunk(None, 8195) == 8
    assert M.resolve_chunk(16, 8195) == 16
    AT.set_active_plan(_plan({("msm", 16): {"chunk": "eight"}}))
    assert M.resolve_chunk(None, 16) == M.CHUNK    # malformed: the default


def test_plans_reach_the_ntt_plans_and_msm_contexts():
    AT.set_active_plan(_plan({("ntt", 1 << 9): {"max_log_rows": 3,
                                               "tile_log_cols": 0},
                              ("msm", 16): {"chunk": 4}}))
    plan = N.get_plan(1 << 9, "cpu")
    assert plan.digits == [3, 3, 3]
    assert [p.log_cols for p in plan.passes[False]] == [0, 0, 0]
    assert plan is N.get_plan(1 << 9, "cpu", 3, 0)   # keyed on the values
    assert N.pass_shapes(1 << 9, 3, 0) == [(3, 0)] * 3
    ctx = M.MsmContext([(G1_GEN_X, G1_GEN_Y)] * 16, "cpu")
    assert ctx.chunk == 4
    view = ctx.at_chunk(16)
    assert view.chunk == 16 and view.key is ctx.key
    assert ctx.at_chunk(16) is view and ctx.at_chunk(4) is ctx
    # a reloaded plan never serves an old context's chunk
    _, be, pk, _ = port_keys()
    AT.set_active_plan(_plan({("msm", 16): {"chunk": 2}}))
    assert be._ctx(pk.ck).chunk == 2
    AT.set_active_plan(None)
    assert be._ctx(pk.ck).chunk == M.CHUNK


def test_ntt_candidates_collapse_through_the_resolvers():
    tuner = AT.Autotuner([1 << 13], device="cpu")
    sigs = {}
    for cand in tuner._candidates("ntt", 1 << 16):
        params, sig = tuner._resolved("ntt", 1 << 16, cand)
        assert params == cand
        sigs.setdefault(sig, []).append(cand)
    # six stages a pass or seven give [6, 5, 5], eight to ten [8, 8]
    splits = {tuple(r for r, _ in sig[1:]) for sig in sigs}
    assert splits == {(6, 5, 5), (8, 8)} and len(sigs) == 8
    # at 2^20, ten stages a pass with a tile of 4 or 8 columns would take
    # more shared memory than a block may have: not measured
    for tile, fits in ((1, True), (2, False), (3, False)):
        _, sig = tuner._resolved("ntt", 1 << 20, {"max_log_rows": 10,
                                                  "tile_log_cols": tile})
        assert (sig is not None) == fits
    assert N.pass_smem_bytes(10, 2) > N.SMEM_MAX >= N.pass_smem_bytes(8, 3)


class _Small(AT.Autotuner):
    MSM_BATCHES = (1, 2)
    MSM_CHUNKS = (8, 16)
    REPS = 1


def test_parity_gate_rejects_a_planted_wrong_candidate():
    class Lying(_Small):
        def _run_candidate(self, kind, n, cand):
            out, dt, aux = super()._run_candidate(kind, n, cand)
            if cand.get("chunk") == 16:      # fast and wrong
                return b"wrong commitments", 1e-9, aux
            return out, dt, aux

    m = Metrics()
    plan = Lying([8], kinds=("msm",), metrics=m, device="cpu").run()
    cell = plan.cell("msm", 8)
    assert cell["params"]["chunk"] != 16
    assert cell["parity_rejects"] == 1 and cell["candidates"] == 2
    assert set(cell["best_parts_s"]) == {"b0_1", "b1_2"}
    assert _counters(m)["autotune_parity_rejects"] == 1
    assert _counters(m)["autotune_measure_runs"] == 3


def test_cell_dropped_when_its_default_fails():
    class Broken(_Small):
        def _run_candidate(self, kind, n, cand):
            if not cand:
                raise RuntimeError("the default refused to run")
            return super()._run_candidate(kind, n, cand)

    m = Metrics()
    plan = Broken([8], kinds=("msm",), metrics=m, device="cpu").run()
    assert plan.cell("msm", 8) is None
    assert _counters(m)["autotune_candidate_errors"] == 1


def test_off_and_plan_less_load(tmp_path):
    store = ArtifactStore(str(tmp_path))
    m = Metrics()
    rep = calibration.load_or_run(store, mode="load", metrics=m,
                                  device="cpu")
    assert rep == {"source": "none", "fingerprint": FP, "measure_runs": 0}
    assert _counters(m) == {} and AT.active_plan() is None
    calibration.store_plan(store, _plan({("msm", 8): {"chunk": 8}}))
    assert calibration.load_or_run(store, mode="off", metrics=m,
                                   device="cpu") == {"source": "off"}
    assert AT.active_plan() is None and _counters(m) == {}
    with pytest.raises(ValueError):
        calibration.load_or_run(store, mode="bogus", device="cpu")


def test_run_measures_then_a_second_start_loads(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))
    monkeypatch.setattr(AT.Autotuner, "MSM_BATCHES", (1,))
    monkeypatch.setattr(AT.Autotuner, "MSM_CHUNKS", (8,))
    monkeypatch.setattr(AT.Autotuner, "REPS", 1)
    m = Metrics()
    rep = calibration.load_or_run(store, mode="run", shapes=[8],
                                  metrics=m, device="cpu")
    assert rep["source"] == "fresh" and rep["cells"] == 2
    assert rep["measure_runs"] == 3      # one NTT geometry, two chunks
    plan = AT.active_plan()
    assert plan.fingerprint == FP
    assert set(plan.cells) == {("ntt", 64), ("msm", 8)}
    assert plan.cell("msm", 8)["default_s"] > 0
    g = m.snapshot()["gauges"]
    assert g["autotune_plan_source"] == "fresh"
    assert g["autotune_plan_cells"] == 2
    assert _counters(m)["autotune_runs"] == 1

    def poisoned(*a, **k):
        raise AssertionError("a calibrated store must not measure again")

    monkeypatch.setattr(AT, "Autotuner", poisoned)
    AT.set_active_plan(None)
    rep = calibration.load_or_run(store, mode="run", metrics=m,
                                  device="cpu")
    assert rep == {"source": "store", "fingerprint": FP, "cells": 2,
                   "measure_runs": 0}
    assert AT.active_plan().to_json_bytes() == plan.to_json_bytes()


def test_concurrent_starters_measure_once(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))
    runs = []

    class Counting:
        def __init__(self, shapes, budget_s=None, metrics=None, **kw):
            pass

        def run(self):
            runs.append(1)
            return _plan({("msm", 8): {"chunk": 8}})

    monkeypatch.setattr(AT, "Autotuner", Counting)
    reports = []
    threads = [threading.Thread(target=lambda: reports.append(
        calibration.load_or_run(store, mode="run", shapes=[8],
                                device="cpu"))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(runs) == 1
    assert sorted(r["source"] for r in reports) == ["fresh", "store",
                                                    "store"]


def test_service_worker_and_warm_sync_pick_up_the_plan(tmp_path):
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.runtime.worker import (
        WorkerState, _load_calibration, main)
    from distributed_plonk_tpu_torch.service import ProofService

    served = ArtifactStore(str(tmp_path / "served"))
    calibration.store_plan(served, _plan({("msm", 8): {"chunk": 8}}))
    svc = ProofService(port=0, prover_workers=1, device="cpu",
                       store_dir=str(tmp_path / "served")).start()
    try:
        assert svc.autotune == {"source": "store", "fingerprint": FP,
                                "cells": 1, "measure_runs": 0}
        assert svc.metrics.snapshot()["gauges"][
            "autotune_plan_source"] == "store"
        AT.set_active_plan(None)
        # a joining worker's warm sync pulls this card's plan from a peer
        fresh = ArtifactStore(str(tmp_path / "fresh"))
        stats = store_remote.warm_sync(fresh, [("127.0.0.1", svc.port)])
        assert stats["artifacts"] == 1 and stats["errors"] == 0
        assert fresh.get(calibration.plan_store_key(FP)) == \
            served.get(calibration.plan_store_key(FP))
    finally:
        svc.shutdown()
    state = WorkerState(TorchBackend(device="cpu"), stages=None, store=fresh)
    rep = _load_calibration(state, "load")
    assert rep["source"] == "store" and state.autotune is rep
    assert M.resolve_chunk(None, 8) == 8
    assert state.metrics.snapshot()["counters"]["autotune_plan_loads"] == 1
    with pytest.raises(SystemExit):
        main(["0", "cfg.json", "--autotune", "sometimes"])


def test_proof_small_under_a_non_default_plan():
    ckt, be, pk, vk = port_keys()
    n = ckt.n
    AT.set_active_plan(_plan({
        ("msm", n): {"chunk": 8},
        ("ntt", AT.quotient_size(n)): {"max_log_rows": 6,
                                        "tile_log_cols": 1}}))
    assert N.get_plan(AT.quotient_size(n), "cpu").max_log_rows == 6
    assert be._ctx(pk.ck).chunk == 8
    proof = prove(random.Random(1), ckt, pk, be)
    assert proof_io.serialize_proof(proof) == golden()
