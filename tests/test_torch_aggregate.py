"""The port's batch-KZG aggregation against the JAX package's: for the same
members, `aggregate.to_bytes(build(...))` is the JAX package's blob (and
agg_id), both packages' `verify` accept it with one pairing check, and
both reject a member with one flipped proof byte. Over the wire, the
port's service aggregates its own DONE jobs (AGGREGATE, AGG_FETCH),
journals the artifact, and re-serves it after a restart.
"""

import copy

import pytest
import torch

from distributed_plonk_tpu import aggregate as JAGG
from distributed_plonk_tpu.service import jobs as JJ

from distributed_plonk_tpu_torch import aggregate as AGG
from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.service import ProofService, ServiceClient
from distributed_plonk_tpu_torch.service import jobs as PJ
from distributed_plonk_tpu_torch.service.client import ServiceError

from test_torch_service import (TOY_A, TOY_B, _jax_bucket, jax_proof,
                                port_bucket, store_with)

torch.set_num_threads(1)

SPECS = [dict(TOY_A, seed=31), dict(TOY_B, seed=32), dict(TOY_A, seed=33)]


def _members(pub_from):
    out = []
    for i, obj in enumerate(SPECS):
        spec = pub_from.JobSpec.from_wire(obj)
        out.append({"job_id": f"job-{i}", "spec": spec.to_wire(),
                    "pub": pub_from.build_circuit(spec).public_input(),
                    "proof": jax_proof(obj)})
    return out


def _vk_caches():
    port, jax = {}, {}
    for obj in SPECS:
        for mod, cache, keys in ((PJ, port, port_bucket),
                                 (JJ, jax, _jax_bucket)):
            spec = mod.JobSpec.from_wire(obj)
            cache[mod.shape_key(spec)] = keys(
                spec.kind, tuple(sorted(spec.params.items())))[2]
    return port, jax


@pytest.fixture(scope="module")
def built():
    port = AGG.build(_members(PJ))
    jax = JAGG.build(_members(JJ))
    return port, jax


def test_aggregate_blob_is_the_jax_blob(built):
    port, jax = built
    assert AGG.to_bytes(port) == JAGG.to_bytes(jax)
    assert port["agg_id"] == jax["agg_id"]
    assert AGG.from_bytes(JAGG.to_bytes(jax)) == port
    assert AGG.derive_challenges(port["members"]) == \
        JAGG.derive_challenges(jax["members"])


def test_both_packages_verify_it_and_reject_a_flipped_member(built):
    port, _ = built
    port_vks, jax_vks = _vk_caches()
    assert AGG.verify(port, dict(port_vks))
    assert JAGG.verify(JAGG.from_bytes(AGG.to_bytes(port)), dict(jax_vks))
    bad = copy.deepcopy(port)
    proof = bytearray.fromhex(bad["members"][1]["proof"])
    proof[100] ^= 1
    bad["members"][1]["proof"] = proof.hex()
    bad["agg_id"] = AGG.member_id(bad["members"])
    assert not AGG.verify(bad, dict(port_vks))
    assert not JAGG.verify(JAGG.from_bytes(AGG.to_bytes(bad)), dict(jax_vks))


def test_service_aggregate_survives_restart(tmp_path):
    jdir = str(tmp_path / "j")
    store = store_with(tmp_path, TOY_A, TOY_B)
    kw = dict(port=0, prover_workers=1, device="cpu",
              backend_factory=PythonBackend, journal_dir=jdir,
              store_dir=store)
    svc = ProofService(**kw).start()
    try:
        jobs = [svc.submit_local(s) for s in SPECS]
        for j, obj in zip(jobs, SPECS):
            assert j.done_event.wait(180) and j.state == "done"
            assert j.proof_bytes == jax_proof(obj)
        with ServiceClient("127.0.0.1", svc.port) as c:
            rep = c.aggregate([j.id for j in jobs])
            agg = c.fetch_aggregate(rep["agg_id"])
            with pytest.raises(ServiceError, match="unknown job"):
                c.aggregate([jobs[0].id, "job-nope"])
            with pytest.raises(ServiceError, match="no aggregate"):
                c.fetch_aggregate("agg-missing")
        assert rep["kinds"] == ["toy"] and rep["members"] == \
            [j.id for j in jobs]
        port_vks, jax_vks = _vk_caches()
        assert AGG.verify(agg, dict(port_vks))
        assert JAGG.verify(agg, dict(jax_vks))
        ctr = svc.metrics.snapshot()["counters"]
        assert ctr["aggregates_built"] == 1 and ctr["aggregate_members"] == 3
    finally:
        svc.shutdown()

    svc = ProofService(**kw).start()
    try:
        ctr = svc.metrics.snapshot()["counters"]
        assert ctr["aggregates_recovered"] == 1
        assert ctr["jobs_recovered_finished"] == 3
        with ServiceClient("127.0.0.1", svc.port) as c:
            assert c.fetch_aggregate(rep["agg_id"]) == agg
    finally:
        svc.shutdown()


def test_verify_builds_missing_vks_on_the_requested_device():
    """Without a vk cache, verify rebuilds each shape's vk through the
    port's build_bucket_keys on `device` (the card by default)."""
    one = AGG.build([m for m in _members(PJ) if m["spec"]["gates"] == 4])
    assert AGG.verify(one, device="cpu")
