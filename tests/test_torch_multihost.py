"""The port's multi-process mesh on the CPU: the counterpart of
tests/test_multihost.py, not marked slow.

Two real processes join one torch.distributed group over gloo
(init_multihost(coord, 2, pid, local_device_ids=range(4), device="cpu"),
each contributing four CPU shard slots) and run, as one program, the
8-shard mesh NTT in all four modes, the mesh MSM over 16 bases, and the
test circuit's preprocess and prove on MeshBackend over 2 x 2 shards from
the golden device SRS (tau = 0xDEADBEEF, prove rng Random(1)). Each child
imports only the port and prints its results as one JSON line; the parent
holds both ranks against the JAX package (poly's NTTs, curve.g1_msm, with
tolerance 0), tests/fixtures/proof_small.hex and each other. The inputs
come from numpy.random.default_rng seeds, written by the parent for both
children. The last tests need no group: the argument checks.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import curve as JC
from distributed_plonk_tpu import poly as JP
from distributed_plonk_tpu.constants import R_MOD
from distributed_plonk_tpu_torch.parallel import mesh as mesh_mod
from distributed_plonk_tpu_torch.parallel import memory_plan
from distributed_plonk_tpu_torch.parallel.mesh import init_multihost
from distributed_plonk_tpu_torch.prover import PipelinedProver

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "proof_small.hex"
N = 64
MODES = [(False, False), (False, True), (True, False), (True, True)]
MODE_IDS = ["fwd", "coset", "inv", "coset_inv"]
CHILD_TIMEOUT_S = 150

_CHILD = r"""
import json, random, sys
sys.path.insert(0, sys.argv[3])
import torch
torch.set_num_threads(1)
from distributed_plonk_tpu_torch import kzg, proof_io
from distributed_plonk_tpu_torch.circuit import PlonkCircuit
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.parallel.mesh import (
    init_multihost, make_mesh, shutdown_multihost)
from distributed_plonk_tpu_torch.parallel.mesh_backend import MeshBackend
from distributed_plonk_tpu_torch.parallel.msm_mesh import MeshMsmContext
from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan

pid = int(sys.argv[1])
with open(sys.argv[4]) as f:
    inputs = json.load(f)
out = {"init": list(init_multihost(sys.argv[2], 2, pid,
                                   local_device_ids=range(4), device="cpu",
                                   timeout_s=60))}
mesh = make_mesh(8)
out["mesh"] = [mesh.size, mesh.first, len(mesh.devices), mesh.world]
plan = MeshNttPlan(mesh, inputs["n"])
out["ntt"] = [plan.run_ints(v, inverse=i, coset=c)
              for (i, c), v in zip(inputs["modes"], inputs["ntt"])]
ctx = MeshMsmContext(mesh, [tuple(p) for p in inputs["bases"]])
out["msm"] = list(ctx.msm(inputs["scalars"]))
out["msm_shards"] = sorted(ctx.shards)

ckt = PlonkCircuit()
x = ckt.create_public_variable(5)
y = ckt.create_public_variable(11)
s = ckt.add(x, y)
p = ckt.mul(x, y)
ckt.power5(s)
lc = ckt.lc([x, y, s, p], [2, 3, 5, 7])
d = ckt.add_constant(lc, 42)
m = ckt.mul_constant(d, 9)
ckt.sub(m, p)
ckt.enforce_ecc_product(x, y, s, p, ckt.one_var, 5 * 11 * 16 * 55)
ckt.finalize()
srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF, device="cpu")
mesh4 = make_mesh(4, device="cpu")
mesh4.transport.reset_stats()
be = MeshBackend(mesh4)
pk, vk = kzg.preprocess(srs, ckt, be)
proof = prove(random.Random(1), ckt, pk, be)
out["n"] = ckt.n
out["proof"] = proof_io.serialize_proof(proof).hex()
out["mesh4"] = [mesh4.size, mesh4.first, len(mesh4.devices)]
out["mesh_ntt_calls"] = {str(k): v for k, v in be.mesh_ntt_calls.items()}
out["replicated_ntt_calls"] = dict(be.replicated_ntt_calls)
out["mesh_msm_calls"] = be.mesh_msm_calls
out["collectives"] = {op: rec["calls"]
                      for op, rec in mesh4.transport.stats.items()}
shutdown_multihost()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fr_values(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(count)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    scalars = _fr_values(1601, 16)
    bases = [JC.g1_mul(JC.G1_GEN, k or 1) for k in _fr_values(1600, 16)]
    data = {"n": N, "modes": MODES,
            "ntt": [_fr_values(N + k, N) for k in range(len(MODES))],
            "bases": bases, "scalars": scalars}
    path = tmp_path_factory.mktemp("multihost") / "inputs.json"
    path.write_text(json.dumps(data))
    return data, path


@pytest.fixture(scope="module")
def ranks(inputs):
    """Both children's results, in rank order; a child that fails or
    overruns its limit fails every test of the module."""
    _, path = inputs
    coord = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(pid), coord, str(REPO),
         str(path)], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, (pid, err[-3000:])
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(line) == 1, (pid, out[-2000:], err[-2000:])
        results.append(json.loads(line[0][len("RESULT "):]))
    return results


def test_init_returns_the_group_counts_and_the_meshes(ranks):
    """init_multihost returns (2 processes, 8 devices), as the JAX
    function does; rank q holds shards [4q, 4q + 4) of the 8-shard mesh
    and [2q, 2q + 2) of MeshBackend's 4-shard mesh."""
    for q, r in enumerate(ranks):
        assert r["init"] == [2, 8]
        assert r["mesh"] == [8, 4 * q, 4, 2]
        assert r["mesh4"] == [4, 2 * q, 2]
        assert r["msm_shards"] == list(range(4 * q, 4 * q + 4))


@pytest.mark.parametrize("mode", range(len(MODES)), ids=MODE_IDS)
def test_mesh_ntt_matches_jax_poly_on_both_ranks(ranks, inputs, mode):
    data, _ = inputs
    inverse, coset = MODES[mode]
    fn = {(False, False): JP.fft, (False, True): JP.coset_fft,
          (True, False): JP.ifft, (True, True): JP.coset_ifft}
    want = fn[(inverse, coset)](JP.Domain(N), data["ntt"][mode])
    assert [r["ntt"][mode] for r in ranks] == [want, want]


def test_mesh_msm_matches_jax_g1_msm_on_both_ranks(ranks, inputs):
    """16 bases over 8 shards pad to 128 points: rank 1's four ranges are
    all identity padding, and the fold across ranks still gives the sum."""
    data, _ = inputs
    want = list(JC.g1_msm(data["bases"], data["scalars"]))
    assert [r["msm"] for r in ranks] == [want, want]


def test_mesh_proof_matches_golden_on_both_ranks(ranks):
    """The golden bytes (which test_torch_prove.py verifies) on both
    ranks."""
    golden = FIXTURE.read_text().strip()
    assert [r["proof"] for r in ranks] == [golden, golden]


def test_counters_and_collectives_agree_across_ranks(ranks):
    """Every NTT of the test circuit's sizes took the mesh path and every
    commitment the mesh MSM, counted alike on both ranks; each mesh NTT
    call is one all-to-all and one all-gather, each commit batch one
    all-gather (preprocess's 18 handles in one batch, the prove's four
    commit rounds)."""
    n = ranks[0]["n"]
    for r in ranks:
        assert r["mesh_ntt_calls"] == {str(n): 18 + 7, str(8 * n): 26}
        assert r["replicated_ntt_calls"] == {}
        assert r["mesh_msm_calls"] == 18 + 13
        calls = r["collectives"]
        assert calls["all_to_all"] > 0
        assert calls["all_gather"] == calls["all_to_all"] + 1 + 4
    assert ranks[0]["collectives"] == ranks[1]["collectives"]


def test_ranks_hold_the_same_values(ranks):
    a, b = (dict(r) for r in ranks)
    for r in (a, b):
        for key in ("mesh", "mesh4", "msm_shards"):
            r.pop(key)
    assert a == b


class _Stub:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_make_mesh_refuses_shards_the_processes_do_not_divide():
    """The global mesh of a two-process group (a stub: no process group
    is formed) deals n_shards / 2 shards to each process, rank 1 from
    shard n_shards / 2 on; a count 2 does not divide raises."""
    cpu = torch.device("cpu")
    group = _Stub(transport=_Stub(world=2, rank=1, backend="gloo"),
                  devices=[cpu] * 2, device_count=4)
    mesh = mesh_mod._global_mesh(group, 6, None)
    assert (mesh.size, mesh.first, mesh.devices) == (6, 3, (cpu,) * 3)
    assert [s for s, _ in mesh.shards()] == [3, 4, 5]
    assert mesh_mod._global_mesh(group, None, "cpu").size == 4
    for bad in (3, 1):
        with pytest.raises(ValueError, match="do not divide"):
            mesh_mod._global_mesh(group, bad, None)


@pytest.mark.parametrize("args,match", [
    (("127.0.0.1:1", 2, 2), "process_id"),
    (("127.0.0.1:1", 2, -1), "process_id"),
    (("127.0.0.1:1", 0, 0), "num_processes"),
    (("127.0.0.1:1", "2", 0), "num_processes"),
    (("127.0.0.1", 2, 0), "host:port"),
], ids=["pid_past_end", "pid_negative", "no_processes", "count_not_int",
        "no_port"])
def test_init_multihost_rejects_bad_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        init_multihost(*args, device="cpu")
    assert mesh_mod._joined is None


def test_nccl_needs_cards_and_the_pipeline_refuses_collectives():
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        init_multihost("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one thread"):
        PipelinedProver(_Stub(issues_collectives=True))


def test_memory_plan_per_process():
    """The per-process figure is the shards one process holds times the
    per-shard bytes."""
    ntt = memory_plan.ntt_mesh_plan(1 << 21, 4, n_processes=2)
    assert ntt["local_shards"] == 2
    assert ntt["per_process"] == 2 * ntt["total"]
    msm = memory_plan.msm_mesh_plan(262176, 4, batch=5, n_processes=2)
    assert msm["per_process"] == 2 * msm["total"]
    r3 = memory_plan.round3_mesh_plan(1 << 13, 1 << 16, 4, n_processes=2)
    assert r3["per_process"] == 2 * r3["shard"]
    with pytest.raises(ValueError):
        memory_plan.ntt_mesh_plan(1 << 16, 4, n_processes=3)
