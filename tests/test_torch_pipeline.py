"""Batched and pipelined proving in the port (prover.prove_many,
prover.prove_pipelined, TorchBackend.commit_many_async / eval_many_async)
on the CPU.

Three members of the test circuit with prove rngs Random(1..3) must give
the bytes of three sequential proves: the golden file for Random(1), the
JAX package's sequential `prove` on its host oracle for the others (the
port's sequential prove equals it: test_torch_prove). A member that fails
at its round-2 latch is dropped while the others finish, and its retry
resumes alone from its snapshot.
"""

import os
import random

import pytest
import torch

from distributed_plonk_tpu import prover as JP
from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.checkpoint import ProverCheckpoint
from distributed_plonk_tpu_torch.prover import prove_many, prove_pipelined
from distributed_plonk_tpu_torch.trace import Tracer

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

SEEDS = (1, 2, 3)


class _Interrupted(Exception):
    pass


class _KillAfterRound(ProverCheckpoint):
    def __init__(self, path, kill_round):
        super().__init__(path)
        self.kill_round = kill_round

    def save(self, round_no, *args, **kwargs):
        super().save(round_no, *args, **kwargs)
        if round_no == self.kill_round:
            raise _Interrupted("killed after round %d" % round_no)


@pytest.fixture(scope="module")
def sequential(proven):
    jckt, jpk, _, _ = proven
    return [golden()] + [
        JIO.serialize_proof(JP.prove(random.Random(s), jckt, jpk,
                                     PythonBackend()))
        for s in SEEDS[1:]]


def _blobs(proofs):
    return [None if p is None else proof_io.serialize_proof(p)
            for p in proofs]


def test_prove_many_equals_sequential(sequential):
    ckt, be, pk, _ = port_keys()
    proofs, errors = prove_many([random.Random(s) for s in SEEDS],
                                [ckt] * 3, pk, be)
    assert errors == [None] * 3
    assert _blobs(proofs) == sequential


def test_prove_pipelined_depth_1_equals_sequential(sequential):
    ckt, be, pk, _ = port_keys()
    events = []
    proofs, errors = prove_pipelined([random.Random(s) for s in SEEDS],
                                     [ckt] * 3, pk, be, depth=1,
                                     observer=events.append)
    assert errors == [None] * 3
    assert _blobs(proofs) == sequential
    # one event per completed stage: five rounds per member, in order,
    # one member in flight
    assert [e["round"] for e in events] == [1, 2, 3, 4, 5] * 3
    for e in events:
        assert set(e) == {"round", "depth", "stage_wait_s", "force_wait_s",
                          "finalize_s", "host_finalize_s"}
        assert e["depth"] == 1
        assert min(e["stage_wait_s"], e["force_wait_s"], e["finalize_s"],
                   e["host_finalize_s"]) >= 0


def test_prove_pipelined_depth_2_isolates_a_failed_member(sequential,
                                                          tmp_path):
    """At depth 2 the member of Random(2) dies at its round-2 latch: the
    other two finish with the sequential bytes, and the retry resumes
    alone from the round-2 snapshot (rounds 3-5 only) to its own."""
    ckt, be, pk, _ = port_keys()
    path = str(tmp_path / "member1.ckpt.npz")
    proofs, errors = prove_pipelined(
        [random.Random(s) for s in SEEDS], [ckt] * 3, pk, be, depth=2,
        checkpoints=[None, _KillAfterRound(path, 2), None])
    assert errors[0] is None and errors[2] is None
    assert isinstance(errors[1], _Interrupted)
    blobs = _blobs(proofs)
    assert blobs[0] == sequential[0] and blobs[2] == sequential[2]
    assert blobs[1] is None and os.path.exists(path)

    tr = Tracer()
    proofs, errors = prove_pipelined([random.Random(2)], [ckt], pk, be,
                                     tracers=[tr],
                                     checkpoints=[ProverCheckpoint(path)])
    assert errors == [None]
    assert _blobs(proofs) == [sequential[1]]
    assert {k for k in tr.totals(0) if k.startswith("round")} == {
        "round3", "round4", "round5"}
    assert not os.path.exists(path)
