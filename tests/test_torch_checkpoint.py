"""Checkpoint and resume in the port (checkpoint.py, the staged prover,
TorchBackend.dump_h / load_h) on the CPU.

A prove stopped after any of rounds 1-4 resumes from its snapshot to the
bytes of tests/fixtures/proof_small.hex and leaves no file behind; the
snapshot format is the JAX package's, so a snapshot written by the JAX
package's prover resumes in the port and the reverse, to the same bytes;
a snapshot of another workload raises. (A port member killed at its latch
is tests/test_torch_pipeline.py's.)
"""

import copy
import os
import random
import shutil

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import checkpoint as JCK
from distributed_plonk_tpu import prover as JP
from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.checkpoint import (ProverCheckpoint,
                                                    dump_handle, load_handle)
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.prover import prove

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)


class _Interrupted(Exception):
    pass


class _JaxKillAfterRound(JCK.ProverCheckpoint):
    """Persist the snapshot like the real thing, then die: a crash at the
    round boundary, with the snapshot already on disk."""

    def __init__(self, path, kill_round):
        super().__init__(path)
        self.kill_round = kill_round

    def save(self, round_no, *args, **kwargs):
        super().save(round_no, *args, **kwargs)
        if round_no == self.kill_round:
            raise _Interrupted("killed after round %d" % round_no)


class _KeepEach(ProverCheckpoint):
    """A checkpoint that also keeps a copy of each round's snapshot, so
    one prove yields the snapshot after every round."""

    def save(self, round_no, *args, **kwargs):
        super().save(round_no, *args, **kwargs)
        shutil.copy(self.path, "%s.r%d" % (self.path, round_no))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """round -> path of the port's snapshot after that round (golden
    recipe, prove rng Random(1))."""
    ckt, be, pk, _ = port_keys()
    path = str(tmp_path_factory.mktemp("ckpt") / "run.ckpt.npz")
    proof = prove(random.Random(1), ckt, pk, be,
                  checkpoint=_KeepEach(path))
    assert proof_io.serialize_proof(proof) == golden()
    assert not os.path.exists(path)     # cleared on success
    return {k: "%s.r%d" % (path, k) for k in range(1, 5)}


def _resume(src, tmp_path):
    """A fresh copy of a snapshot file (resuming deletes it)."""
    dst = str(tmp_path / "resume.ckpt.npz")
    shutil.copy(src, dst)
    return dst


@pytest.mark.parametrize("after_round", [1, 2, 3, 4])
def test_resume_after_each_round_is_byte_identical(snapshots, after_round,
                                                   tmp_path):
    ckt, be, pk, _ = port_keys()
    path = _resume(snapshots[after_round], tmp_path)
    # a new rng object: the snapshot rewinds it
    proof = prove(random.Random(1), ckt, pk, be,
                  checkpoint=ProverCheckpoint(path))
    assert proof_io.serialize_proof(proof) == golden()
    assert not os.path.exists(path)


def test_port_resumes_a_jax_snapshot(proven, tmp_path):
    """The JAX package's prover on its host oracle stops after round 2;
    the port resumes its file to the golden bytes."""
    jckt, jpk, _, _ = proven
    path = str(tmp_path / "jax.ckpt.npz")
    with pytest.raises(_Interrupted):
        JP.prove(random.Random(1), jckt, jpk, PythonBackend(),
                 checkpoint=_JaxKillAfterRound(path, 2))
    ckt, be, pk, _ = port_keys()
    proof = prove(random.Random(1), ckt, pk, be,
                  checkpoint=ProverCheckpoint(path))
    assert proof_io.serialize_proof(proof) == golden()
    assert not os.path.exists(path)


def test_jax_resumes_a_port_snapshot(proven, snapshots, tmp_path):
    """The JAX package's prover resumes the port's round-2 snapshot on its
    host oracle to the golden bytes."""
    jckt, jpk, _, _ = proven
    path = _resume(snapshots[2], tmp_path)
    proof = JP.prove(random.Random(1), jckt, jpk, PythonBackend(),
                     checkpoint=JCK.ProverCheckpoint(path))
    assert JIO.serialize_proof(proof) == golden()
    assert not os.path.exists(path)


def test_snapshot_of_another_workload_raises(snapshots, tmp_path):
    ckt, be, pk, _ = port_keys()
    other = copy.copy(pk)
    other.vk = copy.copy(pk.vk)
    other.vk.num_inputs += 1
    path = _resume(snapshots[1], tmp_path)
    with pytest.raises(ValueError, match="different circuit"):
        prove(random.Random(1), ckt, other, be,
              checkpoint=ProverCheckpoint(path))
    assert os.path.exists(path)       # someone else's snapshot stays


def test_handle_dumps_are_the_jax_layout():
    """A handle's snapshot array is the JAX package's: canonical (16, L)
    uint32 16-bit limbs, whether TorchBackend.dump_h writes it or the
    lower() fallback of a backend without dump_h (the JAX host oracle)."""
    rng = random.Random(9)
    vals = [0, 1, R_MOD - 1] + [rng.randrange(R_MOD) for _ in range(13)]
    _, be, _, _ = port_keys()
    oracle = PythonBackend()
    want = JCK.dump_handle(oracle, oracle.lift(vals))
    assert want.dtype == np.uint32 and want.shape == (16, len(vals))
    h = be.lift(vals)
    assert np.array_equal(dump_handle(be, h), want)
    assert np.array_equal(dump_handle(oracle, oracle.lift(vals)), want)
    assert torch.equal(load_handle(be, want), h)
    assert oracle.lower(load_handle(oracle, want)) == vals
