"""The port's artifact store on the CPU, held to the JAX package's bytes:

- keycache.serialize_bucket of the port's bucket keys (device SRS, lazy
  proving key) gives the JAX package's blob for the same shape, and the
  port reads back the JAX blob to the same keys;
- a bucket the JAX package wrote proves on the port's TorchBackend (which
  did not build it) to the JAX PythonBackend's bytes;
- a StoreCheckpoint crosses packages in both directions through one
  store: a prove stopped after round 2 by one package resumes in the
  other to the uninterrupted bytes; a corrupted snapshot is a miss;
- a port worker launched with --store serves a bucket blob over
  STORE_FETCH (to the port's and the JAX package's fetch) and lists it
  over STORE_LIST;
- aot warmup builds the prover stages on TorchBackend and reports
  "unsupported" on the host oracle; warm_spec provisions a store (a disk
  hit, or a build on the requested device writing the JAX blob).
"""

import os
import random
import socket
import subprocess
import sys
import time

import pytest
import torch

from distributed_plonk_tpu import checkpoint as JCK
from distributed_plonk_tpu.backend.python_backend import \
    PythonBackend as JaxPythonBackend
from distributed_plonk_tpu.prover import prove as jax_prove
from distributed_plonk_tpu.service import jobs as JJ
from distributed_plonk_tpu.store import ArtifactStore as JaxArtifactStore
from distributed_plonk_tpu.store import keycache as JKC
from distributed_plonk_tpu.store import remote as JRS

from distributed_plonk_tpu_torch import checkpoint as PCK
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.service import jobs as PJ
from distributed_plonk_tpu_torch.store import (ArtifactStore, aot_warmup,
                                               warm_spec)
from distributed_plonk_tpu_torch.store import keycache as PKC
from distributed_plonk_tpu_torch.store import remote as PRS

from test_torch_service import (TOY_A, _jax_bucket, jax_proof, port_bucket,
                                store_with)

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PARAMS = tuple(sorted(PJ.JobSpec.from_wire(TOY_A).params.items()))


def _jax_blob():
    return JKC.serialize_bucket(*_jax_bucket("toy", PARAMS))


def test_bucket_blob_is_the_jax_blob():
    srs, pk, vk = port_bucket("toy", PARAMS)
    blob = PKC.serialize_bucket(srs, pk, vk)
    assert blob == _jax_blob()
    # and each package reads the other's blob to the same keys
    jsrs, jpk, jvk = JKC.deserialize_bucket(blob)
    psrs, ppk, pvk = PKC.deserialize_bucket(_jax_blob())
    assert psrs.powers_of_g1 == jsrs.powers_of_g1 == srs.powers_affine()
    assert ppk.selectors == jpk.selectors == pk.selectors
    assert ppk.sigmas == jpk.sigmas == pk.sigmas
    assert ppk.ck == jpk.ck
    assert (pvk.selector_comms, pvk.sigma_comms, pvk.k) == \
        (vk.selector_comms, vk.sigma_comms, vk.k)


def test_jax_written_bucket_proves_on_the_port(tmp_path):
    """The JAX package writes the bucket into a store; the port's store
    loads it (BucketCache's disk tier) and a fresh TorchBackend proves
    with it to the JAX PythonBackend's bytes."""
    jstore = JaxArtifactStore(str(tmp_path / "s"))
    key = JJ.shape_key(JJ.JobSpec.from_wire(TOY_A))
    JKC.store_bucket(jstore, key, *_jax_bucket("toy", PARAMS), build_s=1.5)
    hit = PKC.load_bucket(ArtifactStore(str(tmp_path / "s")),
                          PJ.shape_key(PJ.JobSpec.from_wire(TOY_A)))
    assert hit is not None and hit[3]["build_s"] == 1.5
    _srs, pk, vk, _meta = hit
    spec = PJ.JobSpec.from_wire(dict(TOY_A, seed=6))
    proof = prove(random.Random(6), PJ.build_circuit(spec), pk,
                  TorchBackend(device="cpu"))
    assert proof_io.serialize_proof(proof) == jax_proof(dict(TOY_A, seed=6))


class _Stop(Exception):
    pass


def _stopping(base):
    class StopAfterRound2(base):
        def save(self, round_no, *args, **kwargs):
            super().save(round_no, *args, **kwargs)
            if round_no == 2:
                raise _Stop()
    return StopAfterRound2


@pytest.mark.parametrize("first", ["port", "jax"])
def test_store_checkpoint_crosses_packages(tmp_path, first):
    """One package proves until round 2's snapshot is in the store, the
    other resumes from it (each on its own host oracle and with its own
    copy of the same keys) to the uninterrupted bytes."""
    root = str(tmp_path / "s")
    spec_obj = dict(TOY_A, seed=9)
    jsrs, jpk, jvk = _jax_bucket("toy", PARAMS)
    _, ppk, _ = PKC.deserialize_bucket(_jax_blob())
    sides = {
        "port": (PCK.StoreCheckpoint, ArtifactStore, prove, ppk,
                 PythonBackend, PJ),
        "jax": (JCK.StoreCheckpoint, JaxArtifactStore, jax_prove, jpk,
                JaxPythonBackend, JJ),
    }
    second = "jax" if first == "port" else "port"
    ck_cls, store_cls, prove_fn, pk, be_cls, jobs = sides[first]
    spec = jobs.JobSpec.from_wire(spec_obj)
    with pytest.raises(_Stop):
        prove_fn(random.Random(9), jobs.build_circuit(spec), pk, be_cls(),
                 checkpoint=_stopping(ck_cls)(store_cls(root), "job-x"))
    ck_cls, store_cls, prove_fn, pk, be_cls, jobs = sides[second]
    spec = jobs.JobSpec.from_wire(spec_obj)
    ck = ck_cls(store_cls(root), "job-x")
    assert ck.has_snapshot()
    proof = prove_fn(random.Random(9), jobs.build_circuit(spec), pk,
                     be_cls(), checkpoint=ck)
    assert proof_io.serialize_proof(proof) == jax_proof(spec_obj)


def test_corrupted_store_checkpoint_is_a_miss(tmp_path):
    store = ArtifactStore(str(tmp_path / "s"))
    ck = PCK.StoreCheckpoint(store, "job-y")
    assert not ck.chaos_corrupt()            # nothing to corrupt yet
    store.put(ck.key, b"snapshot bytes" * 64)
    assert ck.chaos_corrupt()
    assert ck.load("fingerprint") is None    # SHA-256 caught it
    assert not ck.has_snapshot()


def test_worker_serves_its_store_over_store_fetch(tmp_path):
    """A port worker launched with --store answers STORE_FETCH with the
    digest-verified blob (the port's fetch and the JAX package's) and
    STORE_LIST with its keys."""
    root = str(tmp_path / "s")
    store = ArtifactStore(root)
    key = PKC.bucket_store_key(PJ.shape_key(PJ.JobSpec.from_wire(TOY_A)))
    digest = store.put(key, _jax_blob(), meta={"kind": "bucket_keys"})
    with socket.socket() as probe:      # a port no other test holds
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    cfg = NetworkConfig([f"127.0.0.1:{port}"])
    cfg_path = str(tmp_path / "network.json")
    cfg.save(cfg_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
         "0", cfg_path, "--device", "cpu", "--store", root], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                keys = PRS.list_keys("127.0.0.1", port)
                break
            except (ConnectionError, OSError):
                assert time.monotonic() < deadline, "worker did not start"
                time.sleep(0.2)
        assert keys == [key]
        meta, blob = PRS.fetch_blob("127.0.0.1", port, key)
        assert blob == _jax_blob() and meta == {"kind": "bucket_keys"}
        jstore = JaxArtifactStore(str(tmp_path / "jax-side"))
        assert JRS.fetch_into(jstore, "127.0.0.1", port, key) == blob
        assert jstore.get_entry(key)[1] == digest
        with pytest.raises(PRS.FetchError, match="no 'bucket:nope'"):
            PRS.fetch_blob("127.0.0.1", port, "bucket:nope")
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_aot_warmup_builds_the_stages():
    _srs, pk, vk = port_bucket("toy", PARAMS)
    out = aot_warmup(TorchBackend(device="cpu"), vk.domain_size, ck=pk.ck)
    assert out["aot"] == "ok" and out["ntt_plans"] == [16, 128]
    assert out["commit_key_points"] == len(pk.ck) == 32
    assert out["device"] == "cpu" and out["kernels"] == []
    assert aot_warmup(PythonBackend(), 16)["aot"] == "unsupported"


def test_warm_spec_provisions_a_store(tmp_path):
    """Offline provisioning: a store that holds the shape reports a disk
    hit; an empty one builds on the requested device and writes the JAX
    package's blob."""
    hit = warm_spec(ArtifactStore(store_with(tmp_path, TOY_A)), TOY_A)
    assert hit["source"] == "disk" and hit["domain_size"] == 16
    empty = ArtifactStore(str(tmp_path / "empty"))
    built = warm_spec(empty, TOY_A, device="cpu",
                      aot_backend=TorchBackend(device="cpu"))
    assert built["source"] == "built" and built["aot"]["aot"] == "ok"
    key = PKC.bucket_store_key(PJ.shape_key(PJ.JobSpec.from_wire(TOY_A)))
    assert empty.get(key) == _jax_blob()
