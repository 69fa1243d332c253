"""The port's operator scripts on the CPU (scripts/torch_warmup.py,
torch_loadgen.py, torch_fleet.py; the runs of the loadgen and of the
fleet script have files of their own, test_torch_loadgen.py,
test_torch_loadgen_remote.py and test_torch_fleet_script.py, to keep
each file within about a minute on one core):

- `torch_warmup.py --store-dir DIR --device cpu` for toy gates 16 leaves
  a `bucket:` blob byte-equal to the one the JAX `scripts/warmup.py
  --store-dir` leaves for the same spec (the meta aside), and a second
  run reports `source: disk`;
- each script exits non-zero without a card unless --device cpu is
  given;
- the loadgen's pure functions `_parse_slo_mix`, `_parse_circuit_mix` and
  `_traffic_schedule` (diurnal, burst and flat at one seed) return
  exactly what the JAX scripts/loadgen.py's return, errors included.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_plonk_tpu.store import ArtifactStore as JaxArtifactStore

from distributed_plonk_tpu_torch.service.jobs import JobSpec, shape_key
from distributed_plonk_tpu_torch.store import ArtifactStore, bucket_store_key

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
TOY16 = {"kind": "toy", "gates": 16}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        "script_" + name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(args, timeout=240):
    out = subprocess.run([sys.executable] + args, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    return out.returncode, [json.loads(ln) for ln in lines], out


def test_warmup_leaves_the_jax_bucket_bytes(tmp_path):
    key = bucket_store_key(shape_key(JobSpec.from_wire(TOY16)))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    spec = json.dumps(TOY16)
    rc, (jout,), out = run_script([
        "scripts/warmup.py", "--store-dir", jax_dir, "--spec", spec])
    assert rc == 0, out.stderr[-2000:]
    assert jout["shapes"][0]["source"] == "built"
    rc, (first,), out = run_script([
        "scripts/torch_warmup.py", "--store-dir", port_dir, "--spec", spec,
        "--device", "cpu"])
    assert rc == 0 and first["ok"], out.stderr[-2000:]
    assert first["shapes"][0]["source"] == "built"
    assert first["device"] == "cpu" and first["kernel_build"] is None
    blob = ArtifactStore(port_dir).get(key)
    assert blob is not None and blob == JaxArtifactStore(jax_dir).get(key)
    rc, (second,), out = run_script([
        "scripts/torch_warmup.py", "--store-dir", port_dir, "--spec", spec,
        "--device", "cpu"])
    assert rc == 0 and second["ok"], out.stderr[-2000:]
    assert second["shapes"][0]["source"] == "disk"
    assert second["shapes"][0]["domain_size"] == \
        first["shapes"][0]["domain_size"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
@pytest.mark.parametrize("script,args", [
    ("torch_warmup.py", ["--store-dir", "STORE"]),
    ("torch_loadgen.py", ["--jobs", "1"]),
    ("torch_fleet.py", ["--workers", "1"]),
])
def test_scripts_refuse_without_a_card(tmp_path, script, args):
    args = [str(tmp_path / "s") if a == "STORE" else a for a in args]
    rc, lines, out = run_script(["scripts/" + script] + args, timeout=60)
    assert rc != 0, out.stdout
    assert "CUDA is not available" in out.stdout + out.stderr


@pytest.fixture(scope="module")
def loadgens():
    return load_script("loadgen"), load_script("torch_loadgen")


@pytest.mark.parametrize("arg", [
    "flagship=0.1,standard=0.6,batch=0.3", "standard=1.0",
    "batch=2,flagship=1", "bogus=1", "standard=x", "standard=0", "standard"])
def test_parse_slo_mix_matches_the_jax_loadgen(loadgens, arg):
    got = [_outcome(lg._parse_slo_mix, arg) for lg in loadgens]
    assert got[0] == got[1]


@pytest.mark.parametrize("arg", [
    "range=0.3,merkle=0.3,rollup=0.2,toy=0.2", "toy=1",
    "preimage=2,range=1", "zk=1", "toy=abc", "toy=0"])
def test_parse_circuit_mix_matches_the_jax_loadgen(loadgens, arg):
    got = [_outcome(lg._parse_circuit_mix, arg) for lg in loadgens]
    assert got[0] == got[1]
    jax_lg, port_lg = loadgens
    assert port_lg._ZOO_SPECS == jax_lg._ZOO_SPECS


@pytest.mark.parametrize("model", ["diurnal", "burst", "flat"])
def test_traffic_schedule_matches_the_jax_loadgen(loadgens, model):
    mix = {"flagship": 0.1, "standard": 0.6, "batch": 0.3}
    got = [lg._traffic_schedule(model, 24, 20.0, 0xC4A05, mix)
           for lg in loadgens]
    assert got[0] == got[1] and len(got[1]) == 24
    assert [t for t, _ in got[1]] == sorted(t for t, _ in got[1])
    jax_lg, port_lg = loadgens
    assert port_lg._SLO_GATES == jax_lg._SLO_GATES
    assert port_lg._MIX == jax_lg._MIX and \
        port_lg._KILL_SPEC == jax_lg._KILL_SPEC


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except SystemExit as e:
        return ("exit", str(e))
