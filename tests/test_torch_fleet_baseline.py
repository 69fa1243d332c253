"""scripts/torch_fleet_baseline.py, the port's counterpart of
scripts/fleet_baseline.py (BASELINE.json's configuration 2), on the CPU:
two port workers (`--device cpu`) on free ports, the set-up and
preprocess in the script's process, a cold and a warm prove through the
port's RemoteBackend, verify. Its one JSON line has exactly the JAX
script's keys plus `device`, and `verified` is true.

The workload is the smallest the script takes: height 1 (the JAX
generator's least) with `--proofs 0`, the tree's root as the only public
input (n = 4). One Merkle proof at height 1 (n = 512) takes the plain
CPU MSM about 150 s here (about 2.4 s an MSM, 18 in the preprocess and
13 a prove); the card runs the v1 workload (height 32, one proof).

Without a card and without --device cpu the script exits non-zero before
it starts a worker, and never falls back to the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPT = os.path.join(REPO, "scripts", "torch_fleet_baseline.py")
ENV = dict(os.environ, OMP_NUM_THREADS="1")
# the keys of scripts/fleet_baseline.py's line
JAX_KEYS = {"workers", "height", "num_proofs", "n", "log2_n",
            "circuit_gen_s", "setup_preprocess_host_s", "prove_cold_s",
            "prove_s", "rounds", "verify_s", "verified"}


def test_two_cpu_workers_prove_and_verify(tmp_path):
    out_file = tmp_path / "line.json"
    out = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--workers", "2",
         "--height", "1", "--proofs", "0", "--out", str(out_file)],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS | {"device"}, sorted(line)
    assert line["verified"] is True and line["device"] == "cpu"
    assert (line["workers"], line["height"], line["num_proofs"]) == \
        (2, 1, 0)
    assert line["n"] == 1 << line["log2_n"] == 4
    assert all(line[k] > 0 for k in ("setup_preprocess_host_s",
                                     "prove_cold_s", "prove_s",
                                     "verify_s"))
    assert {"commit_wires", "commit_quot"} <= set(line["rounds"])
    assert json.loads(out_file.read_text()) == line


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_no_card_no_fleet():
    out = subprocess.run([sys.executable, SCRIPT, "--workers", "2"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=ENV)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert out.stdout.strip() == ""
