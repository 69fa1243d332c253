"""The two mesh scale scripts of the PyTorch port, each at its smallest
mode on the CPU's plain kernels, run as a user runs them (a child
process from the repo root): scripts/torch_mesh_ntt_scale.py at 2^10
(the coset NTT round trip on sharded handles and the poly oracle) and
scripts/torch_mesh_prove_scale.py on the toy circuit of the conftest
size (n = 16, every handle sharded by --min-local 1: the proof held to
the PythonBackend proof and verified, the residency check within the
plan), and once with its plan cut to nothing, where it must write its
numbers and exit non-zero.
"""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
LIMIT_S = 240


def _run(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / script)] + list(args),
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=LIMIT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, (proc.returncode, proc.stdout[-2000:],
                             proc.stderr[-3000:])
    return proc.returncode, json.loads(lines[0]), proc.stderr


def test_ntt_scale_round_trip_and_oracle_on_cpu(tmp_path):
    out = tmp_path / "ntt.json"
    rc, res, err = _run("torch_mesh_ntt_scale.py", "--log2n", "10",
                        "--device", "cpu", "--out", str(out))
    assert rc == 0, err[-3000:]
    assert res["roundtrip_exact"] and res["oracle_match"]
    assert (res["log2n"], res["shards"], res["platform"]) == (10, 4, "cpu")
    # four lane blocks of 256 words (8 x 4 B each)
    assert res["shard_bytes"] == {str(s): 256 * 32 for s in range(4)}
    assert res["mesh_ntt_calls"] == {"1024": 3}
    assert json.loads(out.read_text()) == res


def test_prove_scale_matches_the_oracle_within_the_plan_on_cpu():
    rc, res, err = _run("torch_mesh_prove_scale.py", "--toy-gates", "10",
                        "--device", "cpu", "--min-local", "1")
    assert rc == 0, err[-3000:]
    assert res["n"] == 16 and res["m"] == 128 and res["shards"] == 4
    assert res["verified"] and res["oracle_bit_identical"]
    assert res["sharded_handles"] == {"16": 50, "18": 12, "19": 3,
                                      "128": 27}
    assert not res["replicated_handles"]
    r = res["residency"]
    assert r["within_plan"]
    # the 25 coset planes' lanes of each shard: 25 x 32 lanes x 32 B
    assert r["actual_per_shard"] == {str(s): 25 * 32 * 32 for s in range(4)}
    assert r["plan_parts"]["planes"] == 25 * 32 * 32


def test_prove_scale_exits_nonzero_when_the_plan_is_too_small():
    rc, res, err = _run("torch_mesh_prove_scale.py", "--toy-gates", "10",
                        "--device", "cpu", "--min-local", "1",
                        "--shards", "2", "--skip-oracle",
                        "--plan-scale", "0", "--slack-mib", "0")
    assert rc != 0
    assert res["verified"] and not res["residency"]["within_plan"]
    assert res["residency"]["actual_max_per_shard"] > 0
    assert "exceeds round 3's plan" in err
