"""The port's reference-scale runners on the CPU's plain kernels, their
functions called in process at tiny sizes:

- scripts/torch_scale_run.py (the counterpart of scripts/scale_run.py):
  one run at height 1 with no Merkle proof (the root the only public
  input, n = 4; one proof at height 1 is n = 512, minutes of plain CPU
  MSMs): its line has the JAX script's keys plus the port's, and
  verifies;
- scripts/torch_kernel_bench.py (the counterpart of
  scripts/kernel_bench.py): the mont_mul chains at 2^10 and 2^8 lanes,
  the NTT at 2^10 and the MSM at 2^6 points over 2^6 distinct bases on
  both key layouts, each meeting the tiling identity, both giving the
  same point;
- without a card and without --device cpu both exit non-zero.
"""

import importlib.util
import json
import os

import torch

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
# the keys of scripts/scale_run.py's line
SCALE_KEYS = {"height", "num_proofs", "n", "log2_n", "num_gates",
              "circuit_gen_s", "setup_s", "preprocess_s", "prove_cold_s",
              "prove_s", "rounds", "trace", "verify_s", "verified"}

torch.set_num_threads(1)


def load(name):
    """scripts/<name>.py as a module (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_run_line_has_the_jax_keys_and_verifies():
    res = load("torch_scale_run").scale_run(1, 0, device="cpu")
    assert set(res) == SCALE_KEYS | {"device", "rounds_cold"}, sorted(res)
    assert res["verified"] is True and res["device"] == "cpu"
    assert (res["height"], res["num_proofs"]) == (1, 0)
    assert res["n"] == 1 << res["log2_n"] == 4
    assert {"commit_wires", "commit_quot"} <= set(res["rounds"])
    assert set(res["rounds_cold"]) == set(res["rounds"])
    assert all(res[k] > 0 for k in ("setup_s", "preprocess_s",
                                    "prove_cold_s", "prove_s", "verify_s"))
    assert json.loads(json.dumps(res)) == res


def test_kernel_bench_meets_the_tiling_identity_on_both_layouts():
    kb = load("torch_kernel_bench")
    out = kb.kernel_bench("all", torch.device("cpu"), {
        "fr": 10, "fq": 8, "ntt": 10, "msm": (6, 6), "distinct": 6})
    assert (out["kernel"], out["platform"]) == ("plain", "cpu")
    assert "card" not in out
    assert (out["fr"]["kernel"], out["fr"]["n"], out["fr"]["chain"]) == \
        ("mont_mul_fr", 1 << 10, 8)
    assert (out["fq"]["kernel"], out["fq"]["n"]) == ("mont_mul_fq", 1 << 8)
    assert out["ntt"]["kernel"] == "ntt_2p10"
    assert out["ntt"]["elements_per_s"] > 0
    msm = out["msm_2p6"]
    assert msm["same_point"] is True
    assert [msm[k]["layout"] for k in ("shifted", "base")] == \
        ["shifted", "base"]
    # the base layout's window finish (msm_finish) is timed beside its MSM
    assert msm["base"]["finish_ms"] > 0 and "finish_ms" not in msm["shifted"]
    for rec in (msm["shifted"], msm["base"]):
        assert rec["tiling_identity"] is True and rec["n"] == 64
        assert rec["points_per_s"] > 0


def test_both_scripts_refuse_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert load("torch_scale_run").main(["--proofs", "1"]) == 1
    assert load("torch_kernel_bench").main(["msm24"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
