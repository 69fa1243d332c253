"""scripts/torch_loadgen.py's self-hosted default run on the CPU: two
jobs of the mixed mix and the KILL_WORKER target, every proof verified
client-side on keys rebuilt on the CPU, the kill seen as a retry, exit 0.
Every shape costs two CPU key builds of 8-14 s (the service's and the
client's), so to keep the file near a minute on one core the kill
target (toy gates 300, n = 512, whose two key builds alone take over a
minute) and the mix (toy gates 16, 60 and 150) are shrunk in-process to
the mix's first shape, toy gates 16; nothing else changes."""

import json

import torch

from test_torch_operator_scripts import load_script

torch.set_num_threads(1)


def test_loadgen_default_run_with_the_kill(monkeypatch, capsys):
    lg = load_script("torch_loadgen")
    toy16 = {"kind": "toy", "gates": 16}
    monkeypatch.setattr(lg, "_KILL_SPEC", toy16)
    monkeypatch.setattr(lg, "_MIX", [toy16])
    rc = lg.main(["--device", "cpu", "--jobs", "2"])
    out = capsys.readouterr().out
    summary = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
    assert rc == 0, summary
    assert summary["ok"] and summary["verified"] == 2
    assert summary["mix"] == "mixed" and summary["device"] == "cpu"
    kill = summary["kill"]
    assert kill["state"] == "done" and kill["verified"]
    assert kill["retries"] >= 1
    assert [a["outcome"] for a in kill["attempts"]][0] == "killed"
    assert sorted(summary["kinds"]) == ["toy16"]
    assert summary["kinds"]["toy16"]["done"] == 3
    ctr = summary["metrics"]["counters"]
    assert ctr.get("job_retries", 0) >= 1
    # a pool job's kill kills its worker; a batch member's, the member
    assert ctr.get("workers_killed", 0) + \
        ctr.get("batch_member_kills", 0) >= 1
    assert summary["key_builds"] == 1
    assert summary["trace"]["adopted"] == 2
    assert summary["build"]["source"] is None    # no kernels on the CPU
