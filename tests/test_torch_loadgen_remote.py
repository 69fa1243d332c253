"""scripts/torch_loadgen.py --host/--port against an in-test port
service on the CPU (chaos on): one toy gates 16 job and the KILL_WORKER
target shrunk to the same shape (the default n = 512 target's two CPU key
builds alone take over a minute); the script exits 0 with every proof
verified client-side on keys it rebuilt itself and the kill seen as a
retry, and leaves the service running."""

import json

from distributed_plonk_tpu_torch.service import ProofService

from test_torch_operator_scripts import TOY16, run_script


def test_loadgen_against_an_external_port_service():
    svc = ProofService(port=0, device="cpu", chaos=True,
                       allow_remote_shutdown=False).start()
    try:
        rc, lines, out = run_script([
            "scripts/torch_loadgen.py", "--host", "127.0.0.1", "--port",
            str(svc.port), "--device", "cpu", "--jobs", "1",
            "--spec", json.dumps(TOY16), "--kill-spec", json.dumps(TOY16)],
            timeout=300)
    finally:
        svc.shutdown()
    assert rc == 0, (out.stdout[-3000:], out.stderr[-3000:])
    summary = lines[-1]
    assert summary["ok"] and summary["verified"] == 1
    kill = summary["kill"]
    assert kill["state"] == "done" and kill["verified"]
    assert kill["retries"] >= 1 and kill["victim"]
    assert summary["kinds"]["toy16"]["done"] == 2
    assert summary["trace"]["adopted"] == 1
    assert len(summary["done_job_ids"]) == 2
