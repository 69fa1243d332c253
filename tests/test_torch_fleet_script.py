"""scripts/torch_fleet.py on the CPU: two supervised port workers joined
through the membership plane, slot 1 SIGKILLed half a second after the
fleet is up, the toy prove (gates 16, seed 7, Random(1)) through
RemoteBackend equal to the port's PythonBackend bytes (the whole
serialized proof), and the fleet healed back to two workers."""

from test_torch_operator_scripts import run_script


def test_fleet_script_proves_after_a_kill(tmp_path):
    rc, lines, out = run_script([
        "scripts/torch_fleet.py", "--workers", "2", "--prove", "--device",
        "cpu", "--kill", "1", "--store-root", str(tmp_path / "s"),
        "--obs-dump"], timeout=300)
    assert rc == 0, (out.stdout[-3000:], out.stderr[-3000:])
    up, report, obs = lines
    assert up["fleet_up"] and len(up["roster"]["workers"]) == 2
    assert report["prove_ok"] is True
    assert report["healed_to_full_width"] is True
    assert report["counters"]["worker_respawns"] == 1
    assert report["counters"]["membership_rejoins"] == 1
    assert [e["usable"] for e in obs["fleet_obs"]] == [True, True]
    # no kernels load on the CPU
    assert all(e["build"]["source"] is None for e in obs["fleet_obs"])
