"""scripts/torch_ci.sh, the port's lanes of scripts/ci.sh: with no lane
or an unknown one it prints its lanes and exits 2 (the lanes themselves
run pytest files and the static verifier, which tier-1 covers)."""

import os
import subprocess

import pytest

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
LANES = ("fast", "analyze", "chaos", "cuda")


@pytest.mark.parametrize("args", [[], ["bogus"], ["benchcheck"]])
def test_no_or_unknown_lane_lists_the_lanes_and_exits_2(args):
    out = subprocess.run(["bash", os.path.join(REPO, "scripts",
                                               "torch_ci.sh"), *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 2
    assert all(lane in out.stderr for lane in LANES), out.stderr
    assert out.stdout == ""


def test_the_lanes_name_existing_test_files():
    """Every tests/ file a lane runs exists (a renamed file would make the
    lane fail on a path)."""
    with open(os.path.join(REPO, "scripts", "torch_ci.sh")) as f:
        text = f.read()
    files = sorted({w for w in text.replace("\\", " ").split()
                    if w.startswith("tests/test_torch_")})
    assert len(files) >= 11
    missing = [p for p in files if not os.path.isfile(os.path.join(REPO, p))]
    assert missing == []
