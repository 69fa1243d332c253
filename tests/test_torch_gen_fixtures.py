"""scripts/torch_gen_proof_fixtures.py, the fixture regenerator that runs
without JAX (the counterpart of scripts/gen_proof_fixtures.py):

- its two recipe circuits, built on the port's circuit and workload
  modules, equal the JAX recipes' (tests/test_proof_golden.py RECIPES),
  finalized, as integers: the domain size, the 13 selectors, the five
  wires' values, the five sigmas and the public input;
- `proof_small`, proved on the CPU by the script's own code into a
  temporary directory, is byte-identical to tests/fixtures/proof_small.hex
  (the v1 fixture is regenerated on the card: its plain CPU prove takes
  minutes).
"""

import importlib.util
import os

import pytest
import torch

from test_proof_golden import RECIPES as JAX_RECIPES

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FIXDIR = os.path.join(REPO, "tests", "fixtures")

torch.set_num_threads(1)


def load_script():
    spec = importlib.util.spec_from_file_location(
        "torch_gen_proof_fixtures",
        os.path.join(REPO, "scripts", "torch_gen_proof_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = load_script()


def as_ints(ckt):
    if not ckt._finalized:
        ckt.finalize()
    return {
        "n": ckt.n,
        "selectors": [[int(v) for v in s] for s in ckt.selectors],
        "wires": [[int(v) for v in ckt.wire_values(i)] for i in range(5)],
        "sigmas": [[int(v) for v in s] for s in ckt.sigma_values()],
        "public_input": [int(v) for v in ckt.public_input()],
    }


@pytest.mark.parametrize("name", sorted(JAX_RECIPES))
def test_recipe_circuits_equal_the_jax_recipes(name):
    assert sorted(GEN.RECIPES) == sorted(JAX_RECIPES)
    port, ref = as_ints(GEN.RECIPES[name]()), as_ints(JAX_RECIPES[name]())
    for key in ref:
        assert port[key] == ref[key], (name, key)


def test_proof_small_regenerates_byte_identical(tmp_path):
    path, blob, n = GEN.write_fixture("proof_small", str(tmp_path), "cpu")
    assert path == str(tmp_path / "proof_small.hex") and n == 16
    with open(os.path.join(FIXDIR, "proof_small.hex")) as f:
        want = f.read()
    with open(path) as f:
        assert f.read() == want
    assert blob.hex() == want.strip()
