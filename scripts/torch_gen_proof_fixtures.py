#!/usr/bin/env python3
"""Regenerate the golden proof fixtures (tests/fixtures/*.hex) with the
PyTorch port, without JAX (the counterpart of scripts/gen_proof_fixtures.py).

    python3 scripts/torch_gen_proof_fixtures.py [--out-dir DIR]
        [--device cuda|cpu]

The recipes are the JAX package's (tests/test_proof_golden.py: RECIPES
and _prove_bytes), copied onto the port's circuit and workload modules:
the test circuit and the v1 Merkle workload (height 32, one proof,
Random(11)), the SRS of tau 0xDEADBEEF (made on the device: the same
powers as the host set-up), the prove rng Random(1), verification with
Random(2) and the port's proof serialization. tests/test_torch_gen_
fixtures.py holds the two circuits to the JAX recipes'.

Proves on TorchBackend on --device (default: the card; without one the
script exits non-zero unless --device cpu asks for the kernels' plain
versions) and writes <name>.hex into --out-dir (default tests/fixtures).

Regeneration is only legitimate when the proof system's output
intentionally changes (it should never change silently: that is the
point of the fixtures). To check the port against the fixtures instead,
write into another directory and compare the files.
"""

import argparse
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXDIR = os.path.join(REPO, "tests", "fixtures")
TAU = 0xDEADBEEF


def build_test_circuit():
    """Small circuit exercising every selector type (the JAX recipe's
    conftest.build_test_circuit)."""
    from distributed_plonk_tpu_torch.circuit import PlonkCircuit

    ckt = PlonkCircuit()
    x = ckt.create_public_variable(5)
    y = ckt.create_public_variable(11)
    s = ckt.add(x, y)
    p = ckt.mul(x, y)
    ckt.power5(s)
    lc = ckt.lc([x, y, s, p], [2, 3, 5, 7])
    d = ckt.add_constant(lc, 42)
    m = ckt.mul_constant(d, 9)
    ckt.sub(m, p)
    ckt.enforce_ecc_product(x, y, s, p, ckt.one_var, 5 * 11 * 16 * 55)
    return ckt


def build_merkle_2p13():
    """v1 workload scale: height-32 Merkle, 1 proof, n = 2^13 (reference
    src/dispatcher.rs:1064-1070)."""
    from distributed_plonk_tpu_torch.workload import generate_circuit

    ckt, _ = generate_circuit(rng=random.Random(11), height=32, num_proofs=1)
    return ckt


# fixture name -> circuit builder; main() iterates this dict
RECIPES = {
    "proof_small": build_test_circuit,
    "proof_merkle_h32_p1": build_merkle_2p13,
}


def prove_bytes(ckt, device):
    """The golden recipe on TorchBackend(device): (proof bytes, verified)."""
    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.verifier import verify

    if not ckt._finalized:
        ckt.finalize()
    srs = kzg.universal_setup_device(ckt.n + 2, tau=TAU, device=device)
    be = TorchBackend(device=device)
    pk, vk = kzg.preprocess(srs, ckt, be)
    proof = prove(random.Random(1), ckt, pk, be)
    ok = verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    return proof_io.serialize_proof(proof), ok


def write_fixture(name, out_dir, device):
    """Prove recipe `name` and write <out_dir>/<name>.hex; returns (path,
    proof bytes, domain size). Raises if the proof does not verify."""
    ckt = RECIPES[name]()
    blob, ok = prove_bytes(ckt, device)
    if not ok:
        raise RuntimeError("%s: the proof does not verify" % name)
    path = os.path.join(out_dir, name + ".hex")
    with open(path, "w") as f:
        f.write(blob.hex() + "\n")
    return path, blob, ckt.n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=FIXDIR)
    ap.add_argument("--device", default=None,
                    help="the prover's device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_gen_proof_fixtures")
    except RuntimeError as e:
        print("torch_gen_proof_fixtures: %s" % e, file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    for name in RECIPES:
        t = time.perf_counter()
        path, blob, n = write_fixture(name, args.out_dir, device)
        print("wrote %s (%d bytes, n=2^%d, on %s, %.3f s)" % (
            path, len(blob), n.bit_length() - 1, device,
            time.perf_counter() - t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
