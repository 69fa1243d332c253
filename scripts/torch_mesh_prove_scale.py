#!/usr/bin/env python3
"""Prove the reference's v1 workload on the PyTorch port's MeshBackend,
its handles in lane shards: the counterpart of scripts/mesh_prove_scale.py.

The reference's v1 run (a height-32 Merkle membership proof, one proof,
a 2^13 domain) is preprocessed and proved on MeshBackend over --shards
shards: sharded handles through all five rounds, the 4-step mesh NTT on
lane blocks, the range-sharded MSM. The proof is held field by field to
the PythonBackend proof of the same keys and rng (--skip-oracle skips
that: minutes at 2^13), and to --fixture's bytes when given, and must
verify. The circuit comes from workload.generate_circuit(Random(11),
--height, --proofs), or, with --toy-gates G, the service's toy circuit
of G gates (G = 10: the conftest circuit's n = 16); the keys from the
device SRS (tau 0xDEADBEEF), the proof from prove rng Random(1): the
recipe of tests/fixtures/proof_merkle_h32_p1.hex.

Residency check: `quotient` is hooked, as the JAX script hooks it. At
round 3's quotient each shard's live bytes are read from the Sharded
handles there (the 25 coset planes; a whole handle counts to the lead's
shard), with torch.cuda.memory_allocated beside them on the card, and
held to memory_plan.round3_mesh_plan's per-shard resident figure within
1.5x + --slack-mib (64 MiB, as in JAX; --plan-scale scales the plan). A
violation exits non-zero after the numbers are written.

    python3 scripts/torch_mesh_prove_scale.py [--height 32] [--proofs 1] \\
        [--shards 4] [--device cpu] [--skip-oracle] [--out FILE] \\
        [--toy-gates G] [--min-local L] [--fixture FILE]

The mesh runs on the card unless --device names a device ("cpu": the
plain kernels). One JSON line; exit 0 iff every check passed.
"""

import argparse
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PROOF_FIELDS = ("wires_poly_comms", "prod_perm_poly_comm",
                "split_quot_poly_comms", "opening_proof",
                "shifted_opening_proof", "wires_evals", "wire_sigma_evals",
                "perm_next_eval")
SLACK_MIB = 64


def build_circuit(height=32, proofs=1, toy_gates=None):
    """The workload's circuit (finalized)."""
    if toy_gates is not None:
        from distributed_plonk_tpu_torch.service.jobs import _toy_circuit
        return _toy_circuit(toy_gates, 0).finalize()
    from distributed_plonk_tpu_torch.workload import generate_circuit
    ckt, _ = generate_circuit(rng=random.Random(11), height=height,
                              num_proofs=proofs)
    return ckt


def mesh_prove_scale(ckt, shards=4, device=None, skip_oracle=False,
                     fixture=None, min_local=None, plan_scale=1.0,
                     slack_mib=SLACK_MIB):
    """Preprocess and prove ckt on MeshBackend -> the result dict (its
    "residency" holds the check's verdict, "within_plan"). Raises on a
    proof that differs from the oracle or the fixture or fails to
    verify."""
    import torch
    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.backend.python_backend import \
        PythonBackend
    from distributed_plonk_tpu_torch.circuit import NUM_WIRE_TYPES
    from distributed_plonk_tpu_torch.parallel import memory_plan
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend
    from distributed_plonk_tpu_torch.parallel.sharded import Sharded
    from distributed_plonk_tpu_torch.poly import Domain
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify

    mesh = make_mesh(shards, device)
    lead = mesh.lead
    on_card = lead.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(lead)

    n = ckt.n
    m = Domain((NUM_WIRE_TYPES + 1) * (n + 1) + 1).size
    res = {"n": n, "log2_n": n.bit_length() - 1, "m": m, "shards": shards,
           "device": str(lead), "platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(lead) if on_card else "cpu"}
    be = MeshBackend(mesh) if min_local is None \
        else MeshBackend(mesh, min_local=min_local)
    res["min_local"] = be.min_local
    t = time.perf_counter()
    srs = kzg.universal_setup_device(n + 2, tau=0xDEADBEEF, device=lead)
    sync()
    res["setup_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pk, vk = kzg.preprocess(srs, ckt, be)
    sync()
    res["preprocess_s"] = time.perf_counter() - t

    snap = {}
    quotient = be.quotient

    def spy(*args):
        # a whole handle lives on the lead: its bytes count to the lead's
        # shard
        per = {s: 0 for s, _ in mesh.shards()}
        for a in args:
            for h in (a if isinstance(a, list) else [a]):
                if isinstance(h, Sharded):
                    for s, b in h.shard_bytes().items():
                        per[s] += b
                elif isinstance(h, torch.Tensor):
                    per[mesh.first] += h.numel() * h.element_size()
        snap["per_shard"] = per
        if on_card:
            snap["allocated"] = torch.cuda.memory_allocated(lead)
        return quotient(*args)
    be.quotient = spy

    tr = Tracer()
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
    sync()
    res["prove_s"] = time.perf_counter() - t
    res["rounds"] = tr.totals(0)
    res["sharded_handles"] = {str(k): v for k, v in
                              be.sharded_handles.items()}
    res["replicated_handles"] = {str(k): v for k, v in
                                 be.replicated_handles.items()}
    res["mesh_ntt_calls"] = {str(k): v for k, v in be.mesh_ntt_calls.items()}
    res["mesh_msm_calls"] = be.mesh_msm_calls

    plan = memory_plan.round3_mesh_plan(n, m, mesh.size,
                                        n_processes=mesh.world)
    limit = plan["resident"] * plan_scale * 1.5 + slack_mib * (1 << 20)
    worst = max(snap.get("per_shard", {}).values(), default=0)
    res["residency"] = {
        "plan_resident_per_shard": plan["resident"],
        "plan_parts": {k: plan[k] for k in ("planes", "stacks", "tables",
                                            "base", "ntt", "shard",
                                            "per_process")},
        "plan_scale": plan_scale, "slack_mib": slack_mib,
        "actual_per_shard": {str(s): b for s, b in
                             sorted(snap.get("per_shard", {}).items())},
        "actual_max_per_shard": worst,
        "memory_allocated": snap.get("allocated"),
        "within_plan": bool(snap) and worst <= limit}

    res["verified"] = bool(verify(vk, ckt.public_input(), proof,
                                  rng=random.Random(2)))
    if not res["verified"]:
        raise AssertionError("mesh proof did not verify")
    blob = proof_io.serialize_proof(proof)
    if fixture is not None:
        with open(fixture) as f:
            if blob != bytes.fromhex(f.read().strip()):
                raise AssertionError("mesh proof differs from %s" % fixture)
        res["fixture_match"] = True
    if not skip_oracle:
        t = time.perf_counter()
        host = prove(random.Random(1), ckt, pk, PythonBackend())
        res["prove_oracle_s"] = time.perf_counter() - t
        for f in PROOF_FIELDS:
            if getattr(proof, f) != getattr(host, f):
                raise AssertionError("mesh proof differs from the "
                                     "PythonBackend proof at %s" % f)
        res["oracle_bit_identical"] = True
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--proofs", type=int, default=1)
    ap.add_argument("--toy-gates", type=int, default=None,
                    help="prove the service's toy circuit of this many "
                         "gates instead of the Merkle workload")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="every shard on this device (cpu: the plain "
                         "kernels); default: the visible cards")
    ap.add_argument("--min-local", type=int, default=None,
                    help="MeshBackend's min_local (default its own, 1024)")
    ap.add_argument("--skip-oracle", action="store_true",
                    help="skip the PythonBackend prove and field compare")
    ap.add_argument("--fixture", default=None,
                    help="hex proof file the proof must equal")
    ap.add_argument("--plan-scale", type=float, default=1.0)
    ap.add_argument("--slack-mib", type=float, default=SLACK_MIB)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ckt = build_circuit(args.height, args.proofs, args.toy_gates)
    res = mesh_prove_scale(ckt, args.shards, args.device, args.skip_oracle,
                           args.fixture, args.min_local, args.plan_scale,
                           args.slack_mib)
    res.update(height=args.height, num_proofs=args.proofs,
               toy_gates=args.toy_gates)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not res["residency"]["within_plan"]:
        print("per-shard residency %d B exceeds round 3's plan %d B x %g x "
              "1.5 + %g MiB" % (res["residency"]["actual_max_per_shard"],
                                res["residency"]["plan_resident_per_shard"],
                                args.plan_scale, args.slack_mib),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
