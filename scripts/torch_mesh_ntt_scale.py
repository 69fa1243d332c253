#!/usr/bin/env python3
"""Run the v2 workload's quotient-domain NTT on the PyTorch port's mesh,
on sharded handles: the counterpart of scripts/mesh_ntt_scale.py.

The reference's v2 run needs a 2^21-point FFT (50 proofs -> a 2^18
domain, an 8n quotient domain; reference src/dispatcher2.rs:246,
:1219-1221). This script lays a seeded 2^log2n-lane polynomial out in
lane shards over a mesh of --shards shards (parallel/sharded.py), runs
the forward coset NTT and then the inverse through MeshBackend (lane
blocks in, lane blocks out: the mesh NTT's three tile exchanges, no
whole tensor), asserts that the round trip is exact and that the forward
output equals the port's pure-Python poly.coset_fft oracle
(--skip-oracle skips it: minutes at 2^21), and prints one JSON line.

    python3 scripts/torch_mesh_ntt_scale.py [--log2n 21] [--shards 4] \\
        [--device cpu] [--skip-oracle] [--out FILE]

The mesh runs on the card (every shard on the visible cards, dealt round
robin; the script exits non-zero without one) unless --device names a
device: "cpu" runs every shard on the CPU's plain kernels. The input's
words come from torch.Generator(SEED), each value below 2^254 < r.
Exit 0 iff every check passed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 0x2221


def seeded_words(n, seed, device):
    """(8, n) canonical Fr words from torch.Generator(seed): random 32-bit
    words, the top one cut to 30 bits, so every value is below r."""
    import torch
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (8, n), generator=g,
                      dtype=torch.int64)
    w[7] &= (1 << 30) - 1
    return w.to(torch.int32).to(device)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_ntt_scale(log2n=21, shards=4, device=None, skip_oracle=False):
    """The run: (result dict, the input handle, the forward output
    handle, the MeshBackend), both handles Sharded over the mesh. Raises
    on a failed check."""
    import torch
    from distributed_plonk_tpu_torch import poly
    from distributed_plonk_tpu_torch.backend.limbs import lower
    from distributed_plonk_tpu_torch.parallel import sharded as S
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend

    n = 1 << log2n
    mesh = make_mesh(shards, device)
    lead = mesh.lead
    res = {"log2n": log2n, "shards": shards, "device": str(lead),
           "platform": "gpu" if lead.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(lead)
           if lead.type == "cuda" else "cpu"}
    # min_local 1: the handle shards at any size the mesh NTT splits
    be = MeshBackend(mesh, min_local=1)
    domain = poly.Domain(n)
    t = time.perf_counter()
    h = S.shard(mesh, seeded_words(n, SEED, lead), n // mesh.size)
    sync(lead)
    res["input_s"] = time.perf_counter() - t

    t = time.perf_counter()
    ev, = be.coset_fft_many(domain, [h])
    sync(lead)
    res["fwd_cold_s"] = time.perf_counter() - t
    t = time.perf_counter()
    back = be.coset_ifft_h(domain, ev)
    sync(lead)
    res["inv_cold_s"] = time.perf_counter() - t
    for name, x in (("forward", ev), ("inverse", back)):
        if not isinstance(x, S.Sharded) or x.block != n // mesh.size:
            raise AssertionError("the %s output is not in lane shards: %r"
                                 % (name, x))
    if not all(torch.equal(a, b) for a, b in zip(back.pieces, h.pieces)):
        raise AssertionError("coset NTT round trip not exact")
    res["roundtrip_exact"] = True

    t = time.perf_counter()
    ev2, = be.coset_fft_many(domain, [h])
    sync(lead)
    dt = time.perf_counter() - t
    res["fwd_warm_s"] = dt
    res["elements_per_s"] = n / dt
    if not all(torch.equal(a, b) for a, b in zip(ev.pieces, ev2.pieces)):
        raise AssertionError("two forward runs differ")
    res["shard_bytes"] = {str(s): b for s, b in ev.shard_bytes().items()}
    res["mesh_ntt_calls"] = {str(k): v for k, v in be.mesh_ntt_calls.items()}
    if not skip_oracle:
        coeffs = lower(S.gather(h))
        t = time.perf_counter()
        want = poly.coset_fft(domain, coeffs)
        res["oracle_s"] = time.perf_counter() - t
        if lower(S.gather(ev)) != want:
            raise AssertionError("mesh coset NTT differs from poly.coset_fft")
        res["oracle_match"] = True
    return res, h, ev, be


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=21)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="every shard on this device (cpu: the plain "
                         "kernels); default: the visible cards")
    ap.add_argument("--skip-oracle", action="store_true",
                    help="round trip only (the pure-Python oracle takes "
                         "minutes at 2^21)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res, _, _, _ = mesh_ntt_scale(args.log2n, args.shards, args.device,
                                  args.skip_oracle)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
