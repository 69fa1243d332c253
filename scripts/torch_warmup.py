#!/usr/bin/env python3
"""Pre-warm the PyTorch port's proof-service shape buckets (keys, prover
stages and the kernel build): the counterpart of scripts/warmup.py.

Two modes:

  # against a running port service (WARMUP wire tag; --aot also builds
  # the prover stages on the server's backend):
  python3 scripts/torch_warmup.py --host 127.0.0.1 --port 9555 \\
      --spec '{"kind":"toy","gates":16}' --spec '{"kind":"toy","gates":60}'

  # offline store provisioning, no server: build keys straight into the
  # artifact store a later `python -m distributed_plonk_tpu_torch.service
  # --store-dir` or worker `--store` reads
  python3 scripts/torch_warmup.py --store-dir /var/dpt/store \\
      --spec '{"kind":"merkle","height":32,"num_proofs":1}' [--aot]

Offline, keys build on --device (default: the card; the script exits
non-zero without one unless --device cpu asks for the plain versions).
--aot builds each shape's prover stages on a local TorchBackend and, on
the card, publishes this process's kernel build into the store as its
`kbuild:<hash>:sm_<cc>` artifact (store/kernels.py): a worker or service
provisioned from that store, or pulling from one serving it, loads the
kernels without running nvcc.

With no --spec, warms the default loadgen mix (toy gates 16/60/150/300).
Prints one JSON line: per-shape source (memory|disk|built) and timings,
and offline the store's kernel build artifact (null when it has none).
Exit 0 iff every shape warmed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DEFAULT_MIX = [{"kind": "toy", "gates": g} for g in (16, 60, 150, 300)]


def kernel_build_entry(store, device):
    """{key, bytes} of the store's kernel build for this card, or None
    (on the CPU there is none)."""
    if device.type != "cuda":
        return None
    from distributed_plonk_tpu_torch.store import kernels
    key = kernels.artifact_key(kernels.capability(device))
    meta = store.meta(key)
    return None if meta is None else {"key": key, "bytes": meta["bytes"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--host", default=None,
                    help="warm a running server over the wire")
    ap.add_argument("--port", type=int, default=9555)
    ap.add_argument("--store-dir", default=None,
                    help="offline mode: provision this artifact store "
                         "directly, no server involved")
    ap.add_argument("--spec", action="append", default=[],
                    help="job spec JSON (repeatable); default: loadgen mix")
    ap.add_argument("--aot", action="store_true",
                    help="also build the prover stages (wire mode: on the "
                         "server's backend; offline: on a local "
                         "TorchBackend, and publish the kernel build)")
    ap.add_argument("--device", default=None,
                    help="offline mode: where keys and stages build (cuda, "
                         "the default, or cpu)")
    args = ap.parse_args(argv)
    if (args.host is None) == (args.store_dir is None):
        ap.error("exactly one of --host or --store-dir is required")

    specs = [json.loads(s) for s in args.spec] or list(DEFAULT_MIX)
    shapes, ok = [], True
    t0 = time.time()
    out = {}

    if args.host is not None:
        from distributed_plonk_tpu_torch.service import ServiceClient
        with ServiceClient(args.host, args.port) as c:
            for spec in specs:
                try:
                    shapes.append(c.warmup(spec, aot=args.aot))
                except Exception as e:  # noqa: BLE001 - report per shape
                    ok = False
                    shapes.append({"spec": spec, "error": repr(e)})
    else:
        from distributed_plonk_tpu_torch.backend.field_torch import \
            resolve_device
        from distributed_plonk_tpu_torch.store import ArtifactStore, warm_spec
        try:
            device = resolve_device(args.device, "torch_warmup")
        except RuntimeError as e:
            print(json.dumps({"ok": False, "error": str(e)}), flush=True)
            return 1
        store = ArtifactStore(args.store_dir)
        aot_backend = None
        if args.aot:
            from distributed_plonk_tpu_torch.backend.torch_backend import \
                TorchBackend
            aot_backend = TorchBackend(device)
        for spec in specs:
            try:
                shapes.append(warm_spec(store, spec, device=device,
                                        aot_backend=aot_backend))
            except Exception as e:  # noqa: BLE001 - report per shape
                ok = False
                shapes.append({"spec": spec, "error": repr(e)})
        out = {"device": str(device),
               "kernel_build": kernel_build_entry(store, device)}
        if args.aot and device.type == "cuda":
            from distributed_plonk_tpu_torch.backend import _build
            out["build"] = _build.report()
            ok = ok and out["kernel_build"] is not None

    print(json.dumps(dict({"ok": ok, "wall_s": round(time.time() - t0, 3),
                           "shapes": shapes}, **out)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
