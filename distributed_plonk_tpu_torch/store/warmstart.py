"""Warm-start layer: shape warmup ahead of the first job (a copy of the JAX
package's store/warmstart.py; its JAX compile cache under the store
becomes the kernels' packed nvcc build, store/kernels.py).

Two cold-start costs dominate serving a new circuit shape: trusted-setup
and key construction, and the first build of the prover's stages. The
artifact store (artifacts.py + keycache.py) removes the first across
restarts; `aot_warmup` pays the second before any job arrives, through
the backend's `warm_stages` (on TorchBackend: the kernels' nvcc build,
the NttPlans at the shape's two domain sizes, round 3's tables and the
window-shifted commit key). With an AOT backend on the card, `warm_spec`
then publishes this process's kernel build into the store as its
`kbuild:` artifact, where the JAX package re-bounds its compile cache:
a worker or service provisioned from that store loads the kernels
without running nvcc.
"""

import time

from . import keycache


def aot_warmup(backend, domain_size, ck=None):
    """Build the prover stages for one shape's domain on a backend that
    supports it (TorchBackend.warm_stages); the host oracle has no build
    step, so it reports `unsupported` and costs nothing."""
    if backend is None or not hasattr(backend, "warm_stages"):
        return {"aot": "unsupported",
                "backend": getattr(backend, "name", None)}
    t0 = time.monotonic()
    report = backend.warm_stages(domain_size, ck=ck)
    report["aot"] = "ok"
    report["aot_s"] = round(time.monotonic() - t0, 3)
    return report


def warm_spec(store, spec_obj, device=None, aot_backend=None):
    """Offline store provisioning: make sure `store` holds the bucket keys
    for one wire spec, building them on `device` (None: the card) only on
    a disk miss; `aot_backend` additionally builds the shape's prover
    stages and, on the card, publishes the kernel build into `store`
    (`kernel_build`: the artifact's key and bytes; kept when the store
    already holds it). Returns a summary dict ({source: disk|built})."""
    from ..service import jobs as J

    spec = J.JobSpec.from_wire(spec_obj)
    key = J.shape_key(spec)
    t0 = time.monotonic()
    hit = keycache.load_bucket(store, key)
    if hit is not None:
        _srs, pk, vk, meta = hit
        out = {"shape_key": [str(p) for p in key], "source": "disk",
               "domain_size": vk.domain_size,
               "load_s": round(time.monotonic() - t0, 6),
               "build_s": meta.get("build_s")}
    else:
        srs, pk, vk = J.build_bucket_keys(spec, device=device)
        build_s = time.monotonic() - t0
        keycache.store_bucket(store, key, srs, pk, vk, build_s=build_s)
        out = {"shape_key": [str(p) for p in key], "source": "built",
               "domain_size": vk.domain_size, "build_s": round(build_s, 6)}
    if aot_backend is not None:
        out["aot"] = aot_warmup(aot_backend, vk.domain_size, ck=pk.ck)
        dev = getattr(aot_backend, "device", None)
        if getattr(dev, "type", None) == "cuda":
            from . import kernels
            out["kernel_build"] = kernels.publish_if_missing(
                store, kernels.capability(dev))
    return out
