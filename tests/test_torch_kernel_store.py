"""The kernels' packed nvcc build as a store artifact, on the CPU.

There is no nvcc here, so a fake build directory stands in: files of
random bytes under the real library and log names of this tree's hash.
What is checked is the artifact's path, not the libraries:

- a packed build publishes into a port store as `kbuild:<hash>:sm_90`,
  is served over real STORE_FETCH by a port service on that store, is
  pulled into a second store (store/remote.sync_kernel_build) and
  installs into an empty build directory byte-identical, with
  build_report saying `peer`;
- a blob that fails the store's digest check, one that is not a tar, a
  foreign capability, a foreign source hash, other nvcc flags, a size
  unlike its meta and a tar member with a path component each install
  nothing, are each counted as kernel_build_pull_errors and leave no
  entry, so a good build is published in its place;
- installs racing on one directory leave one complete directory;
- ensure_build takes its tiers in order (build directory, store, peers,
  nvcc on a thread) and publishes the loaded build into a store that
  lacks it;
- the artifact counts against the store's byte budget and is evicted;
- a JAX `warm_sync` against a port store holding `kbuild:` pulls none of
  it, and a port `warm_sync` against a JAX store ignores `jaxcache:`.
"""

import os
import threading
import time

import pytest

from distributed_plonk_tpu.service.server import \
    ProofService as JaxProofService
from distributed_plonk_tpu.store import ArtifactStore as JaxArtifactStore
from distributed_plonk_tpu.store import remote as JRS

from distributed_plonk_tpu_torch.backend import _build
from distributed_plonk_tpu_torch.runtime.supervisor import WorkerSupervisor
from distributed_plonk_tpu_torch.service import ProofService
from distributed_plonk_tpu_torch.service.metrics import Metrics
from distributed_plonk_tpu_torch.store import ArtifactStore
from distributed_plonk_tpu_torch.store import kernels
from distributed_plonk_tpu_torch.store import remote as PRS

CAP = "sm_90"


@pytest.fixture
def build_root(tmp_path, monkeypatch):
    """A scratch build root for this test: _build's directory and report
    are restored afterwards."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "unset"))
    monkeypatch.setattr(_build, "build_report", {
        "source": None, "nvcc_s": None, "install_s": None, "bytes": None,
        "dir": None, "seconds": None})
    monkeypatch.setattr(_build, "build_seconds", {})

    def use(name):
        _build.set_build_dir(str(tmp_path / name))
        return os.path.join(_build.BUILD_DIR, _build.source_hash())
    return use


def fake_build(out_dir, seed=1):
    """Random bytes under every library and log name; {name: bytes}."""
    os.makedirs(out_dir)
    rng = __import__("random").Random(seed)
    files = {}
    for n in _build.SOURCES:
        files["lib%s.so" % n] = bytes(rng.randrange(256)
                                      for _ in range(3000 + 100 * len(n)))
        files["%s.log" % n] = ("ptxas info: %s\n" % n).encode()
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    return files


def read_dir(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def count(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


def test_packed_build_travels_over_store_fetch(build_root, tmp_path):
    files = fake_build(build_root("a"))
    blob, meta = _build.pack_build(CAP)
    assert meta["source_hash"] == _build.source_hash()
    assert meta["capability"] == CAP
    assert tuple(meta["nvcc_flags"]) == _build.NVCC_FLAGS
    assert meta["files"] == {k: len(v) for k, v in files.items()}
    assert meta["bytes"] == len(blob)
    assert "nvcc_version" in meta
    assert _build.pack_build(CAP)[0] == blob      # deterministic
    store_a = ArtifactStore(str(tmp_path / "store_a"))
    pub = kernels.publish(store_a, CAP)
    key = "kbuild:%s:sm_90" % _build.source_hash()
    assert pub["key"] == key == kernels.artifact_key(CAP)
    assert pub["bytes"] == len(blob) and store_a.get(key) == blob

    svc = ProofService(port=0, device="cpu", prover_workers=1,
                       store_dir=str(tmp_path / "store_a")).start()
    try:
        out_dir = build_root("b")
        assert not _build.is_built()
        store_b = ArtifactStore(str(tmp_path / "store_b"))
        metrics = Metrics()
        assert PRS.sync_kernel_build(store_b, [("127.0.0.1", svc.port)],
                                     CAP, metrics=metrics) is True
    finally:
        svc.shutdown()
    assert store_b.get(key) == blob and store_b.meta(key) == meta
    assert read_dir(out_dir) == files
    assert _build.is_built()
    report = _build.report()
    assert report["source"] == "peer" and report["bytes"] == len(blob)
    assert report["nvcc_s"] is None and report["dir"] == out_dir
    assert count(metrics, "kernel_build_pull_errors") == 0
    # no peer holds another card's build: a miss, not an error
    assert PRS.sync_kernel_build(store_b, [], "sm_80") is False


def _garble_on_disk(store, key, blob, meta):
    with open(store.object_path(key), "r+b") as f:
        f.seek(100)
        f.write(b"\xff" * 8)


def _put(blob=None, **meta_changes):
    def plant(store, key, blob_, meta):
        m = dict(meta, **meta_changes)
        store.put(key, blob if blob is not None else blob_, meta=m)
    return plant


def _tar_with(name):
    """A plant that adds a member `name` to a valid packed build."""
    def plant(store, key, blob, meta):
        import io
        import tarfile
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:") as src:
            members = [(m, src.extractfile(m).read())
                       for m in src.getmembers()]
        out = io.BytesIO()
        with tarfile.open(fileobj=out, mode="w") as tar:
            for m, data in members:
                tar.addfile(m, io.BytesIO(data))
            info = tarfile.TarInfo(name)
            info.size = 4
            tar.addfile(info, io.BytesIO(b"evil"))
        files = dict(meta["files"], **{name: 4})
        store.put(key, out.getvalue(), meta=dict(meta, files=files))
    return plant


@pytest.mark.parametrize("case,plant", [
    ("garbled on disk", _garble_on_disk),
    ("not a tar", _put(blob=b"\x00garbled" * 512)),
    ("foreign capability", _put(capability="sm_80")),
    ("foreign hash", _put(source_hash="0123456789abcdef")),
    ("foreign flags", _put(nvcc_flags=["-O0"])),
    ("size unlike its meta", _put(bytes=1)),
    ("path component", _tar_with("../libfield.so")),
    ("subdirectory", _tar_with("sub/libntt.so")),
])
def test_refused_artifacts_install_nothing(build_root, tmp_path, case,
                                           plant):
    fake_build(build_root("a"))
    blob, meta = _build.pack_build(CAP)
    store = ArtifactStore(str(tmp_path / "store"))
    key = kernels.artifact_key(CAP)
    store.put(key, blob, meta=meta)
    plant(store, key, blob, meta)
    out_dir = build_root("b")
    metrics = Metrics()
    assert kernels.install_from_store(store, CAP, metrics=metrics) is None
    assert not os.path.exists(out_dir)
    assert not os.path.exists(_build.BUILD_DIR)
    assert count(metrics, "kernel_build_pull_errors") == 1, case
    assert _build.report()["source"] is None
    # the refused entry is gone: no peer is offered it, and the build this
    # process then makes (the nvcc tier's publish) lands in its place
    assert store.meta(key) is None and key not in store.keys()
    files = fake_build(out_dir, seed=2)
    pub = kernels.publish_if_missing(store, CAP)
    assert pub["publish_s"] is not None, pub
    assert store.get(key) == _build.pack_build(CAP)[0]
    assert _build.install_build(store.get(key), store.meta(key), CAP)
    assert read_dir(out_dir) == files


def test_racing_installs_leave_one_complete_directory(build_root):
    files = fake_build(build_root("a"))
    blob, meta = _build.pack_build(CAP)
    out_dir = build_root("b")
    go = threading.Barrier(8)
    errors = []

    def install():
        go.wait()
        try:
            _build.install_build(blob, meta, CAP)
        except Exception as e:  # noqa: BLE001 - collected, asserted below
            errors.append(e)
    threads = [threading.Thread(target=install) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert read_dir(out_dir) == files
    # nothing but the directory and its lock file
    assert sorted(os.listdir(_build.BUILD_DIR)) == sorted(
        [os.path.basename(out_dir), os.path.basename(out_dir) + ".lock"])


def test_ensure_build_takes_its_tiers_in_order(build_root, tmp_path,
                                               monkeypatch):
    loads = []
    monkeypatch.setattr(kernels, "capability", lambda device=None: CAP)
    monkeypatch.setattr(_build, "load", lambda: loads.append(
        _build.is_built()))
    files = fake_build(build_root("a"))
    store_a = ArtifactStore(str(tmp_path / "store_a"))
    # 1. the build directory, published into a store that lacks it
    rep = kernels.ensure_build(store_a)
    assert rep["source"] == "local" and rep["seconds"] >= 0, rep
    assert store_a.meta(kernels.artifact_key(CAP)) is not None
    assert kernels.publish_if_missing(store_a, CAP)["publish_s"] is None
    # 2. the store (the report is this process's: reset it between tiers)
    build_root("b")
    _build.build_report["source"] = None
    rep = kernels.ensure_build(store_a)
    assert rep["source"] == "store" and rep["install_s"] is not None, rep
    # 3. a peer, fetched into the worker's own store
    svc = ProofService(port=0, device="cpu", prover_workers=1,
                       store_dir=str(tmp_path / "store_a")).start()
    try:
        build_root("c")
        store_c = ArtifactStore(str(tmp_path / "store_c"))
        rep = kernels.ensure_build(store_c, [("127.0.0.1", svc.port)])
        assert rep["source"] == "peer" and _build.report() == rep, rep
        assert store_c.meta(kernels.artifact_key(CAP)) is not None
    finally:
        svc.shutdown()
    # 4. nvcc, then published into the store
    out_d = build_root("d")
    store_d = ArtifactStore(str(tmp_path / "store_d"))

    def nvcc():
        os.makedirs(out_d)
        for name, data in files.items():
            with open(os.path.join(out_d, name), "wb") as f:
                f.write(data)
        loads.append("nvcc")
    monkeypatch.setattr(_build, "load", nvcc)
    _build.build_report["source"] = None
    assert kernels.ensure_build(store_d, [("127.0.0.1", 1)])["source"] == \
        "nvcc"
    deadline = time.monotonic() + 30        # nvcc runs on a thread
    while store_d.meta(kernels.artifact_key(CAP)) is None:
        assert time.monotonic() < deadline, "the nvcc tier's publish"
        time.sleep(0.01)
    assert store_d.get(kernels.artifact_key(CAP)) == \
        store_a.get(kernels.artifact_key(CAP))
    assert loads == [True, True, True, "nvcc"]


def test_the_artifact_counts_against_the_byte_budget(build_root, tmp_path):
    fake_build(build_root("a"))
    store = ArtifactStore(str(tmp_path / "store"), byte_budget=40000)
    key = kernels.publish(store, CAP)["key"]
    assert store.stats()["bytes"] > 0
    store.put("bucket:other", b"x" * 30000)
    assert store.meta(key) is None and store.keys() == ["bucket:other"]


def test_a_served_store_lists_what_another_process_wrote(tmp_path):
    """A worker's store instance lists (STORE_LIST) the artifacts an
    offline warmup wrote into the same directory after it opened."""
    serving = ArtifactStore(str(tmp_path / "s"))
    ArtifactStore(str(tmp_path / "s")).put("kbuild:x:sm_90", b"late")
    assert serving.keys() == ["kbuild:x:sm_90"]


def test_set_build_dir_after_load_raises(build_root, monkeypatch):
    build_root("a")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="after the kernels loaded"):
        _build.set_build_dir("/elsewhere")


def test_worker_command_line_carries_the_build_dir(monkeypatch):
    sup = WorkerSupervisor("127.0.0.1", 4321, n=2, device="cpu",
                           store_dirs=["/s0"], build_dirs=["/b0"])
    cmd = sup.worker_cmd(0, sup.slots[0])
    assert cmd[-4:] == ["--store", "/s0", "--build-dir", "/b0"]
    assert "--build-dir" not in sup.worker_cmd(1, sup.slots[1])
    monkeypatch.setattr(sup, "_spawn", lambda i: None)     # no process
    j = sup.add_slot(store_dir="/s2", build_dir="/b2")
    assert sup.slots[j].build_dir == "/b2"
    assert sup.worker_cmd(j, sup.slots[j])[-2:] == ["--build-dir", "/b2"]


def test_jax_warm_sync_skips_the_kernel_build(build_root, tmp_path):
    fake_build(build_root("a"))
    port_dir = str(tmp_path / "port_store")
    kernels.publish(ArtifactStore(port_dir), CAP)
    ArtifactStore(port_dir).put("bucket:toy", b"keys", meta={"n": 1})
    svc = ProofService(port=0, device="cpu", prover_workers=1,
                       store_dir=port_dir).start()
    try:
        jstore = JaxArtifactStore(str(tmp_path / "jax_store"))
        stats = JRS.warm_sync(jstore, [("127.0.0.1", svc.port)])
    finally:
        svc.shutdown()
    assert stats["artifacts"] == 1 and stats["errors"] == 0, stats
    assert jstore.keys() == ["bucket:toy"]


def test_port_warm_sync_skips_the_jax_compile_cache(tmp_path):
    jax_dir = str(tmp_path / "jax_store")
    jstore = JaxArtifactStore(jax_dir)
    jstore.put("bucket:toy", b"keys")
    jstore.jax_cache_write("fp0/entry-1", b"compiled")
    svc = JaxProofService(port=0, store_dir=jax_dir).start()
    try:
        assert any(k.startswith("jaxcache:") for k in PRS.list_keys(
            "127.0.0.1", svc.port))
        store = ArtifactStore(str(tmp_path / "port_store"))
        stats = PRS.warm_sync(store, [("127.0.0.1", svc.port)])
    finally:
        svc.shutdown()
    assert stats["artifacts"] == 1 and stats["errors"] == 0, stats
    assert store.keys() == ["bucket:toy"]
