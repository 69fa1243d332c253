"""The port's kernel work model, its utilisation gauges and its profiler
hooks, on the CPU (the plain versions), exact throughout.

- The work model: a prove of the test circuit records the same kernel
  stages with a `flops` attribute as the JAX prover does for the same
  circuit (the stage is the last segment of the span name, what
  Metrics.observe_kernels keys on), and each count is the port's IMAD
  model: an NTT of n points (n / 2) log2 n Fr products of
  FR_MUL_IMADS = 2 (2 * 8^2 + 8) = 272 IMADs; an MSM of p points
  p * 37 * 11 mixed-add Fq products plus (64 * (ceil(ceil(37p / 64) / 32)
  - 1) + 135) full adds of 12, each Fq product FQ_MUL_IMADS =
  2 (2 * 12^2 + 12) = 600 IMADs.
- observe_kernels with a planted peak publishes the exact gauges; without
  one, on the CPU, it publishes the gflops gauge only.
- The autoscaler's mfu_pct sensor reads the mean of the mfu_* gauges, and
  None before any exists.
- Profiles: the stack sampler, a torch.profiler capture of CPU activity,
  a refused concurrent torch capture, and a torch capture that fails
  falling back to the sampler with its meta saying so; trace.profile_to
  and a Tracer that annotates its spans.
"""

import json
import os
import random
import threading

import pytest
import torch

from distributed_plonk_tpu.backend.python_backend import \
    PythonBackend as JaxPythonBackend
from distributed_plonk_tpu.prover import prove as jax_prove
from distributed_plonk_tpu.trace import Tracer as JaxTracer
from distributed_plonk_tpu_torch import trace as T
from distributed_plonk_tpu_torch.obs import profiling
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.service import autoscale as AS
from distributed_plonk_tpu_torch.service.metrics import Metrics, device_peak
from distributed_plonk_tpu_torch.trace import Tracer

from test_torch_prove import port_keys

torch.set_num_threads(1)


def _stage(span):
    return span.rsplit("/", 1)[-1]


def _work(events):
    """{stage: (flops, data_bytes)} of the events carrying a work model."""
    return {_stage(ev["span"]): (ev["flops"], ev.get("data_bytes"))
            for ev in events if ev.get("flops")}


def test_ntt_and_msm_models_are_the_imad_counts():
    assert T.FR_MUL_IMADS == 272 and T.FQ_MUL_IMADS == 600
    assert T.ntt_flops(1 << 16) == (1 << 15) * 16 * 272
    assert T.ntt_flops(8, 3) == 3 * 4 * 3 * 272
    assert T.ntt_flops(1) == 0
    for p in (18, 8195, 262147):
        per_bucket = -(-37 * p // 64)
        tree = 64 * (-(-per_bucket // 32) - 1)
        want = (p * 37 * 11 + (tree + 135) * 12) * 600
        assert T.msm_flops(p) == want
        assert T.msm_flops(p, 5) == 5 * want


@pytest.fixture(scope="module")
def jax_stages(proven):
    """The stages the JAX prover records a work model on for the test
    circuit (PythonBackend)."""
    jckt, jpk, _, _ = proven
    jtr = JaxTracer()
    jax_prove(random.Random(1), jckt, jpk, JaxPythonBackend(), tracer=jtr)
    return set(_work(jtr.events))


@pytest.mark.parametrize("streamed", [False, True, "fused"])
def test_prove_records_the_jax_stages_with_the_port_model(jax_stages,
                                                          streamed):
    """streamed False: the one-shot round 3 (both hooks None); True: the
    streamed round 3 (quotient_poly_streamed None); "fused": the default,
    held to JAX's quotient_stream_fused work (the coset iNTT inside)."""
    ckt, be, pk, _ = port_keys()
    tr = Tracer()
    hooks = {False: ("quotient_poly_streamed", "quotient_streamed"),
             True: ("quotient_poly_streamed",), "fused": ()}[streamed]
    for hook in hooks:
        setattr(be, hook, None)
    try:
        prove(random.Random(1), ckt, pk, be, tracer=tr)
    finally:
        for hook in hooks:
            be.__dict__.pop(hook, None)
    got = _work(tr.events)
    n, m, nw = ckt.n, 8 * ckt.n, 5
    polys = 13 + 2 * nw + 2          # selectors, sigmas, wires, z, pi
    if streamed is True:
        # the port's streamed round 3 is the JAX package's quotient_stream
        jax_stages = (jax_stages - {"coset_ffts"}) | {"quotient_stream"}
    elif streamed == "fused":
        # and its fused one JAX's quotient_stream_fused (prover.py:332-338)
        jax_stages = ((jax_stages - {"coset_ffts", "coset_ifft_quot"})
                      | {"quotient_stream_fused"})
    assert set(got) == jax_stages
    r3 = {False: {"coset_ffts": (T.ntt_flops(m, polys), polys * m * 32)},
          True: {"quotient_stream": (T.ntt_flops(m, polys),
                                     polys * m * 32)},
          "fused": {"quotient_stream_fused": (T.ntt_flops(m, polys + 1),
                                              polys * m * 32)}}[streamed]
    if streamed != "fused":
        r3["coset_ifft_quot"] = (T.ntt_flops(m), m * 32)
    want = {
        "ifft_wires": (T.ntt_flops(n, nw), nw * n * 32),
        "ifft_perm": (T.ntt_flops(n), n * 32),
        **r3,
        "commit_wires": (T.msm_flops(n + 2, nw), nw * (n + 2) * 32),
        "commit_perm": (T.msm_flops(n + 3), (n + 3) * 32),
        "commit_quot": (T.msm_flops(n + 2, nw), nw * (n + 2) * 32),
        "commit_open": (T.msm_flops(n + 2, 2), 2 * (n + 2) * 32),
    }
    assert got == want
    # the commits' model rides their forced kernels/ events, one level
    # under the round, not the dispatch spans
    commits = [ev for ev in tr.events if _stage(ev["span"]).startswith(
        "commit_") and ev.get("flops")]
    assert all(ev["span"].startswith("kernels/") and ev["depth"] == 1
               for ev in commits)
    assert set(tr.totals(0)) == {"round%d" % i for i in range(1, 6)}


def test_observe_kernels_publishes_exact_gauges():
    events = [{"span": "kernels/commit_wires", "flops": 6e9, "dur_s": 2.0},
              {"span": "ifft_wires", "flops": 1e9, "dur_s": 0.5},
              {"span": "round1", "dur_s": 1.0},           # no model
              {"span": "x", "flops": 5, "dur_s": 0.0}]    # no duration
    m = Metrics()
    m.observe_kernels(events, peak=1e10)
    assert m.snapshot()["gauges"] == {
        "kernel_commit_wires_gflops": 3.0, "mfu_commit_wires_pct": 30.0,
        "kernel_ifft_wires_gflops": 2.0, "mfu_ifft_wires_pct": 20.0}
    m = Metrics()
    m.observe_kernels(events, device="cpu")
    assert m.snapshot()["gauges"] == {"kernel_commit_wires_gflops": 3.0,
                                      "kernel_ifft_wires_gflops": 2.0}
    assert device_peak("cpu") is None and device_peak(None) is None
    text = Metrics()
    text.observe_kernels(events[:1], peak=1e10)
    assert "dpt_mfu_commit_wires_pct 30.0" in text.to_prometheus()


class _Svc:
    """The part of a ProofService the autoscaler's sensors read."""

    class _Queue:
        max_depth = 8

        def depth(self):
            return 0

        def depth_by_class(self):
            return {}

    class _Pool:
        def busy(self):
            return []

    def __init__(self):
        self.metrics = Metrics()
        self.queue = self._Queue()
        self.pool = self._Pool()
        self.fleet_dispatcher = None


def test_autoscaler_reads_mfu_once_gauges_exist():
    svc = _Svc()
    asc = AS.Autoscaler(service=svc, mode="dry")
    assert asc.read_sensors()["mfu_pct"] is None
    svc.metrics.observe_kernels(
        [{"span": "a", "flops": 1e9, "dur_s": 1.0},
         {"span": "b", "flops": 3e9, "dur_s": 1.0}], peak=1e10)
    assert asc.read_sensors()["mfu_pct"] == 20.0


def test_stack_capture_sees_other_threads():
    stop = threading.Event()

    def busy_loop_for_the_sampler():
        while not stop.is_set():
            sum(range(1000))

    th = threading.Thread(target=busy_loop_for_the_sampler)
    th.start()
    try:
        meta, blob = profiling.capture(60, kind="auto", device="cpu")
    finally:
        stop.set()
        th.join()
    doc = json.loads(blob)
    assert meta["format"] == doc["format"] == "pystacks-json"
    assert meta["samples"] >= 1 and meta["bytes"] == len(blob)
    assert any("busy_loop_for_the_sampler" in k for k in doc["stacks"])
    assert len(profiling.profile_id(blob)) == 16


def test_capture_caps_the_window(monkeypatch):
    seen = []
    monkeypatch.setattr(profiling, "_capture_stacks", lambda ms: (
        seen.append(ms), ({"format": "pystacks-json"}, b"{}"))[1])
    profiling.capture(10 ** 9, kind="stacks")
    profiling.capture(None, kind="stacks")
    assert seen == [profiling.MAX_MS, profiling.DEFAULT_MS]


def test_torch_capture_of_cpu_activity():
    stop = threading.Event()

    def work():
        a = torch.ones(64, 64)
        while not stop.is_set():
            a = a @ a / 64

    th = threading.Thread(target=work)
    th.start()
    try:
        meta, blob = profiling.capture(100, kind="torch", device="cpu")
    finally:
        stop.set()
        th.join()
    assert meta["format"] == "torch-trace-gz", meta
    assert "fallback_from" not in meta and meta["events"] >= 0
    assert meta["kernel_events"] == 0 and meta["device"] == "cpu"
    assert profiling.kernel_names(blob) == {}


def test_concurrent_torch_capture_is_refused():
    with profiling._TORCH_LOCK:
        meta, blob = profiling.capture(10, kind="torch", device="cpu")
    assert meta["format"] == "error" and "already running" in meta["error"]
    assert blob == b""


def test_failed_torch_capture_falls_back_and_says_so(monkeypatch):
    def broken(ms, device):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(profiling, "_capture_torch", broken)
    meta, blob = profiling.capture(20, kind="torch", device="cpu")
    assert meta["format"] == "pystacks-json" and blob
    assert meta["fallback_from"] == "torch"
    assert "no profiler here" in meta["error"]


def test_capture_never_raises(monkeypatch):
    def broken(ms):
        raise ValueError("sampler broke")

    monkeypatch.setattr(profiling, "_capture_stacks", broken)
    meta, blob = profiling.capture(5, kind="stacks")
    assert meta["format"] == "error" and "sampler broke" in meta["error"]
    assert blob == b""


def test_profile_to_and_annotated_spans(tmp_path):
    tr = Tracer(annotate=True)
    with T.profile_to(str(tmp_path)):
        with tr.span("outer_span_name"):
            torch.ones(8) + 1
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "outer_span_name" in names
    assert tr.events[0]["span"] == "outer_span_name"
    # off by default: a plain tracer opens no profiler range
    assert Tracer().annotate is False
