"""The port's trace context on the CPU, held to the JAX package's
`trace.Tracer` on the same operations (the cases of the JAX
tests/test_trace.py: inject/extract, the null tracer):

- `Tracer.context()` gives the same keys in both packages, its ids being
  the spans and the adopted parent that made them; the thread's innermost
  open span wins, then the adopted parent, else no `parent_id` key;
- a context from either package, adopted by the other's
  `Tracer.from_context`, keeps its trace id and parent link;
- garbage contexts give the same outcome in both: the given id or a fresh
  32-hex id, and the given parent or None;
- `NULL_TRACER` answers `context`, `totals`, `dump`, `to_json` and
  `events` as the JAX one does;
- `add_event` in the JAX keyword form (ts=, dur_s=, parent=) gets the JAX
  parent outside a span; inside one the port's takes the open span (the
  recorded deviation: kernel events nest under their round);
- a context rides a frame (runtime/protocol.py's wrap_traced) and a
  client SUBMIT unchanged.

Ids are compared exactly; nothing is timed.
"""

import re
import threading

import pytest

from distributed_plonk_tpu import trace as JT
from distributed_plonk_tpu.runtime import protocol as JP

from distributed_plonk_tpu_torch import trace as PT
from distributed_plonk_tpu_torch.runtime import protocol as PP

PACKAGES = {"port": PT, "jax": JT}
HEX32 = re.compile(r"[0-9a-f]{32}\Z")
HEX16 = re.compile(r"[0-9a-f]{16}\Z")


def _links(mod):
    """The JAX test's inject/extract sequence on one package; returns what
    it observed, with every id replaced by its role so the two packages'
    records compare equal."""
    parent = mod.Tracer(proc="client")
    root_ctx = parent.context()
    with parent.span("request") as sid:
        ctx = parent.context()
        with parent.span("inner") as inner:
            inner_ctx = parent.context()
        after_inner = parent.context()
    assert HEX32.match(parent.trace_id) and HEX16.match(sid)
    assert root_ctx == {"trace_id": parent.trace_id}
    assert ctx == {"trace_id": parent.trace_id, "parent_id": sid}
    assert inner_ctx == {"trace_id": parent.trace_id, "parent_id": inner}
    assert after_inner == ctx

    child = mod.Tracer.from_context(ctx, proc="server")
    assert child.trace_id == parent.trace_id and child.parent_id == sid
    assert child.proc == "server"
    # no open span on this thread: the adopted parent is the context's
    assert child.context() == ctx
    with child.span("serve") as serve_sid:
        serve_ctx = child.context()
    assert serve_ctx == {"trace_id": parent.trace_id, "parent_id": serve_sid}
    with child.span("serve2", parent="ab" * 8):
        pass
    # synthetic spans, keyword form, outside any span: the remote parent,
    # or the one given
    q_sid = child.add_event("queued", ts=1.0, dur_s=0.1)
    child.add_event("verified", ts=2.0, dur_s=0.2, parent="cd" * 8)
    serve, serve2, queued, verified = child.events
    roles = {parent.trace_id: "trace", sid: "request", inner: "inner",
             serve_sid: "serve", "ab" * 8: "ab", "cd" * 8: "cd"}
    assert queued["sid"] == q_sid and HEX16.match(q_sid)
    assert (queued["ts"], queued["dur_s"]) == (1.0, 0.1)
    return {
        "keys": [sorted(c) for c in (root_ctx, ctx, inner_ctx, serve_ctx)],
        "parents": [roles[ev["parent"]] for ev in child.events],
        "names": [ev["span"] for ev in child.events],
        "dump": (child.dump()["trace_id"] == parent.trace_id,
                 child.dump()["proc"]),
    }


def test_context_inject_extract_matches_jax():
    port, jax = _links(PT), _links(JT)
    assert port == jax
    assert port["parents"] == ["request", "ab", "request", "cd"]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_context_adopted_across_packages(src, dst):
    """A context made by one package continues in the other: the trace id
    and the parent link survive, and a context made there goes back."""
    a = PACKAGES[src].Tracer(proc="client")
    with a.span("request") as sid:
        ctx = a.context()
    b = PACKAGES[dst].Tracer.from_context(ctx, proc="server")
    assert (b.trace_id, b.parent_id) == (a.trace_id, sid)
    with b.span("serve") as serve_sid:
        back = b.context()
    assert b.events[0]["parent"] == sid
    c = PACKAGES[src].Tracer.from_context(back, proc="worker/0")
    assert (c.trace_id, c.parent_id) == (a.trace_id, serve_sid)
    with c.span("kernel"):
        pass
    assert c.events[0]["parent"] == serve_sid
    # both dumps merge under one id with either package's merge_traces
    for mod in PACKAGES.values():
        merged = mod.merge_traces([a.dump(), b.dump(), c.dump()])
        assert merged["trace_id"] == a.trace_id
        assert [p["proc"] for p in merged["processes"]] == \
            ["client", "server", "worker/0"]


GARBAGE = [
    None,
    "x",
    7,
    [],
    {},
    {"trace_id": ""},
    {"trace_id": 5},
    {"trace_id": None, "parent_id": "cd" * 8},
    {"trace_id": "ab" * 16, "parent_id": 7},
    {"trace_id": "ab" * 16},
    {"trace_id": "ab" * 16, "parent_id": "cd" * 8},
    {"trace_id": "ab" * 16, "parent_id": ""},
    {"parent_id": "cd" * 8, "extra": 1},
]


def _outcome(mod, ctx):
    tr = mod.Tracer.from_context(ctx, proc="p", host="h")
    given = isinstance(ctx, dict) and ctx.get("trace_id") == tr.trace_id
    assert given or HEX32.match(tr.trace_id), tr.trace_id
    out = (tr.trace_id if given else "fresh", tr.parent_id,
           sorted(tr.context()), tr.proc, tr.host)
    # the injected context is the extracted one
    assert tr.context() == dict(
        {"trace_id": tr.trace_id},
        **({} if tr.parent_id is None else {"parent_id": tr.parent_id}))
    return out


@pytest.mark.parametrize("ctx", GARBAGE, ids=repr)
def test_from_context_tolerates_garbage_like_jax(ctx):
    port = _outcome(PT, ctx)
    assert port == _outcome(JT, ctx)
    if not isinstance(ctx, dict) or not ctx.get("trace_id") or \
            not isinstance(ctx.get("trace_id"), str):
        assert port[0] == "fresh"


def test_null_tracer_surface_matches_jax():
    for null in (PT.NULL_TRACER, JT.NULL_TRACER):
        with null.span("x") as sid:
            assert sid is None
        assert null.context() is None
        assert null.totals() == {} and null.totals(depth=0) == {}
        assert null.dump() == {} and null.to_json() == "{}"
        assert tuple(null.events) == () and null.trace_id is None
        assert null.add_event("e", ts=1.0, dur_s=0.5) is None
    assert PT.NULL_TRACER.add_event("e", 0.5, 1.0, 0, parent="ab") is None
    assert PT.NULL_TRACER.to_json() == JT.NULL_TRACER.to_json()


def test_add_event_inside_a_span_is_the_recorded_deviation():
    """Outside a span both packages give a synthetic event the adopted
    parent; inside one the port's takes the open span (its kernels/<name>
    events nest under their round, prover.py's _flush_work), the JAX
    package's the adopted parent. An explicit parent wins in both."""
    ctx = {"trace_id": "ab" * 16, "parent_id": "cd" * 8}
    got = {}
    for name, mod in PACKAGES.items():
        tr = mod.Tracer.from_context(ctx)
        with tr.span("round1") as sid:
            tr.add_event("kernels/x", ts=1.0, dur_s=0.5)
            tr.add_event("kernels/y", ts=1.0, dur_s=0.5, parent="ef" * 8)
        tr.add_event("after", ts=2.0, dur_s=0.5)
        x, y, _round, after = tr.events
        got[name] = (x["parent"] == sid, y["parent"], after["parent"])
    assert got["port"] == (True, "ef" * 8, "cd" * 8)
    assert got["jax"] == (False, "ef" * 8, "cd" * 8)
    # the port's positional form keeps its order (name, dur_s, ts, depth)
    tr = PT.Tracer.from_context(ctx)
    tr.add_event("kernels/z", 0.25, 3.0, 1, flops=7)
    ev = tr.events[0]
    assert (ev["dur_s"], ev["ts"], ev["depth"], ev["parent"],
            ev["flops"]) == (0.25, 3.0, 1, "cd" * 8, 7)


def test_context_is_per_thread():
    """A span open on one thread is not the parent of a context taken on
    another: the other thread injects the adopted parent, in both."""
    for mod in PACKAGES.values():
        tr = mod.Tracer(trace_id="ab" * 16, parent_id="cd" * 8)
        seen = []
        with tr.span("main") as sid:
            t = threading.Thread(target=lambda: seen.append(tr.context()))
            t.start()
            t.join()
            assert tr.context()["parent_id"] == sid
        assert seen == [{"trace_id": "ab" * 16, "parent_id": "cd" * 8}]


def test_host_argument():
    for mod in PACKAGES.values():
        assert mod.Tracer(host="h1").dump()["host"] == "h1"
        tr = mod.Tracer.from_context({"trace_id": "ab" * 16}, proc="p",
                                     host="h2")
        assert (tr.proc, tr.host, tr.dump()["host"]) == ("p", "h2", "h2")


def test_context_rides_a_traced_frame_both_ways():
    """wrap_traced / strip_context carry a context() dict unchanged, and
    each package reads the other's frame."""
    tr = PT.Tracer(proc="client")
    with tr.span("call"):
        ctx = tr.context()
    for wrap, strip in ((PP.wrap_traced, JP.strip_context),
                        (JP.wrap_traced, PP.strip_context)):
        tag, payload = wrap(PP.SUBMIT, b"body", ctx)
        assert tag & PP.TRACED
        assert strip(tag, payload) == (PP.SUBMIT, ctx, b"body")
    # the null tracer's context frames nothing
    assert PP.wrap_traced(PP.SUBMIT, b"body", PT.NULL_TRACER.context()) == \
        (PP.SUBMIT, b"body")
