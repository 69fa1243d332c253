"""Aten-graph abstract interpretation: one integer interval per value.

The kernel half of the port's static verifier (`python -m
distributed_plonk_tpu_torch.analysis`), the counterpart of the JAX
package's jaxpr interval pass. The port's plain kernels carry 32-bit words
in int64 and 16-bit limbs in int64 column sums; each is right only while
those int64 values stay in range and every narrowing back to int32 words
sees a value that fits. This module re-derives that mechanically:

`trace(fn, args)` runs `functionalize(fn, remove="mutations_and_views")`
on CPU tensors under a dispatch mode that records every aten op the
functionalization layer sends down: the op set `make_fx` would put in its
graph (select_copy, slice_scatter, ...: no views, no in-place ops), at a
fiftieth of make_fx's cost. Tensors that no recorded op made and that are
not arguments (memoized constants such as `field_torch._COLS`, an NTT
plan's tables) enter the graph as concrete constants; an op whose tensor
operands are all constants is "static" and keeps its concrete value. The
trace runs `fn` once eagerly first, so memo caches fill with real tensors
and never with the tracer's.

`Interpreter` then pushes one interval [lo, hi] per value through the
graph and reports

  (a) an int64 (or any integer) result that can leave its dtype's range
      (silent wraparound),
  (b) a narrowing to int32 (`_to_copy`, `copy`) whose operand can leave
      [-2^31, 2^31),
  (c) any floating-point value or float literal in the graph, and
  (d) a declared output bound that is not met.

Precision, and the soundness it keeps:

- `torch.where(v >= c, v - k, v)` (`field_torch._narrow`) bounds each
  branch under its own condition: a comparison of a value with a constant
  carries an anchor to that value, and a branch computed from the same
  value by ops with constant operands is re-evaluated on the restricted
  interval (the counterpart of the JAX pass's floor-chain anchors).
- `empty`/`empty_like` make an uninitialized value: an `init` mask says
  which elements were written, the interval bounds only those, and
  reading it before every element is written gives the dtype's range.
  `select_scatter`, `slice_scatter` and `index_put` with static indices
  update the mask exactly (the scatter is run on boolean tensors), so a
  row-by-row fill of an empty tensor is bounded by its rows, and a
  scatter that overwrites a whole base drops the base's interval.
- `sort`, `searchsorted`, `nonzero` and the other data-dependent index
  ops are bounded by their output ranges, never by their values. A graph
  traced through a data-dependent branch is specialized to its trace
  data; every interval rule is still width- and value-generic.

What intervals cannot prove (a value spread across words is below 2p, a
carry out is zero) is promoted into `field_torch.CARRY_CONTRACTS`, named
inequalities over the real constants that `check_contracts` evaluates for
Fr and Fq; the CUDA bodies' side conditions are there too.
"""

import math

import numpy as np
import torch
from torch.func import functionalize
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["AbsVal", "Bound", "Graph", "Interpreter", "Violation",
           "check_contracts", "check_fn", "from_concrete", "trace",
           "word_rows"]


def _dtype_range(dtype):
    if dtype == torch.bool:
        return 0, 1
    if dtype.is_floating_point or dtype.is_complex:
        return -math.inf, math.inf
    info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


def _is_int(dtype):
    return dtype == torch.bool or not (dtype.is_floating_point
                                       or dtype.is_complex)


# --- the traced graph --------------------------------------------------------

def _map(f, cls, x):
    """x with every leaf of type cls replaced by f(leaf), through tuples
    (structseqs become tuples), lists and dicts: torch's pytree, without
    its per-call cost (it dominated the trace and the interpretation)."""
    if isinstance(x, cls):
        return f(x)
    if isinstance(x, (tuple, list)):
        return (list if isinstance(x, list) else tuple)(
            _map(f, cls, y) for y in x)
    if isinstance(x, dict):
        return {k: _map(f, cls, v) for k, v in x.items()}
    return x


def _leaves(x, out=None):
    """The leaves of nested tuples / lists / dicts, in order."""
    out = [] if out is None else out
    if isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


class Slot:
    """A tensor value of a Graph (an argument, a constant, an op output)."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __repr__(self):
        return "%%%d" % self.i


class Node:
    """One recorded aten op: `op(*args, **kwargs)` with Slots in place of
    tensors; `outs` is the op's output structure with Slots for tensors.
    floats: the Python float literals among the operands."""

    __slots__ = ("op", "name", "args", "kwargs", "outs", "_out_slots",
                 "floats")

    def __init__(self, op, args, kwargs, outs):
        self.op = op
        self.name = op.overloadpacket.__name__
        self.args = args
        self.kwargs = kwargs
        self.outs = outs
        self._out_slots = [x for x in _leaves(outs) if isinstance(x, Slot)]
        self.floats = [x for x in _leaves((args, kwargs))
                       if isinstance(x, float)]

    def out_slots(self):
        return self._out_slots


class Graph:
    """An aten graph recorded by `trace`.

    inputs: the argument Slots in order; consts: slot -> concrete tensor;
    meta: slot -> (dtype, shape); static: slot -> concrete value of every
    value that depends on no argument (constants and ops on them);
    outputs: the flattened output Slots; machine_out: the eager run's
    flattened outputs (what the plain function computed on the trace
    arguments)."""

    def __init__(self):
        self.inputs = []
        self.consts = {}
        self.meta = {}
        self.static = {}
        self.nodes = []
        self.outputs = []
        self.machine_out = []
        self._n = 0

    def new_slot(self, t):
        s = Slot(self._n)
        self._n += 1
        self.meta[s.i] = (t.dtype, tuple(t.shape))
        return s

    def __len__(self):
        return len(self.nodes)


_EMPTY_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


class _Recorder(TorchDispatchMode):
    def __init__(self, graph, inputs):
        super().__init__()
        self.g = graph
        self.slot_of = {}
        self.keep = []
        for t in inputs:
            s = graph.new_slot(t)
            graph.inputs.append(s)
            self.slot_of[id(t)] = s
            self.keep.append(t)

    def _arg(self, t):
        s = self.slot_of.get(id(t))
        if s is None:
            s = self.g.new_slot(t)
            c = t.detach().clone()
            self.g.consts[s.i] = c
            self.g.static[s.i] = c
            self.slot_of[id(t)] = s
            self.keep.append(t)
        return s

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        a = _map(self._arg, torch.Tensor, args)
        k = _map(self._arg, torch.Tensor, kwargs)
        static = all(s.i in self.g.static for s in _leaves((a, k))
                     if isinstance(s, Slot))
        static = static and func.overloadpacket.__name__ not in _EMPTY_OPS

        def new(t):
            s = self.g.new_slot(t)
            self.slot_of[id(t)] = s
            self.keep.append(t)
            if static:
                self.g.static[s.i] = t.detach().clone()
            return s
        outs = _map(new, torch.Tensor, out)
        self.g.nodes.append(Node(func, a, k, outs))
        return out


def trace(fn, args):
    """The aten graph of `fn(*args)` on CPU tensors (see the module
    docstring): functionalized, views and mutations removed, memoized
    constants concrete. `fn` runs once eagerly first."""
    args = tuple(args)
    eager = fn(*args)
    g = Graph()
    g.machine_out = [t.detach().clone() for t in _leaves(eager)
                     if isinstance(t, torch.Tensor)]
    rec = _Recorder(g, args)

    def cloned(*a):
        # each output a fresh tensor: functionalize's output unwrap fails
        # on a view of a tensor written in place through another view
        return _map(lambda t: t.clone(), torch.Tensor, fn(*a))
    with rec:
        out = functionalize(cloned, remove="mutations_and_views")(*args)
    for t in _leaves(out):
        if not isinstance(t, torch.Tensor):
            raise TypeError("trace: %r returned a non-tensor" % (fn,))
        s = rec.slot_of.get(id(t))
        if s is None:
            raise RuntimeError("trace: an output of %r was made by no "
                               "recorded op" % (fn,))
        g.outputs.append(s)
    # the graph must compute what the eager function computed:
    # functionalization replays an in-place write through a view's
    # inverse, and where it misreads aliasing (contiguous() of an expanded
    # tensor taken for the view itself) the graph computes something else
    for i, (t, m) in enumerate(zip(_leaves(out), g.machine_out)):
        if not torch.equal(t, m):
            raise TraceDiverged("trace: output %d of the functionalized "
                                "graph differs from the eager run's" % i)
    return g


class TraceDiverged(Exception):
    """The functionalized graph computes other values than the eager
    function: the graph is not the function, and nothing proved on it
    holds for the function."""


# --- abstract values ---------------------------------------------------------

class AbsVal:
    """Abstract value: dtype + shape + one interval [lo, hi] over every
    element (Python ints; +-inf for floats).

    init: None when every element holds a value, else a bool tensor of
    the shape, True where one was written (lo/hi bound only those; None
    while none is). slot: the graph slot this value is (anchor target).
    deriv: (slot, f) when the value is f(that slot's value) elementwise,
    f an interval map (a chain of ops with constant operands). cmp: (slot,
    op, c) when the value is `slot op c` for a constant interval c. bits:
    for a non-negative value, a mask holding every bit any element may
    set (the bitwise ops' refinement: (i | neg << 8) & 0xFF <= i)."""

    __slots__ = ("dtype", "shape", "lo", "hi", "init", "slot", "deriv",
                 "cmp", "bits")

    def __init__(self, dtype, shape, lo, hi, init=None):
        self.dtype = dtype
        self.shape = tuple(shape)
        self.lo = lo
        self.hi = hi
        self.init = init
        self.slot = None
        self.deriv = None
        self.cmp = None
        self.bits = None

    def __repr__(self):
        return "AbsVal(%s, %s, [%s, %s]%s)" % (
            self.dtype, self.shape, self.lo, self.hi,
            "" if self.init is None else ", partly written")


def from_concrete(t):
    """AbsVal of a concrete tensor (an exact interval)."""
    t = torch.as_tensor(t)
    if t.numel() == 0:
        return AbsVal(t.dtype, t.shape, 0, 0)
    if _is_int(t.dtype):
        return AbsVal(t.dtype, t.shape, int(t.min()), int(t.max()))
    return AbsVal(t.dtype, t.shape, float(t.min()), float(t.max()))


def _lit(v):
    """AbsVal of a Python scalar operand."""
    if isinstance(v, bool):
        return AbsVal(torch.bool, (), int(v), int(v))
    if isinstance(v, int):
        return AbsVal(torch.int64, (), v, v)
    return AbsVal(torch.float64, (), v, v)


class Bound:
    """Declared input interval for a traced argument: shape + torch dtype
    + [lo, hi] over every element (the documented precondition, e.g.
    32-bit words = Bound(shape, torch.int32, -2^31, 2^31 - 1))."""

    def __init__(self, shape, dtype, lo, hi):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.lo = lo
        self.hi = hi

    def absval(self):
        return AbsVal(self.dtype, self.shape, self.lo, self.hi)

    def sample(self, rng):
        """A concrete tensor inside the bound (the trace's arguments)."""
        if self.dtype == torch.bool:
            a = rng.integers(0, 2, size=self.shape).astype(bool)
        else:
            a = rng.integers(self.lo, self.hi, size=self.shape,
                             dtype=np.int64, endpoint=True)
        return torch.from_numpy(np.asarray(a)).to(self.dtype)


def word_rows(*shape):
    """32-bit word rows: int32 tensors holding any bit pattern (the port's
    handle layout; the counterpart of the JAX package's limb_rows)."""
    return Bound(shape, torch.int32, -(1 << 31), (1 << 31) - 1)


class Violation:
    def __init__(self, kernel, prim, message, where=""):
        self.kernel = kernel
        self.prim = prim
        self.message = message
        self.where = where

    def __str__(self):
        loc = " @ %s" % self.where if self.where else ""
        return "[%s] %s: %s%s" % (self.kernel, self.prim, self.message, loc)


def _join(a, b):
    """Least upper bound of two intervals (None = bottom)."""
    if a is None:
        return b
    if b is None:
        return a
    return min(a[0], b[0]), max(a[1], b[1])


def _bits_hi(hi):
    return (1 << int(hi).bit_length()) - 1 if hi > 0 else 0


def _bits_of(v):
    """A mask of the bits a non-negative operand may set, else None."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v if v >= 0 else None
    if not isinstance(v, AbsVal) or v.init is not None or v.lo is None \
            or v.lo < 0:
        return None
    if v.bits is not None:
        return v.bits
    return v.lo if v.lo == v.hi else _bits_hi(v.hi)


def _twos_span(lo, hi):
    """[-2^k, 2^k - 1] covering [lo, hi] (a bitwise op's result range
    when an operand may be negative)."""
    k = max(int(abs(lo)).bit_length(), int(abs(hi)).bit_length())
    return -(1 << k), (1 << k) - 1


# interval transfer functions of the elementwise ops, (lo, hi) x (lo, hi)
# -> (lo, hi) in true integer arithmetic (a dtype check follows)

def _t_add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _t_sub(a, b):
    return a[0] - b[1], a[1] - b[0]


def _t_mul(a, b):
    ps = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
    return min(ps), max(ps)


def _t_and(a, b):
    if a[0] >= 0 and b[0] >= 0:
        return 0, min(a[1], b[1])
    if a[0] >= 0:
        return 0, a[1]
    if b[0] >= 0:
        return 0, b[1]
    return _twos_span(min(a[0], b[0]), max(a[1], b[1]))


def _t_or(a, b):
    if a[0] >= 0 and b[0] >= 0:
        return max(a[0], b[0]), _bits_hi(max(a[1], b[1]))
    return _twos_span(min(a[0], b[0]), max(a[1], b[1]))


def _t_xor(a, b):
    if a[0] >= 0 and b[0] >= 0:
        return 0, _bits_hi(max(a[1], b[1]))
    return _twos_span(min(a[0], b[0]), max(a[1], b[1]))


def _t_rshift(a, s):
    if s[0] < 0:
        return None
    return (min(a[0] >> s[0], a[0] >> s[1]),
            max(a[1] >> s[0], a[1] >> s[1]))


def _t_lshift(a, s):
    if s[0] < 0 or s[1] > 1024:
        return None
    return (a[0] << s[0] if a[0] >= 0 else a[0] << s[1],
            a[1] << s[1] if a[1] >= 0 else a[1] << s[0])


def _t_max(a, b):
    return max(a[0], b[0]), max(a[1], b[1])


def _t_min(a, b):
    return min(a[0], b[0]), min(a[1], b[1])


def _t_floordiv(a, b):
    if b[0] <= 0 <= b[1]:
        return None
    qs = [a[0] // b[0], a[0] // b[1], a[1] // b[0], a[1] // b[1]]
    return min(qs), max(qs)


def _t_truncdiv(a, b):
    if b[0] <= 0 <= b[1]:
        return None

    def q(x, y):
        r = abs(x) // abs(y)
        return -r if (x < 0) != (y < 0) else r
    qs = [q(x, y) for x in a for y in b]
    # truncation moves toward zero: 0 lies between the corner quotients'
    # signs whenever a spans 0
    return min(qs + ([0] if a[0] <= 0 <= a[1] else [])), \
        max(qs + ([0] if a[0] <= 0 <= a[1] else []))


def _t_remainder(a, b):
    """torch.remainder: the sign of the divisor."""
    if b[0] >= 1:
        if 0 <= a[0] and a[1] < b[0]:
            return a
        return 0, b[1] - 1
    if b[1] <= -1:
        return b[0] + 1, 0
    return None


def _t_fmod(a, b):
    """torch.fmod: the sign of the dividend, |r| < |b|."""
    m = max(abs(b[0]), abs(b[1])) - 1
    if b[0] <= 0 <= b[1] or m < 0:
        return None
    return (0 if a[0] >= 0 else max(-m, a[0]),
            0 if a[1] <= 0 else min(m, a[1]))


_BINARY = {
    "add": _t_add, "sub": _t_sub, "mul": _t_mul,
    "bitwise_and": _t_and, "__and__": _t_and,
    "bitwise_or": _t_or, "__or__": _t_or,
    "bitwise_xor": _t_xor, "__xor__": _t_xor,
    "__rshift__": _t_rshift, "bitwise_right_shift": _t_rshift,
    "__lshift__": _t_lshift, "bitwise_left_shift": _t_lshift,
    "maximum": _t_max, "minimum": _t_min,
    "floor_divide": _t_floordiv, "remainder": _t_remainder,
    "fmod": _t_fmod,
}

_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}

# ops that only move data: the interval passes from the first operand,
# and the init mask moves the same way
_MOVE = {
    "select", "select_copy", "slice", "slice_copy", "view", "view_copy",
    "_unsafe_view", "reshape", "_reshape_alias", "_reshape_alias_copy",
    "expand", "expand_copy", "unsqueeze", "unsqueeze_copy", "squeeze",
    "squeeze_copy", "permute", "permute_copy", "transpose",
    "transpose_copy", "t", "t_copy", "alias", "alias_copy", "clone",
    "detach", "detach_copy", "lift_fresh", "lift_fresh_copy", "index",
    "_unsafe_index", "index_select", "gather", "flip", "roll", "repeat",
    "as_strided", "as_strided_copy", "contiguous", "unfold", "unfold_copy",
    "diagonal", "diagonal_copy", "split", "split_copy", "split_with_sizes",
    "split_with_sizes_copy", "unbind", "unbind_copy", "narrow",
    "narrow_copy", "movedim", "take", "take_along_dim",
}

# the scatters: (position of the source operand); the written region is
# found by running the op on boolean tensors
_SCATTER_SRC = {"select_scatter": 1, "slice_scatter": 1,
                "diagonal_scatter": 1, "as_strided_scatter": 1,
                "index_put": 2, "scatter": 3, "index_copy": 3}

_ZEROS = {"zeros", "zeros_like", "new_zeros"}
_ONES = {"ones", "ones_like", "new_ones"}
_FULL = {"full": 1, "full_like": 1, "new_full": 2, "scalar_tensor": 0}


class Interpreter:
    """Interval propagation over a Graph (see the module docstring)."""

    def __init__(self, kernel_name, strict=True):
        self.kernel = kernel_name
        self.strict = strict
        self.violations = []
        self.warnings = []

    # -- reporting -------------------------------------------------------------

    def _flag(self, node, msg):
        self.violations.append(Violation(self.kernel, str(node.op), msg))

    def _fallback(self, node, ins):
        """Unknown op: the dtype's full range (sound), and under strict a
        violation: an unvetted op must not pass the verifier silently."""
        msg = ("unhandled aten op '%s' (add a transfer rule to "
               "analysis/bounds.py)" % node.op)
        if self.strict:
            self._flag(node, msg)
        else:
            self.warnings.append(Violation(self.kernel, str(node.op), msg))
        return [self._full(s) for s in node.out_slots()]

    # -- values ----------------------------------------------------------------

    def _meta(self, slot):
        return self.g.meta[slot.i]

    def _full(self, slot):
        dtype, shape = self._meta(slot)
        lo, hi = _dtype_range(dtype)
        return AbsVal(dtype, shape, lo, hi)

    def _iv(self, v):
        """The interval an arithmetic op reads: a partly written value
        reads as its dtype's full range."""
        if not isinstance(v, AbsVal):
            return (v, v)
        if v.init is not None:
            return _dtype_range(v.dtype)
        return v.lo, v.hi

    def _result(self, node, lo, hi, i=0):
        """Bound-check an arithmetic result against its dtype and return
        the (clamped) AbsVal of output i."""
        slot = node.out_slots()[i]
        dtype, shape = self._meta(slot)
        if _is_int(dtype) and dtype != torch.bool:
            dlo, dhi = _dtype_range(dtype)
            if lo < dlo or hi > dhi:
                self._flag(node, "%s range exceeded: result in [%d, %d] vs "
                                 "dtype [%d, %d] (silent wraparound)"
                           % (str(dtype).replace("torch.", ""), lo, hi,
                              dlo, dhi))
                lo, hi = max(lo, dlo), min(hi, dhi)
        elif dtype == torch.bool:
            lo, hi = max(0, min(lo, 1)), min(1, max(hi, 0))
        return AbsVal(dtype, shape, lo, hi)

    # -- the interpreter -------------------------------------------------------

    def run(self, graph, in_vals):
        """AbsVals of graph's outputs, given AbsVals of its inputs."""
        self.g = graph
        env = {}
        self._ivs = {}      # slot -> interval, for the where() anchors

        def put(i, v):
            v.slot = i
            env[i] = v
            self._ivs[i] = self._iv(v)
        assert len(in_vals) == len(graph.inputs), \
            (len(in_vals), len(graph.inputs))
        for s, v in zip(graph.inputs, in_vals):
            put(s.i, v)
        for i, t in graph.consts.items():
            put(i, from_concrete(t))

        def get(s):
            return env[s.i]
        for node in graph.nodes:
            ins = _map(get, Slot, node.args)
            kw = _map(get, Slot, node.kwargs) if node.kwargs else {}
            if node.floats:
                self._flag(node, "float literal %r in a kernel graph"
                           % node.floats[0])
            outs = self._node(node, ins, kw)
            if isinstance(outs, AbsVal):
                outs = [outs]
            for s, v in zip(node.out_slots(), outs):
                dtype, shape = self._meta(s)
                if not _is_int(dtype):
                    self._flag(node, "floating-point value (%s) in a kernel "
                                     "graph" % dtype)
                v.dtype, v.shape = dtype, shape
                conc = graph.static.get(s.i)
                if conc is not None and _is_int(dtype):
                    exact = from_concrete(conc)
                    v.lo, v.hi, v.init = exact.lo, exact.hi, None
                put(s.i, v)
        return [env[s.i] for s in graph.outputs]

    def _node(self, node, ins, kw):
        name = node.name
        if node.floats or any(isinstance(v, AbsVal) and not _is_int(v.dtype)
                              for v in _leaves((ins, kw))):
            # float operands are flagged where they appear; their results
            # hold no integer bound
            return [self._full(s) for s in node.out_slots()]
        if name in _BINARY:
            return self._binary(node, ins, kw)
        if name in _CMP:
            return self._cmp(node, ins)
        if name in _MOVE:
            return self._move(node, ins)
        if name in _SCATTER_SRC:
            return self._scatter(node, ins, kw)
        handler = getattr(self, "_p_" + name.lstrip("_"), None)
        if handler is not None:
            return handler(node, ins, kw)
        if name in _ZEROS:
            return self._result(node, 0, 0)
        if name in _ONES:
            return self._result(node, 1, 1)
        if name in _FULL:
            v = ins[_FULL[name]] if len(ins) > _FULL[name] \
                else kw["fill_value"]
            return self._result(node, v, v)
        if name in _EMPTY_OPS:
            dtype, shape = self._meta(node.out_slots()[0])
            return AbsVal(dtype, shape, None, None,
                          init=torch.zeros(shape, dtype=torch.bool))
        return self._fallback(node, ins)

    # -- elementwise arithmetic ------------------------------------------------

    def _binary(self, node, ins, kw):
        a, b = ins[0], ins[1]
        f = _BINARY[node.name]
        alpha = kw.get("alpha", ins[2] if len(ins) > 2 else 1)
        if node.name in ("add", "sub") and alpha != 1:
            b = self._scaled(b, alpha)
        ia, ib = self._iv(a), self._iv(b)
        r = f(ia, ib)
        if r is None:
            return self._fallback(node, ins)
        out = self._result(node, *r)
        self._bitmask(node.name, out, a, b)
        # derivation chain: one operand a constant -> out = g(other)
        var, const = (a, b) if self._static_operand(b) else (
            (b, a) if self._static_operand(a) else (None, None))
        if var is not None and isinstance(var, AbsVal) and \
                var.init is None:
            civ = self._iv(const)
            if var is a:
                step = (lambda iv, f=f, c=civ: f(iv, c))
            else:
                step = (lambda iv, f=f, c=civ: f(c, iv))
            if var.deriv is not None:
                src, g = var.deriv
                out.deriv = (src, lambda iv, g=g, h=step: _apply(h, _apply(
                    g, iv)))
            else:
                out.deriv = (var.slot, step)
        return out

    def _bitmask(self, name, out, a, b):
        """Refine a bitwise op's result with the operands' bit masks."""
        ba, bb = _bits_of(a), _bits_of(b)
        m = None
        if name in ("bitwise_and", "__and__"):
            if ba is not None and bb is not None:
                m = ba & bb
            elif out.lo >= 0:
                m = ba if ba is not None else bb
        elif name in ("bitwise_or", "__or__", "bitwise_xor", "__xor__"):
            if ba is not None and bb is not None:
                m = ba | bb
        elif name in ("__rshift__", "bitwise_right_shift", "__lshift__",
                      "bitwise_left_shift"):
            sh = self._iv(b)
            if ba is not None and sh[0] == sh[1] and 0 <= sh[0] <= 1024:
                m = ba >> sh[0] if "right" in name or "rshift" in name \
                    else ba << sh[0]
        if m is not None and out.lo >= 0:
            out.bits = m
            out.hi = min(out.hi, m)

    def _scaled(self, b, alpha):
        iv = self._iv(b)
        lo, hi = _t_mul(iv, (alpha, alpha))
        return AbsVal(b.dtype if isinstance(b, AbsVal) else torch.int64,
                      b.shape if isinstance(b, AbsVal) else (), lo, hi)

    def _static_operand(self, x):
        if not isinstance(x, AbsVal):
            return True
        return x.init is None and x.slot in self.g.static and \
            x.lo == x.hi

    def _p_rsub(self, node, ins, kw):
        a, b = ins[0], ins[1]
        return self._result(node, *_t_sub(self._iv(b), self._iv(a)))

    def _p_neg(self, node, ins, kw):
        lo, hi = self._iv(ins[0])
        return self._result(node, -hi, -lo)

    def _p_abs(self, node, ins, kw):
        lo, hi = self._iv(ins[0])
        return self._result(node, 0 if lo <= 0 <= hi else
                            min(abs(lo), abs(hi)), max(abs(lo), abs(hi)))

    def _p_bitwise_not(self, node, ins, kw):
        if self._meta(node.out_slots()[0])[0] == torch.bool:
            return self._result(node, 0, 1)
        lo, hi = self._iv(ins[0])
        return self._result(node, -hi - 1, -lo - 1)

    def _p_logical_not(self, node, ins, kw):
        return self._result(node, 0, 1)

    _p_logical_and = _p_logical_or = _p_logical_xor = _p_logical_not
    _p_any = _p_all = _p_isin = _p_logical_not

    def _p_clamp(self, node, ins, kw):
        lo, hi = self._iv(ins[0])
        cmin = ins[1] if len(ins) > 1 else kw.get("min")
        cmax = ins[2] if len(ins) > 2 else kw.get("max")
        if cmin is not None:
            m = self._iv(cmin)
            lo, hi = max(lo, m[0]), max(hi, m[0])
        if cmax is not None:
            m = self._iv(cmax)
            lo, hi = min(lo, m[1]), min(hi, m[1])
        return self._result(node, lo, hi)

    def _p_clamp_min(self, node, ins, kw):
        lo, hi = self._iv(ins[0])
        m = self._iv(ins[1])
        return self._result(node, max(lo, m[0]), max(hi, m[1]))

    def _p_clamp_max(self, node, ins, kw):
        lo, hi = self._iv(ins[0])
        m = self._iv(ins[1])
        return self._result(node, min(lo, m[0]), min(hi, m[1]))

    def _p_div(self, node, ins, kw):
        mode = kw.get("rounding_mode", ins[2] if len(ins) > 2 else None)
        f = {"floor": _t_floordiv, "trunc": _t_truncdiv}.get(mode)
        r = f(self._iv(ins[0]), self._iv(ins[1])) if f else None
        if r is None:
            return self._fallback(node, ins)
        return self._result(node, *r)

    # -- comparisons / select --------------------------------------------------

    def _cmp(self, node, ins):
        out = self._result(node, 0, 1)
        a, b = ins[0], ins[1]
        if isinstance(a, AbsVal) and a.init is None and \
                self._static_operand(b):
            out.cmp = (a.slot, node.name, self._iv(b))
        return out

    def _p_where(self, node, ins, kw):
        cond, x, y = ins[0], ins[1], ins[2]
        branches = [self._branch(cond, x, True), self._branch(cond, y, False)]
        iv = None
        for b in branches:
            iv = _join(iv, b)
        if iv is None:
            iv = (0, 0)
        return self._result(node, *iv)

    def _branch(self, cond, v, taken):
        """The interval of a where() branch, under its own condition when
        the condition compares an anchor value with a constant and the
        branch is that value or derived from it."""
        iv = self._iv(v)
        if not (isinstance(cond, AbsVal) and cond.cmp is not None
                and isinstance(v, AbsVal) and v.init is None):
            return iv
        src, op, c = cond.cmp
        if v.slot == src:
            f = None
        elif v.deriv is not None and v.deriv[0] == src:
            f = v.deriv[1]
        else:
            return iv
        s = self._ivs[src]
        r = _restrict(s, op if taken else _NEGATE[op], c)
        if r is None:
            return None     # the branch is never taken
        r = r if f is None else _apply(f, r)
        if r is None:
            return iv
        return max(iv[0], r[0]), min(iv[1], r[1])

    def _p_masked_fill(self, node, ins, kw):
        return self._result(node, *_join(self._iv(ins[0]),
                                         self._iv(ins[2])))

    # -- dtype conversion ------------------------------------------------------

    def _narrowing(self, node, iv, dtype):
        if _is_int(dtype) and dtype != torch.bool:
            dlo, dhi = _dtype_range(dtype)
            if iv[0] < dlo or iv[1] > dhi:
                self._flag(node, "narrowing to %s of a value in [%d, %d] "
                                 "(outside [%d, %d])"
                           % (str(dtype).replace("torch.", ""), iv[0],
                              iv[1], dlo, dhi))
                return max(iv[0], dlo), min(iv[1], dhi)
        if dtype == torch.bool:
            return (0, 1)
        return iv

    def _p_to_copy(self, node, ins, kw):
        dtype, _ = self._meta(node.out_slots()[0])
        v = ins[0]
        if v.init is not None:
            return self._move(node, ins)
        lo, hi = self._narrowing(node, (v.lo, v.hi), dtype)
        out = self._result(node, lo, hi)
        if dtype != torch.bool and lo >= 0 and (lo, hi) == (v.lo, v.hi):
            out.bits = _bits_of(v)
        if dtype == v.dtype:
            out.deriv = v.deriv or (v.slot, None)
        return out

    def _p_copy(self, node, ins, kw):
        dtype, _ = self._meta(node.out_slots()[0])
        src = ins[1]
        if src.init is not None:
            return self._full(node.out_slots()[0])
        lo, hi = self._narrowing(node, (src.lo, src.hi), dtype)
        return self._result(node, lo, hi)

    # -- structure -------------------------------------------------------------

    def _moved_mask(self, node, ins):
        """The init mask moved by the node's own op (None when the operand
        is fully written; all False when the move needs a non-static
        index)."""
        v = ins[0]
        if v.init is None:
            return None
        args = list(node.args)
        args[0] = v.init
        try:
            args = [self._concrete_arg(a) for a in args]
            kwargs = {k: self._concrete_arg(a)
                      for k, a in node.kwargs.items()}
        except _NotStatic:
            return [torch.zeros(self._meta(s)[1], dtype=torch.bool)
                    for s in node.out_slots()]
        if node.name == "_to_copy":
            kwargs.pop("dtype", None)
        out = node.op(*args, **kwargs)
        return [m.clone() for m in _leaves(out)]

    def _concrete_arg(self, a):
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, Slot):
            c = self.g.static.get(a.i)
            if c is None:
                raise _NotStatic()
            return c
        if isinstance(a, (list, tuple)):
            return type(a)(self._concrete_arg(x) for x in a)
        return a

    def _move(self, node, ins):
        v = ins[0]
        masks = self._moved_mask(node, ins)
        outs = []
        for i, s in enumerate(node.out_slots()):
            dtype, shape = self._meta(s)
            m = None if masks is None else masks[i]
            if m is not None and bool(m.all()):
                m = None
            if m is not None and not bool(m.any()):
                outs.append(AbsVal(dtype, shape, None, None, init=m))
                continue
            lo, hi = (v.lo, v.hi) if v.lo is not None else \
                _dtype_range(dtype)
            out = AbsVal(dtype, shape, lo, hi, init=m)
            if m is None:
                out.bits = v.bits
            if node.name in _ELEMENTWISE_MOVE and m is None:
                out.deriv = v.deriv or (v.slot, None)
            outs.append(out)
        return outs

    def _join_many(self, node, vals, axis_op):
        iv, masks, any_mask = None, [], False
        for v in vals:
            if v.init is not None:
                any_mask = True
            if v.lo is not None:
                iv = _join(iv, (v.lo, v.hi))
            masks.append(v.init if v.init is not None
                         else torch.ones(v.shape, dtype=torch.bool))
        dtype, shape = self._meta(node.out_slots()[0])
        mask = axis_op(masks) if any_mask else None
        if mask is not None and bool(mask.all()):
            mask = None
        if iv is None:
            return AbsVal(dtype, shape, None, None, init=mask)
        return AbsVal(dtype, shape, iv[0], iv[1], init=mask)

    def _p_cat(self, node, ins, kw):
        dim = ins[1] if len(ins) > 1 else kw.get("dim", 0)
        return self._join_many(node, ins[0],
                               lambda ms: torch.cat(ms, dim))

    def _p_stack(self, node, ins, kw):
        dim = ins[1] if len(ins) > 1 else kw.get("dim", 0)
        return self._join_many(node, ins[0],
                               lambda ms: torch.stack(ms, dim))

    def _p_constant_pad_nd(self, node, ins, kw):
        v = ins[0]
        pad = ins[1]
        value = ins[2] if len(ins) > 2 else kw.get("value", 0)
        if v.init is not None:
            mask = torch.nn.functional.pad(v.init, list(pad), value=True)
            iv = _join(None if v.lo is None else (v.lo, v.hi),
                       (value, value))
            return AbsVal(v.dtype, tuple(mask.shape), iv[0], iv[1],
                          init=None if bool(mask.all()) else mask)
        return self._result(node, *_join((v.lo, v.hi), (value, value)))

    def _p_fill(self, node, ins, kw):
        return self._result(node, *self._iv(ins[1]))

    def _p_arange(self, node, ins, kw):
        nums = [x for x in ins if isinstance(x, (int, float))]
        if len(nums) == 1:
            start, end, step = 0, nums[0], 1
        elif len(nums) == 2:
            (start, end), step = nums, 1
        else:
            start, end, step = nums[:3]
        n = max(0, -(-(end - start) // step))
        last = start + step * max(n - 1, 0)
        return self._result(node, min(start, last), max(start, last))

    # -- scatters --------------------------------------------------------------

    def _scatter(self, node, ins, kw):
        base = ins[0]
        pos = _SCATTER_SRC[node.name]
        src = ins[pos] if len(ins) > pos else None
        if node.name == "index_put" and (ins[3] if len(ins) > 3 else
                                         kw.get("accumulate", False)):
            return self._accumulate(node, ins)
        if not isinstance(src, AbsVal):
            src = _lit(src if src is not None else kw.get("value"))
        written = self._written(node, ins, src)
        dtype, shape = self._meta(node.out_slots()[0])
        siv = None if src.lo is None or src.init is not None and \
            not bool(src.init.any()) else (src.lo, src.hi)
        siv = self._narrowing(node, siv, dtype) if siv is not None else None
        if written is None:
            # the written region is unknown: the base keeps its mask and
            # the source joins its interval
            bm = base.init
            biv = None if base.lo is None else (base.lo, base.hi)
            iv = _join(biv, siv)
            if iv is None:
                return AbsVal(dtype, shape, None, None, init=bm)
            return AbsVal(dtype, shape, iv[0], iv[1], init=bm)
        any_w, init_w = written
        bmask = base.init if base.init is not None else \
            torch.ones(shape, dtype=torch.bool)
        kept = bmask & ~any_w
        iv = siv if bool(init_w.any()) else None
        if bool(kept.any()) and base.lo is not None:
            iv = _join(iv, (base.lo, base.hi))
        mask = kept | init_w
        mask = None if bool(mask.all()) else mask
        if iv is None:
            return AbsVal(dtype, shape, None, None, init=mask)
        return AbsVal(dtype, shape, iv[0], iv[1], init=mask)

    def _written(self, node, ins, src):
        """(elements the scatter writes, elements it writes from written
        source elements) as bool tensors, or None when a position operand
        is not static."""
        pos = _SCATTER_SRC[node.name]
        dtype, shape = self._meta(node.out_slots()[0])
        try:
            rest = [a if i in (0, pos) else self._concrete_arg(a)
                    for i, a in enumerate(node.args)]
            kwargs = {k: self._concrete_arg(a)
                      for k, a in node.kwargs.items()}
        except _NotStatic:
            return None

        def run(src_mask):
            args = list(rest)
            args[0] = torch.zeros(shape, dtype=torch.bool)
            if len(args) > pos and isinstance(node.args[pos], Slot):
                args[pos] = src_mask
            elif len(args) > pos:
                args[pos] = True
            else:
                kwargs["value"] = True
            return node.op(*args, **kwargs)
        ones = torch.ones(src.shape, dtype=torch.bool)
        any_w = run(ones)
        init_w = any_w if src.init is None else run(src.init)
        return any_w, init_w

    def _accumulate(self, node, ins):
        base, vals = ins[0], ins[2]
        idx = node.args[1]
        mult = None
        try:
            cidx = self._concrete_arg(list(idx))
            dtype, shape = self._meta(node.out_slots()[0])
            hits = torch.zeros(shape, dtype=torch.int64)
            hits.index_put_(cidx, torch.ones(vals.shape, dtype=torch.int64),
                            accumulate=True)
            mult = int(hits.max()) if hits.numel() else 0
        except _NotStatic:
            mult = max(1, int(np.prod(vals.shape)))
        b, v = self._iv(base), self._iv(vals)
        return self._result(node, b[0] + mult * min(0, v[0]),
                            b[1] + mult * max(0, v[1]))

    def _p_scatter_add(self, node, ins, kw):
        base, src = ins[0], ins[3]
        n = max(1, int(np.prod(src.shape)))
        b, v = self._iv(base), self._iv(src)
        return self._result(node, b[0] + n * min(0, v[0]),
                            b[1] + n * max(0, v[1]))

    _p_index_add = _p_scatter_add

    # -- reductions ------------------------------------------------------------

    def _reduced_count(self, v, dims):
        if dims is None or dims == []:
            return max(1, int(np.prod(v.shape)))
        if isinstance(dims, int):
            dims = [dims]
        n = 1
        for d in dims:
            n *= v.shape[d] if v.shape else 1
        return max(n, 1)

    def _p_sum(self, node, ins, kw):
        v = ins[0]
        dims = ins[1] if len(ins) > 1 and not isinstance(ins[1], bool) \
            else kw.get("dim")
        n = self._reduced_count(v, dims)
        lo, hi = self._iv(v)
        return self._result(node, lo * n, hi * n)

    def _p_cumsum(self, node, ins, kw):
        v = ins[0]
        dim = ins[1] if len(ins) > 1 else kw.get("dim")
        n = v.shape[dim] if v.shape else 1
        lo, hi = self._iv(v)
        return self._result(node, min(lo, lo * n), max(hi, hi * n))

    def _extreme(self, node, ins, kw):
        v = ins[0]
        lo, hi = self._iv(v)
        outs = [self._result(node, lo, hi)]
        if len(node.out_slots()) > 1:
            dim = ins[1] if len(ins) > 1 else kw.get("dim", 0)
            n = v.shape[dim] if v.shape else 1
            outs.append(self._result(node, 0, max(n - 1, 0), i=1))
        return outs

    _p_amax = _p_amin = _p_max = _p_min = _extreme

    def _p_argmax(self, node, ins, kw):
        v = ins[0]
        dim = ins[1] if len(ins) > 1 else kw.get("dim")
        n = v.shape[dim] if dim is not None and v.shape else \
            max(1, int(np.prod(v.shape)))
        return self._result(node, 0, max(n - 1, 0))

    _p_argmin = _p_argmax

    # -- data-dependent index ops: bounded by their output ranges -------------

    def _p_sort(self, node, ins, kw):
        v = ins[0]
        dim = kw.get("dim", -1)
        for x in ins[1:]:
            if isinstance(x, int) and not isinstance(x, bool):
                dim = x
                break
        n = v.shape[dim] if v.shape else 1
        lo, hi = self._iv(v)
        return [self._result(node, lo, hi),
                self._result(node, 0, max(n - 1, 0), i=1)]

    def _p_argsort(self, node, ins, kw):
        v = ins[0]
        dim = ins[1] if len(ins) > 1 and isinstance(ins[1], int) else -1
        n = v.shape[dim] if v.shape else 1
        return self._result(node, 0, max(n - 1, 0))

    def _p_searchsorted(self, node, ins, kw):
        seq = ins[0]
        n = seq.shape[-1] if seq.shape else 1
        return self._result(node, 0, n)

    def _p_nonzero(self, node, ins, kw):
        v = ins[0]
        return self._result(node, 0, max(max(v.shape or (1,)) - 1, 0))

    def _p_repeat_interleave(self, node, ins, kw):
        if node.op._overloadname == "Tensor":     # repeats -> indices
            r = ins[0]
            return self._result(node, 0, max(int(np.prod(r.shape)) - 1, 0))
        lo, hi = self._iv(ins[0])
        return self._result(node, lo, hi)

    def _p_bincount(self, node, ins, kw):
        v = ins[0]
        return self._result(node, 0, max(1, int(np.prod(v.shape))))

    def _p_local_scalar_dense(self, node, ins, kw):
        return []


class _NotStatic(Exception):
    pass


# ops that move elements one to one, keeping each element's value: the
# derivation chain of a where() branch passes through them
_ELEMENTWISE_MOVE = {"clone", "alias", "alias_copy", "detach", "detach_copy",
                     "lift_fresh", "lift_fresh_copy", "contiguous"}

_NEGATE = {"eq": "ne", "ne": "eq", "lt": "ge", "ge": "lt", "le": "gt",
           "gt": "le"}


def _apply(f, iv):
    if iv is None:
        return None
    return iv if f is None else f(iv)


def _restrict(s, op, c):
    """The part of interval s where `x op c` can hold for some c in the
    interval c (None when it never holds)."""
    lo, hi = s
    clo, chi = c
    if op == "ge":
        lo = max(lo, clo)
    elif op == "gt":
        lo = max(lo, clo + 1)
    elif op == "le":
        hi = min(hi, chi)
    elif op == "lt":
        hi = min(hi, chi - 1)
    elif op == "eq":
        lo, hi = max(lo, clo), min(hi, chi)
    if lo > hi:
        return None
    return lo, hi


def check_graph(name, graph, in_vals, out_bounds=None, strict=True):
    """Interval-check a traced graph given AbsVals of its inputs; returns
    the list of Violations (empty = proven clean at these shapes)."""
    interp = Interpreter(name, strict=strict)
    outs = interp.run(graph, in_vals)
    if out_bounds is not None:
        # fail closed: a postcondition list that does not cover every
        # output would leave the extras unchecked
        assert len(out_bounds) == len(outs), (name, len(out_bounds),
                                              len(outs))
        for i, ((lo, hi), v) in enumerate(zip(out_bounds, outs)):
            vlo, vhi = interp._iv(v)
            if vlo < lo or vhi > hi:
                interp.violations.append(Violation(
                    name, "output", "output %d bound [%s, %s] exceeds the "
                    "declared contract [%d, %d]" % (i, vlo, vhi, lo, hi)))
    return interp.violations


def input_vals(args):
    """AbsVals of a check's arguments: a Bound's interval, a concrete
    tensor's exact interval."""
    out = []
    for a in args:
        out.append(a.absval() if isinstance(a, Bound) else
                   from_concrete(torch.as_tensor(a)))
    return out


def sample_args(args, seed=0):
    """Concrete trace arguments for Bounds (seeded) and tensors."""
    rng = np.random.default_rng(seed)
    return tuple(a.sample(rng) if isinstance(a, Bound) else
                 torch.as_tensor(a) for a in args)


def check_fn(name, fn, args, out_bounds=None, strict=True, graph=None):
    """Trace `fn` at the arguments and interval-check the graph. `args`:
    Bounds (a declared interval; the trace runs on a seeded sample inside
    it) or concrete tensors (exact intervals). `graph`: an earlier trace
    of the same fn at these shapes, reused. `out_bounds`: (lo, hi) per
    flattened output, the declared postcondition. Returns Violations."""
    if graph is None:
        try:
            graph = trace(fn, sample_args(args))
        except TraceDiverged as e:
            return [Violation(name, "trace", str(e))]
    return check_graph(name, graph, input_vals(args), out_bounds, strict)


def check_contracts(specs=None):
    """Evaluate field_torch.CARRY_CONTRACTS against the actual field
    constants of each spec (Fr and Fq by default). Returns Violations
    (empty = every contract holds)."""
    from ..backend import field_torch as F

    if specs is None:
        specs = (F.FR, F.FQ)
    out = []
    for spec in specs:
        for c in F.CARRY_CONTRACTS:
            try:
                ok = bool(c["holds"](spec))
            except Exception as e:  # a malformed contract is a finding
                out.append(Violation("contract/%s" % c["name"], spec.name,
                                     "contract raised: %r" % (e,)))
                continue
            if not ok:
                out.append(Violation(
                    "contract/%s" % c["name"], spec.name,
                    "DOES NOT HOLD for %s: %s (%s)" % (spec.name, c["claim"],
                                                       c["where"])))
    return out
