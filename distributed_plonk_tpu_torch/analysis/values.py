"""Value-semantics pass: prove what the port's kernels COMPUTE, not just
what ranges they stay in (the counterpart of the JAX package's values.py).

The bounds pass (bounds.py) proves the plain kernels' machine arithmetic
never wraps and never narrows a value that does not fit: machine
semantics == exact integer semantics. It says nothing about WHICH integer
function a kernel computes: a dropped carry into column L of
`mont_mul_ref` keeps every limb below 2^16 and every int64 in range while
it changes the product mod p.

This module closes that gap twice:

- on the host, `run_exact(graph, args)` evaluates the SAME traced aten
  graph the bounds pass read, exactly, on object-dtype numpy arrays of
  Python ints. Ops that only move data (select, slice, view, index,
  gather, the scatters, cat, stack, pad) are run as the real aten op on
  int64 POSITION tensors, and the positions index the object arrays: the
  index arithmetic is torch's own, the values never leave exact ints.
  A result that leaves its dtype (a `_to_copy` to int32 of a value
  outside int32, an int64 sum past 2^63) is reported, never wrapped;
  a read of a never-written element of an `empty` tensor is reported
  too. With the bounds pass: machine == exact, exact |= contract.
- on the card (`device="cuda"`), an entry's kernel runs on the same
  sampled inputs and its output is held to the same contract: the CUDA
  bodies, which no interval reaches, answer to the algebra directly.

Contracts are per entry (registry.ValueObligation) and algebraic:
value(out) == value(a)*value(b)*R^-1 (mod p), out < p, for Montgomery
multiplies; value(words) + carry*2^(32K) == value(cols) for `_sweep32`;
the NTT == the port's `poly` oracle; digits recombine to from_mont(h);
Horner == sum c_i z^i. Samples are seeded field elements with 0, 1 and
p-1 pinned in corner lanes.
"""

import operator

import numpy as np
import torch

from .bounds import (Slot, TraceDiverged, Violation, trace, _EMPTY_OPS,
                     _FULL, _MOVE, _ONES, _SCATTER_SRC, _ZEROS, _leaves,
                     _map)

__all__ = [
    "Violation", "UnsupportedOp", "ExactInterpreter", "to_exact",
    "run_exact", "check_value", "word_value", "col_value",
    "words_from_int", "rand_fe", "mont_r", "elementwise",
    "mismatch_report",
]


class UnsupportedOp(Exception):
    """An op (or op mode) the exact evaluator cannot model faithfully, or
    a result it refuses to wrap. Strict mode turns it into a Violation:
    skipping an op would let a rewrite smuggle unvetted arithmetic past
    the value pass."""


class _Uninit:
    """The content of an element no op wrote (an `empty` tensor's)."""

    def __repr__(self):
        return "<uninitialized>"


UNINIT = _Uninit()


# -- exact value conversion ----------------------------------------------------

def _exact_scalar(v):
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    return int(v)


_EXACTIFY = np.frompyfunc(_exact_scalar, 1, 1)


def to_exact(x):
    """Tensor / numpy array / scalar -> object ndarray of Python ints
    (bools for bool tensors). Floats are refused: nothing in a kernel
    graph is a float."""
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point:
            raise UnsupportedOp("floating-point tensor %s" % (x.dtype,))
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype == object:
        return a.copy()
    if a.dtype.kind == "f":
        raise UnsupportedOp("floating-point value %s" % (a.dtype,))
    return np.asarray(_EXACTIFY(a), dtype=object).reshape(a.shape)


def _obj(x):
    return np.asarray(x, dtype=object)


def _ew(fn, *xs):
    """Elementwise with numpy broadcasting over object arrays."""
    xs = [_obj(x) for x in xs]
    return np.asarray(np.frompyfunc(fn, len(xs), 1)(*xs), dtype=object)


elementwise = _ew   # public alias for contract builders


def _dtype_range(dtype):
    if dtype == torch.bool:
        return 0, 1
    info = torch.iinfo(dtype)
    return int(info.min), int(info.max)


def _to_torch(a, dtype):
    """Exact object array -> a tensor of dtype (index operands); the
    values must fit."""
    if dtype == torch.bool:
        return torch.from_numpy(np.asarray(a, dtype=bool).copy())
    return torch.from_numpy(np.asarray(a, dtype=np.int64).copy()).to(dtype)


# -- exact scalar ops matching torch's integer semantics ----------------------

def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _fmod(a, b):
    return a - _trunc_div(a, b) * b


def _not(v):
    return (not v) if isinstance(v, bool) else ~v


_BINARY = {
    "mul": operator.mul,
    "bitwise_and": operator.and_, "__and__": operator.and_,
    "bitwise_or": operator.or_, "__or__": operator.or_,
    "bitwise_xor": operator.xor, "__xor__": operator.xor,
    "__rshift__": operator.rshift, "bitwise_right_shift": operator.rshift,
    "__lshift__": operator.lshift, "bitwise_left_shift": operator.lshift,
    "maximum": max, "minimum": min,
    "floor_divide": operator.floordiv, "remainder": operator.mod,
    "fmod": _fmod,
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "logical_and": lambda a, b: bool(a) and bool(b),
    "logical_or": lambda a, b: bool(a) or bool(b),
    "logical_xor": lambda a, b: bool(a) != bool(b),
}

_UNARY = {
    "neg": operator.neg, "abs": abs, "bitwise_not": _not,
    "logical_not": lambda v: not v,
}


def _subst(x, f, counter):
    """x with every leaf replaced by f(its index in _leaves order, leaf)."""
    if isinstance(x, (tuple, list)):
        return (list if isinstance(x, list) else tuple)(
            _subst(y, f, counter) for y in x)
    if isinstance(x, dict):
        return {k: _subst(v, f, counter) for k, v in x.items()}
    i = counter[0]
    counter[0] += 1
    return f(i, x)


# -- the interpreter -----------------------------------------------------------

class ExactInterpreter:
    """Evaluate a bounds.Graph exactly on object arrays of Python ints."""

    def __init__(self, kernel_name):
        self.kernel = kernel_name

    def run(self, graph, in_vals):
        self.g = graph
        env = {}
        if len(graph.inputs) != len(in_vals):
            raise UnsupportedOp("arity mismatch: %d inputs, %d values"
                                % (len(graph.inputs), len(in_vals)))
        for s, v in zip(graph.inputs, in_vals):
            env[s.i] = to_exact(v)
        for i, t in graph.consts.items():
            env[i] = to_exact(t)
        for node in graph.nodes:
            try:
                outs = self._node(node, env)
            except TypeError as e:
                if "_Uninit" in str(e):
                    raise UnsupportedOp("%s reads an element no op wrote "
                                        "(uninitialized memory)" % node.op)
                raise
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for s, v in zip(node.out_slots(), outs):
                env[s.i] = _obj(v)
        return [env[s.i] for s in graph.outputs]

    # -- helpers ---------------------------------------------------------------

    def _meta(self, slot):
        return self.g.meta[slot.i]

    def _checked(self, node, v, i=0):
        """Report (never wrap) a result that leaves its dtype."""
        dtype, shape = self._meta(node.out_slots()[i])
        if dtype.is_floating_point or dtype.is_complex:
            raise UnsupportedOp("%s: a floating-point result (%s) has no "
                                "exact integer value" % (node.op, dtype))
        v = _obj(v)
        if dtype == torch.bool:
            return _ew(bool, v)
        if v.size:
            lo, hi = _dtype_range(dtype)
            flat = v.reshape(-1)
            mn, mx = min(flat), max(flat)
            if mn < lo or mx > hi:
                raise UnsupportedOp(
                    "%s: result in [%d, %d] leaves %s [%d, %d] (the machine "
                    "would wrap)" % (node.op, mn, mx, str(dtype).replace(
                        "torch.", ""), lo, hi))
        return np.broadcast_to(v, shape).copy() if v.shape != shape else v

    # -- dispatch --------------------------------------------------------------

    def _node(self, node, env):
        name = node.name
        slots = [a for a in _leaves((node.args, node.kwargs))
                 if isinstance(a, Slot)]

        def get(x):
            return env[x.i]
        args = _map(get, Slot, node.args)
        kw = _map(get, Slot, node.kwargs)
        fill = self._creation(node, args, kw)
        if fill is not None:
            dtype, shape = self._meta(node.out_slots()[0])
            out = np.empty(shape, dtype=object)
            out[...] = fill
            return out if fill is UNINIT else self._checked(node, out)
        if not slots:
            # arange and the other creations of a recorded constant
            return [to_exact(self.g.static[s.i]) for s in node.out_slots()]
        if name in ("add", "sub", "rsub"):
            a, b = args[0], args[1]
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            if name == "add":
                r = _ew(lambda x, y: x + alpha * y, a, b)
            elif name == "sub":
                r = _ew(lambda x, y: x - alpha * y, a, b)
            else:
                r = _ew(lambda x, y: y - alpha * x, a, b)
            return self._checked(node, r)
        if name in _BINARY:
            return self._checked(node, _ew(_BINARY[name], args[0], args[1]))
        if name in _UNARY:
            return self._checked(node, _ew(_UNARY[name], args[0]))
        if name in _MOVE or name in ("cat", "stack") or (
                name in _SCATTER_SRC and not self._accumulating(node, args,
                                                                kw)):
            return self._move(node, env)
        handler = getattr(self, "_p_" + name.lstrip("_"), None)
        if handler is None:
            raise UnsupportedOp("unhandled aten op '%s' in exact "
                                "evaluation" % node.op)
        return handler(node, args, kw)

    def _creation(self, node, args, kw):
        """The fill value of a creation op (UNINIT for an empty tensor),
        else None."""
        name = node.name
        if name in _EMPTY_OPS:
            return UNINIT
        if name in _ZEROS:
            return 0
        if name in _ONES:
            return 1
        if name in _FULL:
            v = args[_FULL[name]] if len(args) > _FULL[name] \
                else kw["fill_value"]
            return v
        return None

    def _accumulating(self, node, args, kw):
        return node.name == "index_put" and (
            args[3] if len(args) > 3 else kw.get("accumulate", False))

    # -- data movement: the real op on position tensors ------------------------

    def _move(self, node, env):
        pool, offset = [], [0]

        def positions(slot):
            a = env[slot.i]
            pool.append(a.reshape(-1))
            t = torch.arange(offset[0], offset[0] + a.size,
                             dtype=torch.int64).reshape(a.shape)
            offset[0] += a.size
            return t

        data = self._data_positions(node)

        def sub(i, x):
            if not isinstance(x, Slot):
                return x
            if i in data:
                return positions(x)
            return _to_torch(env[x.i], self._meta(x)[0])
        args, kwargs = _subst((node.args, node.kwargs), sub, [0])
        out = node.op(*args, **kwargs)
        whole = np.concatenate(pool) if pool else np.empty(0, dtype=object)
        return [whole[p.numpy()] for p in _leaves(out)
                if isinstance(p, torch.Tensor)]

    def _data_positions(self, node):
        """Flat-leaf indices of the operands that carry data (the rest,
        index tensors and masks, run with their real values)."""
        flat = _leaves((node.args, node.kwargs))
        slots = [i for i, x in enumerate(flat) if isinstance(x, Slot)]
        name = node.name
        if name in ("cat", "stack"):
            n = len(node.args[0])
            return set(slots[:n])
        if name in _SCATTER_SRC:
            # the base and the source; index tensors in between are real
            pos = _SCATTER_SRC[name]
            leaves_before = len(_leaves(list(node.args[:pos])))
            return {0, leaves_before}
        return {slots[0]} if slots else set()

    # -- conversions -----------------------------------------------------------

    def _p_to_copy(self, node, args, kw):
        dtype, _ = self._meta(node.out_slots()[0])
        x = _obj(args[0])
        if dtype == torch.bool:
            return _ew(lambda v: bool(v != 0), x)
        return self._checked(node, _ew(int, x))

    def _p_copy(self, node, args, kw):
        dtype, shape = self._meta(node.out_slots()[0])
        src = np.broadcast_to(_obj(args[1]), shape).copy()
        if dtype == torch.bool:
            return _ew(lambda v: bool(v != 0), src)
        return self._checked(node, _ew(int, src))

    def _p_fill(self, node, args, kw):
        _, shape = self._meta(node.out_slots()[0])
        v = _obj(args[1]).reshape(-1)[0] if isinstance(
            args[1], np.ndarray) else args[1]
        out = np.empty(shape, dtype=object)
        out[...] = v
        return self._checked(node, out)

    def _p_where(self, node, args, kw):
        cond, x, y = args[0], args[1], args[2]
        _, shape = self._meta(node.out_slots()[0])
        c = np.broadcast_to(_obj(cond), shape)
        xs = np.broadcast_to(_obj(x), shape)
        ys = np.broadcast_to(_obj(y), shape)
        out = np.empty(shape, dtype=object)
        flat_c, fx, fy, fo = c.reshape(-1), xs.reshape(-1), ys.reshape(-1), \
            out.reshape(-1)
        for i in range(fo.size):
            fo[i] = fx[i] if flat_c[i] else fy[i]
        return self._checked(node, out)

    def _p_masked_fill(self, node, args, kw):
        x, mask, v = args[0], args[1], args[2]
        if isinstance(v, np.ndarray):
            v = v.reshape(-1)[0]
        return self._checked(node, _ew(lambda a, m: v if m else a, x, mask))

    def _p_constant_pad_nd(self, node, args, kw):
        x = _obj(args[0])
        pad = list(args[1])
        value = args[2] if len(args) > 2 else kw.get("value", 0)
        pos = torch.arange(x.size, dtype=torch.int64).reshape(x.shape)
        out = torch.nn.functional.pad(pos, pad, value=x.size)
        pool = np.concatenate([x.reshape(-1), _obj([value])])
        return self._checked(node, pool[out.numpy()])

    def _p_clamp(self, node, args, kw):
        x = _obj(args[0])
        lo = args[1] if len(args) > 1 else kw.get("min")
        hi = args[2] if len(args) > 2 else kw.get("max")
        if lo is not None:
            x = _ew(max, x, lo)
        if hi is not None:
            x = _ew(min, x, hi)
        return self._checked(node, x)

    def _p_clamp_min(self, node, args, kw):
        return self._checked(node, _ew(max, args[0], args[1]))

    def _p_clamp_max(self, node, args, kw):
        return self._checked(node, _ew(min, args[0], args[1]))

    def _p_div(self, node, args, kw):
        mode = kw.get("rounding_mode", args[2] if len(args) > 2 else None)
        if mode == "floor":
            return self._checked(node, _ew(operator.floordiv, args[0],
                                           args[1]))
        if mode == "trunc":
            return self._checked(node, _ew(_trunc_div, args[0], args[1]))
        raise UnsupportedOp("true division has no exact integer value")

    # -- reductions ------------------------------------------------------------

    def _dims(self, x, dims):
        if dims is None or dims == [] or dims == ():
            return tuple(range(x.ndim))
        if isinstance(dims, int):
            return (dims,)
        return tuple(dims)

    def _p_sum(self, node, args, kw):
        x = _obj(args[0])
        dims = args[1] if len(args) > 1 and not isinstance(args[1], bool) \
            else kw.get("dim")
        keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
        r = np.sum(x, axis=self._dims(x, dims), keepdims=keep)
        return self._checked(node, _obj(r))

    def _p_cumsum(self, node, args, kw):
        x = _obj(args[0])
        dim = args[1] if len(args) > 1 else kw["dim"]
        return self._checked(node, _obj(np.cumsum(x, axis=dim)))

    def _p_any(self, node, args, kw):
        x = _obj(args[0])
        dims = args[1] if len(args) > 1 else kw.get("dim")
        return self._checked(node, _obj(np.any(
            _ew(bool, x), axis=self._dims(x, dims))))

    def _p_all(self, node, args, kw):
        x = _obj(args[0])
        dims = args[1] if len(args) > 1 else kw.get("dim")
        return self._checked(node, _obj(np.all(
            _ew(bool, x), axis=self._dims(x, dims))))


# -- entry points --------------------------------------------------------------

def run_exact(graph, args):
    """Evaluate a traced graph (bounds.trace) exactly on the arguments'
    values (tensors or arrays); returns the flattened outputs as object
    arrays of Python ints."""
    return ExactInterpreter("run_exact").run(graph, list(args))


def _card_outputs(kernel, args, device):
    """Run a card entry on the arguments moved to `device`; its outputs
    back on the host as exact object arrays."""
    dev_args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                     for a in args)
    out = kernel(*dev_args)
    torch.cuda.synchronize(device)
    return [to_exact(t.cpu()) for t in _leaves(out)
            if isinstance(t, torch.Tensor)]


def check_value(name, fn, sampler, contract, samples=2, seed=0,
                strict=True, device="cpu", kernel=None, graphs=None):
    """Hold `fn` to `contract` at `samples` seeded sample points; returns
    a list of Violations.

    device "cpu": `fn` (the plain version) is traced once at the sample
    shapes and the graph is evaluated exactly (run_exact). device "cuda"
    (or "cuda:i"): `kernel` runs on the card on the same samples.
    sampler(rng) -> tuple of CPU tensors; contract(args, outs) -> error
    strings ([] when it holds); outs are object arrays of exact ints.
    `graphs` memoizes traces by argument shapes."""
    violations = []
    graphs = {} if graphs is None else graphs
    for s in range(samples):
        rng = np.random.default_rng((seed << 16) ^ (0x5eed + s))
        args = tuple(sampler(rng))
        try:
            if torch.device(device).type == "cuda":
                outs = _card_outputs(kernel, args, device)
            else:
                key = tuple((tuple(a.shape), a.dtype) for a in args)
                g = graphs.get(key)
                if g is None:
                    g = graphs[key] = trace(fn, args)
                outs = run_exact(g, args)
        except (UnsupportedOp, TraceDiverged) as e:
            if strict:
                violations.append(Violation(name, "value", str(e),
                                            "sample %d" % s))
            return violations
        for msg in (contract(args, outs) or ()):
            violations.append(Violation(name, "value", msg, "sample %d" % s))
    return violations


# -- value algebra helpers -----------------------------------------------------

def col_value(cols, bits=32, axis=0):
    """sum_i cols[i] * 2^(bits*i) along `axis`, exactly (columns may
    exceed `bits` bits). Returns an object array shaped like cols minus
    `axis`."""
    a = np.moveaxis(_obj(cols), axis, 0)
    out = np.empty(a.shape[1:], dtype=object)
    out[...] = 0
    for i in range(a.shape[0]):
        out = out + _ew(int, a[i]) * (1 << (bits * i))
    return out


def word_value(words, axis=0):
    """The value of (L, ...) 32-bit words held as int32 bit patterns (or
    as unsigned ints): sum_i (w_i mod 2^32) * 2^(32 i)."""
    return col_value(_ew(lambda w: int(w) & 0xFFFFFFFF, words), 32, axis)


def words_from_int(v, n_words):
    """An int -> its `n_words` little-endian 32-bit words (np.uint32)."""
    return np.array([(int(v) >> (32 * i)) & 0xFFFFFFFF
                     for i in range(n_words)], dtype=np.uint32)


def word_tensor(values, n_words, shape=None):
    """Ints -> an int32 (n_words, len) word tensor (the same bits)."""
    arr = np.stack([words_from_int(v, n_words) for v in values], axis=1)
    t = torch.from_numpy(arr.view(np.int32).copy())
    return t if shape is None else t.reshape((n_words,) + tuple(shape))


def rand_fe(rng, p):
    """Uniform field element below p from a seeded Generator (composed
    from bytes: numpy draws no 255-bit ints)."""
    nbytes = (p.bit_length() + 7) // 8 + 8
    return int.from_bytes(bytes(rng.integers(0, 256, nbytes,
                                             dtype=np.uint8)),
                          "little") % p


def mont_r(spec):
    """The Montgomery radix R = 2^(32 * n_words) of a field spec."""
    return 1 << (32 * spec.n_words)


def mismatch_report(tag, got, want, mod=None):
    """Compare two object arrays of ints (optionally mod `mod`); [] when
    equal, else one message naming the first bad lane."""
    g, w = _obj(got), _obj(want)
    if mod is not None:
        g = _ew(lambda v: int(v) % mod, g)
        w = _ew(lambda v: int(v) % mod, w)
    if g.shape != w.shape:
        return ["%s: shape mismatch %s vs %s" % (tag, g.shape, w.shape)]
    bad = np.argwhere(_ew(operator.ne, g, w).astype(bool))
    if not len(bad):
        return []
    at = tuple(int(x) for x in bad[0])
    return ["%s: value mismatch at lane %s: got %s, want %s (%d/%d lanes "
            "differ)" % (tag, at, g[at], w[at], len(bad), g.size)]
