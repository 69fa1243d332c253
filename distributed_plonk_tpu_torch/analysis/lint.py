"""AST-level hazard lints over the port's package (the counterpart of the
JAX package's analysis/lint.py; the lock, glossary and tag rules are its
copies, scoped to distributed_plonk_tpu_torch/).

CACHE01 cache key (JIT01's counterpart): a value stored in a module or
    instance cache (`_PLANS[key] = ...`, `self._tables[key] = ...`,
    `self._cache_put(cache, key, value)`, `self._cached(cache, key,
    build)`) whose construction depends on a function parameter the key
    does not determine: two calls that differ only there share one
    cached value. Derivability is tracked through simple local
    assignments (`max_log_rows, tile = plan_params(n, max_log_rows,
    tile)` keeps both key-derived when the key holds them); `self` and
    module globals are allowed. A nested `functools.lru_cache` function
    that reads an enclosing function's local is the same hazard (the
    local is not part of its key).

PROM01/PROM02 float promotion (backend/*_torch.py, the plain kernels): a
    float literal in tensor arithmetic (`x * 2.0` makes an int64 word
    tensor float), and any float dtype (`torch.float64`, `.double()`,
    ...): the word and limb pipeline is integer end to end.

LOCK01/LOCK02/LOCK03 lock discipline and lock order (service/, store/,
    runtime/, obs/, parallel/, circuits/, prover.py, aggregate.py,
    backend/_build.py): a self attribute of a class that owns a lock
    mutated both inside and outside `with self._lock` (LOCK01), or
    mutated outside it while another method reads it under it (LOCK02);
    a cycle in the may-hold-while-acquiring graph over (class, lock)
    nodes, or a non-reentrant lock re-acquired while held (LOCK03).
    Helper methods whose intra-class call sites are all lock-held count
    as lock-held; `Condition(lock)` aliases the wrapped lock; cross-class
    edges are matched by method name.

OBS01 metric glossary (same scope): a metric recorded by a string literal
    `.inc("name")` / `.observe("name")` must be documented in the port's
    service/metrics.py docstring glossary.

LOG01 log subsystems (same scope): the `subsystem` literal of every
    structured-log `emit("subsystem", ...)` must be documented in the
    port's obs/log.py docstring glossary.

ENV01 environment reads (the whole package): the port's settings are
    constants and arguments, so ANY read of the environment
    (`os.environ`, `os.getenv`, `environb`) is a finding.

TAG01 wire-tag conformance: every tag of the port's runtime/protocol.py
    TAG_NAMES must be referenced by a site in the port outside
    protocol.py and by a tests/test_torch_*.py file.

Suppression: `# analysis: ok(<reason>)` on the flagged line or the line
above it (for LOCK03 on any edge of the cycle, for TAG01 on the tag's
assignment line).
"""

import ast
import os
import re

PRAGMA_RE = re.compile(r"#\s*analysis:\s*ok\(([^)]*)\)")

_REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
_PKG = os.path.join(_REPO, "distributed_plonk_tpu_torch")

# the cache-key lint's scope (module and instance caches of plans, tables,
# contexts)
CACHE_DIRS = ("backend", "parallel", "runtime")
# modules with cross-thread shared state: the lock lints run here (entries
# ending in ".py" are single modules)
LOCK_DIRS = ("service", "store", "runtime", "obs", "parallel", "circuits",
             "prover.py", "aggregate.py", os.path.join("backend", "_build.py"))
# modules that record metrics and structured logs
OBS_DIRS = LOCK_DIRS

# mutating container-method names treated as writes by LOCK01 (calls on
# self.<attr>.<name>(...)); read-only or thread-safe APIs (queue.put,
# event.set) are deliberately absent
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "setdefault", "move_to_end", "sort",
             "add", "discard"}


class Finding:
    def __init__(self, path, line, code, message):
        self.path = path
        self.line = line
        self.code = code
        self.message = message

    def __str__(self):
        rel = os.path.relpath(self.path, _REPO) if os.path.isabs(
            self.path) else self.path
        return "%s:%d: %s: %s" % (rel, self.line, self.code, self.message)


def _pragma_lines(src):
    """Line numbers (1-based) carrying an `# analysis: ok(...)` pragma."""
    out = set()
    for i, line in enumerate(src.splitlines(), start=1):
        if PRAGMA_RE.search(line):
            out.add(i)
    return out


def _suppressed(pragmas, line):
    return line in pragmas or (line - 1) in pragmas


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _self_attr(node):
    """'self.x' -> 'x' (walking through subscripts: self.x[k] -> 'x')."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None



# --- LOCK01: lock discipline --------------------------------------------------

def _lock_attrs(cls):
    """Attrs assigned threading.Lock()/RLock() anywhere in the class."""
    out = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                (f.id if isinstance(f, ast.Name) else None)
            if name in ("Lock", "RLock"):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr:
                        out.add(attr)
    return out


def _with_lock_ranges(method, locks):
    """(start, end) line ranges of `with self.<lock>` bodies."""
    ranges = []
    for node in ast.walk(method):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in locks:
                end = max(getattr(n, "end_lineno", n.lineno)
                          for n in node.body)
                ranges.append((node.body[0].lineno
                               if node.body else node.lineno, end))
                break
    return ranges


def _flat_targets(targets):
    """Assignment targets with tuple/list unpacking flattened."""
    out = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_flat_targets(t.elts))
        else:
            out.append(t)
    return out


def _writes_in(method):
    """[(attr, line)] of self-attribute mutations in a method."""
    out = []
    for node in ast.walk(method):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in _flat_targets(targets):
                attr = _self_attr(t)
                if attr:
                    out.append((attr, node.lineno,
                                isinstance(t, ast.Subscript)))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for t in _flat_targets([node.target]):
                attr = _self_attr(t)
                if attr:
                    out.append((attr, node.lineno, False))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr:
                    out.append((attr, node.lineno, True))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr:
                out.append((attr, node.lineno, True))
    return out


def _reads_in(method):
    """[(attr, line)] of self-attribute loads in a method."""
    out = []
    for node in ast.walk(method):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load):
            attr = _self_attr(node)
            if attr:
                out.append((attr, node.lineno))
    return out


def _method_calls(method):
    """Names of self.<m>(...) calls made by a method, with lines."""
    out = []
    for node in ast.walk(method):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            out.append((node.func.attr, node.lineno))
    return out


def _lint_locks(tree, path, src, findings):
    pragmas = _pragma_lines(src)
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, ast.FunctionDef)}
        ranges = {name: _with_lock_ranges(m, locks)
                  for name, m in methods.items()}

        def _in_lock(name, line):
            return any(a <= line <= b for a, b in ranges.get(name, ()))

        # fixpoint: a method is lock-held if every intra-class call site
        # is inside a lock scope or in a lock-held method (__init__ and
        # the lock-holding frames count as held: single-threaded
        # construction / already-serialized)
        held = {"__init__"}
        callers = {}  # method -> [(caller, line)]
        for name, m in methods.items():
            for callee, line in _method_calls(m):
                callers.setdefault(callee, []).append((name, line))
        changed = True
        while changed:
            changed = False
            for name in methods:
                if name in held or name not in callers:
                    continue
                if all(caller in held or _in_lock(caller, line)
                       for caller, line in callers[name]):
                    held.add(name)
                    changed = True

        locked_writers = {}    # attr -> first locked write line
        locked_readers = {}    # attr -> first locked read line
        unlocked_writers = {}  # attr -> [(method, line)]
        for name, m in methods.items():
            if name == "__init__":
                continue
            for attr, line, _sub in _writes_in(m):
                if attr in locks:
                    continue
                if name in held or _in_lock(name, line):
                    locked_writers.setdefault(attr, line)
                else:
                    unlocked_writers.setdefault(attr, []).append(
                        (name, line))
            for attr, line in _reads_in(m):
                if attr not in locks \
                        and (name in held or _in_lock(name, line)):
                    locked_readers.setdefault(attr, line)

        for attr, sites in unlocked_writers.items():
            if attr in locked_writers:
                code, other = "LOCK01", ("written under `with self.<lock>`"
                                         f" at line {locked_writers[attr]}")
            elif attr in locked_readers:
                code, other = "LOCK02", ("read under `with self.<lock>` at"
                                         f" line {locked_readers[attr]}")
            else:
                continue
            for method, line in sites:
                if _suppressed(pragmas, line):
                    continue
                findings.append(Finding(
                    path, line, code,
                    f"{cls.name}.{attr} is {other} but mutated without "
                    f"the lock in {method}()"))


# --- LOCK03: lock-acquisition-order graph -------------------------------------

# lock-object methods: calls on these never descend into user code, so a
# held call to them is not an acquisition edge
_LOCK_OBJ_METHODS = {"acquire", "release", "locked", "notify", "notify_all",
                     "wait", "wait_for"}

# method names that collide with builtin container/string/IO protocols:
# excluded from cross-class NAME matching (a held `d.get(k)` on a plain
# dict must not edge into every class exposing a locked `get`). A held
# call through one of these names onto a real linted object is the
# lint's known blind spot — such APIs get reviewed manually.
_GENERIC_METHODS = {"get", "put", "pop", "popitem", "keys", "values",
                    "items", "update", "setdefault", "clear", "copy",
                    "append", "extend", "insert", "remove", "sort",
                    "index", "count", "add", "discard", "split", "join",
                    "strip", "format", "encode", "decode", "read",
                    "write", "close", "flush", "readline", "seek",
                    "load", "loads", "dump", "dumps", "send", "recv"}


def _lock_kinds(cls):
    """({attr: 'Lock'|'RLock'|'Condition'}, {alias_attr: lock_attr}) for
    a class: attrs assigned threading.Lock()/RLock()/Condition() anywhere
    in the class body. `Condition(self._lock)` does not mint a new lock —
    acquiring the condition IS acquiring the wrapped lock, so it is
    recorded as an alias."""
    kinds, aliases = {}, {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                (f.id if isinstance(f, ast.Name) else None)
            if name not in ("Lock", "RLock", "Condition"):
                continue
            wrapped = _self_attr(node.value.args[0]) \
                if name == "Condition" and node.value.args else None
            for t in node.targets:
                attr = _self_attr(t)
                if not attr:
                    continue
                if wrapped is not None:
                    aliases[attr] = wrapped
                else:
                    kinds[attr] = name
    # an alias of an unknown lock (Condition over a parameter) counts as
    # its own plain lock
    for a, w in list(aliases.items()):
        if w not in kinds:
            del aliases[a]
            kinds[a] = "Condition"
    return kinds, aliases


def _collect_lock_graph(tree, path, src):
    """Per-class acquisition records for LOCK03 from one module. The
    graph itself is assembled globally (cross-file, cross-class) by
    _lock_graph_findings once every module in scope is collected."""
    pragmas = _pragma_lines(src)
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        kinds, aliases = _lock_kinds(cls)
        if not kinds:
            continue
        rec = {"name": cls.name, "path": path, "pragmas": pragmas,
               "kinds": kinds, "methods": {}}
        for m in cls.body:
            if not isinstance(m, ast.FunctionDef):
                continue

            def canon(expr_attr):
                return aliases.get(expr_attr, expr_attr)

            ranges = {}  # lock attr -> [(body start, body end)]
            for node in ast.walk(m):
                if not isinstance(node, ast.With) or not node.body:
                    continue
                end = max(getattr(n, "end_lineno", n.lineno)
                          for n in node.body)
                for item in node.items:
                    attr = canon(_self_attr(item.context_expr))
                    if attr in kinds:
                        ranges.setdefault(attr, []).append(
                            (node.body[0].lineno, end))

            def held(line):
                return {a for a, rs in ranges.items()
                        if any(s <= line <= e for s, e in rs)}

            with_edges, held_calls, self_calls, attr_calls = [], [], [], []
            for node in ast.walk(m):
                if isinstance(node, ast.With):
                    h, here = held(node.lineno), []
                    for item in node.items:
                        attr = canon(_self_attr(item.context_expr))
                        if attr not in kinds:
                            continue
                        for prev in sorted(h) + here:
                            with_edges.append((prev, attr, node.lineno))
                        here.append(attr)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr not in _LOCK_OBJ_METHODS:
                    is_self = isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self"
                    # cross-class candidates are SIMPLE chains only —
                    # `obj.m()` / `self.attr.m()`; a subscripted chain
                    # (`self._table[k].get(...)`) is container traffic,
                    # and name-matching dict/list protocol calls against
                    # class APIs would flood the graph with false edges
                    simple = isinstance(node.func.value,
                                        (ast.Name, ast.Attribute))
                    if is_self:
                        self_calls.append((node.func.attr, node.lineno))
                    elif simple:
                        attr_calls.append((node.func.attr, node.lineno))
                    h = held(node.lineno)
                    if h and (is_self or simple):
                        held_calls.append((node.func.attr, is_self,
                                           frozenset(h), node.lineno))
            rec["methods"][m.name] = {
                "direct": set(ranges), "with_edges": with_edges,
                "held_calls": held_calls, "self_calls": self_calls,
                "attr_calls": attr_calls}
        out.append(rec)
    return out


def _lock_graph_findings(class_infos):
    """Assemble the global may-hold-while-acquiring graph and report one
    LOCK03 finding per cycle (strongly connected component, or self-edge
    on a non-reentrant lock)."""
    # per-class transitive acquires: locks a method may take through its
    # intra-class self-call closure (fixpoint); the same closure carries
    # the method names it calls on OTHER objects, so a helper invoked
    # under a lock still contributes its outbound cross-class calls
    for rec in class_infos:
        methods = rec["methods"]
        trans = {n: set(m["direct"]) for n, m in methods.items()}
        ext = {n: {c for c, _l in m["attr_calls"]}
               for n, m in methods.items()}
        changed = True
        while changed:
            changed = False
            for n, m in methods.items():
                for callee, _line in m["self_calls"]:
                    extra = trans.get(callee, set()) - trans[n]
                    extra_ext = ext.get(callee, set()) - ext[n]
                    if extra or extra_ext:
                        trans[n] |= extra
                        ext[n] |= extra_ext
                        changed = True
        rec["trans"] = trans
        rec["ext"] = ext

    # method-name index for cross-class edges (no type inference: a held
    # call `obj.submit(...)` edges into every linted class whose `submit`
    # may acquire a lock)
    by_method = {}
    for rec in class_infos:
        for mname, acquired in rec["trans"].items():
            if acquired:
                by_method.setdefault(mname, []).append((rec, acquired))

    def name_targets(callee):
        if callee in _GENERIC_METHODS:
            return []
        return [(rec2, lock) for rec2, locks in by_method.get(callee, ())
                for lock in locks]

    edges = {}  # (src, dst) -> (path, line, suppressed)

    def add_edge(src_rec, src_attr, dst_node, line, path, pragmas):
        src = (src_rec["name"], src_attr)
        if src == dst_node \
                and src_rec["kinds"].get(src_attr) == "RLock":
            return  # re-entrant re-acquisition is fine
        key = (src, dst_node)
        if key not in edges:
            edges[key] = (path, line, _suppressed(pragmas, line))

    for rec in class_infos:
        for m in rec["methods"].values():
            for a, b, line in m["with_edges"]:
                add_edge(rec, a, (rec["name"], b), line,
                         rec["path"], rec["pragmas"])
            for callee, is_self, held, line in m["held_calls"]:
                # name matches back into the SAME class are dropped: the
                # receiver is not self (a helper object whose method name
                # collides with the class API — Histogram.snapshot vs
                # Metrics.snapshot), and intra-class edges are already
                # covered precisely by the self./trans path
                if is_self:
                    # everything the callee may acquire: its own class's
                    # locks plus its outbound calls' name matches
                    targets = [(rec["name"], lock)
                               for lock in rec["trans"].get(callee, ())]
                    for name in rec["ext"].get(callee, ()):
                        targets += [(r2["name"], lock)
                                    for r2, lock in name_targets(name)
                                    if r2 is not rec]
                else:
                    targets = [(r2["name"], lock)
                               for r2, lock in name_targets(callee)
                               if r2 is not rec]
                for h in held:
                    for dst in targets:
                        add_edge(rec, h, dst, line,
                                 rec["path"], rec["pragmas"])

    graph = {}
    for (src, dst) in edges:
        graph.setdefault(src, set()).add(dst)
        graph.setdefault(dst, set())

    # Tarjan SCC (graphs here are tiny; recursion depth is bounded by
    # the node count)
    index_of, low, stack, on_stack, sccs = {}, {}, [], set(), []

    def strongconnect(v, counter=[0]):
        index_of[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in graph.get(v, ()):
            if w not in index_of:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index_of[w])
        if low[v] == index_of[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for v in graph:
        if v not in index_of:
            strongconnect(v)

    findings = []
    for comp in sccs:
        comp_set = set(comp)
        if len(comp) == 1:
            v = comp[0]
            if (v, v) not in edges:
                continue
            cycle = [v, v]
        else:
            # shortest representative cycle from one node back to itself
            # through the component
            start = min(comp_set)
            prev, frontier, seen = {}, [start], {start}
            cycle = None
            while frontier and cycle is None:
                nxt = []
                for u in frontier:
                    for w in graph.get(u, ()):
                        if w == start:
                            cycle = [start]
                            node = u
                            while node != start:
                                cycle.append(node)
                                node = prev[node]
                            cycle.append(start)
                            cycle.reverse()
                            break
                        if w in comp_set and w not in seen:
                            seen.add(w)
                            prev[w] = u
                            nxt.append(w)
                    if cycle:
                        break
                frontier = nxt
            if cycle is None:
                continue  # unreachable for a true SCC
        sites = [edges[(cycle[i], cycle[i + 1])]
                 for i in range(len(cycle) - 1)]
        if any(sup for _p, _l, sup in sites):
            continue  # a pragma on any edge breaks the cycle
        names = " -> ".join(f"{c}.{a}" for c, a in cycle)
        where = "; ".join(f"{os.path.relpath(p, _REPO)}:{line}"
                          for p, line, _s in sites)
        path, line, _s = sites[0]
        if len(cycle) == 2 and cycle[0] == cycle[1]:
            msg = (f"non-reentrant lock {names.split(' -> ')[0]} may be "
                   f"re-acquired while already held (self-deadlock); "
                   f"acquisition sites: {where}")
        else:
            msg = (f"lock-order cycle {names}: two threads taking these "
                   f"locks in opposite orders deadlock; acquisition "
                   f"sites: {where}")
        findings.append(Finding(path, line, "LOCK03", msg))
    return findings



# --- CACHE01: cache keys ------------------------------------------------------

def _free_names(expr):
    """Names an expression reads, minus those bound inside it (lambda
    parameters, comprehension targets)."""
    bound = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Lambda):
            a = node.args
            bound |= {x.arg for x in a.args + a.kwonlyargs + a.posonlyargs}
        elif isinstance(node, ast.comprehension):
            bound |= _names_in(node.target)
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)
            and isinstance(n.ctx, ast.Load)} - bound


def _local_deps(fn):
    """name -> names it was computed from, for assignments in `fn`'s body
    (tuple targets map each name to the whole right side; no control-flow
    sensitivity)."""
    deps = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            src = _free_names(node.value)
            for t in node.targets:
                for n in _names_in(t):
                    if isinstance(t, (ast.Name, ast.Tuple, ast.List)):
                        deps.setdefault(n, set()).update(src)
        elif isinstance(node, (ast.For, ast.comprehension)):
            for n in _names_in(node.target):
                deps.setdefault(n, set()).update(_free_names(node.iter))
    return deps


def _transitive(names, deps, limit=32):
    out = set(names)
    for _ in range(limit):
        grew = False
        for n in list(out):
            for d in deps.get(n, ()):
                if d not in out:
                    out.add(d)
                    grew = True
        if not grew:
            break
    return out


def _def_free_names(fdef):
    """Free names of a nested function: read in its body, not its own
    parameters or locals."""
    a = fdef.args
    bound = {x.arg for x in a.args + a.kwonlyargs + a.posonlyargs}
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for node in ast.walk(fdef):
        if isinstance(node, (ast.Assign, ast.For)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                bound |= _names_in(t)
    free = set()
    for node in fdef.body:
        free |= _free_names(node) if isinstance(node, ast.expr) else {
            n.id for n in ast.walk(node) if isinstance(n, ast.Name)
            and isinstance(n.ctx, ast.Load)}
    return free - bound


def _looked_up(fn):
    """AST dumps of the containers `fn` looks a key up in: `X.get(k)`,
    `k in X` / `k not in X`, a subscript load `X[k]`."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "get":
            out.add(ast.dump(node.func.value))
        elif isinstance(node, ast.Compare):
            for op, right in zip(node.ops, node.comparators):
                if isinstance(op, (ast.In, ast.NotIn)):
                    out.add(ast.dump(right))
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load):
            out.add(ast.dump(node.value))
    return out


def _cache_writes(fn):
    """(line, key expr, value expr) of every cache write in `fn`: a
    subscript store into a module global or a self attribute that `fn`
    also looks keys up in (a memo, not a state table), and the
    _cache_put / _cached helpers' calls."""
    out = []
    looked = _looked_up(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and (
                        _self_attr(t) is not None
                        or isinstance(t.value, ast.Name)) \
                        and ast.dump(t.value) in looked:
                    out.append((node.lineno, t.slice, node.value, t))
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name == "_cache_put" and len(node.args) == 3:
                out.append((node.lineno, node.args[1], node.args[2], None))
            elif name == "_cached" and len(node.args) in (2, 3):
                key, build = node.args[-2], node.args[-1]
                out.append((node.lineno, key, build, None))
    return out


def _lint_cache_keys(tree, path, src, module_names, findings):
    pragmas = _pragma_lines(src)
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                  + fn.args.posonlyargs}
        deps = _local_deps(fn)
        local_defs = {n.name: _def_free_names(n) for n in ast.walk(fn)
                      if isinstance(n, ast.FunctionDef) and n is not fn}
        for line, key, value, target in _cache_writes(fn):
            if target is not None and isinstance(target.value, ast.Name) \
                    and target.value.id not in module_names:
                continue        # a local dict, not a cache
            names = _free_names(value)
            for n in list(names):
                if n in local_defs:
                    names |= local_defs[n]
            key_closure = _transitive(_free_names(key), deps)
            hazards = set()
            for n in sorted(names):
                if n == "self" or n in module_names or n in key_closure:
                    continue
                chain = _transitive({n}, deps)
                origins = {r for r in chain if r not in deps} or {n}
                hazards |= {r for r in origins
                            if r in params and r not in key_closure
                            and r != "self" and r not in module_names}
            if hazards and not _suppressed(pragmas, line):
                findings.append(Finding(
                    path, line, "CACHE01",
                    "cache write keyed on %s but the cached value also "
                    "depends on %s: a call differing only there reuses the "
                    "wrong value (add them to the key or derive them from "
                    "it)" % (sorted(_free_names(key)), sorted(hazards))))
        # a nested lru_cache function keyed on its arguments only
        for node in ast.walk(fn):
            if not (isinstance(node, ast.FunctionDef) and node is not fn
                    and _is_lru(node)):
                continue
            enclosing = (params | set(deps)) - module_names
            stale = sorted(_def_free_names(node) & enclosing)
            if stale and not _suppressed(pragmas, node.lineno):
                findings.append(Finding(
                    path, node.lineno, "CACHE01",
                    "lru_cache function %s reads %s of the enclosing "
                    "function, which its key does not hold"
                    % (node.name, stale)))


def _is_lru(fdef):
    for d in fdef.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name in ("lru_cache", "cache"):
            return True
    return False


# --- PROM01 / PROM02: float promotion -----------------------------------------

_FLOAT_DTYPES = {"float64", "float32", "float16", "bfloat16", "double",
                 "half", "float", "cfloat", "cdouble", "complex64",
                 "complex128"}


def _lint_promotion(tree, path, src, findings):
    pragmas = _pragma_lines(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) \
                        and isinstance(side.value, float):
                    other = node.right if side is node.left else node.left
                    if isinstance(other, ast.Constant):
                        continue  # constant folding, no tensor involved
                    if _suppressed(pragmas, node.lineno):
                        continue
                    findings.append(Finding(
                        path, node.lineno, "PROM01",
                        "float literal %r in kernel-module arithmetic: a "
                        "tensor operand becomes float (use an int, or mark "
                        "a host-only expression with # analysis: ok(...))"
                        % (side.value,)))
                    break
        elif isinstance(node, ast.Attribute) and (
                (node.attr in _FLOAT_DTYPES and isinstance(
                    node.value, ast.Name) and node.value.id == "torch")
                or node.attr in ("double", "half", "float64", "bfloat16")):
            if not _suppressed(pragmas, node.lineno):
                findings.append(Finding(
                    path, node.lineno, "PROM02",
                    "float dtype %s in a kernel module (the word and limb "
                    "pipeline is integer end to end)" % node.attr))


# --- OBS01: metric-name glossary ----------------------------------------------

_GLOSSARY_PATH = os.path.join(_PKG, "service", "metrics.py")
_GLOSSARY_TOKEN_RE = re.compile(r"[a-z][a-z0-9_/]*(?:\*)?")


def parse_glossary(doc):
    """(exact names, wildcard prefixes) from a glossary docstring: only the
    NAME COLUMN of indented entry lines (`    name [/ name...]  text`,
    >= 2 spaces before the description); `family_*` documents a prefix."""
    exact, prefixes = set(), []
    for line in doc.splitlines():
        if not line.startswith("    ") or not line.strip():
            continue
        name_col = re.split(r"\s{2,}", line.strip(), maxsplit=1)[0]
        for tok in _GLOSSARY_TOKEN_RE.findall(name_col):
            if tok.endswith("*"):
                prefixes.append(tok[:-1])
            else:
                exact.add(tok)
    return exact, tuple(prefixes)


def _docstring(path):
    with open(path) as f:
        return ast.get_docstring(ast.parse(f.read(), filename=path)) or ""


def _documented(name, glossary):
    exact, prefixes = glossary
    for n in (name, "store_" + name):  # scoped-registry publication
        if n in exact or any(n.startswith(p) for p in prefixes):
            return True
    return False


def _lint_obs(tree, path, src, findings, glossary):
    pragmas = _pragma_lines(src)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("inc", "observe")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        if _documented(name, glossary) or _suppressed(pragmas, node.lineno):
            continue
        findings.append(Finding(
            path, node.lineno, "OBS01",
            "metric %r is recorded here but absent from the port's "
            "service/metrics.py glossary: document it (or a matching "
            "`family_*` wildcard)" % name))


# --- LOG01: structured-log subsystem glossary ---------------------------------

_LOG_GLOSSARY_PATH = os.path.join(_PKG, "obs", "log.py")


def parse_log_glossary(doc):
    """Documented subsystem names: the first token of each indented entry
    line with >= 2 spaces before its description."""
    out = set()
    for line in (doc or "").splitlines():
        if not line.startswith("    ") or not line.strip():
            continue
        cols = re.split(r"\s{2,}", line.strip(), maxsplit=1)
        if len(cols) == 2 and re.fullmatch(r"[a-z][a-z0-9_]*", cols[0]):
            out.add(cols[0])
    return out


def _lint_log_subsystems(tree, path, src, findings, subsystems):
    pragmas = _pragma_lines(src)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            (f.id if isinstance(f, ast.Name) else None)
        if name != "emit" or not (
                node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        sub = node.args[0].value
        if sub in subsystems or _suppressed(pragmas, node.lineno):
            continue
        findings.append(Finding(
            path, node.lineno, "LOG01",
            "log subsystem %r is emitted here but absent from the port's "
            "obs/log.py subsystem glossary" % sub))


# --- ENV01: environment reads -------------------------------------------------

_ENV_ATTRS = ("environ", "environb", "getenv", "getenvb", "putenv",
              "unsetenv")


def _lint_env(tree, path, src, findings):
    """Any environment access: the port reads none by design."""
    pragmas = _pragma_lines(src)
    for node in ast.walk(tree):
        hit = (isinstance(node, ast.Attribute) and node.attr in _ENV_ATTRS) \
            or (isinstance(node, ast.Name) and node.id in _ENV_ATTRS
                and isinstance(node.ctx, ast.Load)) \
            or (isinstance(node, ast.ImportFrom) and node.module == "os"
                and any(a.name in _ENV_ATTRS for a in node.names))
        if hit and not _suppressed(pragmas, node.lineno):
            findings.append(Finding(
                path, node.lineno, "ENV01",
                "the environment is read here: the port's settings are "
                "constants and arguments"))


# --- TAG01: wire-tag conformance ----------------------------------------------

_PROTOCOL_PATH = os.path.join(_PKG, "runtime", "protocol.py")
_TESTS_DIR = os.path.join(_REPO, "tests")
# mirrors protocol.py's TAG_NAMES comprehension (non-tag uppercase ints)
_NON_TAG_CONSTS = ("FR_BYTES", "FQ_BYTES", "POINT_BYTES")


def protocol_tags(src):
    """{tag name: assignment line} of a protocol module's source, by AST
    as its TAG_NAMES comprehension selects them (the lint never imports
    the codec)."""
    tree = ast.parse(src)
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper() \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            consts[node.targets[0].id] = (node.value.value, node.lineno)
    err = consts.get("ERR", (101, 0))[0]
    return {name: line for name, (value, line) in consts.items()
            if 0 < value <= err and name not in _NON_TAG_CONSTS}


def _tag_refs_in(tree, tags):
    """Tag names a module references (protocol.NAME, or a bare NAME)."""
    refs = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in tags:
            refs.add(node.attr)
        elif isinstance(node, ast.Name) and node.id in tags:
            refs.add(node.id)
    return refs


def _port_tests_text():
    out = []
    if os.path.isdir(_TESTS_DIR):
        for fname in sorted(os.listdir(_TESTS_DIR)):
            if fname.startswith("test_torch_") and fname.endswith(".py"):
                with open(os.path.join(_TESTS_DIR, fname)) as f:
                    out.append(f.read())
    return "\n".join(out)


def tag_findings(protocol_src, code_refs, tests_text,
                 protocol_path=_PROTOCOL_PATH):
    """TAG01 findings of a protocol source: tags with no site in the port
    outside protocol.py (`code_refs`) or no reference in the port's tests
    (`tests_text`)."""
    pragmas = _pragma_lines(protocol_src)
    findings = []
    tags = protocol_tags(protocol_src)
    for name, line in sorted(tags.items(), key=lambda kv: kv[1]):
        if _suppressed(pragmas, line):
            continue
        missing = []
        if name not in code_refs:
            missing.append("site in the port outside protocol.py")
        if not re.search(r"\b%s\b" % name, tests_text):
            missing.append("reference in a tests/test_torch_*.py file")
        if missing:
            findings.append(Finding(
                protocol_path, line, "TAG01",
                "wire tag %s has no %s: every tag needs a live codec site "
                "and a test of how a peer handles it"
                % (name, " and no ".join(missing))))
    return findings


# --- driver -------------------------------------------------------------------

def _module_globals(tree):
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                names |= _names_in(t)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                names.add(a.asname or a.name)
    return names


def _iter_py_all(root):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def _in_scope(rel, scope):
    top = rel.split(os.sep)[0]
    return rel in scope or (top in scope and not top.endswith(".py"))


def run_lints(pkg_root=_PKG):
    """Every lint over its scope in the port. Returns [Finding]."""
    findings = []
    glossary = parse_glossary(_docstring(_GLOSSARY_PATH))
    subsystems = parse_log_glossary(_docstring(_LOG_GLOSSARY_PATH))
    with open(_PROTOCOL_PATH) as f:
        protocol_src = f.read()
    tags = protocol_tags(protocol_src)
    lock_classes, tag_refs = [], set()
    for path in _iter_py_all(pkg_root):
        with open(path) as f:
            src = f.read()
        tree = ast.parse(src, filename=path)
        rel = os.path.relpath(path, pkg_root)
        _lint_env(tree, path, src, findings)
        if os.path.normpath(path) != os.path.normpath(_PROTOCOL_PATH):
            tag_refs |= _tag_refs_in(tree, tags)
        if _in_scope(rel, CACHE_DIRS):
            _lint_cache_keys(tree, path, src, _module_globals(tree),
                             findings)
        if rel.startswith("backend" + os.sep) and rel.endswith("_torch.py"):
            _lint_promotion(tree, path, src, findings)
        if _in_scope(rel, LOCK_DIRS):
            _lint_locks(tree, path, src, findings)
            lock_classes += _collect_lock_graph(tree, path, src)
        if _in_scope(rel, OBS_DIRS):
            _lint_obs(tree, path, src, findings, glossary)
            _lint_log_subsystems(tree, path, src, findings, subsystems)
    findings += _lock_graph_findings(lock_classes)
    findings += tag_findings(protocol_src, tag_refs, _port_tests_text())
    return findings


def lint_source(src, path="<string>", kinds=("cache", "prom", "lock"),
                glossary_doc=None, log_glossary_doc=None):
    """Lint one source string. kinds: "cache" (CACHE01), "prom"
    (PROM01/02), "lock" (LOCK01/02 and the LOCK03 graph over this
    source's classes), "obs" / "log" (against the given glossary text, by
    default the port's), "env" (ENV01)."""
    findings = []
    tree = ast.parse(src, filename=path)
    if "cache" in kinds:
        _lint_cache_keys(tree, path, src, _module_globals(tree), findings)
    if "prom" in kinds:
        _lint_promotion(tree, path, src, findings)
    if "lock" in kinds:
        _lint_locks(tree, path, src, findings)
        findings += _lock_graph_findings(
            _collect_lock_graph(tree, path, src))
    if "obs" in kinds:
        doc = glossary_doc if glossary_doc is not None else \
            _docstring(_GLOSSARY_PATH)
        _lint_obs(tree, path, src, findings, parse_glossary(doc))
    if "log" in kinds:
        doc = log_glossary_doc if log_glossary_doc is not None else \
            _docstring(_LOG_GLOSSARY_PATH)
        _lint_log_subsystems(tree, path, src, findings,
                             parse_log_glossary(doc))
    if "env" in kinds:
        _lint_env(tree, path, src, findings)
    return findings
