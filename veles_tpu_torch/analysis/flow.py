"""Flow-aware concurrency analysis (the port's copy of
``veles_tpu/analysis/flow.py``), the whole-program model the
concurrency rules need:

- :class:`Project`: a cross-module index of classes, functions,
  imports, lock definitions (the canonical names of
  ``witness.lock("...")`` sites, derived ``module.Class.attr`` names
  otherwise) and light type bindings (``self.sentinel = Sentinel(...)``,
  module singletons, locals assigned from return-annotated calls),
  enough to resolve ``self.sentinel.record_died(...)`` or
  ``telemetry.histogram(...).record(...)`` to their definitions;
- :func:`build_lock_graph`: the lock acquisition graph.  Each lock is a
  node, and taking B while A is held (nested ``with`` blocks, or a call
  chain from inside A's scope that reaches a ``with B``) is an edge
  A->B.  A cycle is a deadlock in waiting; the acyclic graph is written
  as ``veles_tpu_torch/analysis/lock_order.json``, the law the runtime
  witness (``witness.py``) holds real execution to;
- :func:`blocking_findings`: calls that can stall indefinitely
  (``time.sleep``, subprocess waits, untimed ``Queue.get/put``,
  ``Future.result()``, socket and pipe reads, and the device syncs
  ``torch.cuda.synchronize()`` / ``.synchronize()``, ``.item()``,
  ``.cpu()``, ``.tolist()``) made while a lock is held, directly or
  through resolvable callees;
- :func:`waiter_findings`: a statement-level control-flow graph (if,
  while, for, try with exception edges) and a reachability check that
  every waiter made (a ``.submit(...)`` handle, ``Future()``,
  ``Event()``) is resolved, cancelled or handed off on every path out
  of the function that made it, exception edges included.  An exception
  that propagates out of the function hands the obligation to the
  caller and is not flagged.

Stdlib ``ast`` only and conservative: what cannot be resolved
statically is skipped, not flagged.
"""

from __future__ import annotations

import ast
import json
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from veles_tpu_torch.analysis.engine import (  # noqa: F401
    LAW_PATH,
    Finding,
    ModuleContext,
)

#: follow-call depth for effects (lock acquires / blocking behaviour
#: of callees) — deep enough for telemetry.histogram -> Registry
#: -> Histogram chains, bounded so resolution noise cannot run away
MAX_DEPTH = 5

_THREADING_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock",
                         "Condition": "condition"}
_WITNESS_CTORS = {"lock": "lock", "rlock": "rlock",
                  "condition": "condition"}

#: waiter-creating calls: attribute spellings whose result is a
#: handle somebody must eventually collect/cancel/hand off
_SUBMIT_ATTRS = frozenset(("submit",))
_WAITER_CTOR_NAMES = frozenset(("Future", "Event"))

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: argument-less attribute calls that wait for the card: torch's
#: ``torch.cuda.synchronize()`` and an event's or stream's
#: ``.synchronize()``, and the tensor reads that sync (``.item()``,
#: ``.cpu()``, ``.tolist()``)
_DEVICE_SYNCS = frozenset((
    "block_until_ready", "synchronize", "item", "cpu", "tolist"))


def module_base(path: str) -> str:
    """``veles_tpu_torch/serve/batcher.py`` -> ``serve.batcher`` (the
    package prefix is noise in lock identities)."""
    p = path[:-3] if path.endswith(".py") else path
    parts = p.split("/")
    if parts and parts[0] == "veles_tpu_torch":
        parts = parts[1:]
    return ".".join(parts) or p


def dotted_name(path: str) -> str:
    """``veles_tpu_torch/serve/batcher.py`` ->
    ``veles_tpu_torch.serve.batcher``."""
    p = path[:-3] if path.endswith(".py") else path
    return p.replace("/", ".")


def _attr_chain(node: ast.expr) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when not a pure chain."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        parts.reverse()
        return parts
    return None


class LockDef:
    """One lock definition site."""

    __slots__ = ("name", "kind", "path", "line", "witnessed")

    def __init__(self, name: str, kind: str, path: str, line: int,
                 witnessed: bool) -> None:
        self.name = name
        self.kind = kind
        self.path = path
        self.line = line
        self.witnessed = witnessed


class FuncInfo:
    """One function/method definition and its lexical context."""

    __slots__ = ("node", "path", "cls", "chain", "qualname")

    def __init__(self, node: ast.AST, path: str, cls: Optional[str],
                 chain: Tuple[int, ...], qualname: str) -> None:
        self.node = node
        self.path = path
        self.cls = cls
        #: id()s of enclosing function nodes, outermost first
        self.chain = chain
        self.qualname = qualname


class ModuleInfo:
    """Everything the flow analyses index about one module."""

    def __init__(self, ctx: ModuleContext) -> None:
        self.ctx = ctx
        self.path = ctx.path
        self.base = module_base(ctx.path)
        #: local alias -> dotted module name (``import x.y as z`` and
        #: ``from pkg import mod``)
        self.mod_aliases: Dict[str, str] = {}
        #: local name -> (dotted module, original name) for
        #: ``from mod import name``
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.functions: Dict[str, ast.AST] = {}       # module level
        self.methods: Dict[Tuple[str, str], ast.AST] = {}
        #: every function anywhere in the module, by id(node)
        self.funcs: Dict[int, FuncInfo] = {}
        #: nested defs: id(parent fn) -> {name: child fn node}
        self.nested: Dict[int, Dict[str, ast.AST]] = {}
        # lock bindings
        self.module_locks: Dict[str, LockDef] = {}
        self.attr_locks: Dict[Tuple[str, str], LockDef] = {}
        self.local_locks: Dict[Tuple[int, str], LockDef] = {}
        # type bindings: -> (module_path, class_name)
        self.module_var_types: Dict[str, Tuple[str, str]] = {}
        self.attr_types: Dict[Tuple[str, str],
                              Tuple[str, str]] = {}
        self.local_var_types: Dict[Tuple[int, str],
                                   Tuple[str, str]] = {}
        self._index_defs()

    def _index_defs(self) -> None:
        for node in self.ctx.tree.body:
            if isinstance(node, (ast.Import,)):
                for alias in node.names:
                    self.mod_aliases[alias.asname
                                     or alias.name.split(".")[0]] = \
                        alias.name if alias.asname else \
                        alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    local = alias.asname or alias.name
                    # ``from pkg import mod`` is a module alias when
                    # pkg.mod is a module; recorded as BOTH — the
                    # project resolves whichever exists
                    self.mod_aliases.setdefault(
                        local, f"{node.module}.{alias.name}")
                    self.from_imports[local] = (node.module,
                                                alias.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for sub in node.body:
                    if isinstance(sub, _FUNC_DEFS):
                        self.methods[(node.name, sub.name)] = sub
            elif isinstance(node, _FUNC_DEFS):
                self.functions[node.name] = node

        # every function with its lexical context
        def walk(body: Iterable[ast.stmt], cls: Optional[str],
                 chain: Tuple[int, ...], prefix: str) -> None:
            for node in body:
                if isinstance(node, _FUNC_DEFS):
                    qual = f"{prefix}{node.name}"
                    self.funcs[id(node)] = FuncInfo(
                        node, self.path, cls, chain, qual)
                    if chain:
                        self.nested.setdefault(
                            chain[-1], {})[node.name] = node
                    walk(node.body, cls, chain + (id(node),),
                         qual + ".")
                elif isinstance(node, ast.ClassDef):
                    walk(node.body, node.name, chain,
                         f"{node.name}.")
                elif isinstance(node, (ast.If, ast.Try, ast.With,
                                       ast.For, ast.While)):
                    for field in ("body", "orelse", "finalbody",
                                  "handlers"):
                        sub = getattr(node, field, None) or []
                        for s in sub:
                            if isinstance(s, ast.ExceptHandler):
                                walk(s.body, cls, chain, prefix)
                            else:
                                walk([s], cls, chain, prefix)
        walk(self.ctx.tree.body, None, (), "")


class Project:
    """The whole-program index over every scanned module."""

    def __init__(self, contexts: List[ModuleContext]) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, str] = {}
        for ctx in contexts:
            mi = ModuleInfo(ctx)
            self.modules[ctx.path] = mi
            self.by_dotted[dotted_name(ctx.path)] = ctx.path
        for mi in self.modules.values():
            self._index_locks_and_types(mi)
        self._effects_memo: Dict[int, Dict[str, Any]] = {}
        self._effects_stack: Set[int] = set()

    # -- indexing ------------------------------------------------------

    def module_for_alias(self, mi: ModuleInfo,
                         name: str) -> Optional[ModuleInfo]:
        dotted = mi.mod_aliases.get(name)
        if dotted is None:
            return None
        path = self.by_dotted.get(dotted)
        if path is None and "." not in dotted:
            # bare ``import telemetry``-style alias inside the package
            path = self.by_dotted.get(f"veles_tpu_torch.{dotted}")
        return self.modules.get(path) if path else None

    def resolve_class(self, mi: ModuleInfo, name: str
                      ) -> Optional[Tuple[ModuleInfo, str]]:
        if name in mi.classes:
            return mi, name
        imp = mi.from_imports.get(name)
        if imp:
            target = self.modules.get(
                self.by_dotted.get(f"{imp[0]}.{imp[1]}", ""))
            # ``from a import b`` where a.b is a module: not a class
            if target is not None:
                return None
            src = self.modules.get(self.by_dotted.get(imp[0], ""))
            if src and imp[1] in src.classes:
                return src, imp[1]
        return None

    def _lock_ctor(self, mi: ModuleInfo, value: ast.expr,
                   derived: str) -> Optional[Tuple[str, str, bool]]:
        """(lock name, kind, witnessed) when ``value`` constructs a
        lock; ``derived`` is the fallback identity."""
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name):
            base, attr = f.value.id, f.attr
            if base == "threading" and \
                    attr in _THREADING_LOCK_CTORS:
                return derived, _THREADING_LOCK_CTORS[attr], False
            if base == "witness" and attr in _WITNESS_CTORS:
                name = derived
                if value.args and \
                        isinstance(value.args[0], ast.Constant) and \
                        isinstance(value.args[0].value, str):
                    name = value.args[0].value
                return name, _WITNESS_CTORS[attr], True
        return None

    def _type_of_value(self, mi: ModuleInfo, value: ast.expr
                       ) -> Optional[Tuple[str, str]]:
        """(module path, class name) of an assigned value when it is
        a direct class instantiation or a call with a resolvable
        return annotation."""
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        if isinstance(f, ast.Name):
            cls = self.resolve_class(mi, f.id)
            if cls:
                return cls[0].path, cls[1]
            fn = mi.functions.get(f.id)
            if fn is not None:
                return self._return_type(mi, fn)
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name):
            target = self.module_for_alias(mi, f.value.id)
            if target is not None:
                if f.attr in target.classes:
                    return target.path, f.attr
                fn = target.functions.get(f.attr)
                if fn is not None:
                    return self._return_type(target, fn)
        return None

    def _return_type(self, mi: ModuleInfo, fn: ast.AST
                     ) -> Optional[Tuple[str, str]]:
        ann = getattr(fn, "returns", None)
        name: Optional[str] = None
        if isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Constant) and \
                isinstance(ann.value, str):
            name = ann.value.split("[")[0].strip()
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        if not name:
            return None
        cls = self.resolve_class(mi, name)
        return (cls[0].path, cls[1]) if cls else None

    def _index_locks_and_types(self, mi: ModuleInfo) -> None:
        if mi.path.startswith("veles_tpu_torch/analysis/"):
            return   # the analyzer/witness plumbing is not the law

        def visit(body, cls: Optional[str], fn: Optional[int]):
            for node in body:
                if isinstance(node, _FUNC_DEFS):
                    visit(node.body, cls, id(node))
                    continue
                if isinstance(node, ast.ClassDef):
                    visit(node.body, node.name, fn)
                    continue
                targets: List[ast.expr] = []
                value: Optional[ast.expr] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    targets, value = [node.target], node.value
                if value is not None and len(targets) == 1:
                    t = targets[0]
                    self._bind(mi, t, value, cls, fn)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(node, field, None)
                    if sub:
                        visit(sub, cls, fn)
                for h in getattr(node, "handlers", []) or []:
                    visit(h.body, cls, fn)
        visit(mi.ctx.tree.body, None, None)

    def _bind(self, mi: ModuleInfo, target: ast.expr,
              value: ast.expr, cls: Optional[str],
              fn: Optional[int]) -> None:
        if isinstance(target, ast.Name):
            scope = f"{cls}." if cls and fn is None else ""
            derived = f"{mi.base}.{scope}{target.id}"
            lock = self._lock_ctor(mi, value, derived)
            if lock is not None:
                ld = LockDef(lock[0], lock[1], mi.path,
                             value.lineno, lock[2])
                if fn is not None:
                    mi.local_locks[(fn, target.id)] = ld
                else:
                    mi.module_locks[target.id] = ld
                return
            typ = self._type_of_value(mi, value)
            if typ is not None:
                if fn is not None:
                    mi.local_var_types[(fn, target.id)] = typ
                else:
                    mi.module_var_types[target.id] = typ
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self" and cls is not None:
            derived = f"{mi.base}.{cls}.{target.attr}"
            lock = self._lock_ctor(mi, value, derived)
            if lock is not None:
                mi.attr_locks[(cls, target.attr)] = LockDef(
                    lock[0], lock[1], mi.path, value.lineno, lock[2])
                return
            typ = self._type_of_value(mi, value)
            if typ is not None:
                mi.attr_types[(cls, target.attr)] = typ

    # -- resolution ----------------------------------------------------

    def resolve_lock(self, mi: ModuleInfo, expr: ast.expr,
                     fi: FuncInfo) -> Optional[LockDef]:
        """The lock a ``with``-item / receiver refers to, if any."""
        if isinstance(expr, ast.Name):
            for fid in (fi.chain + (id(fi.node),))[::-1]:
                ld = mi.local_locks.get((fid, expr.id))
                if ld is not None:
                    return ld
            return mi.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and fi.cls is not None:
                return mi.attr_locks.get((fi.cls, expr.attr))
            # module-qualified: other_module._some_lock
            target = self.module_for_alias(mi, expr.value.id)
            if target is not None:
                return target.module_locks.get(expr.attr)
        return None

    def _var_type(self, mi: ModuleInfo, fi: FuncInfo,
                  name: str) -> Optional[Tuple[str, str]]:
        for fid in (fi.chain + (id(fi.node),))[::-1]:
            t = mi.local_var_types.get((fid, name))
            if t is not None:
                return t
        return mi.module_var_types.get(name)

    def resolve_call(self, mi: ModuleInfo, fi: FuncInfo,
                     call: ast.Call
                     ) -> Optional[Tuple[ModuleInfo, ast.AST,
                                         Optional[str]]]:
        """(module, function node, class name) of the callee when it
        is statically resolvable; None otherwise."""
        f = call.func
        if isinstance(f, ast.Name):
            # innermost enclosing scope first: nested defs shadow
            for fid in (fi.chain + (id(fi.node),))[::-1]:
                child = mi.nested.get(fid, {}).get(f.id)
                if child is not None:
                    return mi, child, fi.cls
            fn = mi.functions.get(f.id)
            if fn is not None:
                return mi, fn, None
            cls = self.resolve_class(mi, f.id)
            if cls is not None:
                init = cls[0].methods.get((cls[1], "__init__"))
                if init is not None:
                    return cls[0], init, cls[1]
            imp = mi.from_imports.get(f.id)
            if imp:
                src = self.modules.get(
                    self.by_dotted.get(imp[0], ""))
                if src:
                    fn = src.functions.get(imp[1])
                    if fn is not None:
                        return src, fn, None
            return None
        if not (isinstance(f, ast.Attribute)):
            return None
        base = f.value
        # self.method(...)
        if isinstance(base, ast.Name) and base.id == "self" \
                and fi.cls is not None:
            m = mi.methods.get((fi.cls, f.attr))
            if m is not None:
                return mi, m, fi.cls
            # self.attr.method(...) handled below via attr type
            return None
        # module.func(...) / module.Class(...)
        if isinstance(base, ast.Name):
            target = self.module_for_alias(mi, base.id)
            if target is not None:
                fn = target.functions.get(f.attr)
                if fn is not None:
                    return target, fn, None
                if f.attr in target.classes:
                    init = target.methods.get((f.attr, "__init__"))
                    if init is not None:
                        return target, init, f.attr
                return None
            typ = self._var_type(mi, fi, base.id)
            if typ is not None:
                return self._method_of(typ, f.attr)
            return None
        # self.attr.method(...)
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == "self" and fi.cls is not None:
            typ = mi.attr_types.get((fi.cls, base.attr))
            if typ is not None:
                return self._method_of(typ, f.attr)
            return None
        # chained: expr().method(...) via the inner call's return type
        if isinstance(base, ast.Call):
            inner = self.resolve_call(mi, fi, base)
            if inner is not None:
                tmi, tfn, tcls = inner
                rt = self._return_type(tmi, tfn)
                if rt is None and tcls is not None and \
                        isinstance(base.func, (ast.Name,
                                               ast.Attribute)):
                    # a constructor call returns its class
                    callee_name = base.func.id \
                        if isinstance(base.func, ast.Name) \
                        else base.func.attr
                    if callee_name == tcls or callee_name \
                            == "__init__":
                        rt = (tmi.path, tcls)
                if rt is not None:
                    return self._method_of(rt, f.attr)
        return None

    def _method_of(self, typ: Tuple[str, str], meth: str
                   ) -> Optional[Tuple[ModuleInfo, ast.AST, str]]:
        tmi = self.modules.get(typ[0])
        if tmi is None:
            return None
        m = tmi.methods.get((typ[1], meth))
        if m is None:
            return None
        return tmi, m, typ[1]

    # -- effects -------------------------------------------------------

    def effects(self, mi: ModuleInfo, fnode: ast.AST,
                depth: int = MAX_DEPTH) -> Dict[str, Any]:
        """What calling ``fnode`` may do, transitively (bounded):
        ``{"acquires": {lock name: chain str},
        "blocking": {desc: chain str}}``."""
        key = id(fnode)
        memo = self._effects_memo.get(key)
        if memo is not None:
            return memo
        if key in self._effects_stack or depth <= 0:
            return {"acquires": {}, "blocking": {}}
        self._effects_stack.add(key)
        fi = mi.funcs.get(key)
        acquires: Dict[str, str] = {}
        blocking: Dict[str, str] = {}
        label = f"{module_base(mi.path)}." \
                f"{fi.qualname if fi else '?'}"
        try:
            if fi is None:
                return {"acquires": {}, "blocking": {}}
            for node in self._own_nodes(fnode):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        ld = self.resolve_lock(
                            mi, item.context_expr, fi)
                        if ld is not None:
                            acquires.setdefault(ld.name, label)
                elif isinstance(node, ast.Call):
                    desc = self.classify_blocking(mi, fi, node,
                                                  held=())
                    if desc is not None:
                        blocking.setdefault(desc, label)
                    target = self.resolve_call(mi, fi, node)
                    if target is not None:
                        tmi, tfn, _tcls = target
                        sub = self.effects(tmi, tfn, depth - 1)
                        for name, chain in sub["acquires"].items():
                            acquires.setdefault(
                                name, f"{label} -> {chain}")
                        for desc, chain in sub["blocking"].items():
                            blocking.setdefault(
                                desc, f"{label} -> {chain}")
        finally:
            self._effects_stack.discard(key)
        out = {"acquires": acquires, "blocking": blocking}
        self._effects_memo[key] = out
        return out

    @staticmethod
    def _own_nodes(fnode: ast.AST) -> Iterable[ast.AST]:
        """Walk a function body, NOT descending into nested function
        definitions (they run when called, not here)."""
        stack = list(ast.iter_child_nodes(fnode))
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- blocking classification ---------------------------------------

    _SUBPROCESS_FUNCS = frozenset((
        "run", "call", "check_call", "check_output"))
    _READ_ATTRS = frozenset(("recv", "readline"))

    def classify_blocking(self, mi: ModuleInfo, fi: FuncInfo,
                          call: ast.Call,
                          held: Tuple[str, ...]) -> Optional[str]:
        """A short description when ``call`` can stall indefinitely;
        None otherwise.  ``held`` is the lexically held lock set —
        a ``wait`` on the ONLY held condition is exempt (it releases
        that lock for the duration)."""
        f = call.func
        kwnames = {kw.arg for kw in call.keywords}
        if isinstance(f, ast.Name):
            if f.id == "sleep" and \
                    mi.from_imports.get("sleep", ("",))[0] == "time":
                return "time.sleep()"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        base = f.value
        base_name = base.id if isinstance(base, ast.Name) else None
        if f.attr == "sleep" and base_name == "time":
            return "time.sleep()"
        if base_name == "subprocess" and \
                f.attr in self._SUBPROCESS_FUNCS:
            return f"subprocess.{f.attr}()"
        if base_name == "os" and f.attr == "read":
            return "os.read()"
        if f.attr in self._READ_ATTRS:
            return f".{f.attr}() pipe/socket read"
        if f.attr == "result" and not call.args and \
                "timeout" not in kwnames:
            return ".result() with no timeout"
        if f.attr in _DEVICE_SYNCS and not call.args:
            return f".{f.attr}() device sync"
        if f.attr in ("wait", "wait_for", "join", "get", "put"):
            ld = self.resolve_lock(mi, base, fi)
            if ld is not None and f.attr in ("wait", "wait_for"):
                if held and set(held) == {ld.name}:
                    return None   # cond.wait releases the only lock
                return (f"condition {ld.name}.wait() while other "
                        f"locks are held")
            typ = self._typed_receiver(mi, fi, base)
            if typ is None:
                return None
            if typ == "Event" and f.attr == "wait" and \
                    not call.args and "timeout" not in kwnames:
                return "Event.wait() with no timeout"
            if typ in ("Popen",) and f.attr == "wait" and \
                    not call.args and "timeout" not in kwnames:
                return "Popen.wait() with no timeout"
            if typ == "Thread" and f.attr == "join" and \
                    not call.args and "timeout" not in kwnames:
                return "Thread.join() with no timeout"
            if typ in ("Queue", "SimpleQueue") and f.attr == "get" \
                    and "timeout" not in kwnames:
                return "Queue.get() with no timeout"
            if typ == "Queue" and f.attr == "put" and \
                    "timeout" not in kwnames:
                return "Queue.put() with no timeout"
        return None

    def _typed_receiver(self, mi: ModuleInfo, fi: FuncInfo,
                        base: ast.expr) -> Optional[str]:
        """The stdlib concurrency type of a receiver expression, by
        spelled-out constructor binding (``x = queue.Queue()``,
        ``self._proc = subprocess.Popen(...)``...)."""
        ctor = self._ctor_of(mi, fi, base)
        if ctor is None:
            return None
        chain = _attr_chain(ctor.func) if isinstance(ctor, ast.Call) \
            else None
        if not chain:
            return None
        leaf = chain[-1]
        if leaf in ("Queue", "LifoQueue", "PriorityQueue"):
            return "Queue"
        if leaf == "SimpleQueue":
            return "SimpleQueue"
        if leaf in ("Event", "Popen", "Thread"):
            return leaf
        return None

    def _ctor_of(self, mi: ModuleInfo, fi: FuncInfo,
                 base: ast.expr) -> Optional[ast.Call]:
        """The constructor call a receiver was bound to, scanning the
        module for ``name = Ctor()`` / ``self.attr = Ctor()``."""
        want_attr: Optional[Tuple[str, str]] = None
        want_name: Optional[str] = None
        if isinstance(base, ast.Name):
            want_name = base.id
        elif isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == "self" and fi.cls is not None:
            want_attr = (fi.cls, base.attr)
        else:
            return None
        for node in ast.walk(mi.ctx.tree):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value:
                targets, value = [node.target], node.value
            if not isinstance(value, ast.Call):
                continue
            for t in targets:
                if want_name is not None and \
                        isinstance(t, ast.Name) and \
                        t.id == want_name:
                    return value
                if want_attr is not None and \
                        isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and \
                        t.attr == want_attr[1]:
                    return value
        return None


# -- the lock acquisition graph ----------------------------------------

class LockGraph:
    """Nodes (LockDef by name) + directed edges with provenance."""

    def __init__(self) -> None:
        self.nodes: Dict[str, LockDef] = {}
        #: (holder, acquired) -> first provenance string
        self.edges: Dict[Tuple[str, str], str] = {}

    def add_node(self, ld: LockDef) -> None:
        self.nodes.setdefault(ld.name, ld)

    def add_edge(self, holder: str, acquired: str,
                 via: str) -> None:
        if holder == acquired:
            return
        self.edges.setdefault((holder, acquired), via)

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable in the edge set (DFS;
        deduplicated by rotation)."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        seen_cycles: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def dfs(start: str, node: str, path: List[str],
                on_path: Set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cyc = path[:]
                    rot = min(range(len(cyc)),
                              key=lambda i: cyc[i])
                    canon = tuple(cyc[rot:] + cyc[:rot])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif nxt not in on_path and nxt > start:
                    # only walk nodes ordered after start: each
                    # cycle is found exactly once, from its
                    # smallest node
                    on_path.add(nxt)
                    dfs(start, nxt, path + [nxt], on_path)
                    on_path.discard(nxt)

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out

    def to_payload(self, manual: Optional[List[Dict[str, str]]]
                   = None) -> Dict[str, Any]:
        return {
            "format": 1,
            "comment": ("GENERATED lock acquisition graph (the "
                        "repo's locking law) — regenerate with "
                        "`python -m veles_tpu_torch.tools.veleslint "
                        "--sync-lock-order`; hand-add edges only "
                        "under manual_edges, with a justification."),
            "nodes": [
                {"name": n.name, "kind": n.kind,
                 "defined": f"{n.path}:{n.line}",
                 "witnessed": n.witnessed}
                for n in sorted(self.nodes.values(),
                                key=lambda n: n.name)],
            "edges": [
                {"from": a, "to": b, "via": via}
                for (a, b), via in sorted(self.edges.items())],
            "manual_edges": manual or [],
        }

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return set(self.edges)


def build_project(contexts: List[ModuleContext]) -> Project:
    return Project(contexts)


def _iter_with_items(node: ast.AST) -> List[ast.expr]:
    return [item.context_expr for item in node.items] \
        if isinstance(node, (ast.With, ast.AsyncWith)) else []


def _walk_held(project: Project, mi: ModuleInfo, fi: FuncInfo,
               on_with, on_call) -> None:
    """Walk one function's own statements tracking the lexically held
    lock stack; ``on_with(lockdef, node, held)`` fires at each
    resolved lock acquisition, ``on_call(call, held)`` at each call
    made while any lock is held."""

    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            return   # runs later, on its own stack
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for expr in _iter_with_items(node):
                ld = project.resolve_lock(mi, expr, fi)
                if ld is not None:
                    on_with(ld, node, inner)
                    inner = inner + (ld.name,)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Call) and held:
            on_call(node, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fi.node.body:
        visit(stmt, ())


def build_lock_graph(project: Project,
                     scope: Optional[List[str]] = None,
                     node_scope: Optional[List[str]] = None
                     ) -> LockGraph:
    """The cross-module lock acquisition graph.  ``scope`` limits
    which modules' FUNCTIONS are walked for acquisition sites (the
    thread-spawning modules); call-following covers every scanned
    module regardless, so an edge from a scoped module into
    telemetry's locks is still found.  ``node_scope`` (path prefixes)
    limits whose lock definitions are nodes (None: every module's)."""
    graph = LockGraph()
    for mi in project.modules.values():
        if mi.path.startswith("veles_tpu_torch/analysis/"):
            continue
        if node_scope is not None and not any(
                mi.path == p or mi.path.startswith(p.rstrip("/") + "/")
                for p in node_scope):
            continue
        for ld in mi.module_locks.values():
            graph.add_node(ld)
        for ld in mi.attr_locks.values():
            graph.add_node(ld)
        for ld in mi.local_locks.values():
            graph.add_node(ld)

    for mi in project.modules.values():
        if scope is not None and mi.path not in scope:
            continue
        for fi in mi.funcs.values():
            def on_with(ld: LockDef, node: ast.AST,
                        held: Tuple[str, ...],
                        mi=mi, fi=fi) -> None:
                for holder in held:
                    graph.add_edge(
                        holder, ld.name,
                        f"{mi.path}:{node.lineno} "
                        f"({fi.qualname})")

            def on_call(call: ast.Call, held: Tuple[str, ...],
                        mi=mi, fi=fi) -> None:
                # explicit .acquire() on a resolvable lock
                f = call.func
                if isinstance(f, ast.Attribute) and \
                        f.attr == "acquire":
                    ld = project.resolve_lock(mi, f.value, fi)
                    if ld is not None:
                        for holder in held:
                            graph.add_edge(
                                holder, ld.name,
                                f"{mi.path}:{call.lineno} "
                                f"({fi.qualname})")
                        return
                target = project.resolve_call(mi, fi, call)
                if target is None:
                    return
                tmi, tfn, _tcls = target
                eff = project.effects(tmi, tfn)
                for name, chain in eff["acquires"].items():
                    for holder in held:
                        graph.add_edge(
                            holder, name,
                            f"{mi.path}:{call.lineno} "
                            f"({fi.qualname} -> {chain})")

            _walk_held(project, mi, fi, on_with, on_call)
    return graph


# -- lock_order.json I/O -----------------------------------------------

def load_lock_order(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def declared_edges(payload: Dict[str, Any]) -> Set[Tuple[str, str]]:
    out = set()
    for e in payload.get("edges", []) or []:
        out.add((e["from"], e["to"]))
    for e in payload.get("manual_edges", []) or []:
        out.add((e["from"], e["to"]))
    return out


def write_lock_order(path: str, graph: LockGraph,
                     keep_manual: bool = True) -> None:
    manual: List[Dict[str, str]] = []
    if keep_manual:
        old = load_lock_order(path)
        if old:
            manual = list(old.get("manual_edges", []) or [])
    payload = graph.to_payload(manual)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".lockorder.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def render_lock_table(payload: Dict[str, Any]) -> str:
    """The guide's threading-model table, generated from
    lock_order.json."""
    rows = ["| Held lock | May acquire | Where |",
            "| --- | --- | --- |"]
    for e in payload.get("edges", []) or []:
        via = e.get("via", "")
        rows.append(f"| `{e['from']}` | `{e['to']}` | {via} |")
    for e in payload.get("manual_edges", []) or []:
        rows.append(f"| `{e['from']}` | `{e['to']}` | "
                    f"(manual: {e.get('justification', '')}) |")
    if len(rows) == 2:
        rows.append("| (none) | (none) | no nested acquisition "
                    "anywhere |")
    return "\n".join(rows) + "\n"


# -- blocking-under-lock findings --------------------------------------

RULE_BLOCKING = "blocking-under-lock"


def blocking_findings(project: Project,
                      scope: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in scope:
        mi = project.modules.get(path)
        if mi is None:
            continue
        for fi in mi.funcs.values():
            def on_with(ld, node, held):
                pass

            def on_call(call: ast.Call, held: Tuple[str, ...],
                        mi=mi, fi=fi) -> None:
                desc = project.classify_blocking(mi, fi, call,
                                                 held)
                if desc is None:
                    target = project.resolve_call(mi, fi, call)
                    if target is not None:
                        tmi, tfn, _ = target
                        eff = project.effects(tmi, tfn)
                        for d, chain in eff["blocking"].items():
                            desc = f"{d} (via {chain})"
                            break
                if desc is None:
                    return
                out.append(Finding(
                    RULE_BLOCKING, mi.path, call.lineno,
                    call.col_offset,
                    f"{fi.qualname}:{desc}",
                    f"{desc} while holding "
                    f"{', '.join(sorted(set(held)))} in "
                    f"{fi.qualname!r}: a stalled call under a lock "
                    f"wedges every thread contending for it — move "
                    f"the blocking work outside the critical "
                    f"section or bound it with a timeout"))

            _walk_held(project, mi, fi, on_with, on_call)
    return out


# -- waiter discipline -------------------------------------------------

RULE_WAITER = "waiter-discipline"

_EXIT = "exit"


class _CFG:
    """Statement-level control-flow graph of one function body."""

    def __init__(self) -> None:
        self.succ_norm: Dict[Any, Set[Any]] = {}
        self.succ_exc: Dict[Any, Set[Any]] = {}

    def _edge(self, table: Dict[Any, Set[Any]], a: Any,
              b: Any) -> None:
        table.setdefault(id(a) if not isinstance(a, str) else a,
                         set()).add(b)

    def norm(self, a, b) -> None:
        self._edge(self.succ_norm, a, b)

    def exc(self, a, b) -> None:
        self._edge(self.succ_exc, a, b)

    def successors(self, node) -> Tuple[Set[Any], Set[Any]]:
        key = id(node) if not isinstance(node, str) else node
        return (self.succ_norm.get(key, set()),
                self.succ_exc.get(key, set()))


def _build_cfg(body: List[ast.stmt]) -> _CFG:
    cfg = _CFG()

    def first(stmts: List[ast.stmt], follow):
        return stmts[0] if stmts else follow

    def build(stmts: List[ast.stmt], follow, handlers,
              loop) -> None:
        for i, stmt in enumerate(stmts):
            nxt = stmts[i + 1] if i + 1 < len(stmts) else follow
            build_stmt(stmt, nxt, handlers, loop)

    def build_stmt(stmt: ast.stmt, nxt, handlers, loop) -> None:
        for h in handlers:
            cfg.exc(stmt, h)
        if isinstance(stmt, ast.Return):
            cfg.norm(stmt, _EXIT)
        elif isinstance(stmt, ast.Raise):
            # propagates out (obligation transfers to the caller)
            # unless an enclosing handler catches it — the exc edges
            # above model the catch
            pass
        elif isinstance(stmt, ast.Break):
            if loop:
                cfg.norm(stmt, loop[-1][1])
        elif isinstance(stmt, ast.Continue):
            if loop:
                cfg.norm(stmt, loop[-1][0])
        elif isinstance(stmt, ast.If):
            body_e = first(stmt.body, nxt)
            else_e = first(stmt.orelse, nxt)
            cfg.norm(stmt, body_e)
            cfg.norm(stmt, else_e)
            build(stmt.body, nxt, handlers, loop)
            build(stmt.orelse, nxt, handlers, loop)
        elif isinstance(stmt, (ast.While, ast.For)):
            body_e = first(stmt.body, stmt)
            cfg.norm(stmt, body_e)
            else_e = first(stmt.orelse, nxt)
            cfg.norm(stmt, else_e)
            build(stmt.body, stmt, handlers,
                  loop + [(stmt, nxt)])
            build(stmt.orelse, nxt, handlers, loop)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            body_e = first(stmt.body, nxt)
            cfg.norm(stmt, body_e)
            build(stmt.body, nxt, handlers, loop)
        elif isinstance(stmt, ast.Try):
            h_entries = []
            fin_entry = first(stmt.finalbody, nxt) \
                if stmt.finalbody else nxt
            for h in stmt.handlers:
                h_entries.append(first(h.body, fin_entry))
            body_follow = first(stmt.orelse, fin_entry) \
                if stmt.orelse else fin_entry
            body_e = first(stmt.body, body_follow)
            cfg.norm(stmt, body_e)
            build(stmt.body, body_follow,
                  handlers + h_entries, loop)
            # the else clause runs after the body completed without
            # raising, and ITS exceptions are NOT caught by this
            # try's handlers — outer handlers only
            build(stmt.orelse, fin_entry, handlers, loop)
            for h in stmt.handlers:
                build(h.body, fin_entry, handlers, loop)
            build(stmt.finalbody, nxt, handlers, loop)
        else:
            cfg.norm(stmt, nxt)
    build(body, _EXIT, [], [])
    return cfg


def _mentions(stmt: ast.stmt, var: str) -> bool:
    """Does executing THIS statement (not the statements nested
    inside it) touch ``var``?  Compound statements contribute only
    their header expression — their bodies are separate CFG nodes; a
    nested function definition capturing the name counts in full (the
    closure is a handoff)."""
    if isinstance(stmt, (ast.If, ast.While)):
        probe: List[ast.AST] = [stmt.test]
    elif isinstance(stmt, ast.For):
        probe = [stmt.iter, stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        probe = [i.context_expr for i in stmt.items]
    elif isinstance(stmt, ast.Try):
        probe = []
    else:
        probe = [stmt]
    for root in probe:
        for node in ast.walk(root):
            if isinstance(node, ast.Name) and node.id == var:
                return True
            if isinstance(node, _FUNC_DEFS):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and \
                            sub.id == var:
                        return True
    return False


def _waiter_creator(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _SUBMIT_ATTRS:
        return ".submit()"
    name = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute):
        name = f.attr
    if name in _WAITER_CTOR_NAMES:
        return f"{name}()"
    return None


def waiter_findings(project: Project,
                    scope: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in scope:
        mi = project.modules.get(path)
        if mi is None:
            continue
        for fi in mi.funcs.values():
            out.extend(_check_function_waiters(mi, fi))
    return out


def _check_function_waiters(mi: ModuleInfo,
                            fi: FuncInfo) -> List[Finding]:
    body = list(fi.node.body)
    cfg = _build_cfg(body)
    out: List[Finding] = []

    # index every statement of THIS function (nested defs are their
    # own functions with their own CFG — double-reporting otherwise)
    all_stmts: Dict[int, ast.stmt] = {}

    def collect(stmts: List[ast.stmt]) -> None:
        for s in stmts:
            if isinstance(s, _FUNC_DEFS + (ast.ClassDef,)):
                all_stmts[id(s)] = s
                continue
            all_stmts[id(s)] = s
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(s, field, None)
                if sub:
                    collect(sub)
            for h in getattr(s, "handlers", []) or []:
                collect(h.body)
    collect(body)

    for s in all_stmts.values():
        creations = _creations_in(s, fi)
        for var, what, call in creations:
            if var is None:
                out.append(Finding(
                    RULE_WAITER, mi.path, call.lineno,
                    call.col_offset,
                    f"{fi.qualname}:dropped:{what}:{call.lineno}",
                    f"{what} result dropped in {fi.qualname!r}: "
                    f"nobody will collect this waiter (its errors "
                    f"vanish) — assign it and resolve/cancel/hand "
                    f"it off on every path"))
                continue
            leak = _leaks(cfg, s, var)
            if leak is not None:
                out.append(Finding(
                    RULE_WAITER, mi.path, call.lineno,
                    call.col_offset,
                    f"{fi.qualname}:{var}:{what}",
                    f"waiter {var!r} from {what} in "
                    f"{fi.qualname!r} is abandoned on "
                    + ("an exception path" if leak == "exc"
                       else "a normal path")
                    + " — every control-flow path (exception edges "
                    f"included) must resolve, cancel, or hand it "
                    f"off (the leaked-waiter class)"))
    return out


def _creations_in(stmt: ast.stmt, fi: FuncInfo
                  ) -> List[Tuple[Optional[str], str, ast.Call]]:
    """(var or None-if-dropped, creator desc, call) for waiter
    creations at statement level."""
    out: List[Tuple[Optional[str], str, ast.Call]] = []
    if isinstance(stmt, ast.Assign) and \
            isinstance(stmt.value, ast.Call) and \
            len(stmt.targets) == 1 and \
            isinstance(stmt.targets[0], ast.Name):
        what = _waiter_creator(stmt.value)
        if what:
            out.append((stmt.targets[0].id, what, stmt.value))
    elif isinstance(stmt, ast.Expr) and \
            isinstance(stmt.value, ast.Call):
        what = _waiter_creator(stmt.value)
        if what:
            out.append((None, what, stmt.value))
    return out


def _leaks(cfg: _CFG, creation: ast.stmt,
           var: str) -> Optional[str]:
    """'exc' / 'norm' when an exit is reachable from the creation with
    the waiter unresolved (and how the leaking hop was reached);
    None when every path resolves it.  The obligation starts on the
    creation's NORMAL successors only — an exception inside the
    creating call means nothing was created."""
    norm0, _exc0 = cfg.successors(creation)
    frontier: List[Tuple[Any, str]] = [(n, "norm") for n in norm0]
    seen: Set[Tuple[Any, str]] = set()
    while frontier:
        node, how = frontier.pop()
        key = (id(node) if not isinstance(node, str) else node, how)
        if key in seen:
            continue
        seen.add(key)
        if node == _EXIT:
            return how
        assert isinstance(node, ast.stmt)
        resolved = _mentions(node, var)
        norm, exc = cfg.successors(node)
        if not resolved:
            for n in norm:
                frontier.append((n, how))
        for n in exc:
            frontier.append((n, "exc"))
    return None
