"""The flow-aware concurrency rules (the port's copy of
``veles_tpu/analysis/concurrency.py``).

Three whole-program rules built on :mod:`veles_tpu_torch.analysis.flow`
(they see every scanned module at once, so a lock acquired three calls
away still makes an edge):

- ``lock-order``: the cross-module lock acquisition graph must be
  acyclic and match the checked-in
  ``veles_tpu_torch/analysis/lock_order.json`` (regenerate with
  ``python -m veles_tpu_torch.tools.veleslint --sync-lock-order``), and
  README.md's threading-model table must match the json.  The runtime
  witness (``witness.py``) holds real execution to this law.
- ``blocking-under-lock``: no call that can block indefinitely
  (``time.sleep``, subprocess waits, untimed ``Queue.get/put``,
  ``Future.result()``, pipe and socket reads, device syncs) while a
  lock is held, directly or through resolvable callees.
- ``waiter-discipline``: every waiter made (a ``.submit()`` handle,
  ``Future()``, ``Event()``) in the serving and pool modules is
  resolved, cancelled or handed off on every control-flow path out of
  the function that made it, exception edges included.

And three per-module rules:

- ``thread-lifecycle``: every ``threading.Thread`` in the
  thread-spawning modules is ``daemon=True`` or provably joined.
- ``wire-protocol``: string keys of dict literals flowing to the JSONL
  wire must be declared in ``veles_tpu_torch/serve/protocol.py``.
- ``trace-wire-key``: ``veles_tpu_torch/trace.py``'s propagation
  fields must be declared there too.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from veles_tpu_torch.analysis import flow
from veles_tpu_torch.analysis.engine import (Config, Finding,
                                       ModuleContext)

#: the command that regenerates the law and the guide's table
SYNC_LOCK_ORDER = ("python -m veles_tpu_torch.tools.veleslint "
                   "--sync-lock-order")

#: markers bracketing the generated threading-model table in the guide
LOCK_TABLE_BEGIN = "<!-- veleslint:lockorder:begin -->"
LOCK_TABLE_END = "<!-- veleslint:lockorder:end -->"


def _in_scope(path: str, modules: List[str]) -> bool:
    return path in modules


_protocol_mod = None


def _protocol():
    """``veles_tpu_torch/serve/protocol.py``, loaded from its file: the
    ``serve`` package's ``__init__`` imports torch, and the scan stays
    stdlib-only."""
    global _protocol_mod
    if _protocol_mod is None:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "serve", "protocol.py")
        spec = importlib.util.spec_from_file_location(
            "_veleslint_protocol", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _protocol_mod = mod
    return _protocol_mod


# -- per-module rules --------------------------------------------------

class ThreadLifecycleRule:
    """A non-daemon thread in a long-lived module outlives shutdown
    paths silently; every spawn must be ``daemon=True`` or the module
    must provably join it."""

    name = "thread-lifecycle"
    doc = ("`threading.Thread(...)` in a thread-spawning module "
           "without `daemon=True` and without any `.join(...)` in "
           "the module — an unjoined non-daemon thread blocks "
           "interpreter exit on every shutdown path")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_scope(ctx.path, ctx.config.thread_modules):
            return []
        has_join = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
            for n in ast.walk(ctx.tree))
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Thread"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "threading"):
                continue
            daemon = None
            label = None
            for kw in node.keywords:
                if kw.arg == "daemon" and \
                        isinstance(kw.value, ast.Constant):
                    daemon = bool(kw.value.value)
                if kw.arg == "name" and \
                        isinstance(kw.value, ast.Constant):
                    label = str(kw.value.value)
                if kw.arg == "target":
                    t = kw.value
                    if label is None and isinstance(t, ast.Name):
                        label = t.id
                    elif label is None and \
                            isinstance(t, ast.Attribute):
                        label = t.attr
            if daemon is True:
                continue
            if daemon is None and has_join:
                # non-daemon but the module joins threads — the
                # shutdown path is explicit
                continue
            out.append(Finding(
                self.name, ctx.path, node.lineno, node.col_offset,
                f"thread:{label or node.lineno}",
                f"thread {label or '<unnamed>'} is not daemon=True "
                f"and the module never joins: it outlives every "
                f"shutdown path — mark it daemon or join it on "
                f"close"))
        return out


class WireProtocolRule:
    """JSONL wire fields are declared once in serve/protocol.py; an
    ad-hoc key in a dict flowing to the wire is the emitter/reader
    typo class (a misspelled field is emitted forever and read
    never)."""

    name = "wire-protocol"
    doc = ("string key in a dict literal flowing to the JSONL wire "
           "(emit/_send/json.dumps arguments, assigned-then-sent "
           "locals, returned response dicts) that is not declared in "
           "veles_tpu_torch/serve/protocol.py")

    _SEND_FUNCS = frozenset(("emit", "_send", "send"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_scope(ctx.path, ctx.config.wire_modules):
            return []
        protocol = _protocol()
        wire_dicts: List[ast.Dict] = []
        sent_names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                fname = None
                f = node.func
                if isinstance(f, ast.Name):
                    fname = f.id
                elif isinstance(f, ast.Attribute):
                    fname = f.attr
                if fname in self._SEND_FUNCS or fname == "dumps":
                    for arg in node.args:
                        if isinstance(arg, ast.Name):
                            sent_names.add(arg.id)
                        wire_dicts.extend(self._dicts_in(arg))
            elif isinstance(node, ast.Return) and node.value:
                wire_dicts.extend(self._dicts_in(node.value))
        # assigned-then-sent locals: hello = {...}; emit(hello)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id in sent_names:
                wire_dicts.extend(self._dicts_in(node.value))
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        for d in wire_dicts:
            for key in d.keys:
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                if protocol.known(key.value):
                    continue
                mark = (key.value, key.lineno)
                if mark in seen:
                    continue
                seen.add(mark)
                out.append(Finding(
                    self.name, ctx.path, key.lineno,
                    key.col_offset, key.value,
                    f"undeclared wire key {key.value!r}: declare it "
                    f"in veles_tpu_torch/serve/protocol.py (or it is a "
                    f"typo of a declared field)"))
        return out

    @staticmethod
    def _dicts_in(expr: ast.expr) -> List[ast.Dict]:
        """Dict literals within ``expr``, NOT descending into call
        arguments (a dict handed to a constructor is that callee's
        business, not a wire payload)."""
        out: List[ast.Dict] = []
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Call):
                continue
            if isinstance(node, ast.Dict):
                out.append(node)
            stack.extend(ast.iter_child_nodes(node))
        return out


class TraceWireKeyRule:
    """veles_tpu_torch/trace.py deliberately does NOT import
    serve/protocol.py (it must stay import-light for the GA worker
    and telemetry consumers), so its trace-propagation field names are
    duplicated literals.  This rule is the static pin that makes the
    duplication safe: every string in trace.py's ``WIRE_FIELDS``
    tuple (and every ``K_*`` field constant) must be declared in the
    serve/protocol.py wire-key registry — zero waivers, so a trace
    context key can never ride the wire undeclared."""

    name = "trace-wire-key"
    doc = ("trace-propagation field in veles_tpu_torch/trace.py "
           "(WIRE_FIELDS / K_* literals) that is not declared in the "
           "serve/protocol.py wire-key registry")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        norm = ctx.path.replace("\\", "/")
        if not norm.endswith("veles_tpu_torch/trace.py"):
            return []
        protocol = _protocol()
        out: List[Finding] = []
        saw_wire_fields = False
        for node in ctx.tree.body:
            if not isinstance(node, ast.Assign) \
                    or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            tname = node.targets[0].id
            if tname == "WIRE_FIELDS" \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                saw_wire_fields = True
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str) \
                            and not protocol.known(elt.value):
                        out.append(Finding(
                            self.name, ctx.path, elt.lineno,
                            elt.col_offset, elt.value,
                            f"trace wire field {elt.value!r} is not "
                            f"in the serve/protocol.py registry — "
                            f"declare it there (zero waivers: an "
                            f"undeclared propagation key is silently "
                            f"dropped by readers)"))
            elif tname.startswith("K_") \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and not protocol.known(node.value.value):
                out.append(Finding(
                    self.name, ctx.path, node.lineno,
                    node.col_offset, node.value.value,
                    f"trace field constant {tname} = "
                    f"{node.value.value!r} is not in the "
                    f"serve/protocol.py registry"))
        if not saw_wire_fields:
            out.append(Finding(
                self.name, ctx.path, 1, 0, "WIRE_FIELDS",
                "veles_tpu_torch/trace.py must pin its propagation keys in "
                "a module-level WIRE_FIELDS tuple for this rule to "
                "cross-check against serve/protocol.py"))
        return out


# -- whole-program rules -----------------------------------------------

class BlockingUnderLockRule:
    name = flow.RULE_BLOCKING
    doc = ("indefinitely-blocking call (time.sleep, subprocess "
           "waits, untimed Queue.get/put, Future.result(), "
           "pipe/socket reads, device syncs) while a lock is held — "
           "directly or through resolvable callees (the "
           "batcher/router stall class)")

    def check_project(self, project: flow.Project, config: Config,
                      root: str) -> List[Finding]:
        return flow.blocking_findings(project, config.lock_modules)


class WaiterDisciplineRule:
    name = flow.RULE_WAITER
    doc = ("a created waiter (`.submit()` handle, `Future()`, "
           "`Event()`) in the serve+pool modules that some "
           "control-flow path — exception edges included — abandons "
           "without resolving, cancelling, or handing off (the "
           "leaked-waiter class)")

    def check_project(self, project: flow.Project, config: Config,
                      root: str) -> List[Finding]:
        return flow.waiter_findings(project, config.waiter_modules)


class LockOrderRule:
    name = "lock-order"
    doc = ("the cross-module lock acquisition graph (every "
           "`with <lock>:` inside another lock's scope, followed "
           "through direct calls) must be cycle-free and match the "
           "checked-in analysis/lock_order.json, which names "
           "exactly the witness's LOCK_NAMES, + the guide's "
           "threading-model table (`veleslint --sync-lock-order`)")

    def check_project(self, project: flow.Project, config: Config,
                      root: str) -> List[Finding]:
        graph = flow.build_lock_graph(project,
                                      scope=config.lock_modules,
                                      node_scope=config.law_scope)
        out: List[Finding] = []
        law_path = os.path.join(root, config.lock_order)
        law_rel = os.path.relpath(law_path, root)
        payload = flow.load_lock_order(law_path)
        declared_manual: Set[Tuple[str, str]] = set()
        if payload is not None:
            for e in payload.get("manual_edges", []) or []:
                just = (e.get("justification") or "").strip()
                if not just or just.lower().startswith("todo"):
                    out.append(Finding(
                        self.name, law_rel, 1, 0,
                        f"manual:{e.get('from')}->{e.get('to')}",
                        "manual lock-order edge "
                        f"{e.get('from')} -> {e.get('to')} has no "
                        "written justification"))
                declared_manual.add((e["from"], e["to"]))
        # cycles over computed + manual edges: a declared cycle is a
        # latent deadlock no matter who declared it
        check = flow.LockGraph()
        check.nodes = dict(graph.nodes)
        check.edges = dict(graph.edges)
        for (a, b) in declared_manual:
            check.add_edge(a, b, "manual")
        for cyc in check.cycles():
            loop = " -> ".join(cyc + [cyc[0]])
            vias = "; ".join(
                graph.edges.get((cyc[i], cyc[(i + 1) % len(cyc)]),
                                "manual")
                for i in range(len(cyc)))
            out.append(Finding(
                self.name, law_rel, 1, 0, f"cycle:{loop}",
                f"lock-order CYCLE {loop} (latent deadlock): two "
                f"threads walking it in opposite phases stop "
                f"forever — break the cycle by moving one "
                f"acquisition outside the other's scope [{vias}]"))
        # drift vs the checked-in law
        computed = graph.edge_pairs()
        if payload is None:
            out.append(Finding(
                self.name, law_rel, 1, 0, "missing",
                f"{law_rel} is missing — the locking law must be "
                f"checked in; run {SYNC_LOCK_ORDER}"))
        else:
            declared = {(e["from"], e["to"])
                        for e in payload.get("edges", []) or []}
            decl_nodes = {n["name"]
                          for n in payload.get("nodes", []) or []}
            comp_nodes = set(graph.nodes)
            missing = sorted(computed - declared)
            stale = sorted(declared - computed)
            if missing or stale or decl_nodes != comp_nodes:
                parts = []
                if missing:
                    parts.append("undeclared edge(s) " + ", ".join(
                        f"{a}->{b}" for a, b in missing))
                if stale:
                    parts.append("stale declared edge(s) "
                                 + ", ".join(f"{a}->{b}"
                                             for a, b in stale))
                if decl_nodes != comp_nodes:
                    parts.append(
                        "node set drift (+%s/-%s)" % (
                            sorted(comp_nodes - decl_nodes),
                            sorted(decl_nodes - comp_nodes)))
                out.append(Finding(
                    self.name, law_rel, 1, 0, "drift",
                    "lock acquisition graph drifted from the "
                    "checked-in law: " + "; ".join(parts)
                    + f" — review the change and run {SYNC_LOCK_ORDER}"))
        # the law names exactly the locks the port makes through the
        # witness's factories (a scratch tree without locks is exempt)
        from veles_tpu_torch.analysis import witness
        if graph.nodes and set(graph.nodes) != witness.LOCK_NAMES:
            out.append(Finding(
                self.name, law_rel, 1, 0, "names",
                "the scanned locks are not the witness's LOCK_NAMES: "
                f"scanned only {sorted(set(graph.nodes) - witness.LOCK_NAMES)}"
                f", declared only "
                f"{sorted(witness.LOCK_NAMES - set(graph.nodes))}"))
        # the guide's generated threading-model table
        guide_f = self._check_guide(root, config, payload)
        if guide_f is not None:
            out.append(guide_f)
        return out

    def _check_guide(self, root: str, config: Config,
                     payload) -> Optional[Finding]:
        guide = os.path.join(root, config.guide)
        try:
            with open(guide, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return None   # env-registry already reports a lost guide
        begin = text.find(LOCK_TABLE_BEGIN)
        end = text.find(LOCK_TABLE_END)
        if begin < 0 or end < 0:
            return Finding(
                self.name, config.guide, 1, 0, "lock-table",
                f"threading-model table markers not found "
                f"({LOCK_TABLE_BEGIN} ... {LOCK_TABLE_END}); run "
                f"{SYNC_LOCK_ORDER}")
        current = text[begin:end + len(LOCK_TABLE_END)]
        if payload is None:
            return None   # the drift finding already fired
        if current.strip() != lock_table_block(payload).strip():
            line = text[:begin].count("\n") + 1
            return Finding(
                self.name, config.guide, line, 0, "lock-table",
                "the threading-model table is out of sync with "
                f"analysis/lock_order.json; run {SYNC_LOCK_ORDER}")
        return None


def lock_table_block(payload) -> str:
    """The guide's generated threading-model block, markers
    included."""
    return (f"{LOCK_TABLE_BEGIN}\n"
            "<!-- GENERATED from veles_tpu_torch/analysis/lock_order.json "
            "by `python -m veles_tpu_torch.tools.veleslint "
            "--sync-lock-order`; do not edit. -->\n"
            f"{flow.render_lock_table(payload)}"
            f"{LOCK_TABLE_END}")


def sync_lock_order(root: str, config: Config,
                    contexts: List[ModuleContext]) -> str:
    """Regenerate analysis/lock_order.json from the live scan and
    rewrite the guide's threading-model table from it.  Returns the
    json path."""
    import tempfile
    project = flow.build_project(contexts)
    graph = flow.build_lock_graph(project,
                                  scope=config.lock_modules,
                                  node_scope=config.law_scope)
    law_path = os.path.join(root, config.lock_order)
    flow.write_lock_order(law_path, graph)
    payload = flow.load_lock_order(law_path)
    guide = os.path.join(root, config.guide)
    try:
        with open(guide, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return law_path
    block = lock_table_block(payload)
    begin = text.find(LOCK_TABLE_BEGIN)
    end = text.find(LOCK_TABLE_END)
    if begin >= 0 and end >= 0:
        text = text[:begin] + block + text[end
                                          + len(LOCK_TABLE_END):]
    else:
        text = text.rstrip("\n") + "\n\n" + block + "\n"
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(guide),
                               prefix=".guide.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, guide)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return law_path


PROJECT_RULES = [
    LockOrderRule(),
    BlockingUnderLockRule(),
    WaiterDisciplineRule(),
]
