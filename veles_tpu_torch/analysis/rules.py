"""The per-file veleslint rules (the port's copy of
``veles_tpu/analysis/rules.py``).

Each rule is one class with a ``name``, a one-line ``doc`` and
``check(ctx) -> [Finding]`` over one :class:`ModuleContext`.  Rules are
syntactic and conservative: a name that cannot be resolved statically
is skipped, not flagged, and the inline waiver and the baseline are for
the rare justified exception.

Two rules differ from the reference's, whose subjects are JAX's:

- ``tracer-hygiene`` holds the port's device-side step code free of
  host syncs.  That code is every function handed to a ``torch.func``
  transform (``vmap``, ``functional_call``, ``grad``, ``vjp``, ...) by
  name or through ``functools.partial``, or decorated with one, and
  every function nested in a ``build_*`` function of the
  ``device_step_modules`` (the fused step's builders in
  ``engine/core.py``).  A host sync there is ``.item()``, ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize()`` (any
  ``.synchronize()``), ``print()``, ``bool`` / ``float`` / ``int`` of a
  parameter, or a Python ``if`` / ``while`` on a ``torch`` call.
- ``engine-residency-seam`` keeps host -> card placement on the serving
  and online paths (``seam_scope``) inside the seam modules
  (``engine/core.py`` and ``serve/residency.py``): ``.cuda()``,
  ``.to(<device>)`` (a ``device=`` keyword, a ``"cuda..."`` string or a
  name or attribute spelled with ``device`` / ``dev``), and a ``torch``
  factory called with ``device=``.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from veles_tpu_torch.analysis.engine import Finding, ModuleContext

#: attribute calls that force a device -> host sync inside device-side
#: step code
_HOST_SYNC_METHODS = frozenset((
    "item", "cpu", "numpy", "tolist", "synchronize"))

#: mutating container methods for the lock-discipline rule
_MUTATORS = frozenset((
    "append", "appendleft", "add", "clear", "pop", "popleft",
    "popitem", "update", "setdefault", "remove", "discard", "extend",
    "insert", "sort", "reverse"))
#: telemetry entry points whose first argument is a registry name
_TELEMETRY_FUNCS = frozenset((
    "event", "counter", "gauge", "histogram", "span",
    "recent_events"))
#: the exit codes owned by the launcher/supervisor contract
_CONTRACT_CODES = (13, 14)


def _in_scope(path: str, prefixes: List[str]) -> bool:
    return any(path == p or path.startswith(p.rstrip("/") + "/")
               for p in prefixes)


def _call_name(func: ast.expr) -> Optional[str]:
    """Trailing identifier of a call target: ``jit`` for both
    ``vmap(...)`` and ``torch.func.vmap(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class AtomicWriteRule:
    """Persistent-state files must be written tempfile-then-
    ``os.replace``; a bare ``open(path, "w")`` tears under crashes and
    concurrent writers."""

    name = "atomic-write"
    doc = ("bare `open(..., \"w\")` in package code — route through "
           "the tempfile+os.replace helpers "
           "(snapshotter.atomic_write / write_json_atomic)")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_scope(ctx.path, ctx.config.atomic_write_scope):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open"):
                continue
            mode: Optional[ast.expr] = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if not (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and "w" in mode.value):
                continue
            out.append(Finding(
                self.name, ctx.path, node.lineno, node.col_offset,
                f"open-{mode.value}",
                f"bare open(..., {mode.value!r}) is a torn-write "
                "window: write via snapshotter.atomic_write / "
                "write_json_atomic (tempfile + os.replace)"))
        return out


class EnvRegistryRule:
    """Every ``os.environ`` read/write of a ``VELES_*`` name must be
    declared in veles_tpu_torch/knobs.py (which also generates the
    README's knob table); an undeclared knob is read forever and set
    never."""

    name = "env-registry"
    doc = ("`VELES_*` environment access whose name is not declared "
           "in veles_tpu_torch/knobs.py (also verifies the generated "
           "README.md knob table is in sync)")

    def _env_key_nodes(self, ctx: ModuleContext
                       ) -> Iterator[ast.expr]:
        for node in ast.walk(ctx.tree):
            # os.environ.get/pop/setdefault(KEY, ...), os.getenv(KEY)
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and node.args:
                    base = f.value
                    if (isinstance(base, ast.Attribute)
                            and base.attr == "environ"
                            and f.attr in ("get", "pop",
                                           "setdefault")):
                        yield node.args[0]
                    elif (isinstance(base, ast.Name)
                          and base.id == "os"
                          and f.attr == "getenv"):
                        yield node.args[0]
            # os.environ[KEY] in any expression context
            elif isinstance(node, ast.Subscript):
                v = node.value
                if isinstance(v, ast.Attribute) and \
                        v.attr == "environ":
                    yield node.slice

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if ctx.path in ctx.config.registry_exempt:
            return []
        from veles_tpu_torch import knobs
        declared = knobs.names()
        out: List[Finding] = []
        for key_node in self._env_key_nodes(ctx):
            name = ctx.resolve_str(key_node)
            if name is None or not name.startswith("VELES_"):
                continue
            if name in declared:
                continue
            out.append(Finding(
                self.name, ctx.path, key_node.lineno,
                key_node.col_offset, name,
                f"undeclared env knob {name!r}: declare it in "
                "veles_tpu_torch/knobs.py (name, default, parser, doc) "
                "and regenerate the README table"))
        return out


class EventRegistryRule:
    """Telemetry names (journal events, counters, gauges, histograms,
    spans) must be the declared constants from
    veles_tpu_torch/events.py,
    never ad-hoc string literals — an emitter/asserter typo otherwise
    only surfaces when a chaos drill reads an event that never
    fired."""

    name = "event-registry"
    doc = ("string literal passed to telemetry.event / counter / "
           "gauge / histogram / span / recent_events — use the "
           "declared constant from veles_tpu_torch/events.py")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if ctx.path in ctx.config.registry_exempt or \
                ctx.path == "veles_tpu_torch/telemetry.py":
            # telemetry.py forwards caller-supplied names; the
            # registries declare literals by design
            return []
        from veles_tpu_torch import events
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            f = node.func
            is_telemetry_call = (
                isinstance(f, ast.Attribute)
                and f.attr in _TELEMETRY_FUNCS
                and isinstance(f.value, ast.Name)
                and f.value.id == "telemetry")
            if not is_telemetry_call:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue   # constants/variables/f-strings pass
            literal = arg.value
            if events.known(literal):
                hint = ("declared in veles_tpu_torch/events.py — "
                        "import and use its constant instead of the "
                        "literal")
            else:
                hint = ("NOT declared in veles_tpu_torch/events.py — a "
                        "typo, or a new name missing its registry "
                        "entry")
            out.append(Finding(
                self.name, ctx.path, arg.lineno, arg.col_offset,
                literal,
                f"ad-hoc telemetry name literal {literal!r}: {hint}"))
        return out


class TracerHygieneRule:
    """Device-side step code (module docstring) must not host-sync: each
    sync is a device -> host round trip inside what should be one
    stream of kernels, and under ``vmap`` some of them raise."""

    name = "tracer-hygiene"
    doc = ("host sync (.item / .cpu / .numpy / .tolist / synchronize / "
           "print / bool, float, int of a parameter / a Python branch "
           "on a torch value) inside device-side step code: a function "
           "under a torch.func transform or built by a build_* "
           "function of engine/core.py")

    _TRANSFORMS = frozenset((
        "vmap", "functional_call", "grad", "grad_and_value", "vjp",
        "jvp", "jacrev", "jacfwd"))

    def _target_name(self, arg: ast.expr) -> Optional[str]:
        """The function a transform is handed: ``f``, or
        ``functools.partial(f, ...)``."""
        if isinstance(arg, ast.Name):
            return arg.id
        if isinstance(arg, ast.Call) and \
                _call_name(arg.func) == "partial" and arg.args and \
                isinstance(arg.args[0], ast.Name):
            return arg.args[0].id
        return None

    def _device_functions(self, ctx: ModuleContext
                          ) -> List[ast.FunctionDef]:
        transformed = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and \
                    _call_name(node.func) in self._TRANSFORMS:
                for arg in node.args:
                    name = self._target_name(arg)
                    if name:
                        transformed.add(name)
        out = []
        seen = set()

        def add(fn) -> None:
            if id(fn) not in seen:
                seen.add(id(fn))
                out.append(fn)

        if ctx.path in ctx.config.device_step_modules:
            for stmt in ctx.tree.body:
                if isinstance(stmt, ast.FunctionDef) and \
                        stmt.name.startswith("build_"):
                    for node in ast.walk(stmt):
                        if node is not stmt and isinstance(
                                node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                            add(node)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node.name in transformed:
                add(node)
                continue
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if _call_name(d) in self._TRANSFORMS:
                    add(node)
                    break
        return out

    def _flag(self, ctx: ModuleContext, node: ast.AST, fn_name: str,
              what: str, out: List[Finding]) -> None:
        out.append(Finding(
            self.name, ctx.path, node.lineno,
            getattr(node, "col_offset", 0),
            f"{fn_name}:{what}",
            f"{what} inside device-side function {fn_name!r}: a host "
            "sync in the step (or an error under vmap) — keep the "
            "step's code on the device"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in self._device_functions(ctx):
            params = {a.arg for a in fn.args.args
                      + fn.args.posonlyargs + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) and \
                            f.attr in _HOST_SYNC_METHODS:
                        self._flag(ctx, node, fn.name,
                                   f".{f.attr}()", out)
                    elif isinstance(f, ast.Name) and \
                            f.id == "print":
                        self._flag(ctx, node, fn.name, "print()",
                                   out)
                    elif isinstance(f, ast.Name) and \
                            f.id in ("float", "int", "bool") and \
                            len(node.args) == 1 and \
                            isinstance(node.args[0], ast.Name) and \
                            node.args[0].id in params:
                        self._flag(
                            ctx, node, fn.name,
                            f"{f.id}({node.args[0].id})", out)
                elif isinstance(node, (ast.If, ast.While)):
                    for sub in ast.walk(node.test):
                        if isinstance(sub, ast.Call) and \
                                isinstance(sub.func, ast.Attribute) \
                                and isinstance(sub.func.value,
                                               ast.Name) \
                                and sub.func.value.id == "torch":
                            self._flag(
                                ctx, node, fn.name,
                                "python branch on torch value", out)
                            break
        return out


class ExitCodeLiteralsRule:
    """The 13/14 exit-code contract flows from the named constants
    (Launcher.PREEMPT_EXIT, supervisor.EXIT_*);
    a bare 13 or 14 in an exit call or comparison silently forks the
    contract."""

    name = "exit-code-literals"
    doc = ("literal 13/14 in exit calls or comparisons inside the "
           "exit-contract modules — use the launcher/supervisor "
           "constants")

    _EXIT_CALLS = frozenset(("_exit", "exit", "SystemExit"))

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if ctx.path not in ctx.config.exit_code_modules:
            return []
        out: List[Finding] = []

        def flag(node: ast.AST, value: int, where: str) -> None:
            out.append(Finding(
                self.name, ctx.path, node.lineno,
                getattr(node, "col_offset", 0),
                f"{where}-{value}",
                f"exit-code literal {value} in {where}: use the "
                "named constant (Launcher.PREEMPT_EXIT, "
                "supervisor.EXIT_PREEMPTED / EXIT_MULTIHOST_ABORT)"))

        def contract_consts(node: ast.expr) -> Iterator[ast.Constant]:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and \
                        sub.value in _CONTRACT_CODES and \
                        isinstance(sub.value, int):
                    yield sub

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and \
                    _call_name(node.func) in self._EXIT_CALLS:
                for arg in node.args:
                    for c in contract_consts(arg):
                        flag(c, c.value, "exit-call")
            elif isinstance(node, ast.Compare):
                for side in [node.left] + list(node.comparators):
                    for c in contract_consts(side):
                        flag(c, c.value, "comparison")
        return out


class LockDisciplineRule:
    """Module-level mutable containers in the thread-spawning modules
    must be mutated under a held lock (``with <...lock...>:``) —
    anything else is a data race a drill can only catch by luck."""

    name = "lock-discipline"
    doc = ("module-level mutable container mutated outside a held "
           "lock in a thread-spawning module")

    _CTORS = frozenset(("dict", "list", "set", "deque",
                        "defaultdict", "OrderedDict"))

    def _module_mutables(self, ctx: ModuleContext) -> set:
        names = set()
        for stmt in ctx.tree.body:
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            mutable = isinstance(value, (ast.Dict, ast.List,
                                         ast.Set)) or (
                isinstance(value, ast.Call)
                and _call_name(value.func) in self._CTORS)
            if not mutable:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        return names

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if ctx.path not in ctx.config.lock_modules:
            return []
        mutables = self._module_mutables(ctx)
        if not mutables:
            return []
        out: List[Finding] = []

        def flag(node: ast.AST, name: str, how: str) -> None:
            out.append(Finding(
                self.name, ctx.path, node.lineno,
                getattr(node, "col_offset", 0),
                f"{name}.{how}",
                f"module-level mutable {name!r} mutated ({how}) "
                "outside a held lock in a thread-spawning module — "
                "wrap in `with <lock>:` (or waive with a written "
                "reason if provably single-threaded/GIL-atomic)"))

        for node in ast.walk(ctx.tree):
            # import-time statements run before any thread exists
            if not ctx.in_function(node):
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in mutables and \
                    node.func.attr in _MUTATORS:
                if not ctx.under_lock(node):
                    flag(node, node.func.value.id, node.func.attr)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in mutables and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                if not ctx.under_lock(node):
                    flag(node, node.value.id, "setitem")
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Subscript) and \
                    isinstance(node.target.value, ast.Name) and \
                    node.target.value.id in mutables:
                if not ctx.under_lock(node):
                    flag(node, node.target.value.id, "augassign")
        return out


class EngineResidencySeamRule:
    """Host -> card placement is the execution core's and the residency
    ledger's job: a stray ``.cuda()`` or ``.to(device)`` on the serving
    or online path puts bytes on the card that the HBM arbiter never
    charged, so placement there may only appear inside the seam modules
    (engine/core.py, serve/residency.py); everything else routes
    through ``engine.core`` / ``ExecutionCore.put``."""

    name = "engine-residency-seam"
    doc = ("host -> card placement (`.cuda()`, `.to(device)`, a torch "
           "factory with `device=`) on the serving or online path "
           "outside the residency seam (engine/core.py, "
           "serve/residency.py) — route through the execution core")

    _FACTORIES = frozenset((
        "tensor", "as_tensor", "zeros", "ones", "empty", "full",
        "arange", "linspace", "rand", "randn", "randint", "zeros_like",
        "ones_like", "empty_like", "full_like", "eye", "from_numpy"))

    @staticmethod
    def _is_device(node: ast.expr) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str) and \
                node.value.startswith("cuda")
        ident = _call_name(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if isinstance(node, ast.Call):
            ident = _call_name(node.func)
        return bool(ident) and ("device" in ident.lower()
                                or ident.lower() in ("dev", "cuda"))

    def _placement(self, node: ast.Call) -> Optional[str]:
        f = node.func
        kws = {kw.arg: kw.value for kw in node.keywords if kw.arg}
        if isinstance(f, ast.Attribute) and f.attr == "cuda":
            return ".cuda()"
        if isinstance(f, ast.Attribute) and f.attr == "to":
            if "device" in kws or (node.args
                                   and self._is_device(node.args[0])):
                return ".to(device)"
            return None
        if "device" in kws and isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and \
                f.value.id == "torch" and f.attr in self._FACTORIES:
            return f"torch.{f.attr}(device=)"
        return None

    def check(self, ctx: ModuleContext) -> List[Finding]:
        if not _in_scope(ctx.path, ctx.config.seam_scope) or \
                _in_scope(ctx.path, ctx.config.engine_seam_modules):
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            what = self._placement(node)
            if what is None:
                continue
            out.append(Finding(
                self.name, ctx.path, node.lineno, node.col_offset, what,
                f"{what} outside the residency seam bypasses the HBM "
                "arbiter's ledger — place tensors through "
                "engine.core (ExecutionCore.put) or "
                "serve/residency.py"))
        return out


from veles_tpu_torch.analysis.concurrency import (  # noqa: E402 — it
    # needs Finding/ModuleContext from engine, so it cannot be imported
    # before them
    PROJECT_RULES,
    ThreadLifecycleRule,
    TraceWireKeyRule,
    WireProtocolRule,
)

RULES = [
    AtomicWriteRule(),
    EnvRegistryRule(),
    EventRegistryRule(),
    TracerHygieneRule(),
    ExitCodeLiteralsRule(),
    LockDisciplineRule(),
    EngineResidencySeamRule(),
    ThreadLifecycleRule(),
    WireProtocolRule(),
    TraceWireKeyRule(),
]


def rule_names() -> List[str]:
    """Every rule, per-file and whole-program alike (the CLI's
    --rule choices and the guide's catalog order)."""
    return [r.name for r in RULES] + [r.name for r in PROJECT_RULES]
