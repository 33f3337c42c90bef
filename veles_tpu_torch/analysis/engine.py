"""The veleslint engine (the port's copy of
``veles_tpu/analysis/engine.py``): file discovery, AST scaffolding,
waivers, baseline bookkeeping and the README's knob-table check.

Stdlib ``ast`` only: the scan imports neither torch nor the reference,
so it runs anywhere, tier-1 included, in about a second.

Each file parses once into a :class:`ModuleContext` (the AST, parent
links, module and class string constants, the source lines); every rule
visits it, and findings are filtered through inline waivers (``#
veleslint: disable=<rule>[,<rule>...]`` on the flagged line; a bare
``disable`` waives every rule) and then the baseline.  A finding's
identity is ``rule | path | detail``, not its line, so a baselined
finding survives edits elsewhere in its file.

The configuration is this module's :data:`_DEFAULTS`, the port's own
(the reference reads ``pyproject.toml``'s ``[tool.veleslint]``, which
describes the reference's tree): the port's package and
``chip_smoke.py``, its scope lists, its baseline and locking law under
``veles_tpu_torch/analysis/``, and README.md, whose port section holds
the generated knob and threading-model tables.
"""

from __future__ import annotations

import ast
import json
import os
import re
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Tuple

WAIVER_RE = re.compile(
    r"#\s*veleslint:\s*disable(?:=([A-Za-z0-9_,\- ]+))?")

#: the command that regenerates the guide's knob table
SYNC_DOCS = "python -m veles_tpu_torch.tools.veleslint --sync-docs"

#: markers bracketing the generated knob table in the guide (README.md)
KNOB_TABLE_BEGIN = "<!-- veleslint:knobs:begin -->"
KNOB_TABLE_END = "<!-- veleslint:knobs:end -->"


class Finding:
    """One lint finding.  ``detail`` is the stable identity component
    (an env name, an event literal, a function name...) so baseline
    matching survives line drift."""

    __slots__ = ("rule", "path", "line", "col", "detail", "message")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 detail: str, message: str) -> None:
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.detail = detail
        self.message = message

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.detail}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}")

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "col": self.col,
                "detail": self.detail, "message": self.message,
                "key": self.key}

    def __repr__(self) -> str:
        return f"Finding({self.format()})"


# -- configuration -----------------------------------------------------

_PKG = "veles_tpu_torch"

#: the port's checked-in locking law, absolute: the lint's default, the
#: chaos drill's witness pass and the smoke's fleet witness all read it
LAW_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lock_order.json")


def _mods(*names: str) -> List[str]:
    return [f"{_PKG}/{n}.py" for n in names]


_SERVE = ("serve/batcher", "serve/client", "serve/fleet", "serve/hive",
          "serve/residency", "serve/router", "serve/sentinel",
          "serve/traffic", "serve/autoscale")
_ONLINE = ("online/tap", "online/buffer", "online/trainer",
           "online/promote")

_DEFAULTS: Dict[str, Any] = {
    # scan roots, relative to the repo root
    "paths": [_PKG, "chip_smoke.py"],
    # directory basenames never descended into
    "exclude": ["__pycache__", "_build", "csrc", "tests", "build",
                "dist"],
    "baseline": f"{_PKG}/analysis/baseline.json",
    # where the generated knob and threading-model tables live
    "guide": "README.md",
    # atomic-write applies only under these prefixes (the smoke script
    # writes scratch files freely; the package writes persistent state)
    "atomic_write_scope": [_PKG],
    # exit-code-literals applies to the modules that own the 0/13/14
    # contract (elsewhere a bare 13 is just a number)
    "exit_code_modules": _mods(
        "launcher", "supervisor", "__main__", "genetics/core",
        "genetics/worker", "genetics/pool", *_ONLINE,
        "tools/chaos_drill", "tools/gauntlet"),
    # lock-discipline, blocking-under-lock and the lock graph's walk
    # apply to the modules that hold locks and spawn threads
    "lock_modules": _mods(
        "faults", "telemetry", "trace", "launcher", "supervisor",
        "web_status", "genetics/pool", "genetics/worker", "ops/fused",
        "ops/lrn_cuda", *_SERVE, *_ONLINE),
    # waiter-discipline applies to the serving tier and the GA's pool
    "waiter_modules": _mods(*_SERVE, "genetics/pool", *_ONLINE),
    # wire-protocol applies to the modules that build JSONL lines
    "wire_modules": _mods(
        "serve/router", "serve/client", "serve/hive", "serve/batcher",
        "serve/sentinel", "serve/traffic", "online/tap",
        "online/trainer", "online/promote"),
    # thread-lifecycle applies to every thread-spawning module
    "thread_modules": _mods(
        "faults", "telemetry", "launcher", "supervisor", "web_status",
        "genetics/pool", "genetics/worker", "serve/batcher",
        "serve/hive", "serve/client", "serve/fleet", "serve/router",
        "serve/sentinel", "serve/traffic", "serve/autoscale",
        "online/trainer", "tools/gauntlet") + ["chip_smoke.py"],
    # engine-residency-seam: host -> card placement on these paths is
    # the seam modules' job alone
    "seam_scope": [f"{_PKG}/serve", f"{_PKG}/online"],
    "engine_seam_modules": _mods("engine/core", "serve/residency"),
    # tracer-hygiene: every function nested in a ``build_*`` function of
    # these modules is device-side step code (the fused step's builders)
    "device_step_modules": _mods("engine/core"),
    #: the checked-in locking law the lock-order rule verifies
    "lock_order": LAW_PATH,
    # the lock graph's nodes: the locks made under these prefixes (the
    # smoke script's own locks are not the port's law)
    "law_scope": [_PKG],
    # the registries themselves declare names as literals by design
    "registry_exempt": _mods("knobs", "events"),
    # rules to run (all by default)
    "rules": [],
}


class Config:
    """Veleslint configuration: :data:`_DEFAULTS`, with keyword
    overrides (the tests scope a fixture this way)."""

    def __init__(self, **overrides: Any) -> None:
        self._values = dict(_DEFAULTS)
        for k, v in overrides.items():
            if k not in _DEFAULTS:
                raise ValueError(f"veleslint: unknown config key {k!r}"
                                 f" (known: {sorted(_DEFAULTS)})")
            self._values[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None


def load_config(root: Optional[str] = None) -> Config:
    """The port's configuration (its defaults; ``root`` is accepted for
    the reference's signature)."""
    return Config()


def repo_root() -> str:
    """The repository root (two levels above this package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# -- module context ----------------------------------------------------

class ModuleContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, source: str, config: Config) -> None:
        self.path = path          # repo-relative, posix separators
        self.source = source
        self.config = config
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        #: module- and class-level ``NAME = "literal"`` string
        #: constants, for resolving env/event names referenced by
        #: constant instead of literal.  Class attrs are flattened by
        #: bare attribute name (``self.PREEMPT_GRACE_ENV`` ->
        #: ``PREEMPT_GRACE_ENV``).
        self.str_consts: Dict[str, str] = {}
        self._collect_consts()

    def _collect_consts(self) -> None:
        def grab(body: Iterable[ast.stmt]) -> None:
            for stmt in body:
                targets: List[ast.expr] = []
                value: Optional[ast.expr] = None
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    targets, value = [stmt.target], stmt.value
                if not (isinstance(value, ast.Constant)
                        and isinstance(value.value, str)):
                    continue
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.str_consts.setdefault(t.id, value.value)
        grab(self.tree.body)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.ClassDef):
                grab(stmt.body)

    def resolve_str(self, node: ast.expr) -> Optional[str]:
        """The string value of ``node`` when statically resolvable:
        a literal, a module/class constant referenced by Name, or by
        Attribute (``self.CONST`` / ``Cls.CONST``).  None otherwise —
        unresolvable names are skipped, not flagged (an imported
        constant is checked where it is defined)."""
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.str_consts.get(node.id)
        if isinstance(node, ast.Attribute):
            return self.str_consts.get(node.attr)
        return None

    def enclosing(self, node: ast.AST,
                  kinds: Tuple[type, ...]) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_function(self, node: ast.AST) -> bool:
        return self.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) is not None

    def under_lock(self, node: ast.AST) -> bool:
        """Is ``node`` lexically inside a ``with <...lock...>:``
        block?  A lock is any context expression containing a
        Name/Attribute whose identifier contains "lock"."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    for sub in ast.walk(item.context_expr):
                        ident = None
                        if isinstance(sub, ast.Name):
                            ident = sub.id
                        elif isinstance(sub, ast.Attribute):
                            ident = sub.attr
                        if ident and "lock" in ident.lower():
                            return True
            cur = self.parents.get(cur)
        return False

    def waived(self, line: int, rule: str) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        m = WAIVER_RE.search(self.lines[line - 1])
        if not m:
            return False
        which = m.group(1)
        if which is None:
            return True
        return rule in {r.strip() for r in which.split(",")}


# -- scanning ----------------------------------------------------------

def _iter_files(root: str, config: Config) -> List[str]:
    """Repo-relative paths of every .py file under the configured scan
    roots, exclusions applied."""
    exclude = set(config.exclude)
    out: List[str] = []
    for entry in config.paths:
        full = os.path.join(root, entry)
        if os.path.isfile(full):
            out.append(entry.replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in exclude)
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name),
                                      root)
                out.append(rel.replace(os.sep, "/"))
    return out


def _scan_ctx(ctx: ModuleContext,
              rules: Optional[List[str]]) -> List[Finding]:
    """Per-file rules over one parsed module context."""
    from veles_tpu_torch.analysis.rules import RULES
    findings: List[Finding] = []
    for rule in RULES:
        if rules and rule.name not in rules:
            continue
        for f in rule.check(ctx):
            if not ctx.waived(f.line, f.rule):
                findings.append(f)
    return findings


def scan_source(path: str, source: str, config: Optional[Config] = None,
                rules: Optional[List[str]] = None) -> List[Finding]:
    """Run the (selected) per-file rules over one in-memory module.
    ``path`` is the repo-relative path used for scoping and
    reporting.  The whole-program concurrency rules (lock-order,
    blocking-under-lock, waiter-discipline) need every module at once
    and only run through :func:`run_lint` /
    :func:`project_findings`."""
    config = config or Config()
    try:
        ctx = ModuleContext(path, source, config)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 0, 0,
                        "syntax", f"does not parse: {e.msg}")]
    selected = rules if rules is not None else \
        (config.rules or None)
    findings = _scan_ctx(ctx, selected)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def load_contexts(root: str, config: Config
                  ) -> List[ModuleContext]:
    """Parse every configured file once (parse errors surface as
    findings through run_lint; unparsable files are skipped here)."""
    out: List[ModuleContext] = []
    for rel in _iter_files(root, config):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        try:
            out.append(ModuleContext(rel, source, config))
        except SyntaxError:
            continue
    return out


def project_findings(contexts: List[ModuleContext], root: str,
                     config: Config,
                     rules: Optional[List[str]] = None
                     ) -> List[Finding]:
    """The whole-program concurrency rules over the parsed contexts,
    inline waivers applied (a project finding anchored in a scanned
    file honors `# veleslint: disable=...` on its line)."""
    from veles_tpu_torch.analysis.concurrency import PROJECT_RULES
    from veles_tpu_torch.analysis.flow import build_project
    selected = rules if rules is not None else \
        (config.rules or None)
    wanted = [r for r in PROJECT_RULES
              if not selected or r.name in selected]
    if not wanted:
        return []
    project = build_project(contexts)
    by_path = {ctx.path: ctx for ctx in contexts}
    findings: List[Finding] = []
    for rule in wanted:
        for f in rule.check_project(project, config, root):
            ctx = by_path.get(f.path)
            if ctx is not None and ctx.waived(f.line, f.rule):
                continue
            findings.append(f)
    return findings


def run_lint(root: Optional[str] = None,
             config: Optional[Config] = None,
             rules: Optional[List[str]] = None,
             check_docs: bool = True,
             only_paths: Optional[List[str]] = None) -> List[Finding]:
    """The full scan: per-file rules over every configured file, the
    whole-program concurrency rules over the project, and the docs-sync
    check of the generated knob table.

    ``only_paths`` (the CLI's ``--changed-only`` fast mode) restricts
    REPORTING to those files: the project is still parsed and the
    lock-order law still checked whole (the graph is meaningless
    piecemeal), but per-file and per-function findings outside the
    set are dropped.  The full scan remains the tier-1 gate."""
    root = root or repo_root()
    config = config or load_config(root)
    selected = rules if rules is not None else \
        (config.rules or None)
    only = set(only_paths) if only_paths is not None else None
    findings: List[Finding] = []
    contexts: List[ModuleContext] = []
    for rel in _iter_files(root, config):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        try:
            ctx = ModuleContext(rel, source, config)
        except SyntaxError as e:
            if only is None or rel in only:
                findings.append(Finding(
                    "parse-error", rel, e.lineno or 0, 0, "syntax",
                    f"does not parse: {e.msg}"))
            continue
        contexts.append(ctx)
        if only is not None and rel not in only:
            continue
        findings += _scan_ctx(ctx, selected)
    for f in project_findings(contexts, root, config, rules):
        if only is not None and f.path in only and \
                f.path.endswith(".py"):
            findings.append(f)
        elif only is None or not f.path.endswith(".py"):
            # law-level findings (lock_order.json drift/cycles,
            # guide table) always report — the graph is global
            findings.append(f)
    if check_docs and (rules is None or "env-registry" in rules):
        doc = check_knob_table(root, config)
        if doc is not None:
            findings.append(doc)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- docs sync ---------------------------------------------------------

def knob_table_block() -> str:
    """The full generated block, markers included."""
    from veles_tpu_torch import knobs
    return (f"{KNOB_TABLE_BEGIN}\n"
            "<!-- GENERATED from veles_tpu_torch/knobs.py by `python -m "
            "veles_tpu_torch.tools.veleslint --sync-docs`; do not edit. "
            "-->\n"
            f"{knobs.render_table()}"
            f"{KNOB_TABLE_END}")


def check_knob_table(root: str, config: Config) -> Optional[Finding]:
    """None when the guide's knob table matches the registry; a
    finding otherwise (missing markers count as out of sync)."""
    guide = os.path.join(root, config.guide)
    try:
        with open(guide, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return Finding(
            "env-registry", config.guide, 1, 0, "knob-table",
            "guide file is missing — the generated VELES_* knob table "
            f"must live here ({SYNC_DOCS})")
    begin = text.find(KNOB_TABLE_BEGIN)
    end = text.find(KNOB_TABLE_END)
    if begin < 0 or end < 0:
        return Finding(
            "env-registry", config.guide, 1, 0, "knob-table",
            f"knob-table markers not found ({KNOB_TABLE_BEGIN} ... "
            f"{KNOB_TABLE_END}); run {SYNC_DOCS}")
    current = text[begin:end + len(KNOB_TABLE_END)]
    if current.strip() != knob_table_block().strip():
        line = text[:begin].count("\n") + 1
        return Finding(
            "env-registry", config.guide, line, 0, "knob-table",
            "the VELES_* knob table is out of sync with "
            f"veles_tpu_torch/knobs.py; run {SYNC_DOCS}")
    return None


def sync_knob_table(root: Optional[str] = None,
                    config: Optional[Config] = None) -> str:
    """Rewrite the guide's knob table from the registry (atomically);
    returns the guide path.  Appends a fresh block when the markers
    are missing."""
    root = root or repo_root()
    config = config or load_config(root)
    guide = os.path.join(root, config.guide)
    with open(guide, encoding="utf-8") as f:
        text = f.read()
    block = knob_table_block()
    begin = text.find(KNOB_TABLE_BEGIN)
    end = text.find(KNOB_TABLE_END)
    if begin >= 0 and end >= 0:
        text = text[:begin] + block + text[end + len(KNOB_TABLE_END):]
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
    return guide


# -- baseline ----------------------------------------------------------

def load_baseline(path: str) -> Dict[str, str]:
    """``{finding key: justification}``.  Raises ValueError when an
    entry lacks a written justification — a grandfathered finding
    without a reason is just a suppressed bug."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    out: Dict[str, str] = {}
    for entry in data.get("findings", []):
        key = entry.get("key", "")
        just = (entry.get("justification") or "").strip()
        if not key:
            continue
        if not just or just.lower().startswith("todo"):
            raise ValueError(
                f"{path}: baseline entry {key!r} has no written "
                "justification — fix the finding or justify why it is "
                "grandfathered")
        out[key] = just
    return out


def write_baseline(path: str, findings: List[Finding],
                   existing: Optional[Dict[str, str]] = None) -> None:
    """Write ``findings`` as the new baseline, keeping existing
    justifications and stamping new entries with a TODO the loader
    refuses — committing an unjustified baseline fails tier-1 by
    design."""
    existing = existing or {}
    entries = []
    seen = set()
    for f in findings:
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({
            "key": f.key,
            "line": f.line,
            "message": f.message,
            "justification": existing.get(
                f.key, "TODO: justify this grandfathered finding or "
                       "fix it"),
        })
    payload = {"format": 1, "findings": entries}
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".baseline.",
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


def new_findings(findings: List[Finding],
                 baseline: Dict[str, str]) -> List[Finding]:
    return [f for f in findings if f.key not in baseline]


def repo_scan(root: Optional[str] = None
              ) -> Tuple[List[Finding], Dict[str, str]]:
    """The canonical full scan: (non-baselined findings, the baseline),
    what the tier-1 test records."""
    root = root or repo_root()
    config = load_config(root)
    baseline = load_baseline(os.path.join(root, config.baseline))
    findings = run_lint(root, config)
    return new_findings(findings, baseline), baseline
