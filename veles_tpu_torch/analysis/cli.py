"""The ``veleslint`` command line of the port (the port's copy of
``veles_tpu/analysis/cli.py``), run as ``python -m
veles_tpu_torch.tools.veleslint``.

Exit codes: 0 clean (no non-baselined finding), 1 new findings, 2 a
usage, config or baseline error (a baseline entry without a written
justification, say).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from veles_tpu_torch.analysis import engine, rules as rules_mod
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch.tools.veleslint",
        description="the port's AST invariant checks (README.md's "
                    "port section)")
    p.add_argument("--root", default=None,
                   help="repository root (default: autodetected)")
    p.add_argument("--rule", action="append", default=None,
                   metavar="NAME", choices=rules_mod.rule_names(),
                   help="run only this rule (repeatable)")
    p.add_argument("--format", choices=("text", "json"),
                   default="text")
    p.add_argument("--all", action="store_true",
                   help="report every finding, baselined ones "
                        "included (marked)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather the current findings into the "
                        "baseline file; new entries get a TODO "
                        "justification that MUST be hand-edited "
                        "(the loader refuses TODOs)")
    p.add_argument("--sync-docs", action="store_true",
                   help="regenerate the VELES_* knob table in "
                        "README.md from veles_tpu_torch/knobs.py")
    p.add_argument("--sync-lock-order", action="store_true",
                   help="regenerate veles_tpu_torch/analysis/"
                        "lock_order.json (the locking law) and README.md's "
                        "threading-model table from the live scan; review "
                        "the diff before committing")
    p.add_argument("--changed-only", action="store_true",
                   help="fast inner-loop mode: report per-file "
                        "findings only for git-changed files (the "
                        "lock-order law is still checked whole; the "
                        "full scan stays the tier-1 gate)")
    p.add_argument("--no-docs-check", action="store_true",
                   help="skip the README knob-table sync check")
    args = p.parse_args(argv)

    root = args.root or engine.repo_root()
    try:
        config = engine.load_config(root)
    except ValueError as e:
        print(f"veleslint: {e}", file=sys.stderr)
        return 2

    if args.sync_docs:
        guide = engine.sync_knob_table(root, config)
        print(f"veleslint: knob table regenerated in {guide}")
        return 0

    if args.sync_lock_order:
        from veles_tpu_torch.analysis.concurrency import sync_lock_order
        contexts = engine.load_contexts(root, config)
        law = sync_lock_order(root, config, contexts)
        print(f"veleslint: locking law regenerated in {law} "
              f"(+ the README threading-model table)")
        return 0

    only_paths = None
    if args.changed_only:
        only_paths = _git_changed_paths(root)
        if only_paths is None:
            print("veleslint: --changed-only needs a git checkout; "
                  "falling back to the full scan", file=sys.stderr)

    baseline_path = os.path.join(root, config.baseline)
    try:
        baseline = engine.load_baseline(baseline_path)
    except ValueError as e:
        print(f"veleslint: {e}", file=sys.stderr)
        return 2

    findings = engine.run_lint(root, config, rules=args.rule,
                               check_docs=not args.no_docs_check,
                               only_paths=only_paths)

    if args.write_baseline:
        engine.write_baseline(baseline_path, findings, baseline)
        print(f"veleslint: {len(findings)} finding(s) written to "
              f"{baseline_path}; edit every TODO justification "
              "before committing")
        return 0

    new = engine.new_findings(findings, baseline)
    shown = findings if args.all else new
    if args.format == "json":
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": len(findings) - len(new),
            "baseline_total": len(baseline),
        }, indent=1))
    else:
        for f in shown:
            tag = "" if f.key not in baseline else " (baselined)"
            print(f.format() + tag)
        # staleness is only decidable from a full scan: a --rule or
        # --changed-only run never produces the other findings
        stale = [] if args.rule or only_paths is not None else \
            [k for k in baseline
             if k not in {f.key for f in findings}]
        if stale:
            print(f"veleslint: note: {len(stale)} stale baseline "
                  "entr(y/ies) no longer found — prune them:",
                  file=sys.stderr)
            for k in stale:
                print(f"  {k}", file=sys.stderr)
        print(f"veleslint: {len(new)} new finding(s), "
              f"{len(findings) - len(new)} baselined, "
              f"{len(baseline)} baseline entr(y/ies)")
    return 1 if new else 0


def _git_changed_paths(root: str) -> Optional[List[str]]:
    """Repo-relative .py paths with uncommitted changes (staged,
    unstaged, or untracked); None when git is unavailable — the
    caller falls back to the full scan."""
    import subprocess
    try:
        proc = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=15)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    out: List[str] = []
    for line in proc.stdout.splitlines():
        path = line[3:].strip()
        if " -> " in path:          # rename: scan the new name
            path = path.split(" -> ", 1)[1]
        path = path.strip('"')
        if path.endswith(".py"):
            out.append(path)
    return out


if __name__ == "__main__":
    sys.exit(main())
