"""The port's veleslint (``veles_tpu_torch/analysis``) against the
reference's (``veles_tpu/analysis``).

- Every framework-free rule over the reference's own fixtures
  (``tests/fixtures/veleslint/``), finding for finding with the
  reference's ``scan_source`` and flow analyses: the same rule, line,
  column and identity, each package scanning the fixture under its own
  package path.
- The two torch rules (``tracer-hygiene``, ``engine-residency-seam``) on
  the seeded sources of ``tests/torch_lint_fixtures.py``.
- Waivers, the baseline's round trip and the port's baseline's reasons.
- The full scan of the port's tree: zero findings outside the baseline,
  no stale entry; the README's knob table in sync with ``knobs.py``; the
  locking law in sync with the scan, acyclic, and naming exactly the
  witness's ``LOCK_NAMES``.
"""

import json
import os

import pytest

from tests import torch_lint_fixtures as fx
from veles_tpu.analysis import Config as RefConfig
from veles_tpu.analysis import flow as ref_flow
from veles_tpu.analysis import rule_names as ref_rule_names
from veles_tpu.analysis import scan_source as ref_scan_source
from veles_tpu.analysis.engine import ModuleContext as RefModuleContext
from veles_tpu_torch import knobs
from veles_tpu_torch.analysis import (Config, check_knob_table,
                                      load_baseline, load_config,
                                      new_findings, repo_root, repo_scan,
                                      rule_names, run_lint, scan_source,
                                      write_baseline)
from veles_tpu_torch.analysis import flow, witness
from veles_tpu_torch.analysis.concurrency import lock_table_block
from veles_tpu_torch.analysis.engine import (ModuleContext,
                                             knob_table_block,
                                             load_contexts)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "veleslint")
ROOT = repo_root()


def fixture(name: str) -> str:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        return f.read()


def _ids(findings, rule=None):
    return sorted((f.rule, f.line, f.col, f.detail) for f in findings
                  if rule is None or f.rule == rule)


# -- the framework-free rules, finding for finding -----------------------

#: (fixture, rule, path under each package or None for a scoped path,
#: the config key that scopes it)
PER_FILE = [
    ("atomic_bad.py", "atomic-write", None, None),
    ("atomic_clean.py", "atomic-write", None, None),
    ("env_bad.py", "env-registry", None, None),
    ("env_clean.py", "env-registry", None, None),
    ("event_bad.py", "event-registry", None, None),
    ("event_clean.py", "event-registry", None, None),
    ("exit_bad.py", "exit-code-literals", "fx/exit.py",
     "exit_code_modules"),
    ("exit_clean.py", "exit-code-literals", "fx/exit.py",
     "exit_code_modules"),
    ("lock_bad.py", "lock-discipline", "fx/lock.py", "lock_modules"),
    ("lock_clean.py", "lock-discipline", "fx/lock.py", "lock_modules"),
    ("thread_bad.py", "thread-lifecycle", "fx/threads.py",
     "thread_modules"),
    ("thread_clean.py", "thread-lifecycle", "fx/threads.py",
     "thread_modules"),
    ("wire_bad.py", "wire-protocol", "fx/wire.py", "wire_modules"),
    ("wire_clean.py", "wire-protocol", "fx/wire.py", "wire_modules"),
    ("waiver.py", None, None, None),
]


@pytest.mark.parametrize("name,rule,path,key", PER_FILE,
                         ids=[p[0] for p in PER_FILE])
def test_per_file_rule_matches_the_reference(name, rule, path, key):
    src = fixture(name)
    if path is None:
        ref = ref_scan_source(f"veles_tpu/_fixture_{name}", src,
                              RefConfig())
        mine = scan_source(f"veles_tpu_torch/_fixture_{name}", src,
                           Config())
    else:
        ref = ref_scan_source(path, src, RefConfig(**{key: [path]}))
        mine = scan_source(path, src, Config(**{key: [path]}))
    assert _ids(mine, rule) == _ids(ref, rule)
    if name.endswith("_bad.py"):
        assert _ids(mine, rule), f"{name}: nothing found"
    if name.endswith("_clean.py") or name == "waiver.py":
        assert _ids(mine, rule) == []


def _projects(name: str, sub: str):
    src = fixture(name)
    ref_path = f"veles_tpu/serve/{sub}"
    path = f"veles_tpu_torch/serve/{sub}"
    ref = ref_flow.build_project(
        [RefModuleContext(ref_path, src, RefConfig())])
    mine = flow.build_project([ModuleContext(path, src, Config())])
    return (ref, ref_path), (mine, path)


@pytest.mark.parametrize("name", ["blocking_bad.py", "blocking_clean.py"])
def test_blocking_under_lock_matches_the_reference(name):
    (ref, rp), (mine, mp) = _projects(name, "_fx_blocking.py")
    want = _ids(ref_flow.blocking_findings(ref, [rp]))
    got = _ids(flow.blocking_findings(mine, [mp]))
    assert got == want
    assert bool(got) == (name == "blocking_bad.py")


@pytest.mark.parametrize("name", ["waiter_bad.py", "waiter_clean.py"])
def test_waiter_discipline_matches_the_reference(name):
    (ref, rp), (mine, mp) = _projects(name, "_fx_waiter.py")
    want = _ids(ref_flow.waiter_findings(ref, [rp]))
    got = _ids(flow.waiter_findings(mine, [mp]))
    assert got == want
    assert bool(got) == (name == "waiter_bad.py")


@pytest.mark.parametrize("name", ["lockorder_bad.py",
                                  "lockorder_clean.py"])
def test_lock_graph_matches_the_reference(name):
    (ref, rp), (mine, mp) = _projects(name, "_fx_lockorder.py")
    want = ref_flow.build_lock_graph(ref, scope=[rp])
    got = flow.build_lock_graph(mine, scope=[mp])
    assert got.edge_pairs() == want.edge_pairs() and got.edge_pairs()
    assert set(got.nodes) == set(want.nodes)
    assert got.cycles() == want.cycles()
    assert bool(got.cycles()) == (name == "lockorder_bad.py")


def test_the_rule_catalog_is_the_references():
    assert rule_names() == ref_rule_names()
    assert len(rule_names()) == 13


# -- the torch rules -------------------------------------------------------

def _tracer(src: str, path: str = "veles_tpu_torch/_fx_step.py"):
    found = scan_source(path, src, Config(device_step_modules=[path]))
    return [f for f in found if f.rule == "tracer-hygiene"]


def test_tracer_hygiene_catches_every_host_sync():
    got = _tracer(fx.TRACER_BAD)
    assert {f.detail for f in got} == {
        "member_step:.item()", "member_step:print()",
        "member_step:float(lr)", "member_eval:.cpu()",
        "member_eval:.numpy()",
        "decorated:python branch on torch value",
        "fused_step:.synchronize()", "fused_step:bool(flag)",
        "fused_step:.tolist()"}, got
    # the builders count only in the device-step modules
    other = scan_source("veles_tpu_torch/_fx_other.py", fx.TRACER_BAD,
                        Config())
    assert not any(f.detail.startswith("fused_step:") for f in other)


def test_tracer_hygiene_clean():
    assert _tracer(fx.TRACER_CLEAN) == []


def _seam(src: str, path: str):
    return [f for f in scan_source(path, src, Config())
            if f.rule == "engine-residency-seam"]


def test_residency_seam_catches_placements_on_the_serving_path():
    got = _seam(fx.SEAM_BAD, "veles_tpu_torch/serve/_fx_place.py")
    assert sorted(f.detail for f in got) == sorted([
        ".cuda()", ".to(device)", "torch.as_tensor(device=)",
        "torch.zeros(device=)", ".to(device)"]), got
    # the same code in a seam module, or off the serving and online
    # paths, is allowed
    assert _seam(fx.SEAM_BAD, "veles_tpu_torch/serve/residency.py") == []
    assert _seam(fx.SEAM_BAD, "veles_tpu_torch/engine/core.py") == []
    assert _seam(fx.SEAM_BAD, "veles_tpu_torch/ops/_fx_place.py") == []
    assert _seam(fx.SEAM_BAD, "veles_tpu_torch/online/_fx.py") != []


def test_residency_seam_clean():
    assert _seam(fx.SEAM_CLEAN, "veles_tpu_torch/serve/_fx_place.py") == []


def test_trace_wire_key_checks_the_ports_trace_module():
    found = scan_source("veles_tpu_torch/trace.py", fx.TRACE_WIRE_BAD,
                        Config())
    got = {f.detail for f in found if f.rule == "trace-wire-key"}
    assert got == {"not_a_wire_key", "hops_undeclared"}
    with open(os.path.join(ROOT, "veles_tpu_torch", "trace.py")) as f:
        real = scan_source("veles_tpu_torch/trace.py", f.read(), Config())
    assert [f for f in real if f.rule == "trace-wire-key"] == []


# -- waivers and the baseline ----------------------------------------------

def test_finding_key_is_line_stable():
    src = fixture("env_bad.py")
    a = scan_source("veles_tpu_torch/_fx_env.py", src, Config())
    b = scan_source("veles_tpu_torch/_fx_env.py", "# pad\n# pad\n" + src,
                    Config())
    assert {f.key for f in a} == {f.key for f in b} and a
    assert {f.line for f in a} != {f.line for f in b}


def test_baseline_roundtrip(tmp_path):
    findings = scan_source("veles_tpu_torch/_fx_env.py",
                           fixture("env_bad.py"), Config())
    path = str(tmp_path / "baseline.json")
    write_baseline(path, findings)
    # a grandfathered finding without a written reason is refused
    with pytest.raises(ValueError, match="justification"):
        load_baseline(path)
    with open(path) as f:
        data = json.load(f)
    for entry in data["findings"]:
        entry["justification"] = "fixture: deliberately seeded"
    with open(path, "w") as f:
        json.dump(data, f)
    baseline = load_baseline(path)
    assert len(baseline) == len({f.key for f in findings})
    assert new_findings(findings, baseline) == []


def test_the_ports_baseline_gives_a_reason_per_entry():
    path = os.path.join(ROOT, load_config(ROOT).baseline)
    with open(path) as f:
        entries = json.load(f)["findings"]
    assert entries
    for e in entries:
        assert len(e["justification"].split()) >= 8, e
        assert e["key"].split("|")[1].startswith("veles_tpu_torch/"), e


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config key"):
        Config(not_a_real_option=True)


# -- the full scan, the tables, the law ------------------------------------

@pytest.fixture(scope="module")
def full_scan():
    return run_lint(ROOT)


def test_full_scan_has_no_finding_outside_the_baseline(full_scan):
    baseline = load_baseline(os.path.join(ROOT, load_config(ROOT).baseline))
    new = new_findings(full_scan, baseline)
    assert not new, "\n".join(f.format() for f in new)
    # no stale entry: each one still matches a finding
    assert set(baseline) == {f.key for f in full_scan}
    scanned = {f.path for f in full_scan}
    assert all(p.startswith("veles_tpu_torch/") for p in scanned), scanned


def test_repo_scan_and_the_cli_agree(capsys):
    from veles_tpu_torch.analysis import cli
    new, baseline = repo_scan()
    assert new == [] and baseline
    assert cli.main(["--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["baseline_total"] == len(baseline)


def test_cli_exit_code_on_a_seeded_tree(tmp_path, capsys):
    from veles_tpu_torch.analysis import cli
    root = tmp_path / "repo"
    (root / "veles_tpu_torch").mkdir(parents=True)
    (root / "veles_tpu_torch" / "bad.py").write_text(
        'def w(p):\n    with open(p, "w") as f:\n        f.write("x")\n')
    rc = cli.main(["--root", str(root), "--rule", "atomic-write",
                   "--no-docs-check"])
    out = capsys.readouterr().out
    assert rc == 1 and "atomic-write" in out and "bad.py" in out


def test_the_readme_knob_table_is_in_sync():
    assert check_knob_table(ROOT, load_config(ROOT)) is None
    with open(os.path.join(ROOT, "README.md")) as f:
        readme = f.read()
    assert knob_table_block() in readme
    assert "`VELES_PLOTS_DIR` | 'plots' | str |" in knobs.render_table()


def test_the_law_is_the_scan_acyclic_and_the_witness_names(full_scan):
    cfg = load_config(ROOT)
    law = flow.load_lock_order(os.path.join(ROOT, cfg.lock_order))
    assert not [f for f in full_scan if f.rule == "lock-order"]
    project = flow.build_project(load_contexts(ROOT, cfg))
    graph = flow.build_lock_graph(project, scope=cfg.lock_modules,
                                  node_scope=cfg.law_scope)
    assert graph.edge_pairs() == flow.declared_edges(law)
    assert graph.cycles() == []
    assert {n["name"] for n in law["nodes"]} == witness.LOCK_NAMES
    assert all(n["witnessed"] for n in law["nodes"])
    with open(os.path.join(ROOT, "README.md")) as f:
        assert lock_table_block(law) in f.read()
