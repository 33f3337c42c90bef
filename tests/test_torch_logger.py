"""The port's logger against the reference's.

``Logger`` names, ``add_jsonl_sink`` (the same line format the
reference's sink writes, one JSON object a record, read back the same
way), the journal hook (WARNING and above become ``log.record`` events
in the port's telemetry, INFO does not), and a sink whose file closes
under it unregistering itself instead of failing the caller.
"""

import json
import logging

import pytest

from veles_tpu import logger as ref_logger
from veles_tpu_torch import events, logger, telemetry


@pytest.fixture(autouse=True)
def _port_logging():
    telemetry.reset()
    logger.setup_logging()
    hooks = list(logger.event_hooks)
    yield
    logger.event_hooks[:] = hooks
    telemetry.reset()


class Unit(logger.Logger):
    pass


class Named(logger.Logger):
    name = "loader"


def test_logger_names_match_the_reference():
    class RefUnit(ref_logger.Logger):
        pass

    assert Unit().logger.name == "veles.Unit"
    assert Named().logger.name == "veles.loader"
    assert RefUnit().logger.name == "veles.RefUnit"


def test_setup_logging_routes_the_veles_namespace():
    vlog = logging.getLogger("veles")
    assert any(isinstance(h, logger._HookHandler) for h in vlog.handlers)
    assert any(type(h) is logging.StreamHandler for h in vlog.handlers)
    plog = logging.getLogger("veles_tpu_torch")
    assert any(isinstance(h, logger._HookHandler) for h in plog.handlers)
    assert plog.propagate
    n = len(vlog.handlers)
    logger.setup_logging(logging.DEBUG)   # idempotent
    assert len(vlog.handlers) == n and vlog.level == logging.DEBUG
    logger.setup_logging()


def test_jsonl_sink_writes_the_reference_format(tmp_path):
    path = tmp_path / "events.jsonl"
    detach = logger.add_jsonl_sink(str(path))
    Named().info("epoch %d done", 3)
    Unit().warning("careful")
    logging.getLogger("veles_tpu_torch.fused").warning("port namespace")
    detach()
    Named().info("after detach")
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [(r["level"], r["unit"], r["message"]) for r in rows] == [
        ("INFO", "veles.loader", "epoch 3 done"),
        ("WARNING", "veles.Unit", "careful"),
        ("WARNING", "veles_tpu_torch.fused", "port namespace")]
    assert all(set(r) == {"ts", "level", "unit", "message"}
               and isinstance(r["ts"], float) for r in rows)

    # the reference's sink, fed the same record, writes the same keys
    ref_path = tmp_path / "ref.jsonl"
    ref_detach = ref_logger.add_jsonl_sink(str(ref_path))
    record = logging.LogRecord("veles.loader", logging.INFO, __file__, 1,
                               "epoch %d done", (3,), None)
    ref_logger.event_hooks[-1](record)
    ref_detach()
    ref_row = json.loads(ref_path.read_text())
    assert set(ref_row) == set(rows[0])
    assert {k: ref_row[k] for k in ("level", "unit", "message")} == \
        {k: rows[0][k] for k in ("level", "unit", "message")}


def test_warnings_reach_the_journal_and_info_does_not():
    Unit().warning("probe %d", 7)
    Unit().info("below the threshold")
    evs = telemetry.recent_events(events.EV_LOG_RECORD)
    assert any(e["message"] == "probe 7" and e["level"] == "WARNING"
               and e["unit"] == "veles.Unit" for e in evs)
    assert not any(e["message"] == "below the threshold" for e in evs)


def test_a_closed_sink_unregisters_itself(tmp_path):
    path = tmp_path / "closed.jsonl"
    logger.add_jsonl_sink(str(path))
    hook = logger.event_hooks[-1]
    sink_file = next(c.cell_contents for c in hook.__closure__
                     if hasattr(c.cell_contents, "write"))
    sink_file.close()
    Unit().info("lost, and harmless")
    assert hook not in logger.event_hooks
    Unit().info("the run goes on")
