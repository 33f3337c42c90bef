"""The port's unit graph core (``mutable.py``, ``units.py``,
``workflow.py``, ``memory.py``, ``accelerated_units.py``) against the
JAX package's.

- The reference's ``TestBool`` and ``TestWorkflowEngine`` scenarios
  (``tests/test_foundation.py``) run in both packages: the same firing
  traces, equal to the reference's literal ones, and the same values.
- The Vector's coherence protocol on the CPU device, step by step beside
  the reference's Vector on XLA:CPU: the same host values and the same
  validity flags after each step.
- A ``Doubler`` AcceleratedUnit, and a Repeater loop of 4 turns around a
  unit that accumulates on its device: results equal to the
  reference's on XLA:CPU, exactly (the same f32 sums), and the output
  stays a device tensor until ``map_read``.
"""

import pickle

import numpy as np
import pytest
import torch

from veles_tpu import accelerated_units as ref_au
from veles_tpu import memory as ref_memory
from veles_tpu import mutable as ref_mutable
from veles_tpu import units as ref_units
from veles_tpu import workflow as ref_workflow
from veles_tpu.backends import JaxDevice
from veles_tpu_torch import accelerated_units, memory, mutable, units, \
    workflow
from veles_tpu_torch.backends import make_device

PORT = (mutable, units, workflow, memory, accelerated_units)
REF = (ref_mutable, ref_units, ref_workflow, ref_memory, ref_au)
CPU = make_device("cpu")


@pytest.fixture(scope="module")
def jaxdev():
    return JaxDevice(platform="cpu")


# -- Bool ------------------------------------------------------------------

def _bool_value_and_assign(m):
    b = m.Bool(False)
    out = [bool(b)]
    b.set(True)
    out.append(bool(b))
    b << False
    return out + [bool(b)]


def _bool_expression_lazy(m):
    a, b = m.Bool(False), m.Bool(False)
    c = a | b
    d = ~c
    out = [bool(c), bool(d)]
    b.set(True)
    return out + [bool(c), bool(d)]


def _bool_and(m):
    a, b = m.Bool(True), m.Bool(False)
    out = [bool(a & b)]
    b.set(True)
    return out + [bool(a & b)]


def _bool_pickle_flattens_expr(m):
    c = pickle.loads(pickle.dumps(~m.Bool(True)))
    out = [bool(c)]
    c.set(True)   # a value again: assignable
    return out + [bool(c)]


def _bool_on_change(m):
    seen = []
    b = m.Bool(False)
    b.on_change = seen.append
    b.set(True)
    b.set(True)
    b << False
    return seen


BOOL_CASES = {
    "value_and_assign": (_bool_value_and_assign, [False, True, False]),
    "expression_lazy": (_bool_expression_lazy, [False, True, True, False]),
    "and": (_bool_and, [False, True]),
    "pickle_flattens_expr": (_bool_pickle_flattens_expr, [False, True]),
    "on_change": (_bool_on_change, [True, False]),
}


@pytest.mark.parametrize("case", sorted(BOOL_CASES))
def test_bool_is_the_references(case):
    fn, want = BOOL_CASES[case]
    assert fn(ref_mutable) == want
    assert fn(mutable) == want


def test_derived_bool_is_not_assignable():
    for m in (ref_mutable, mutable):
        with pytest.raises(ValueError):
            (~m.Bool()).set(True)


# -- the workflow engine ---------------------------------------------------

def _recorder(m_units):
    class Recorder(m_units.Unit):
        def __init__(self, wf, name, trace):
            super().__init__(wf, name=name)
            self.trace = trace

        def run(self):
            self.trace.append(self.name)
    return Recorder


def _linear_chain(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    a, b = R(w, "a", trace), R(w, "b", trace)
    a.link_from(w.start_point)
    b.link_from(a)
    w.end_point.link_from(b)
    w.initialize()
    w.run()
    return trace


def _and_join(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    a, b, c = R(w, "a", trace), R(w, "b", trace), R(w, "c", trace)
    a.link_from(w.start_point)
    b.link_from(w.start_point)
    c.link_from(a, b)
    w.end_point.link_from(c)
    w.initialize()
    w.run()
    return trace


def _gate_skip(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    a, b = R(w, "a", trace), R(w, "b", trace)
    a.link_from(w.start_point)
    b.link_from(a)
    w.end_point.link_from(b)
    a.gate_skip = m_mut.Bool(True)
    w.initialize()
    w.run()
    return trace + [a.run_count, b.run_count]


def _gate_block(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    a, b = R(w, "a", trace), R(w, "b", trace)
    a.link_from(w.start_point)
    b.link_from(a)
    w.end_point.link_from(a)
    b.gate_block = m_mut.Bool(True)
    w.initialize()
    w.run()
    return trace


def _training_loop(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    rpt = m_wf.Repeater(w, name="repeater")
    body = R(w, "body", trace)

    class Decision(R):
        def __init__(self, wf):
            super().__init__(wf, "decision", trace)
            self.complete = m_mut.Bool(False)

        def run(self):
            super().run()
            if trace.count("decision") >= 3:
                self.complete.set(True)

    dec = Decision(w)
    rpt.link_from(w.start_point)
    body.link_from(rpt)
    dec.link_from(body)
    rpt.link_from(dec)
    rpt.gate_block = dec.complete
    w.end_point.link_from(dec)
    w.end_point.gate_block = ~dec.complete
    w.initialize()
    w.run()
    return trace


def _request_stop_at_boundary(mods):
    m_mut, m_units, m_wf = mods[:3]
    R, trace = _recorder(m_units), []
    w = m_wf.Workflow(name="w")
    rpt = m_wf.Repeater(w, name="repeater")

    class Body(R):
        def run(self):
            super().run()
            if len(trace) == 2:
                w.request_stop()

    body = Body(w, "body", trace)
    rpt.link_from(w.start_point, body)
    body.link_from(rpt)
    w.end_point.link_from(body)
    w.end_point.gate_block = m_mut.Bool(True)
    w.initialize()
    w.run()
    return trace + [w.stop_requested]


def _link_attrs(mods):
    m_mut, m_units, m_wf = mods[:3]
    w = m_wf.Workflow(name="w")
    src = m_units.TrivialUnit(w, name="src")
    dst = m_units.TrivialUnit(w, name="dst")
    src.output = 42
    dst.link_attrs(src, ("input", "output"))
    seen = [dst.input]
    src.output = 7
    seen.append(dst.input)
    dst.input = 9
    return seen + [src.output]


def _initialize_retry(mods):
    m_mut, m_units, m_wf = mods[:3]
    w = m_wf.Workflow(name="w")
    order = []

    class A(m_units.Unit):
        def initialize(self, **kw):
            order.append("a")
            self.out_size = 5

    class B(m_units.Unit):
        def initialize(self, **kw):
            order.append("b")
            self.n = self.__dict__["_src"].out_size

    # "a" sorts after "B0" at the start point: B fails first, then retries
    b, a = B(w, name="B0"), A(w, name="a")
    b._src = a
    b.link_from(w.start_point)
    a.link_from(w.start_point)
    w.end_point.link_from(a, b)
    w.initialize()
    return order + [b.n]


def _initialize_deadlock(mods):
    m_mut, m_units, m_wf = mods[:3]
    w = m_wf.Workflow(name="w")

    class Never(m_units.Unit):
        def initialize(self, **kw):
            raise AttributeError("missing input")

    Never(w, name="never").link_from(w.start_point)
    try:
        w.initialize()
    except RuntimeError as e:
        return [str(e).split(";")[0]]
    return ["no error"]


ENGINE_CASES = {
    "linear_chain": (_linear_chain, ["a", "b"]),
    "and_join": (_and_join, ["a", "b", "c"]),
    "gate_skip_propagates": (_gate_skip, ["b", 0, 1]),
    "gate_block_stops": (_gate_block, ["a"]),
    "training_loop_shape": (_training_loop, ["body", "decision"] * 3),
    "request_stop_at_boundary": (_request_stop_at_boundary,
                                 ["body", "body", True]),
    "link_attrs": (_link_attrs, [42, 7, 9]),
    "initialize_retry": (_initialize_retry, ["b", "a", "b", 5]),
    "initialize_deadlock": (_initialize_deadlock,
                            ["initialization deadlock: 1 units cannot "
                             "initialize"]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_workflow_engine_is_the_references(case):
    fn, want = ENGINE_CASES[case]
    assert fn(REF) == want
    assert fn(PORT) == want


def test_unit_pickles_without_its_device():
    w = workflow.Workflow(name="w")
    u = units.TrivialUnit(w, name="u")
    u.device = CPU
    u.payload = [1, 2]
    u2 = pickle.loads(pickle.dumps(u))
    assert u2.device is None and u2.payload == [1, 2]
    assert u2.workflow.name == "w" and not u2._initialized


# -- Vector ----------------------------------------------------------------

def _vector_steps(m, dev, to_host):
    """The reference's TestVector scenarios as one sequence of steps;
    each step's host view and validity flags."""
    out = []
    v = m.Vector(np.arange(6, dtype=np.float32).reshape(2, 3), name="v")
    out.append(("host_only", v.shape, v.sample_size, len(v),
                v.map_read().tolist(), v._valid))
    host = np.arange(4, dtype=np.float32)
    v = m.Vector(host, name="v")
    v.initialize(dev)
    d = v.unmap()
    assert d is v.devmem
    v.devmem = d * 2
    out.append(("device_write", v._valid, v.map_read().tolist(), v._valid))
    v = m.Vector(np.ones(3, np.float32), name="v")
    v.initialize(dev)
    first = v.unmap()
    mm = v.map_write()
    mm[:] = 5
    d2 = v.unmap()
    out.append(("map_write", d2 is not first, to_host(d2).tolist(),
                to_host(first).tolist(), v._valid))
    v = m.Vector(np.zeros(3, np.float32), name="v")
    v.initialize(dev)
    v.devmem = v.unmap() + 100
    mm = v.map_invalidate()
    mm[:] = 7
    out.append(("map_invalidate", to_host(v.unmap()).tolist(), v._valid))
    v = m.Vector(np.ones(2, np.float32), name="v")
    v.initialize(dev)
    v.devmem = v.unmap() * 3
    v2 = pickle.loads(pickle.dumps(v))
    out.append(("pickle", v2.mem.tolist(), v2.devmem is None, v2._valid,
                v._valid))
    v = m.Vector(np.ones((2, 2), np.float32), name="v")
    v.initialize(dev)
    v.devmem = v.unmap() + 1
    v.drop_devmem()
    out.append(("drop_devmem", bool(v), v.nbytes))
    return out


def test_vector_protocol_is_the_references(jaxdev):
    want = _vector_steps(ref_memory, jaxdev, np.asarray)
    got = _vector_steps(memory, CPU, lambda t: t.numpy())
    assert got == want


def test_vector_unallocated_raises():
    v = memory.Vector(name="v")
    with pytest.raises((RuntimeError, AttributeError)):
        v.map_read()
    v.initialize(CPU)
    with pytest.raises(AttributeError):
        v.shape


def test_vector_host_copy_is_not_a_view_of_the_device_tensor():
    v = memory.Vector(np.zeros(3, np.float32), name="v")
    v.initialize(CPU)
    dev = v.unmap()
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    v.devmem = dev + 1
    host = v.map_read()
    host[:] = 9          # written without map_write: the device keeps 1
    assert v.devmem.tolist() == [1.0, 1.0, 1.0]
    mem = v.map_write()
    assert mem is host
    assert v.unmap().tolist() == [9.0, 9.0, 9.0]


# -- AcceleratedUnit --------------------------------------------------------

def _doubler(m_au, m_memory):
    class Doubler(m_au.AcceleratedUnit):
        """out = in * 2 + p"""

        def __init__(self, wf=None, **kw):
            super().__init__(wf, **kw)
            self.input = m_memory.Vector(name="input")
            self.output = m_memory.Vector(name="output")
            self.p = m_memory.Vector(np.float32([10.0]), name="p")
            self.declare_input("x", self.input)
            self.declare_output("y", self.output)

        def initialize(self, device=None, **kw):
            super().initialize(device=device, **kw)
            self.p.initialize(self.device)

        def gather_params(self):
            return {"p": self.p.unmap()}

        def apply(self, params, inputs, rng=None):
            return {"y": inputs["x"] * 2 + params["p"]}
    return Doubler


def test_doubler_is_the_references(jaxdev):
    outs = []
    for (m_au, m_memory), dev in (((ref_au, ref_memory), jaxdev),
                                  ((accelerated_units, memory), CPU)):
        u = _doubler(m_au, m_memory)(name="d")
        u.input.mem = np.arange(3, dtype=np.float32)
        u.initialize(device=dev)
        u.run()
        assert u.output.devmem is not None
        assert u.output._valid == 2   # device only until map_read
        outs.append(u.output.map_read())
    np.testing.assert_array_equal(outs[0], [10, 12, 14])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].dtype == np.float32


def _loop_graph(mods, dev, x0):
    """StartPoint -> Repeater -> Accumulate (acc = acc * 0.5 + x * w on
    the device) -> Counter (gates the loop after 4 turns) -> EndPoint;
    each turn's host read of acc and whether acc was on the device
    before it."""
    m_mut, m_units, m_wf, m_memory, m_au = mods

    class Accumulate(m_au.AcceleratedUnit):
        def __init__(self, wf, **kw):
            super().__init__(wf, **kw)
            self.x = self.declare_input("x", m_memory.Vector(x0, name="x"))
            self.w = m_memory.Vector(np.linspace(-1, 1, x0.shape[-1],
                                                 dtype=np.float32),
                                     name="w")
            self.acc = self.declare_output(
                "acc", m_memory.Vector(np.zeros_like(x0), name="acc"))

        def initialize(self, device=None, **kw):
            super().initialize(device=device, **kw)
            self.w.initialize(self.device)
            self.acc.unmap()

        def gather_params(self):
            return {"w": self.w.unmap()}

        def gather_inputs(self):
            d = super().gather_inputs()
            d["acc"] = self.acc.unmap()
            return d

        def apply(self, params, inputs, rng=None):
            return {"acc": inputs["acc"] * 0.5 + inputs["x"] * params["w"]}

    class Counter(m_units.Unit):
        def __init__(self, wf, acc, **kw):
            super().__init__(wf, **kw)
            self.acc = acc
            self.turns = 0
            self.complete = m_mut.Bool(False)
            self.seen = []

        def run(self):
            self.turns += 1
            self.seen.append((self.acc._valid, self.acc.map_read().copy()))
            self.complete.set(self.turns >= 4)

    w = m_wf.Workflow(name="graph")
    rpt = m_wf.Repeater(w, name="repeater")
    acc = Accumulate(w, name="accumulate")
    cnt = Counter(w, acc.acc, name="counter")
    rpt.link_from(w.start_point, cnt)
    acc.link_from(rpt)
    cnt.link_from(acc)
    rpt.gate_block = cnt.complete
    w.end_point.link_from(cnt)
    w.end_point.gate_block = ~cnt.complete
    w.initialize(device=dev)
    w.run()
    return cnt, acc


def test_repeater_loop_on_a_device_is_the_references(jaxdev):
    x0 = np.random.default_rng(3).standard_normal((4, 5)).astype(np.float32)
    rc, racc = _loop_graph(REF, jaxdev, x0)
    pc, pacc = _loop_graph(PORT, CPU, x0)
    assert pc.turns == rc.turns == 4
    assert [v for v, _ in pc.seen] == [v for v, _ in rc.seen] == [2] * 4
    for (_, got), (_, want) in zip(pc.seen, rc.seen):
        np.testing.assert_array_equal(got, want)
    assert isinstance(pacc.acc.devmem, torch.Tensor)
    assert pacc.run_count == racc.run_count == 4


def test_accelerated_unit_without_a_device_takes_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u = accelerated_units.AcceleratedUnit(name="u")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        u.initialize()
