"""The master--slave mode of the port (``veles_tpu_torch/server.py``,
``client.py``), over zmq on 127.0.0.1 with the master and its slaves in
threads of this process, on the CPU, against the reference's
(``tests/test_master_slave.py``: the same tiny workflow, data and seed):

- one slave follows the port's standalone run and the reference's
  one-slave run at the reference's bars (every validation loss within
  1e-4, ``n_err`` within 1, the final weights within 1e-4; the
  reference's weights read through ``convert.py``), with one job a
  minibatch (28) and the decision fed by the jobs;
- three slaves: the run ends at ``max_epochs``, each slave does at
  least 10 jobs and the loss falls, and the run's own schedule fed to
  the reference's master and slaves gives the same jobs, staleness,
  losses and final weights; on one fixed schedule (every slave one job
  outstanding, answering in turn) the port's master and slaves give the
  reference's train losses and final weights, and the loss falls by the
  reference test's margin (0.2);
- a zombie slave's job is requeued and the master still ends;
- a slave joining late gets the current weights in its handshake;
- a workflow without an initialized fused runner is refused (slave and
  master);
- the hooks (``distributable.py``): a loader's job and a decision's
  metrics in the reference's formats.

Every thread is joined under a timeout.  The master binds
``tcp://127.0.0.1:*`` and the slaves connect to the endpoint it bound.
"""

import pickle
import threading
import time

import numpy as np
import pytest

from veles_tpu_torch import prng
from veles_tpu_torch.backends import make_device
from veles_tpu_torch.client import SlaveClient
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import ArrayLoader
from veles_tpu_torch.ops.standard_workflow import StandardWorkflow
from veles_tpu_torch.server import MasterServer
from veles_tpu_torch.workflow import Workflow

#: the reference test's workflow (``tests/test_master_slave.py``)
SEED, N_TRAIN, N_VALID, SHAPE, N_CLASSES, MB = 777, 300, 120, (10, 10, 1), 5, 30
#: jobs of 2 epochs: 10 train + 4 validation minibatches an epoch
JOBS_2_EPOCHS = 28


def data():
    from veles_tpu.datasets import synthetic_classification
    train, valid, _ = synthetic_classification(
        N_TRAIN, N_VALID, SHAPE, n_classes=N_CLASSES, seed=42)
    return train, valid


def build_workflow(max_epochs=2, momentum=0.9):
    """The reference test's ``build_workflow`` as a port workflow,
    initialized for training on the CPU."""
    prng.seed_all(SEED)
    train, valid = data()
    gd = {"learning_rate": 0.1, "weight_decay": 0.0001,
          "gradient_moment": momentum}
    w = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(
            wf, train=train, valid=valid, minibatch_size=MB, name="loader"),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 24},
                 "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": 5},
                 "<-": gd}],
        decision_config={"max_epochs": max_epochs}, name="ms_test")
    w.initialize(device=make_device("cpu"), train=True)
    return w


def start(target, name):
    t = threading.Thread(target=target, daemon=True, name=name)
    t.start()
    return t


def start_master(server):
    t = start(server.serve, "master")
    assert server.bound.wait(30), "master did not bind"
    return t, server.endpoint


def recorded(server):
    """Wrap ``server._handle``: every message it answered, in order, as
    ``(ident, message, reply type, seq, jobs applied when it answered)``
    (the last is what a job issued there saw: its staleness is its seq
    less that count)."""
    log, handle = [], server._handle

    def spy(msg, ident):
        applied = server._applied
        reply = handle(msg, ident)
        log.append((ident, msg, reply["type"], reply.get("seq"), applied))
        return reply

    server._handle = spy
    return log


def run_cluster(n_slaves, max_epochs=2, momentum=0.9, record=False):
    slave_ws = [build_workflow(max_epochs, momentum)
                for _ in range(n_slaves)]
    master_w = build_workflow(max_epochs, momentum)
    server = MasterServer(master_w, "tcp://127.0.0.1:*", job_timeout=30.0,
                          linger_s=0.5)
    server.log = recorded(server) if record else None
    mt, addr = start_master(server)
    clients = [SlaveClient(w, addr, timeout_ms=30000) for w in slave_ws]
    threads = [start(c.serve, f"slave-{i}") for i, c in enumerate(clients)]
    mt.join(timeout=120)
    assert not mt.is_alive(), "master did not finish"
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "slave did not finish"
    return master_w, server, clients


def valid_history(history):
    return [h for h in history if h["class"] == "validation"]


def within_reference_bars(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a, b)
        assert abs(a["n_err"] - b["n_err"]) <= 1, (a, b)


@pytest.fixture(scope="module")
def one_slave():
    return run_cluster(1)


def test_one_slave_follows_the_standalone_run(one_slave):
    master_w, server, (client,) = one_slave
    ref = build_workflow()
    ref.run()
    # one job a minibatch, the decision fed by the jobs
    assert server._applied == JOBS_2_EPOCHS == client.jobs_done
    assert master_w.decision.metrics_source is None
    assert master_w.loader.superstep == 1
    assert master_w.decision.complete
    want = valid_history(ref.decision.history)
    within_reference_bars(valid_history(master_w.decision.history), want)
    assert all(h["loss"] > 0 for h in want)
    got, exp = master_w.fused.host_params(), ref.fused.host_params()
    for fname, ps in exp.items():
        for pname, a in ps.items():
            np.testing.assert_allclose(got[fname][pname], a, rtol=0,
                                       atol=1e-4, err_msg=fname + pname)


def test_one_slave_follows_the_reference_one_slave(one_slave):
    """The reference's MasterServer and SlaveClient on the same
    workflow (its master on numpy, its slave on XLA:CPU)."""
    from veles_tpu.backends import JaxDevice, NumpyDevice
    from veles_tpu.client import SlaveClient as RefSlave
    from veles_tpu.server import MasterServer as RefMaster
    from test_master_slave import build_workflow as ref_workflow
    from test_master_slave import free_port

    master_w, _, _ = one_slave
    addr = f"tcp://127.0.0.1:{free_port()}"
    rm = ref_workflow()
    rm.initialize(device=NumpyDevice())
    rs = ref_workflow()
    rs.initialize(device=JaxDevice(platform="cpu"))
    server = RefMaster(rm, addr, job_timeout=30.0, linger_s=0.5)
    mt = start(server.serve, "ref-master")
    st = start(RefSlave(rs, addr, timeout_ms=30000).serve, "ref-slave")
    mt.join(timeout=120)
    st.join(timeout=30)
    assert not mt.is_alive() and not st.is_alive()
    within_reference_bars(valid_history(master_w.decision.history),
                          valid_history(rm.decision.history))
    theirs = params_from_jax({
        f.name: {"weights": f.weights.map_read(),
                 "bias": f.bias.map_read()} for f in rm.forwards})
    ours = master_w.fused.host_params()
    for fname, ps in theirs.items():
        for pname, a in ps.items():
            np.testing.assert_allclose(ours[fname][pname], a, rtol=0,
                                       atol=1e-4, err_msg=fname + pname)


def train_losses(w):
    return [h["loss"] for h in w.decision.history if h["class"] == "train"]


def replay(log, server, slaves):
    """Feed ``server`` (either package's master) the messages of a
    recorded run in their order, every one pickled, each job computed
    by the slave of its ident (``slaves``, one a slave in the order of
    their handshakes) when the run's slave answered it; the master
    applies what is ready after each message and, once the decision is
    complete, drops what is outstanding, as ``serve()`` does.  Returns
    the run's rows as this master gave them: ``(reply type, seq, jobs
    applied)``."""
    def ask(msg, ident):
        reply = server._handle(pickle.loads(pickle.dumps(msg, protocol=4)),
                               ident)
        server._apply_ready()
        if server.workflow.decision.complete:
            server._pending.clear()
            server._requeue.clear()
        return pickle.loads(pickle.dumps(reply, protocol=4))

    by_ident, jobs, rows = {}, {}, []
    for ident, msg, _, _, _ in log:
        applied = server._applied
        if msg["type"] == "handshake":
            slave = by_ident[ident] = slaves[len(by_ident)]
            reply = ask(msg, ident)
            slave.workflow.fused.set_host_params(reply["params"])
        elif msg["type"] == "job_done":
            job = jobs.pop(ident)
            assert job["seq"] == msg["seq"], (job["seq"], msg["seq"])
            reply = ask(by_ident[ident]._run_job(job), ident)
        else:
            reply = ask(msg, ident)
            if reply["type"] == "job":
                jobs[ident] = reply
        rows.append((reply["type"], reply.get("seq"), applied))
    return rows


def test_three_slaves_train():
    """Asynchronous SGD over 3 slave threads: the protocol ends at
    max_epochs, spreads the work, and the loss falls.  How far it falls
    depends on the thread schedule (the staleness each job sees), so the
    run's own schedule, every message in its order, is fed to the
    reference's master and three reference slaves: they issue the same
    jobs with the same staleness and give the same train losses and
    final weights (the reference's bars).  The reference's clear 0.2
    margin is held on one fixed schedule below."""
    master_w, server, clients = run_cluster(3, max_epochs=8, momentum=0.0,
                                            record=True)
    assert master_w.decision.complete
    assert all(c.jobs_done >= 10 for c in clients), \
        [c.jobs_done for c in clients]
    hist = [h for h in master_w.decision.history if h["class"] == "train"]
    assert hist[0]["epoch"] == 1 and hist[-1]["epoch"] == 8
    losses = train_losses(master_w)
    assert min(losses) < losses[0] and losses[-1] < losses[0], losses
    for ps in master_w.fused.host_params().values():
        for a in ps.values():
            assert np.isfinite(a).all()

    from veles_tpu.backends import JaxDevice, NumpyDevice
    from veles_tpu.client import SlaveClient as RefSlave
    from veles_tpu.server import MasterServer as RefMaster
    from test_master_slave import build_workflow as ref_workflow

    ref_slaves = []
    for _ in range(3):
        w = ref_workflow(8, 0.0)
        w.initialize(device=JaxDevice(platform="cpu"))
        ref_slaves.append(RefSlave(w, "tcp://127.0.0.1:1"))
    rm = ref_workflow(8, 0.0)
    rm.initialize(device=NumpyDevice())
    rm.loader.host_fill_enabled = False   # as the reference's serve() sets
    rm.loader.superstep = 1
    ref_server = RefMaster(rm, "tcp://127.0.0.1:1", job_timeout=1e9)
    rows = replay(server.log, ref_server, ref_slaves)
    assert rows == [(kind, seq, applied)
                    for _, _, kind, seq, applied in server.log]
    assert ref_server._applied == server._applied
    theirs = train_losses(rm)
    assert len(theirs) == len(losses) == 8
    for a, b in zip(losses, theirs):
        assert abs(a - b) < 1e-4, (losses, theirs)
    ours_v, theirs_v = (valid_history(master_w.decision.history),
                        valid_history(rm.decision.history))
    # a validation class issued ahead and done before the last train
    # job's result is applied in the same pass: 8 or 9 rows, as the
    # schedule has it
    assert len(ours_v) == len(theirs_v) >= 8, (ours_v, theirs_v)
    for a, b in zip(ours_v, theirs_v):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a, b)
        assert abs(a["n_err"] - b["n_err"]) <= 1, (a, b)
    ref_params = params_from_jax({
        f.name: {"weights": f.weights.map_read(),
                 "bias": f.bias.map_read()} for f in rm.forwards})
    got = master_w.fused.host_params()
    for fname, ps in ref_params.items():
        for pname, a in ps.items():
            np.testing.assert_allclose(got[fname][pname], a, rtol=0,
                                       atol=1e-4, err_msg=fname + pname)


def round_robin(server, clients):
    """Drive a master and its slaves in this thread through one fixed
    schedule, every message pickled: each slave keeps one job
    outstanding, and they answer in turn (each job sees the other two
    slaves' jobs unapplied).  Returns the jobs each slave did."""
    def rpc(ident, msg):
        reply = server._handle(pickle.loads(pickle.dumps(msg, protocol=4)),
                               ident)
        server._apply_ready()
        return pickle.loads(pickle.dumps(reply, protocol=4))

    idents = [f"slave-{i}".encode() for i in range(len(clients))]
    for ident, c in zip(idents, clients):
        c.workflow.fused.set_host_params(
            rpc(ident, {"type": "handshake", "id": ident})["params"])
    jobs = [rpc(ident, {"type": "job_request"}) for ident in idents]
    done = [0] * len(clients)
    while all(j["type"] == "job" for j in jobs):
        for i, (ident, c) in enumerate(zip(idents, clients)):
            assert rpc(ident, c._run_job(jobs[i]))["type"] == "ack"
            done[i] += 1
            jobs[i] = rpc(ident, {"type": "job_request"})
    assert all(j["type"] == "bye" for j in jobs), jobs
    return done


def test_three_slaves_on_one_schedule_follow_the_reference():
    """The same three-slave run on one fixed schedule through the port's
    and the reference's master and slaves: the same train losses every
    epoch and the same final weights (the reference's bars), and the
    loss falls by the reference test's clear margin."""
    from veles_tpu.backends import JaxDevice, NumpyDevice
    from veles_tpu.client import SlaveClient as RefSlave
    from veles_tpu.server import MasterServer as RefMaster
    from test_master_slave import build_workflow as ref_workflow

    slaves = [build_workflow(8, 0.0) for _ in range(3)]
    master_w = build_workflow(8, 0.0)
    server = MasterServer(master_w, job_timeout=1e9)
    server._prepare()
    done = round_robin(server, [SlaveClient(w) for w in slaves])
    server._sync_runner()   # as serve() does at its end

    ref_slaves = []
    for _ in range(3):
        w = ref_workflow(8, 0.0)
        w.initialize(device=JaxDevice(platform="cpu"))
        ref_slaves.append(w)
    rm = ref_workflow(8, 0.0)
    rm.initialize(device=NumpyDevice())
    rm.loader.host_fill_enabled = False   # as the reference's serve() sets
    rm.loader.superstep = 1
    ref_server = RefMaster(rm, "tcp://127.0.0.1:1", job_timeout=1e9)
    assert round_robin(ref_server, [RefSlave(w, "tcp://127.0.0.1:1")
                                    for w in ref_slaves]) == done
    # jobs issued ahead of the last train job's application run into
    # the next epoch and are applied too, in both packages
    assert sum(done) == server._applied == ref_server._applied >= 8 * 14
    ours, theirs = train_losses(master_w), train_losses(rm)
    assert len(ours) == len(theirs) == 8
    for a, b in zip(ours, theirs):
        assert abs(a - b) < 1e-4, (ours, theirs)
    assert min(ours) < ours[0] - 0.2, ours
    assert ours[-1] < ours[0], ours
    ref_params = params_from_jax({
        f.name: {"weights": f.weights.map_read(),
                 "bias": f.bias.map_read()} for f in rm.forwards})
    got = master_w.fused.host_params()
    for fname, ps in ref_params.items():
        for pname, a in ps.items():
            np.testing.assert_allclose(got[fname][pname], a, rtol=0,
                                       atol=1e-4, err_msg=fname + pname)


def test_zombie_slave_job_requeued_and_master_terminates():
    import zmq

    sw = build_workflow(momentum=0.0)
    master_w = build_workflow(momentum=0.0)
    server = MasterServer(master_w, "tcp://127.0.0.1:*", job_timeout=1.5,
                          linger_s=0.5)
    mt, addr = start_master(server)
    # the zombie: handshake, take the FIRST job, never answer
    zombie = zmq.Context.instance().socket(zmq.REQ)
    zombie.setsockopt(zmq.RCVTIMEO, 10000)
    zombie.setsockopt(zmq.LINGER, 0)
    zombie.connect(addr)
    zombie.send(pickle.dumps({"type": "handshake", "id": "zombie"},
                             protocol=4))
    assert pickle.loads(zombie.recv())["type"] == "init"
    zombie.send(pickle.dumps({"type": "job_request"}, protocol=4))
    job = pickle.loads(zombie.recv())
    assert job["type"] == "job" and job["seq"] == 0
    zombie.close(0)

    client = SlaveClient(sw, addr, timeout_ms=30000)
    t1 = start(client.serve, "slave")
    mt.join(timeout=90)
    assert not mt.is_alive(), "master wedged by the zombie slave"
    t1.join(timeout=30)
    assert not t1.is_alive()
    assert master_w.decision.complete
    # job 0 went to the live slave and was applied
    assert server._applied == JOBS_2_EPOCHS
    assert client.jobs_done == JOBS_2_EPOCHS


def test_late_joining_slave_gets_current_weights():
    first, second = build_workflow(max_epochs=10), build_workflow(
        max_epochs=10)
    master_w = build_workflow(max_epochs=10)
    w0 = master_w.fused.host_params()["fwd0_all2all_tanh"]["weights"]
    server = MasterServer(master_w, "tcp://127.0.0.1:*", linger_s=0.5)
    mt, addr = start_master(server)
    t1 = start(SlaveClient(first, addr, timeout_ms=30000).serve, "slave-1")
    deadline = time.monotonic() + 60
    while server._applied < 5 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert server._applied >= 5

    c2 = SlaveClient(second, addr, timeout_ms=30000)
    got = {}
    orig = c2._rpc

    def spy(sock, msg):
        reply = orig(sock, msg)
        if msg.get("type") == "handshake":
            got["params"] = reply["params"]
        return reply

    c2._rpc = spy
    t2 = start(c2.serve, "slave-2")
    mt.join(timeout=120)
    assert not mt.is_alive()
    for t in (t1, t2):
        t.join(timeout=30)
        assert not t.is_alive()
    hs = got["params"]["fwd0_all2all_tanh"]["weights"]
    assert not np.allclose(hs, w0), "the handshake sent the initial weights"


def test_slave_without_a_fused_runner_is_refused():
    with pytest.raises(ValueError, match="fused training step"):
        SlaveClient(Workflow(name="graph"), "tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="master mode"):
        MasterServer(Workflow(name="graph"), "tcp://127.0.0.1:1")
    prng.seed_all(SEED)
    train, valid = data()
    bare = StandardWorkflow(
        loader_factory=lambda wf: ArrayLoader(wf, train=train, valid=valid,
                                              minibatch_size=MB),
        layers=[{"type": "softmax", "->": {"output_sample_shape": 5}}])
    with pytest.raises(ValueError, match="initialized for training"):
        SlaveClient(bare, "tcp://127.0.0.1:1")


def test_hooks_carry_the_reference_formats():
    """A master's loader job applied on a slave's loader is that
    minibatch as a superstep of one; the decision's metric hooks take
    and give the reference's lists."""
    w = build_workflow()
    ld = w.loader
    ld.superstep = 1
    ld.run()                          # the first validation minibatch
    job = ld.generate_data_for_slave()
    assert set(job) == {"indices", "class", "size"}
    assert job["class"] == VALID and job["size"] == MB
    other = build_workflow().loader
    other.apply_data_from_master(job)
    assert other.minibatch_class == VALID and other.superstep_k == 1
    np.testing.assert_array_equal(other.superstep_indices, ld.superstep_indices)
    np.testing.assert_array_equal(other.superstep_mask, ld.superstep_mask)
    # the last train minibatch is padded: its real rows only
    other.apply_data_from_master({"indices": np.arange(MB), "class": TRAIN,
                                  "size": 7})
    assert other.superstep_mask.sum() == 7
    # the jobs' metrics, summed at the class end in the order applied
    d = w.decision
    d.apply_data_from_slave({"n_err": [3.0], "loss": [1.5], "count": [30.0]})
    d.apply_data_from_slave({"n_err": [2.0], "loss": [0.5], "count": [30.0]})
    assert d._take_slave_metrics() == (5.0, 2.0, 60.0, None)
    assert d._take_slave_metrics() == (0.0, 0.0, 0.0, None)
    for unit in (ld, d, w.decision, Workflow(name="graph")):
        assert unit.drop_slave("gone") is None


def test_cli_refuses_a_multihost_master_and_a_master_ignores_dp():
    """A master with --multihost is refused (every process of the group
    would bind the one address); a master computes nothing, so --dp N
    asks for no cards (one process serves the jobs, as the reference's
    master runs with its unused mesh)."""
    from veles_tpu_torch.__main__ import (build_parser, refused_master_slave,
                                          refused_parallel)
    parse = build_parser().parse_args
    a = parse(["--listen-address", "tcp://127.0.0.1:1", "--multihost",
               "wf.py"])
    assert "refused" in refused_master_slave(a)
    a = parse(["--listen-address", "tcp://127.0.0.1:1", "--dp", "4", "-b",
               "cuda", "wf.py"])
    assert refused_master_slave(a) is None and refused_parallel(a) is None
    # a slave's --dp N needs its N cards, as a standalone run's
    a = parse(["--master-address", "tcp://127.0.0.1:1", "--dp", "4", "-b",
               "cuda", "wf.py"])
    assert refused_master_slave(a) is None
    assert "--dp 4" in refused_parallel(a)


def test_a_masters_snapshot_resumes_as_a_standalone_run(one_slave):
    """A master unhooks its decision from the fused runner and its
    loader's host assembly; a snapshot of it carries the canonical params
    and, initialized for training again, is a standalone workflow."""
    master_w, _, _ = one_slave
    back = pickle.loads(pickle.dumps(master_w))
    assert back.decision.metrics_source is None
    assert not back.loader.host_fill_enabled
    back.initialize(device=make_device("cpu"), train=True)
    assert back.decision.metrics_source is back.fused
    assert back.loader.host_fill_enabled
    got, want = back.fused.host_params(), master_w.fused.host_params()
    for fname, ps in want.items():
        for pname, a in ps.items():
            np.testing.assert_array_equal(got[fname][pname], a)
