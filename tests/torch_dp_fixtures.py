"""Helpers of the data-parallel tests (``test_torch_dp*.py``,
``test_torch_multihost.py``): the reference's tiny data-parallel
workflow (``tests/test_parallel.py``'s ``build_workflow``) as a port
workflow file, run through ``python -m veles_tpu_torch --dp N -b cpu``,
each rank leaving its history, params, param CRC and residency in
``result_<rank>.json`` / ``.npz``."""

import json
import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference test's sizes: 480 + 192 samples of 12x12x1, 10 classes
N_TRAIN, N_VALID, SHAPE, N_CLASSES, DATA_SEED = 480, 192, (12, 12, 1), 10, 42
SEED = 777

WORKFLOW = textwrap.dedent('''
    import json
    import os
    import zlib

    import numpy as np

    from veles_tpu_torch.loader.fullbatch import ArrayLoader
    from veles_tpu_torch.ops.standard_workflow import StandardWorkflow

    CFG = json.loads(os.environ["DP_TEST_CFG"])


    def create_workflow(launcher):
        d = np.load(CFG["data"])
        train = (d["train_x"], d["train_y"])
        valid = (d["valid_x"], d["valid_y"])
        gd = {"learning_rate": 0.1, "weight_decay": 0.0001,
              "gradient_moment": CFG.get("momentum", 0.9)}
        layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 32},
                   "<-": gd}]
        if CFG.get("dropout"):
            layers.append({"type": "dropout",
                           "->": {"dropout_ratio": CFG["dropout"]}})
        layers.append({"type": "softmax", "->": {"output_sample_shape": 10},
                       "<-": gd})
        snap = CFG.get("snapshots")
        return StandardWorkflow(
            loader_factory=lambda w: ArrayLoader(
                w, train=train, valid=valid, minibatch_size=CFG["mb"],
                name="loader", **CFG.get("loader", {})),
            layers=layers,
            decision_config={"max_epochs": CFG["epochs"]},
            snapshotter_config=None if snap is None else
            {"directory": snap, "prefix": "dp", "compression": ""},
            superstep=CFG.get("superstep", 1), name="dp_test")


    def run(launcher):
        w = launcher.create_workflow(create_workflow)
        if launcher.snapshot is not None:
            w.decision.max_epochs = CFG["epochs"]
        launcher.initialize()
        launcher.run()
        group = launcher.group
        rank = 0 if group is None else group.rank
        params = w.fused.host_params()
        flat = {f"{f}|{p}": a for f, ps in params.items()
                for p, a in ps.items()}
        crc = 0
        for key in sorted(flat):
            crc = zlib.crc32(np.ascontiguousarray(flat[key]).tobytes(), crc)
        np.savez(os.path.join(CFG["out"], f"result_{rank}.npz"), **flat)
        ld = w.loader
        with open(os.path.join(CFG["out"], f"result_{rank}.json"), "w") as f:
            json.dump({"history": w.decision.history, "crc": crc,
                       "world": 1 if group is None else group.world_size,
                       "device": str(launcher.device.device),
                       "resident_bytes": ld.resident_bytes,
                       "shard_resident": ld.shard_resident,
                       "device_resident": ld.device_resident,
                       "dequant": ld.dequant is not None,
                       "collectives": {} if group is None
                       else group.stats}, f)
''')


def data_arrays():
    """The reference test's data, from its own generator."""
    from veles_tpu.datasets import synthetic_classification
    train, valid, _ = synthetic_classification(
        N_TRAIN, N_VALID, SHAPE, n_classes=N_CLASSES, seed=DATA_SEED)
    return train, valid


def write_case(tmp, **cfg):
    """The workflow file, the data npz and the run's config (an env
    value) under ``tmp``; returns (workflow path, env)."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    data = os.path.join(tmp, "data.npz")
    xs = cfg.pop("x_transform", None)
    if not os.path.exists(data):
        (tx, ty), (vx, vy) = data_arrays()
        if xs is not None:
            tx, vx = xs(tx), xs(vx)
        np.savez(data, train_x=tx, train_y=ty, valid_x=vx, valid_y=vy)
    wf = os.path.join(tmp, "dp_wf.py")
    with open(wf, "w") as f:
        f.write(WORKFLOW)
    out = cfg.pop("out", os.path.join(tmp, "out"))
    os.makedirs(out, exist_ok=True)
    cfg = dict({"mb": 48, "epochs": 2, "data": data, "out": out}, **cfg)
    env = dict(os.environ, PYTHONPATH=REPO, DP_TEST_CFG=json.dumps(cfg),
               OMP_NUM_THREADS="1")
    for key in ("VELES_FAULTS", "VELES_SUPERVISE_ATTEMPT",
                "VELES_RESUME_MANIFEST", "VELES_MESH_SHARD_DATA",
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return wf, env, out


def run_cli(args, env, timeout=120):
    return subprocess.run([sys.executable, "-m", "veles_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def results(out, world):
    """Each rank's (meta, params)."""
    res = []
    for r in range(world):
        with open(os.path.join(out, f"result_{r}.json")) as f:
            meta = json.load(f)
        arrays = np.load(os.path.join(out, f"result_{r}.npz"))
        res.append((meta, {k: arrays[k] for k in arrays.files}))
    return res


def run_dp(tmp, n=2, extra=(), env_extra=None, **cfg):
    """``--dp n -b cpu`` (``n`` 1: one process, no group) of the tiny
    workflow; returns each rank's (meta, params)."""
    wf, env, out = write_case(tmp, **cfg)
    env.update(env_extra or {})
    args = ["-b", "cpu", "-s", str(SEED)] + \
        (["--dp", str(n)] if n > 1 else []) + list(extra) + [wf]
    p = run_cli(args, env)
    assert p.returncode == 0, p.stderr[-4000:]
    return results(out, n)


def valid_history(history):
    return [h for h in history if h["class"] == "validation"]


def crc_of(params):
    crc = 0
    for key in sorted(params):
        crc = zlib.crc32(np.ascontiguousarray(params[key]).tobytes(), crc)
    return crc
