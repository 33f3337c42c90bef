#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path, the serving process, at the full width of
AlexNet, and holds its hand-written kernel against its plain PyTorch
version.  Every phase is fatal: the script exits nonzero, printing no
result line, when any check fails, when there is no CUDA device, or
when it is run without the repository beside it.  It imports nothing
of JAX and nothing of the JAX package.

1. Device: the card's name and power limit; build the LRN kernel from
   ``veles_tpu_torch/csrc/lrn_fwd.cu`` and print the build time and
   what ptxas reported.
2. Kernel vs plain on the card: ``lrn_fwd`` at AlexNet's two norm
   shapes at batch 64, n = 5 and 4, f32 and bf16, plus a ragged row
   count and a channel count over 48 KiB of shared memory.  Each case
   prints the kernel's, the plain version's and the library call's
   (``torch.nn.functional.local_response_norm``) times from CUDA
   events after warm-up, its memory bound, and the max abs error.
   bf16 cases are also held to one bf16 ulp.
3. Serve: pack a 2-member full-width AlexNet ensemble (gaussian init at
   ``alexnet_layers``' stddevs from a numpy seed), start
   ``python -m veles_tpu_torch --serve-models alexnet=PKG --max-batch
   64`` on the card, send concurrent requests of 1-16 rows, check every
   answer (rows_n, crc, probabilities summing to 1, agreement with the
   in-process engine at the same dtype), read the hive's stats (the
   main path's kernel launches), shut it down (rc 0).  Then each norm
   layer of each member, in bf16 on a served batch, against the plain
   version to one bf16 ulp; and, once, the in-process engine in f32 on
   the card (TF32 off) against the CPU plain path in f32.
4. Summary: a ``kernels`` JSON line and a ``serve`` JSON line, then the
   device line last.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor flop/s
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
MAX_BATCH = 64
N_MEMBERS = 2
SAMPLE_SHAPE = (227, 227, 3)
N_CLASSES = 1000
#: the served burst: requests of 1-16 rows from N_THREADS client threads
N_REQUESTS = 24
N_THREADS = 8
SEED = 20261016


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# -- phase 2: the kernel against its plain version ---------------------

def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` from CUDA events around each call,
    after warm-up.  Before each call a 128 MiB write evicts the 50 MB
    L2, so an input that fits there is still read from device memory,
    as the bound assumes."""
    import torch
    for _ in range(warmup):
        fn()
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def lrn_bound(shape, dtype, n: int):
    """(bound_ms, bound_by): x read once, y written once, against
    about n + 6 f32 operations per element."""
    import torch
    numel = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    t_bytes = 2 * numel * item / HBM_BYTES_S * 1e3
    t_ops = (n + 6) * numel / F32_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_one_ulp(y, ref, what: str) -> None:
    """bf16 ``y`` within one bf16 ulp of ``ref``: the kernel and the
    plain version round f32 values that differ only in the order of the
    window sum, so their bf16 results differ by one ulp at most, and
    one ulp is at most 2^-7 of the value."""
    err = (y.float() - ref.float()).abs()
    bad = err > 2.0 ** -7 * ref.float().abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} bf16 elements more than one ulp "
          f"off (max abs err {float(err.max()):.3g})")


def kernel_phase(card: str):
    import torch
    import torch.nn.functional as F

    from veles_tpu_torch.ops import lrn_cuda

    k, alpha = 2.0, 1e-4
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # tolerances against the plain version in the same dtype: in f32
    # the two differ only in the order of the <= n-term f32 window sum
    # (den >= k = 2, so relative errors stay near 1e-7); in bf16 that
    # order can flip the final rounding of y by one bf16 ulp (2^-8
    # relative), well inside 2e-2
    tol = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 2e-2)}
    cases = []
    # bf16 is also held to one ulp (below): 2e-2 alone would pass an
    # alpha off by 10%, which moves y by about 1.5% at these inputs
    for shape in ((MAX_BATCH, 55, 55, 96), (MAX_BATCH, 27, 27, 256)):
        for n in (5, 4):
            for dt in (torch.float32, torch.bfloat16):
                cases.append((shape, n, dt, "main"
                              if n == 5 and dt == torch.bfloat16
                              else "check"))
    cases.append(((3, 17, 19, 96), 5, torch.float32, "ragged"))
    cases.append(((5, 16384), 5, torch.bfloat16, "wide"))
    rows = []
    for shape, n, dt, role in cases:
        # post-ReLU-scale activations: alpha * window sum is a sizable
        # part of den, so the power term is exercised
        x = (torch.randn(shape, generator=gen, device="cuda") * 30.0
             ).to(dt)
        y = lrn_cuda.lrn_fwd(x, n, k, alpha)
        ref = lrn_cuda.lrn_fwd_plain(x, n, k, alpha)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        rtol, atol = tol[dt]
        bad = err > atol + rtol * ref.float().abs()
        check(not bool(bad.any()),
              f"lrn_fwd {shape} n={n} {dt}: {int(bad.sum())} elements "
              f"off (max abs err {float(err.max()):.3g})")
        if dt == torch.bfloat16:
            check_one_ulp(y, ref, f"lrn_fwd {shape} n={n}")
        row = {"shape": list(shape), "n": n, "dtype": str(dt)[6:],
               "role": role, "max_abs_err": float(err.max())}
        row["kernel_ms"] = cuda_ms(lambda: lrn_cuda.lrn_fwd(x, n, k, alpha))
        row["plain_ms"] = cuda_ms(
            lambda: lrn_cuda.lrn_fwd_plain(x, n, k, alpha))
        if len(shape) == 4:
            xc = x.permute(0, 3, 1, 2)
            row["library_ms"] = cuda_ms(lambda: F.local_response_norm(
                xc, size=n, alpha=alpha * n, beta=0.75, k=k))
        else:
            row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = lrn_bound(shape, dt, n)
        print("lrn_fwd " + json.dumps(row) + f"  [{card}]", flush=True)
        rows.append(row)
    return rows


# -- phase 3: the served ensemble --------------------------------------

class HiveProcess:
    """``python -m veles_tpu_torch --serve-models`` over pipes."""

    def __init__(self, pkg: str, workdir: str) -> None:
        self.stderr_path = os.path.join(workdir, "hive.stderr")
        self._stderr = open(self.stderr_path, "w")
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--serve-models",
             f"alexnet={pkg}", "-b", "cuda", "--max-batch",
             str(MAX_BATCH), "--max-wait-ms", "20", "--install-dir",
             os.path.join(workdir, "hive_install"),
             "--heartbeat-every", "0"],
            cwd=HERE, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._stderr, text=True,
            bufsize=1)
        self._cond = threading.Condition()
        self._lines = {}
        self.hello = None
        self._wlock = threading.Lock()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            msg = json.loads(line)
            with self._cond:
                if msg.get("ready"):
                    self.hello = msg
                elif "id" in msg:
                    self._lines[msg["id"]] = msg
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def _wait(self, pred, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                got = pred()
                if got is not None:
                    return got
                left = deadline - time.monotonic()
                check(left > 0 and self.proc.poll() is None,
                      f"hive: no {what} (rc={self.proc.poll()}); "
                      f"stderr tail:\n{self.stderr_tail()}")
                self._cond.wait(min(left, 0.5))

    def wait_hello(self, timeout: float = 600.0):
        return self._wait(lambda: self.hello, timeout, "hello")

    def send(self, obj) -> None:
        """One request line: a dict, or a line already serialized."""
        line = (obj if isinstance(obj, str) else json.dumps(obj)) + "\n"
        with self._wlock:
            self.proc.stdin.write(line)
            self.proc.stdin.flush()

    def result(self, jid, timeout: float = 300.0):
        return self._wait(lambda: self._lines.pop(jid, None), timeout,
                          f"answer to {jid!r}")

    def stderr_tail(self, n: int = 30) -> str:
        self._stderr.flush()
        with open(self.stderr_path) as f:
            return "".join(f.readlines()[-n:])

    def shutdown(self, timeout: float = 120.0) -> int:
        self.send({"op": "shutdown"})
        return self.proc.wait(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._stderr.close()


def build_package(workdir: str) -> str:
    """A full-width AlexNet ensemble package: members drawn with numpy
    from SEED at the stddevs ``alexnet_layers`` declares, written in
    the framework-neutral (reference) layout."""
    from veles_tpu_torch.convert import params_to_jax
    from veles_tpu_torch.ensemble.packaging import pack_ensemble
    from veles_tpu_torch.models import alexnet

    class FL:
        workflow = None

    entry = os.path.join(workdir, "alexnet_entry.py")
    with open(entry, "w") as f:
        f.write("from veles_tpu_torch.models.alexnet import "
                "create_workflow  # noqa: F401\n")
    w = alexnet.create_workflow(FL())
    w.initialize()
    members = []
    for i in range(N_MEMBERS):
        gen = np.random.default_rng(SEED + i)
        params = {f.name: f.init_params(gen) for f in w.forwards}
        members.append({"params": params_to_jax(params),
                        "seed": SEED + i, "valid_error": 0.0,
                        "forward_names": [f.name for f in w.forwards]})
    pkg = os.path.join(workdir, "alexnet.vpkg")
    pack_ensemble(pkg, "alexnet", members, entry)
    return pkg


def request_rows():
    """Integer pixel values, mean-subtracted, as 1-16 row requests."""
    gen = np.random.default_rng(SEED + 100)
    out = []
    for _ in range(N_REQUESTS):
        n = int(gen.integers(1, 17))
        out.append((gen.integers(0, 256, (n,) + SAMPLE_SHAPE)
                    - 128).astype(np.float32))
    return out


def agree(got: np.ndarray, want: np.ndarray, atol: float, rtol: float,
          spread_frac: float, what: str) -> dict:
    """Probabilities within atol/rtol, and log-probabilities within
    ``spread_frac`` of their spread across classes: with random weights
    the probabilities sit near uniform, so the second check is the one
    that sees a wrong answer."""
    diff = np.abs(got - want)
    check(np.all(diff <= atol + rtol * np.abs(want)),
          f"{what}: probs differ by up to {diff.max():.3g}")
    lg = np.log(np.maximum(got, 1e-30))
    lw = np.log(np.maximum(want, 1e-30))
    spread = float(np.std(lw, axis=-1).min())
    dlog = float(np.abs(lg - lw).max())
    check(dlog <= spread_frac * spread,
          f"{what}: log-probs differ by {dlog:.3g}, spread {spread:.3g}")
    return {"max_abs_err": float(diff.max()), "max_logp_err": dlog,
            "logp_spread": spread}


def norm_layers_in_situ(model, device, rows: np.ndarray) -> list:
    """Each member's forward in bf16 on the card, unit by unit as the
    engine runs it: at every norm layer the kernel's output against the
    plain version's on the same activations, to one bf16 ulp.  Returns,
    per layer, the mean share of the denominator that the alpha term
    makes (how far the layer's output could show an alpha error)."""
    import torch

    from veles_tpu_torch.ops import batching, lrn_cuda
    from veles_tpu_torch.ops.lrn import LRNormalizer

    cast = batching.make_caster(torch.bfloat16)
    params = cast(batching.stack_member_params(
        model.forwards, model.member_params, device))
    shares = []
    with torch.inference_mode():
        for i in range(N_MEMBERS):
            x = device.put(rows).to(torch.bfloat16)
            for f in model.forwards:
                y, _ = f.apply_fwd({p: t[i] for p, t in
                                    params[f.name].items()}, x)
                if isinstance(f, LRNormalizer):
                    xc = x.contiguous()
                    check_one_ulp(y, lrn_cuda.lrn_fwd_plain(
                        xc, f.n, f.k, f.alpha, f.beta),
                        f"member {i} {f.name} in situ")
                    c = xc.shape[-1]
                    band = torch.from_numpy(
                        lrn_cuda.band_matrix(c, f.n)).to(xc.device)
                    s = (xc * xc).float().reshape(-1, c) @ band
                    shares.append(float(
                        (f.alpha * s / (f.k + f.alpha * s)).mean()))
                x = y
    return shares


def serve_phase(card: str, workdir: str):
    import torch

    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.fused import EnsembleEvalEngine
    from veles_tpu_torch.ops.lrn import LRNormalizer
    from veles_tpu_torch.serve.hive import load_model_package

    t0 = time.perf_counter()
    pkg = build_package(workdir)
    print(f"serve: packed {N_MEMBERS}-member ensemble "
          f"({os.path.getsize(pkg) / 2**20:.1f} MiB) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    hive = HiveProcess(pkg, workdir)
    try:
        t0 = time.perf_counter()
        hello = hive.wait_hello()
        check(hello["models"]["alexnet"]["resident"],
              f"model not resident: {hello}")
        print(f"serve: hive ready in {time.perf_counter() - t0:.1f}s "
              f"(platform {hello['platform']})", flush=True)
        # the main path's counts are the hive's own: a fresh process
        # starts them at 0, read here just before the requests and
        # again just after them
        hive.send({"op": "stats", "id": "stats0"})
        stats0 = hive.result("stats0")["stats"]
        check(stats0["kernel_launches"] == {"lrn_fwd": 0}
              and stats0["dispatches"] == 0,
              f"hive counts not zero before the requests: {stats0}")
        reqs = request_rows()
        payloads = [json.dumps({"id": i, "model": "alexnet",
                                "rows": r.tolist()})
                    for i, r in enumerate(reqs)]
        answers, lat = {}, {}
        errors = []

        def worker(ids):
            try:
                for i in ids:
                    ts = time.perf_counter()
                    hive.send(payloads[i])
                    answers[i] = hive.result(i)
                    lat[i] = time.perf_counter() - ts
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker,
                                    args=(range(t, N_REQUESTS, N_THREADS),))
                   for t in range(N_THREADS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t_start
        check(not errors and len(answers) == N_REQUESTS,
              f"requests failed: {errors[:3]}")
        hive.send({"op": "stats", "id": "stats"})
        stats = hive.result("stats")["stats"]
        rc = hive.shutdown()
        check(rc == 0, f"hive shutdown rc {rc}")
    finally:
        hive.kill()

    for i, r in enumerate(reqs):
        a = answers[i]
        check("probs" in a, f"request {i}: {a}")
        probs = np.asarray(a["probs"], np.float32)
        check(a["rows_n"] == len(r) and probs.shape == (len(r),
                                                        N_CLASSES),
              f"request {i}: rows_n {a['rows_n']} shape {probs.shape}")
        check(a["crc"] == zlib.crc32(probs.tobytes()),
              f"request {i}: crc mismatch")
        check(np.all(np.isfinite(probs)), f"request {i}: non-finite")
        check(np.allclose(probs.sum(-1), 1.0, atol=1e-3),
              f"request {i}: probs sum {probs.sum(-1)}")
    # the in-process engine on the card, same package, same dtype
    device = make_device("cuda")
    pristine = dict(root.__dict__)
    model = load_model_package("alexnet", pkg, device,
                               os.path.join(workdir, "local"), pristine)

    # every dispatch ran both LRN layers for every member on the card
    dispatches = int(stats["dispatches"])
    launches = int(stats["kernel_launches"]["lrn_fwd"])
    n_norm = sum(isinstance(f, LRNormalizer) for f in model.forwards)
    per_dispatch = n_norm * N_MEMBERS
    check(dispatches > 0 and launches == per_dispatch * dispatches,
          f"main path launched lrn_fwd {launches} times in {dispatches} "
          f"dispatches (want {per_dispatch} per dispatch)")

    engine = EnsembleEvalEngine(model.forwards, model.member_params,
                                device)
    # bf16 compute.  Each request runs here zero-padded to the hive's
    # batch shape, so the convolutions pick the algorithms they picked
    # there, but its neighbours in the hive's batch differ; 1e-3 abs on
    # probs, and 5% of the log-prob spread across classes
    worst = {"max_abs_err": 0.0, "max_logp_err": 0.0}
    for i, r in enumerate(reqs):
        xb = np.zeros((MAX_BATCH,) + r.shape[1:], np.float32)
        xb[:len(r)] = r
        res = agree(np.asarray(answers[i]["probs"], np.float32),
                    engine.predict_proba(xb)[:len(r)], 1e-3, 0.0, 0.05,
                    f"request {i} vs in-process engine")
        for key in worst:
            worst[key] = max(worst[key], res[key])

    # device-side dispatch time of the engine at the served batch
    rows64 = np.concatenate(reqs)[:MAX_BATCH]
    check(len(rows64) == MAX_BATCH, f"only {len(rows64)} request rows")
    xb = device.put(rows64)
    dispatch_ms = cuda_ms(lambda: engine.predict(xb), warmup=2, iters=10)
    engine.release()
    alpha_shares = norm_layers_in_situ(model, device, rows64)

    # f32 on the card (TF32 off) against the CPU plain path, 4 rows
    rows4 = np.concatenate(reqs)[:4]
    e32 = EnsembleEvalEngine(model.forwards, model.member_params, device,
                             compute_dtype=torch.float32)
    got = e32.predict_proba(rows4)
    e32.release()
    cpu = make_device("cpu")
    ecpu = EnsembleEvalEngine(model.forwards, model.member_params, cpu)
    want = ecpu.predict_proba(rows4)
    ecpu.release()
    f32 = agree(got, want, 0.0, 1e-3, 1e-3, "f32 card vs CPU plain path")

    lat_ms = sorted(v * 1e3 for v in lat.values())
    n_rows = sum(len(r) for r in reqs)
    serve = {"requests": N_REQUESTS, "rows": n_rows,
             "dispatches": dispatches,
             "max_batch_rows": stats["max_batch_rows"],
             "lrn_fwd_launches": launches,
             "launches_per_dispatch": launches / dispatches,
             "p50_ms": lat_ms[len(lat_ms) // 2], "p_max_ms": lat_ms[-1],
             "img_s": n_rows / wall, "wall_s": wall,
             "engine_dispatch_ms_b64": dispatch_ms,
             "engine_img_s_b64": MAX_BATCH / dispatch_ms * 1e3,
             "vs_engine_bf16": worst, "f32_card_vs_cpu": f32,
             "lrn_alpha_share_in_situ": alpha_shares,
             "prob_max": float(max(np.max(a["probs"])
                                   for a in answers.values())),
             "card": card}
    return serve, launches


def summary_kernel(rows, launches: int, card: str) -> dict:
    """The kernels-line entry: times summed over the main path's two
    shapes (one member's forward at batch 64 in bf16, n = 5)."""
    main = [r for r in rows if r["role"] == "main"]
    lib = [r["library_ms"] for r in main]
    return {"name": "lrn_fwd", "route": "cuda",
            "source": "veles_tpu_torch/csrc/lrn_fwd.cu",
            "replaces": "veles_tpu/ops/lrn_pallas.py:132",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in main),
            "ms": sum(r["kernel_ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in main) else "operations",
            "library_ms": sum(lib) if None not in lib else None,
            "shapes": [r["shape"] for r in main], "card": card}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; "
              "this script needs one CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from veles_tpu_torch.backends import make_device
        from veles_tpu_torch.ops import lrn_cuda
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not beside this script "
              f"({e})", file=sys.stderr)
        return 1

    workdir = os.path.join(HERE, "_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        # phase 1: device and build
        make_device("auto")
        name = torch.cuda.get_device_name(0)
        card = card_line()
        print(f"device: {name} x{torch.cuda.device_count()}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        lrn_cuda.build()
        print(f"build: lrn_fwd in {time.perf_counter() - t0:.1f}s "
              f"({lrn_cuda.build_info['path']})", flush=True)
        for line in lrn_cuda.build_info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas: " + line.strip())
        # phase 2: every kernel against its plain version
        rows = kernel_phase(card)
        # phase 3: the main path
        serve, launches = serve_phase(card, workdir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print("serve " + json.dumps(serve))
    print(card)
    print(json.dumps({"kernels": [summary_kernel(rows, launches, card)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
