#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's two main paths at the full width of AlexNet, serving
and training, and holds each hand-written kernel against its plain
PyTorch version.  Every phase is fatal: the script exits nonzero,
printing no result line, when any check fails, when there is no CUDA
device, or when it is run without the repository beside it.  It imports
nothing of JAX and nothing of the JAX package.

1. Device: the card's name and power limit; build both LRN kernels from
   ``veles_tpu_torch/csrc/`` (one ``nvcc`` each, started together),
   print each kernel function's registers and spills as ptxas reports
   them, and fail on any spill.
2. Kernels vs plain on the card, at AlexNet's two norm shapes.
   ``lrn_fwd`` at batch 64 (serving) and 128 (training), ``lrn_bwd`` at
   batch 128; n = 5 and 4, f32 and bf16; plus the edges of the kernels'
   design (``lrn_cases``).  Each case prints the kernel's, the plain
   version's and the library call's times (``torch.nn.functional.
   local_response_norm`` and, for the backward, autograd through it),
   each the mean of many launches back to back over rotated copies of
   the inputs with no host time in the window (``cuda_ms``), its memory
   bound, its share of the bound and the max abs error.
3. Serve: pack a 2-member full-width AlexNet ensemble (gaussian init at
   ``alexnet_layers``' stddevs from a numpy seed), start
   ``python -m veles_tpu_torch --serve-models alexnet=PKG --max-batch
   64`` on the card, send concurrent requests of 1-16 rows, check every
   answer (rows_n, crc, probabilities summing to 1, agreement with the
   in-process engine at the same dtype), read the hive's stats (the
   serving path's kernel launches), shut it down (rc 0).  Then each norm
   layer of each member, in bf16 on a served batch, against the plain
   version to one bf16 ulp; and, once, the in-process engine in f32 on
   the card (TF32 off) against the CPU plain path in f32.
4. Train: full-width AlexNet (227x227x3, 1000 classes, minibatch 128,
   superstep 8, bf16) for 2 epochs through ``Launcher`` +
   ``drive_workflow`` on ``veles_tpu_torch/models/alexnet.py``, the path
   ``python -m veles_tpu_torch`` takes, in process, with the data set
   cut to 1024 train + 128 validation images.  The launch counts are
   zeroed just before and read just after; every training minibatch
   must have run ``lrn_bwd`` at both norm layers and every minibatch
   ``lrn_fwd``.  Then one train superstep timed with CUDA events, and
   each norm layer's backward at the activations and error of a real
   training minibatch, kernel vs plain, in bf16.
5. Card vs CPU: one train superstep (k = 2, dropout 0, f32, TF32 off)
   from the same params and indices on the card and through the port's
   CPU plain path, the CPU replaying the card's choices at every max
   pool (argmax) and ReLU (mask), each choice it would have made
   otherwise a near tie: every param's change agrees within 1e-3
   relative.
6. Summary: ``serve`` and ``train`` JSON lines, the card line, the
   ``kernels`` line, then the device line last.
"""

from __future__ import annotations

import json
import logging
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
TRAIN_BATCH = 128
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

#: inputs rotated in a timed run add up to at least this much, well over
#: the H100's 50 MB L2, so that each launch reads its own inputs cold
ROTATE_BYTES = 256 << 20
#: cycles of the sleep kernel queued ahead of a timed run (about 11 ms at
#: 1.75 GHz); doubled until the host has queued every launch before it
#: ends
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, inputs, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` over ``iters``
    launches back to back between two CUDA events.  ``inputs`` holds
    copies of the arguments (``rotations``), together well over the L2,
    so each launch reads its own inputs from device memory, and each
    output is written back once, as the bound counts; no flush leaves
    dirty lines for the timed kernel to write back.  A sleep kernel is
    queued ahead of the start event, and the host must queue every
    launch before it ends (else the sleep doubles and the run repeats),
    so the host's time per call never falls inside the window."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    cycles = SLEEP_CYCLES
    for _ in range(7):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise SmokeFailure("cuda_ms: the host could not queue the launches "
                       "within a sleep of %d cycles" % cycles)


def rotations(*tensors, iters: int):
    """Copies of ``tensors`` for :func:`cuda_ms`: enough sets that they
    add up to ``ROTATE_BYTES``, at least 2, and no more than ``iters`` + 2
    (the timed and warm-up launches)."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = min(max(2, -(-ROTATE_BYTES // size)), iters + 2)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def lrn_bound(shape, dtype, n_arrays: int, ops_per_elem: float):
    """(bound_ms, bound_by): each of ``n_arrays`` arrays of ``shape``
    read or written once, against ``ops_per_elem`` f32 operations per
    element."""
    import torch
    numel = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    t_bytes = n_arrays * numel * item / HBM_BYTES_S * 1e3
    t_ops = ops_per_elem * numel / F32_FLOPS_S * 1e3
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


def bwd_terms(x, err, n: int, k: float, alpha: float, beta: float = 0.75):
    """The two terms of the backward, ``|e*d|`` and ``|2*alpha*beta*x*wt|``,
    in f32 as the plain version forms them."""
    import torch

    from veles_tpu_torch.ops import lrn_cuda
    c = x.shape[-1]
    xr = x.reshape(-1, c)
    xf, ef = xr.float(), err.reshape(-1, c).float()
    s = (xr * xr).float() @ lrn_cuda._band_tensor(c, n, x.device,
                                                  torch.float32)
    d, d1 = lrn_cuda._powers(k + alpha * s, beta, need_d1=True)
    t = (ef * xf * d1).to(x.dtype).float()
    wt = t @ lrn_cuda._band_tensor(c, n, x.device, torch.float32,
                                   transpose=True)
    return ((ef * d).abs().reshape(x.shape),
            (2.0 * alpha * beta * xf * wt).abs().reshape(x.shape))


def check_bwd_bf16(out, ref, x, err, n: int, k: float, alpha: float,
                   what: str, beta: float = 0.75) -> None:
    """bf16 backward within one bf16 ulp (at most 2^-7 of the value) of
    the LARGER of its two terms, ``|e*d|`` and ``|2*alpha*beta*x*wt|``.
    The result is their difference: where they cancel, an ulp of the
    result alone is far smaller than the rounding either term carries
    (the kernel and the plain version may round t, or the result, on
    either side of a bf16 boundary when their f32 window sums differ in
    order), so the yardstick is the larger term's ulp."""
    import torch
    a, b = bwd_terms(x, err, n, k, alpha, beta)
    diff = (out.float() - ref.float()).abs()
    bad = diff > 2.0 ** -7 * torch.maximum(a, b)
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} bf16 elements more than one ulp of "
          f"the larger term off (max abs err {float(diff.max()):.3g})")


K_LRN, ALPHA_LRN = 2.0, 1e-4
#: kernel vs plain version, in the same dtype.  Forward: in f32 the two
#: differ only in the order of the <= n-term f32 window sum (den >= k =
#: 2, so relative errors stay near 1e-7); in bf16 that order can flip the
#: final rounding of y by one bf16 ulp (2^-8 relative), well inside 2e-2,
#: and bf16 is also held to one ulp (2e-2 alone would pass an alpha off
#: by 10%).  Backward: f32 at the tolerance of the reference's own Pallas
#: backward test (tests/test_ops.py); bf16 by check_bwd_bf16.
FWD_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}
BWD_TOL = (2e-4, 1e-5)
#: timed launches of a kernel, and of its plain version or library call
KERNEL_ITERS, REF_ITERS = 50, 10
#: the edge cases' rows: 4 x 13 x 17 = 884
EDGE = (4, 13, 17)


def lrn_cases():
    """(kernel, shape, n, dtype, role) of every kernel-phase case.  Roles:
    "serve" and "train" are the main paths' shapes (bf16, n = 5, at batch
    64 and 128); "check" the other n and dtypes there; the rest are edges
    of the kernels' design: a ragged row count, a row of 16 384 channels
    (the vector path) and one of 16 383 (the row path, with over 48 KiB
    of shared memory a block), C not a multiple of the 8-element vector
    (100) or under n (3), n = 1, n = 9 (past the vector path's widest
    window, 5), n = 19 (a halo wider than a neighbouring vector), and
    inputs whose data pointer is one element past a 16-byte boundary;
    "rows" times the row path at the training path's row count (C =
    100, bf16)."""
    cases = []
    for name, roles in (("lrn_fwd", (("serve", 64), ("train", 128))),
                        ("lrn_bwd", (("train", 128),))):
        for role, batch in roles:
            for hw, c in ((55, 96), (27, 256)):
                for n in (5, 4):
                    if name == "lrn_fwd" and role == "train" and n != 5:
                        continue
                    for dt in ("float32", "bfloat16"):
                        main = n == 5 and dt == "bfloat16"
                        cases.append((name, (batch, hw, hw, c), n, dt,
                                      role if main else "check"))
        cases.append((name, (3, 17, 19, 96), 5, "float32", "ragged"))
        if name == "lrn_bwd":
            cases.append((name, (3, 17, 19, 96), 4, "bfloat16", "ragged"))
        cases.append((name, (TRAIN_BATCH, 55, 55, 100), 5, "bfloat16",
                      "rows"))
        cases.append((name, (5, 16384), 5, "bfloat16", "wide"))
        cases.append((name, (5, 16383), 5, "bfloat16", "wide"))
        for dt in ("float32", "bfloat16"):
            for c, n in ((100, 5), (3, 5), (96, 1), (96, 9), (96, 19)):
                cases.append((name, EDGE + (c,), n, dt, "edge"))
            cases.append((name, EDGE + (96,), 5, dt, "unaligned"))
    return cases


def _misaligned(t):
    """A contiguous copy of ``t`` whose data pointer is one element into
    a buffer, so not 16-byte aligned."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 != 0,
          "could not make a misaligned input")
    return out


def lrn_case(case, gen, card: str) -> dict:
    """One kernel-phase case: the kernel against its plain version at the
    stated tolerance, then the kernel's, the plain version's and the
    library call's times (never called by the port: ``torch.nn.
    functional.local_response_norm`` on an NCHW view, and for the
    backward autograd through it), its memory bound and its share of the
    bound."""
    import torch
    import torch.nn.functional as F

    from veles_tpu_torch.ops import lrn_cuda
    name, shape, n, dt, role = case
    dtype = getattr(torch, dt)
    k, alpha = K_LRN, ALPHA_LRN
    # post-ReLU-scale activations: alpha * window sum is a sizable part of
    # den, so the power term is exercised
    x = (torch.randn(shape, generator=gen, device="cuda") * 30.0).to(dtype)
    e = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if role == "unaligned":
        x, e = _misaligned(x), _misaligned(e)
    row = {"kernel": name, "shape": list(shape), "n": n, "dtype": dt,
           "role": role}
    what = f"{name} {shape} n={n} {dt} {role}"
    if name == "lrn_fwd":
        args = (x,)
        kernel = lambda x: lrn_cuda.lrn_fwd(x, n, k, alpha)  # noqa: E731
        plain = lambda x: lrn_cuda.lrn_fwd_plain(x, n, k, alpha)  # noqa: E731
        got, ref = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        rtol, atol = FWD_TOL[dt]
        bad = err > atol + rtol * ref.float().abs()
        check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
              f"off (max abs err {float(err.max()):.3g})")
        if dtype == torch.bfloat16:
            check_one_ulp(got, ref, what)
    else:
        args = (x, e)
        kernel = lambda x, e: lrn_cuda.lrn_bwd(x, e, n, k, alpha)  # noqa: E731
        plain = lambda x, e: lrn_cuda.lrn_bwd_plain(  # noqa: E731
            x, e, n, k, alpha)
        got, ref = kernel(x, e), plain(x, e)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if dtype == torch.bfloat16:
            check_bwd_bf16(got, ref, x, e, n, k, alpha, what)
        else:
            rtol, atol = BWD_TOL
            bad = err > atol + rtol * ref.abs()
            check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements "
                  f"off (max abs err {float(err.max()):.3g})")
    row["max_abs_err"] = float(err.max())
    if role == "unaligned":
        rot = [tuple(_misaligned(t) for t in args) for _ in range(2)]
    else:
        rot = rotations(*args, iters=KERNEL_ITERS)
    row["kernel_ms"] = cuda_ms(kernel, rot, KERNEL_ITERS)
    if name == "lrn_fwd":
        row["bound_ms"], row["bound_by"] = lrn_bound(shape, dtype, 2, n + 6)
    else:
        # x and e read once, the result written once; about 3n + 11 f32
        # operations an element (two window sums, the squares, den and
        # its powers, the products)
        row["bound_ms"], row["bound_by"] = lrn_bound(shape, dtype, 3,
                                                     3 * n + 11)
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["plain_ms"] = cuda_ms(plain, rot, REF_ITERS)
    row["library_ms"] = None
    if len(shape) == 4 and name == "lrn_fwd":
        row["library_ms"] = cuda_ms(
            lambda x: F.local_response_norm(
                x.permute(0, 3, 1, 2), size=n, alpha=alpha * n, beta=0.75,
                k=k), rot, REF_ITERS)
    elif len(shape) == 4:
        # autograd through the library's forward, one graph recorded per
        # rotated input set
        graphs = []
        for xr, er in rot:
            xl = xr.permute(0, 3, 1, 2).detach().requires_grad_(True)
            graphs.append((xl, F.local_response_norm(
                xl, size=n, alpha=alpha * n, beta=0.75, k=k),
                er.permute(0, 3, 1, 2)))
        row["library_ms"] = cuda_ms(
            lambda xl, yl, el: torch.autograd.grad(yl, xl, el,
                                                   retain_graph=True),
            graphs, REF_ITERS)
        del graphs
    print(f"{name} " + json.dumps(row) + f"  [{card}]", flush=True)
    return row


def kernel_phase(card: str):
    """Both kernels against their plain versions, with times."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return [lrn_case(case, gen, card) for case in lrn_cases()]


def ptxas_table(log: str) -> list:
    """Per kernel function in ptxas's -v output: its registers and spill
    bytes."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None and "spill_stores" not in cur:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


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
        params = {f.name: f.fill_params(gen) for f in w.forwards}
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
                                    params[f.name].items()}, x,
                                   train=False)
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
    dispatch_ms = cuda_ms(engine.predict, [(xb,)], iters=10)
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


# -- phase 4: training ----------------------------------------------------

#: the data set cut of the training phase: host generation stays about
#: 20 s; widths and depth are the model's
TRAIN_OVERRIDES = ["root.alexnet.loader.n_train=1024",
                   "root.alexnet.loader.n_valid=128",
                   "root.alexnet.decision.max_epochs=2"]
N_TRAIN, N_VALID, N_EPOCHS, SUPERSTEP = 1024, 128, 2, 8


class _Capture:
    """Wraps a gradient unit's backward_from_saved to keep every
    (x, err) it is given, in order."""

    def __init__(self, gd) -> None:
        self.gd, self.got = gd, []
        self.inner = gd.backward_from_saved
        gd.backward_from_saved = self

    def __call__(self, params, saved, err, *args, **kwargs):
        self.got.append((saved[0].contiguous(), err.contiguous()))
        return self.inner(params, saved, err, *args, **kwargs)

    def restore(self) -> None:
        del self.gd.backward_from_saved


def train_phase(card: str) -> dict:
    """Full-width AlexNet, 2 epochs, through the port's entry path."""
    import torch

    from veles_tpu_torch.config import parse_overrides, root
    from veles_tpu_torch.launcher import Launcher, drive_workflow
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops import lrn_cuda
    from veles_tpu_torch.ops.lrn import GDLRNormalizer

    saved_root = dict(root.__dict__)
    parse_overrides(TRAIN_OVERRIDES)
    try:
        launcher = Launcher(backend="cuda", seed=SEED)
        # the training path's counts: zeroed just before, read just after
        lrn_cuda.lrn_fwd.launches = lrn_cuda.lrn_bwd.launches = 0
        t0 = time.perf_counter()
        drive_workflow(launcher, os.path.join(
            HERE, "veles_tpu_torch", "models", "alexnet.py"))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"lrn_fwd": lrn_cuda.lrn_fwd.launches,
                    "lrn_bwd": lrn_cuda.lrn_bwd.launches}
    finally:
        root.__dict__.clear()
        root.__dict__.update(saved_root)
    w = launcher.workflow
    ld, fused = w.loader, w.fused
    check(ld.max_minibatch_size == TRAIN_BATCH and
          w.superstep == SUPERSTEP and fused.compute_dtype ==
          torch.bfloat16, f"not the configured run: mb "
          f"{ld.max_minibatch_size}, superstep {w.superstep}, "
          f"{fused.compute_dtype}")
    n_norm = sum(isinstance(gd, GDLRNormalizer) for gd in w.gds)
    train_mb = N_EPOCHS * N_TRAIN // TRAIN_BATCH
    valid_mb = N_EPOCHS * -(-N_VALID // TRAIN_BATCH)
    check(n_norm == 2 and launches == {
        "lrn_bwd": n_norm * train_mb,
        "lrn_fwd": n_norm * (train_mb + valid_mb)},
        f"training path launches {launches} with {n_norm} norm layers, "
        f"{train_mb} train and {valid_mb} validation minibatches")
    hist = w.decision.history
    check([(r["class"], r["count"]) for r in hist] ==
          [("validation", N_VALID), ("train", N_TRAIN)] * N_EPOCHS,
          f"history {hist}")
    check(all(np.isfinite(r["loss"]) for r in hist),
          f"non-finite loss in {hist}")
    check(w.decision.complete, "decision did not complete")

    # one train superstep timed with CUDA events (the loader goes on
    # past the last epoch: a validation firing, then train)
    ld.run()
    ld.run()
    check(ld.minibatch_class == TRAIN and ld.superstep_k == SUPERSTEP,
          f"no full train superstep: class {ld.minibatch_class}, k "
          f"{ld.superstep_k}")
    w.lr_adjust.run()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    fused.run()
    end.record()
    torch.cuda.synchronize()
    superstep_ms = start.elapsed_time(end)
    fused.take_class_metrics()

    # in situ: each norm layer's backward at a real training minibatch
    caps = [_Capture(gd) for gd in w.gds if isinstance(gd, GDLRNormalizer)]
    try:
        fused.run()
        torch.cuda.synchronize()
    finally:
        for cap in caps:
            cap.restore()
    fused.take_class_metrics()
    in_situ = []
    for cap in caps:
        f = cap.gd.forward
        x, err = cap.got[0]
        check(x.dtype == err.dtype == torch.bfloat16,
              f"{cap.gd.name}: saw {x.dtype} / {err.dtype}")
        out = lrn_cuda.lrn_bwd(x, err, f.n, f.k, f.alpha, f.beta)
        ref = lrn_cuda.lrn_bwd_plain(x, err, f.n, f.k, f.alpha, f.beta)
        torch.cuda.synchronize()
        check_bwd_bf16(out, ref, x, err, f.n, f.k, f.alpha,
                       f"{cap.gd.name} in situ", f.beta)
        a, b = bwd_terms(x, err, f.n, f.k, f.alpha, f.beta)
        in_situ.append({"layer": cap.gd.name, "shape": list(x.shape),
                        "max_abs_err": float((out.float() - ref.float())
                                             .abs().max()),
                        "window_term_share": float(
                            (b / (a + b).clamp(min=1e-30)).mean())})
    images = N_EPOCHS * (N_TRAIN + N_VALID)
    return {"epochs": N_EPOCHS, "minibatch": TRAIN_BATCH,
            "superstep": SUPERSTEP, "dtype": "bfloat16",
            "train_minibatches": train_mb,
            "valid_minibatches": valid_mb, "launches": launches,
            "history": hist, "superstep_ms": superstep_ms,
            "ms_per_train_minibatch": superstep_ms / SUPERSTEP,
            "train_img_s": SUPERSTEP * TRAIN_BATCH / superstep_ms * 1e3,
            "run_wall_s": w.wall_time, "run_img_s_wall":
            images / w.wall_time, "drive_wall_s": total_s,
            "lrn_bwd_in_situ": in_situ, "card": card}


# -- phase 5: one step on the card against the CPU plain path -----------

class _Routed(_Capture):
    """A max-pool gradient unit whose choices are recorded and, given
    ``indices`` (per call, in order: the (N, C, OH, OW) flat H*W
    positions of ``F.max_pool2d(..., return_indices=True)``), replayed:
    it then scatters its error to the inputs they name, summing where
    windows overlap, as the pool's own backward does with its own
    argmax.  ``choices()``: per call, its own argmax and its input."""

    def __init__(self, gd, indices=None) -> None:
        super().__init__(gd)
        self.indices = indices

    def __call__(self, params, saved, err, *args, **kwargs):
        import torch
        if self.indices is None:
            return super().__call__(params, saved, err, *args, **kwargs)
        x = saved[0]
        self.got.append((x.contiguous(), err.contiguous()))
        n, h, w, c = x.shape
        idx = torch.from_numpy(self.indices[len(self.got) - 1]).to(x.device)
        g = torch.zeros(n, c, h * w, dtype=err.dtype, device=x.device)
        g.scatter_add_(2, idx.reshape(n, c, -1),
                       err.permute(0, 3, 1, 2).reshape(n, c, -1))
        return g.reshape(n, c, h, w).permute(0, 2, 3, 1), {}

    def choices(self):
        import torch.nn.functional as F
        f = self.gd.forward
        return [(F.max_pool2d(x.permute(0, 3, 1, 2), (f.ky, f.kx),
                              f.sliding, return_indices=True)[1]
                 .cpu().numpy(), x.cpu()) for x, _ in self.got]


class _Masked:
    """A ReLU gradient unit whose choices are recorded and, given
    ``masks`` (per call, in order: output > 0), replayed in place of its
    own.  ``choices()``: per call, its own mask and its output."""

    def __init__(self, gd, masks=None) -> None:
        self.gd, self.masks, self.got = gd, masks, []
        self.inner = gd.act_deriv
        gd.act_deriv = self

    def __call__(self, output, err_output):
        import torch
        self.got.append(output.detach().cpu())
        if self.masks is None:
            return self.inner(output, err_output)
        mask = torch.from_numpy(self.masks[len(self.got) - 1])
        return err_output * mask.to(output.device, output.dtype)

    def restore(self) -> None:
        del self.gd.act_deriv

    def choices(self):
        return [((y > 0).numpy(), y) for y in self.got]


def _one_f32_step(backend: str, replay=None):
    """One train superstep of k = 2 minibatches of 32, dropout 0, f32,
    from the SEED params and indices: (params before, after, metrics,
    indices, {gradient unit: its own choices}), the choices those of
    every max pool and every ReLU in each minibatch (``_Routed``,
    ``_Masked``).  With ``replay`` ({gradient unit: choices per
    minibatch}), each of those units makes the given choices instead."""
    import torch

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.models import alexnet
    from veles_tpu_torch.ops.pooling import MaxPooling

    class FL:
        workflow = None

    prng.seed_all(SEED)
    loader = dict(alexnet.DEFAULTS["loader"], minibatch_size=32,
                  n_train=64, n_valid=0)
    w = alexnet.create_workflow(FL(), loader=loader, dropout=0.0)
    w.superstep = 2
    w.fused.compute_dtype = torch.float32
    w.initialize(device=make_device(backend), train=True)
    before = w.fused.host_params()
    w.loader.run()
    check(w.loader.minibatch_class == TRAIN and w.loader.superstep_k == 2,
          "card-vs-CPU step: no 2-minibatch train superstep")
    w.lr_adjust.run()
    replay = replay or {}
    caps = [_Routed(gd, replay.get(gd.name))
            if isinstance(gd.forward, MaxPooling) else
            _Masked(gd, replay.get(gd.name)) for gd in w.gds
            if isinstance(gd.forward, MaxPooling)
            or gd.forward.activation_mode == "relu"]
    try:
        w.fused.run()
    finally:
        for cap in caps:
            cap.restore()
    return before, w.fused.host_params(), w.fused.take_class_metrics(), \
        w.loader.superstep_indices, {cap.gd.name: cap.choices()
                                     for cap in caps}


def _flip_gap(card, cpu) -> tuple:
    """(choices that differ, choices, the largest near-tie gap among
    them) of one unit over the step's minibatches.  A max pool's gap is
    how far apart, relative to the window's max, the CPU's inputs at the
    two chosen positions lie; a ReLU's is the larger of the two devices'
    outputs there, relative to the layer's largest output."""
    import torch
    n_flip = n_all = 0
    gap = 0.0
    for (c_dec, c_val), (own, val) in zip(card, cpu):
        n_all += own.size
        flip = c_dec != own
        n_flip += int(flip.sum())
        if not flip.any():
            continue
        at = torch.from_numpy(flip)
        if own.dtype == bool:             # a ReLU: mask and outputs
            g = (torch.maximum(val[at].abs(), c_val[at].abs()).max()
                 / val.abs().max().clamp(min=1e-30))
        else:                             # a max pool: its inputs
            xf = val.permute(0, 3, 1, 2).flatten(2)
            got = [xf.gather(2, torch.from_numpy(i).flatten(2))
                   .reshape(i.shape)[at] for i in (c_dec, own)]
            g = ((got[1] - got[0]).abs()
                 / got[1].abs().clamp(min=1e-30)).max()
        gap = max(gap, float(g))
    return n_flip, n_all, gap


def _rel_delta_diff(before, after_a, after_b) -> dict:
    """Per param, ``|da - db| / |db|`` of the two steps' changes."""
    out = {}
    for fn, ps in before.items():
        for pn, b in ps.items():
            da, db = after_a[fn][pn] - b, after_b[fn][pn] - b
            out[f"{fn}.{pn}"] = float(np.linalg.norm(da - db)
                                      / max(np.linalg.norm(db), 1e-30))
    return out


def card_vs_cpu_phase() -> dict:
    """The card's f32 step against the CPU plain path's, every param's
    change within 1e-3 relative.  Where a max-pool window's two largest
    inputs, or a ReLU's input and zero, lie closer than the two devices'
    f32 disagreement (about 1e-6 relative), the two may choose apart,
    and one such choice moves the error of every layer below it by about
    1e-3 of its norm.  So the CPU step replays the card's choices at
    every max pool and ReLU, and each choice the CPU would have made
    otherwise must be a near tie (gap within 1e-5, see ``_flip_gap``)
    and such choices rare (under 1e-4 of all: a fault would flip far
    more)."""
    import torch
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    b_card, a_card, m_card, i_card, c_card = _one_f32_step("cuda")
    b_cpu, a_cpu, m_cpu, i_cpu, c_cpu = _one_f32_step(
        "cpu", {name: [dec for dec, _ in got]
                for name, got in c_card.items()})
    check(np.array_equal(i_card, i_cpu), "different minibatch indices")
    flips = {}
    for name, got in c_cpu.items():
        n_flip, n_all, gap = _flip_gap(c_card[name], got)
        check(n_flip <= 1e-4 * n_all and gap <= 1e-5,
              f"{name}: {n_flip} of {n_all} choices differ between card "
              f"and CPU, the widest {gap:.3g} apart (relative)")
        flips[name] = {"differ": n_flip, "of": n_all, "gap": gap}
    for fn in b_cpu:
        for pn in b_cpu[fn]:
            check(np.array_equal(b_card[fn][pn], b_cpu[fn][pn]),
                  f"{fn}.{pn}: different initial params")
    rel = _rel_delta_diff(b_card, a_card, a_cpu)
    for pn, r in rel.items():
        check(r <= 1e-3, f"{pn}: the step's change differs by {r:.3g} "
              f"(relative, limit 1e-3) between card and CPU")
    check(m_card[0] == m_cpu[0] and m_card[2] == m_cpu[2],
          f"n_err/count differ: card {m_card}, cpu {m_cpu}")
    # for the record, not held to a limit: the CPU step on its own
    # choices, what the near ties alone move
    a_own = _one_f32_step("cpu")[1]
    return {"rel_delta_diff": rel, "near_tie_choices": flips,
            "rel_delta_diff_cpu_own_choices": _rel_delta_diff(
                b_card, a_card, a_own),
            "n_err": m_card[0], "count": m_card[2],
            "loss_card": m_card[1], "loss_cpu": m_cpu[1]}


# -- phase 6: summary -------------------------------------------------------

def summary_kernel(name: str, replaces: str, rows, launches: dict,
                   card: str) -> dict:
    """The kernels-line entry: times summed over the training path's two
    shapes (batch 128, bf16, n = 5); ``launches`` is the training path's
    count, ``launches_by_path`` that of each main path that reads it
    (serving runs no backward and reports only ``lrn_fwd``)."""
    main = [r for r in rows if r["kernel"] == name and r["role"] == "train"]
    lib = [r["library_ms"] for r in main]
    entry = {"name": name, "route": "cuda",
             "source": f"veles_tpu_torch/csrc/{name}.cu",
             "replaces": replaces,
             "launches": launches["train"],
             "launches_by_path": launches,
             "max_abs_err": max(r["max_abs_err"] for r in main),
             "ms": sum(r["kernel_ms"] for r in main),
             "plain_ms": sum(r["plain_ms"] for r in main),
             "bound_ms": sum(r["bound_ms"] for r in main),
             "share_of_bound": sum(r["bound_ms"] for r in main)
             / sum(r["kernel_ms"] for r in main),
             "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                        for r in main) else "operations",
             "library_ms": sum(lib) if None not in lib else None,
             "shapes": [r["shape"] for r in main], "card": card}
    serve = [r for r in rows if r["kernel"] == name and r["role"] == "serve"]
    if serve:
        entry["serve_ms"] = sum(r["kernel_ms"] for r in serve)
        entry["serve_shapes"] = [r["shape"] for r in serve]
    return entry


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
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")

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
        print(f"build: lrn_fwd and lrn_bwd in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for kname, info in lrn_cuda.build_info.items():
            print(f"build: {kname} {info['seconds']:.1f}s "
                  f"({info['path']})", flush=True)
            if not info["log"]:
                print(f"ptxas: {kname}: built by an earlier process, "
                      f"no report")
                continue
            table = ptxas_table(info["log"])
            for fn in table:
                print(f"ptxas: {kname}: " + json.dumps(fn))
            spilled = [fn["function"] for fn in table
                       if fn.get("spill_stores") or fn.get("spill_loads")]
            check(table and not spilled,
                  f"{kname}: ptxas reports spills in {spilled}")
        # phase 2: every kernel against its plain version
        rows = kernel_phase(card)
        # phase 3: the serving path
        serve, serve_launches = serve_phase(card, workdir)
        # phases 4 and 5: the training path
        train = train_phase(card)
        t0 = time.perf_counter()
        train["f32_card_vs_cpu"] = card_vs_cpu_phase()
        train["f32_card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = [
        summary_kernel("lrn_fwd", "veles_tpu/ops/lrn_pallas.py:132", rows,
                       {"train": train["launches"]["lrn_fwd"],
                        "serve": serve_launches}, card),
        summary_kernel("lrn_bwd", "veles_tpu/ops/lrn_pallas.py:151", rows,
                       {"train": train["launches"]["lrn_bwd"]}, card)]
    print("serve " + json.dumps(serve))
    print("train " + json.dumps(train))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
