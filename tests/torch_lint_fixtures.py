"""Seeded sources for the port's two torch lint rules
(``tests/test_torch_veleslint.py``): ``tracer-hygiene`` (host syncs in
device-side step code) and ``engine-residency-seam`` (host -> card
placement on the serving and online paths outside the seam), each with
a clean twin, and a ``trace.py`` whose wire field is undeclared."""

#: every host sync the rule knows, in each way a function becomes
#: device-side: handed to torch.func.vmap by name or through
#: functools.partial, decorated with a transform, nested in a build_*
#: function of a device-step module
TRACER_BAD = '''\
import functools

import torch


def member_step(params, x, lr):
    loss = (params * x).sum()
    v = loss.item()                     # finding: .item()
    print("loss", v)                    # finding: print()
    step = float(lr)                    # finding: float(lr)
    return params - step * x


def member_eval(params, x, rc):
    host = x.cpu()                      # finding: .cpu()
    rows = host.numpy()                 # finding: .numpy()
    return params.sum() + len(rows) + rc


@torch.func.grad
def decorated(params, x):
    if torch.isnan(params).any():       # finding: branch on torch value
        return params.sum()
    return (params * x).sum()


def build_step(forwards):
    def fused_step(params, x, flag):
        torch.cuda.synchronize()        # finding: .synchronize()
        out = params * x
        keep = bool(flag)               # finding: bool(flag)
        return out.tolist() if keep else out   # finding: .tolist()
    return fused_step


def host_side(params):
    # not device-side: syncs are the host's business here
    print(params.sum().item())
    return params.cpu()


train = torch.func.vmap(member_step, in_dims=(0, None, 0))
evaluate = torch.func.vmap(functools.partial(member_eval, rc=1))
'''

TRACER_CLEAN = '''\
import functools

import torch


def member_step(params, x, lr):
    loss = (params * x).sum()
    return params - lr * x, torch.stack([loss, lr])


def member_eval(params, x, rc):
    return torch.where(torch.isnan(x), 0.0, params * x).sum() + rc


def build_step(forwards):
    n = len(forwards)

    def fused_step(params, x):
        out = params * x
        for _ in range(n):           # a Python loop over host values
            out = out + 1.0
        return out
    return fused_step


def host_side(params):
    return float(params.sum().item())


train = torch.func.vmap(member_step, in_dims=(0, None, 0))
evaluate = torch.func.vmap(functools.partial(member_eval, rc=1))
'''

#: placements on a serving path, each of the three spellings
SEAM_BAD = '''\
import numpy as np
import torch


class Server:
    def __init__(self, device):
        self.device = device

    def place(self, rows: np.ndarray):
        a = torch.from_numpy(rows).cuda()           # finding: .cuda()
        b = torch.from_numpy(rows).to(self.device)  # finding: .to(device)
        c = torch.as_tensor(rows, device="cuda")    # finding: factory
        d = torch.zeros(4, device=self.device)      # finding: factory
        e = torch.from_numpy(rows).to(device="cuda:0")  # .to(device=)
        return a, b, c, d, e
'''

SEAM_CLEAN = '''\
import numpy as np
import torch

from veles_tpu_torch.engine import core as engine_core


class Server:
    def __init__(self, core):
        self.core = core

    def place(self, rows: np.ndarray):
        t = self.core.put(rows)                     # through the seam
        half = t.to(torch.bfloat16)                 # a cast, no move
        host = torch.zeros(4)                       # on the host
        return half, host, engine_core
'''

#: a trace.py whose WIRE_FIELDS carries a key serve/protocol.py lacks
TRACE_WIRE_BAD = '''\
K_TRACE = "trace"
K_HOPS = "hops_undeclared"
WIRE_FIELDS = ("trace", "span", "parent", "not_a_wire_key")
'''
