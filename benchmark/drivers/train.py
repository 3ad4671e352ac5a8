"""Training loop: the system's train step, back to back, on a batch of
registration pairs.

Set-up makes the model's control points and ``checked_steps`` batches of
pairs that all differ, and drives the model through its first steps on
them with the window's own call: those steps warm up every shape and
are the ones the reference follows.  The window then runs the same call
on the same model, cycling over the batches, for ``--seconds``; it ends
with a synchronize, and every step issued in it is done then.

Traffic keys: ``batch``, ``lr``, ``checked_steps``, ``labels`` (label
count of the synthetic subjects), ``warp_voxels`` (amplitude of a pair's
warp), ``sigma`` (spread of the initial control points), ``trace_units``
(steps in the traced span).
"""
from __future__ import annotations

import time

import torch

from .. import data
from ..reference import models as reference
from .common import free, reset_peak, sync


def _faulty(run, step):
    """The window's step with a planted fault (the fault tests and the
    calibration): ``unchanged`` leaves the state as it was; ``half_batch``
    steps on the first half of the batch alone, its mean over that half."""
    if run.fault is None:
        return step
    if run.fault == "unchanged":
        def unchanged(model, mov, fix):
            saved = model.params.detach().clone()
            loss = step(model, mov, fix)
            with torch.no_grad():
                model.params.copy_(saved)
            return loss
        return unchanged
    if run.fault == "half_batch":
        half = run.system.build(run.cfg, run.traffic["batch"] // 2,
                                run.device)

        def half_batch(model, mov, fix):
            h = mov.shape[0] // 2
            half.params = torch.nn.Parameter(model.params.data[:h])
            return step(half, mov[:h], fix[:h])
        return half_batch
    raise ValueError(f"train: no fault {run.fault!r}")


def setup(run):
    cfg, tr, dev = run.cfg, run.traffic, run.device
    B, K = tr["batch"], tr["checked_steps"]
    p0 = data.control_points(run.gen, B, cfg["coarse_shape"], tr["sigma"],
                             dev)
    mov, fix = data.pairs(run.gen, K * B, cfg["vol_shape"], tr["labels"],
                          tr["warp_voxels"], dev)
    batches = [(mov[k * B:(k + 1) * B], fix[k * B:(k + 1) * B])
               for k in range(K)]
    model = run.system.build(cfg, B, dev)
    with torch.no_grad():
        model.params.copy_(p0)

    def base(model, m, f):
        return run.system.train_step(model, m, f, cfg, tr)
    step = _faulty(run, base)
    losses, p1 = [], None
    for k in range(K):
        losses.append(step(model, *batches[k]))
        if k == 0:
            p1 = model.params.detach().clone()
    p_last = model.params.detach().clone()
    sync(dev)
    return dict(model=model, step=step, batches=batches, p0=p0, p1=p1,
                p_last=p_last, losses=[float(x) for x in losses])


def window(run, st, seconds):
    model, step, batches = st["model"], st["step"], st["batches"]
    dev = run.device
    losses = []
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        losses.append(step(model, *batches[k % len(batches)]))
        k += 1
    sync(dev)
    t1 = time.perf_counter()
    finite = torch.isfinite(torch.stack(losses)) if losses else None
    failed = 0 if finite is None else int((~finite).sum())
    return dict(units=k, seconds=t1 - t0, failed=failed,
                step_s=(t1 - t0) / max(k, 1))


def span(run, st, n):
    """``n`` more steps, each in a ``bench.step`` annotation."""
    model, step, batches = st["model"], st["step"], st["batches"]
    for k in range(n):
        with torch.profiler.record_function("bench.step"):
            step(model, *batches[k % len(batches)])


def program_readings(st, lr):
    """The program's losses, first gradient (from the state after one
    SGD step) and change of the parameters over the checked steps,
    float64."""
    p0 = st["p0"].double()
    return (torch.tensor(st["losses"], dtype=torch.float64),
            (p0 - st["p1"].double()) / lr, st["p_last"].double() - p0)


def compare(prog, ref):
    """The numbers compared: the widest relative gap of a step's loss,
    and the gaps between the norms of the first gradient and of the
    parameters' change (one leaf: the control points), each over the
    reference's norm."""
    (lp, gp, dp), (lr_, gr, dr) = prog, ref

    def gap(a, b):
        nb = float(b.norm())
        return abs(float(a.norm()) - nb) / nb

    loss = float(((lp - lr_).abs() / lr_.abs()).max())
    return {"loss_gap": loss, "grad_gap": gap(gp, gr),
            "change_gap": gap(dp, dr)}


def reference_readings(run, st, dtype=torch.float64):
    tr = run.traffic
    return reference.train_steps(run.system.KIND, run.cfg, st["p0"],
                                 st["batches"], tr["lr"], tr["batch"],
                                 dtype)


def check(run, st):
    """Free the program's state, then hold its readings to the
    reference's."""
    prog = program_readings(st, run.traffic["lr"])
    for key in ("model", "step", "p1", "p_last"):
        st.pop(key, None)
    free(run.device)
    ref = reference_readings(run, st)
    return compare([x.cpu() for x in prog], [r.cpu() for r in ref])
