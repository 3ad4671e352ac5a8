"""Apply requests from a closed-loop client with ``in_flight`` requests
outstanding.

Set-up makes a pool of ``subjects`` (a T1 image, its label map with
``labels`` classes besides the background, and a stored velocity grid
each) and warms the path up with ``warmup`` requests.  In the window the
client issues request n + 1 while request n runs on the card, and waits
for request n + 1 - ``in_flight`` to complete before it issues n + 1:
with ``in_flight`` = 2, it waits for n before it issues n + 2.  It issues
requests until ``--seconds`` have passed, and the window ends with a
synchronize once they are all done.  The subjects come in ``cycle``
requests that take every subject equally often, in an order drawn from
the seed, so every seed asks for the same work.  A request's latency
runs from the host's issue of its first launch to the CUDA event
recorded after its last launch (read after the window, on the clock of
an event recorded as the window starts).

The outputs of ``sample`` requests, a sample drawn from the seed over
all the requests of the window (a reservoir: at most ``sample`` kept at a
time), are held to the reference after the window.

Traffic keys: ``subjects``, ``labels``, ``label_order``, ``in_flight``,
``cycle``, ``warmup``, ``sample``, ``sigma``, ``trace_units``.
"""
from __future__ import annotations

import math
import time

import torch

from .. import data
from ..reference import models as reference
from .common import free, on_cuda, reset_peak, sync


def _order(run):
    """The subject of each request, by its index modulo ``cycle``."""
    tr = run.traffic
    order = [k % tr["subjects"] for k in range(tr["cycle"])]
    run.rng.shuffle(order)
    return order


def setup(run):
    cfg, tr, dev = run.cfg, run.traffic, run.device
    t1, lab = data.subjects(run.gen, tr["subjects"], cfg["vol_shape"],
                            tr["labels"], dev)
    vel = data.control_points(run.gen, tr["subjects"], cfg["coarse_shape"],
                              tr["sigma"], dev)
    model = run.system.build(cfg, 1, dev)
    classes = list(range(tr["labels"] + 1))

    def request(s):
        img, out = run.system.apply(model, vel[s:s + 1], t1[s:s + 1],
                                    lab[s:s + 1], cfg, tr, classes)
        if run.fault == "altered":
            img = img.clone()
            img[..., 0, 0, 0] += 0.5
            out = out.clone()
            out[..., :16, :16, :16] = (out[..., :16, :16, :16] + 1) \
                % len(classes)
        elif run.fault is not None:
            raise ValueError(f"apply: no fault {run.fault!r}")
        return img, out
    with torch.no_grad():
        for k in range(tr["warmup"]):
            request(k % tr["subjects"])
    sync(dev)
    return dict(request=request, t1=t1, lab=lab, vel=vel, classes=classes,
                order=_order(run))


def _loop(run, st, t0, seconds=None, count=None, keep=None):
    """Issue requests in the closed loop from ``t0`` on, until ``seconds``
    have passed or ``count`` are issued; returns their completion events
    (on the CPU, their completion times) and their issue times, s after
    ``t0``.  ``keep`` (a reservoir of ``sample`` slots) keeps the outputs
    of a sample of the requests, drawn with ``run.rng``."""
    cuda = on_cuda(run.device)
    k_in = run.traffic["in_flight"]
    order = st["order"]
    ends, issued = [], []
    with torch.no_grad():
        n = 0
        while True:
            if n >= k_in and cuda:
                ends[n - k_in].synchronize()
            now = time.perf_counter() - t0
            if (seconds is not None and now >= seconds) or \
                    (count is not None and n >= count):
                break
            issued.append(now)
            s = order[n % len(order)]
            out = st["request"](s)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                ends.append(ev)
            else:
                ends.append(time.perf_counter() - t0)
            if keep is not None:
                slots = run.traffic["sample"]
                j = n if n < slots else run.rng.randrange(n + 1)
                if j < slots:
                    keep[j] = (s, out)
            n += 1
    return ends, issued


def window(run, st, seconds):
    dev = run.device
    keep = {}
    sync(dev)
    reset_peak(dev)
    start = None
    if on_cuda(dev):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    ends, issued = _loop(run, st, t0, seconds=seconds, keep=keep)
    sync(dev)
    t1 = time.perf_counter()
    done = [start.elapsed_time(e) * 1e-3 for e in ends] \
        if start is not None else ends
    lat = [d - i for d, i in zip(done, issued)]
    st.update(keep=keep)
    return dict(units=len(issued), seconds=t1 - t0, failed=0,
                latencies=lat)


def span(run, st, n):
    """``n`` more requests in the same loop, each in a ``bench.request``
    annotation."""
    req = st["request"]

    def annotated(s):
        with torch.profiler.record_function("bench.request"):
            return req(s)
    _loop(run, dict(st, request=annotated), time.perf_counter(), count=n)


def compare(prog, ref):
    """The widest gap of a warped image over the reference's largest
    value, and the widest share of a label map's voxels whose label
    differs from the reference's."""
    if not prog:
        return {"image_gap": math.inf, "label_gap": math.inf}
    img = lab = 0.0
    for (pi, pl), (ri, rl) in zip(prog, ref):
        img = max(img, float((pi.double() - ri).abs().max()
                             / ri.abs().max()))
        lab = max(lab, float((pl != rl).double().mean()))
    return {"image_gap": img, "label_gap": lab}


def reference_outputs(run, st, subjects, dtype=torch.float64):
    return [reference.svf_apply(st["vel"][s], st["t1"][s, 0],
                                st["lab"][s, 0], run.cfg, st["classes"],
                                run.traffic["label_order"], dtype)
            for s in subjects]


def check(run, st):
    kept = [st["keep"][j] for j in sorted(st["keep"])]
    prog = [(img[0, 0], lab[0, 0]) for _, (img, lab) in kept]
    st.pop("request", None)
    free(run.device)
    ref = reference_outputs(run, st, [s for s, _ in kept])
    return compare(prog, ref)
