"""The traced span of a ``--trace 1`` run, reduced to what the readers
read.

``torch.profiler`` (CPU and CUDA activity) records the span inside a
``bench.window`` annotation that ends with a synchronize; the trace is
written as Chrome JSON into ``$TMPDIR`` (a file of its own, deleted once
read) and reduced to the window, the device operations (kernels, copies,
sets) and the host operations.  Times are seconds on the profiler's one
clock.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "bench.window"


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Tuple[str, float, float, str]]     # name, start, end, cat
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, pattern: Optional[re.Pattern] = None):
        return [d for d in self.device if d[3] == "kernel"
                and (pattern is None or pattern.search(d[0]))]


def profile(span, device="cuda") -> Trace:
    """Run ``span()`` under the profiler and reduce its trace (on the
    CPU, for the tests, the host's operations alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            span()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events)


def reduce(events) -> Trace:
    window, device, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, t0, t1, cat))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name == WINDOW:
                window = (t0, t1)
            else:
                host.append((name, t0, t1))
    if window is None:
        raise RuntimeError(f"trace: no {WINDOW!r} annotation")
    device = [d for d in device if d[2] > window[0] and d[1] < window[1]]
    device.sort(key=lambda d: d[1])
    host.sort(key=lambda h: h[1])
    return Trace(window, device, host)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the
    window."""
    lo, hi = trace.window
    out: List[List[float]] = []
    for _, t0, t1, _ in trace.device:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The idle intervals of the window."""
    lo, hi = trace.window
    out, t = [], lo
    for a, b in busy_intervals(trace):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_at(trace: Trace, t: float, starts=None) -> str:
    """Name of the innermost host operation running at ``t`` (the one
    that started last among those still running)."""
    starts = starts if starts is not None else [h[1] for h in trace.host]
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0:
        name, t0, t1 = trace.host[k]
        if t1 >= t:
            return name
        k -= 1
    return "host, outside any recorded operation"


def short(name: str, width: int = 96) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list, at most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:width]
    return name[:width]


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The heaviest device operations by name, and the idle time of the
    window by what the host was doing, each at most ``top``."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, t0, t1, _ in trace.device:
        by_op[short(name)] += t1 - t0
    starts = [h[1] for h in trace.host]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps(trace):
        by_host["idle: " + host_at(trace, 0.5 * (a + b), starts)] += b - a

    def rank(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def kernel_pattern(names) -> re.Pattern:
    """Matches a demangled kernel name of one of ``names`` defined at the
    top level or in a top-level anonymous namespace (the program's
    sources), not inside another namespace (PyTorch's ``at::``)."""
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(r"(?:^|\s)(?:\(anonymous namespace\)::)?(?:" + alt
                      + r")[<(]")


def device_s(trace: Trace, pattern: re.Pattern) -> float:
    """Device seconds of the kernels that ``pattern`` matches."""
    return sum(t1 - t0 for name, t0, t1, _ in trace.kernels(pattern))
