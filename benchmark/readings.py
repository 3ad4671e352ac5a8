"""Reductions the metric readers share: a traced span's device time by
layer, and the shares of the card's peaks that a unit's required work
(``work/<work>.py``) reads against the measured time."""
from __future__ import annotations

from typing import Optional

from . import registry
from . import trace as tr
from .work import counts
from .work.peaks import bound_s


def pct(x: float) -> float:
    return 100.0 * x


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return pct(1.0 - tr.busy_s(t) / t.window_s)


def port_pattern():
    names = sorted({k for ks in registry.kernel_sources().values()
                    for k in ks})
    return tr.kernel_pattern(names)


def other_ms(run) -> Optional[float]:
    """Device ms a unit of the device operations that are not the
    program's own kernels (PyTorch's elementwise passes, reductions,
    cuBLAS, copies and sets)."""
    t = run.trace
    if t is None or not run.trace_units:
        return None
    port = port_pattern()
    s = sum(t1 - t0 for name, t0, t1, cat in t.device
            if cat != "kernel" or not port.search(name))
    return 1e3 * s / run.trace_units


def launches(run) -> Optional[float]:
    t = run.trace
    if t is None or not run.trace_units:
        return None
    return len(t.kernels()) / run.trace_units


def roofline_pct(run, source: str) -> Optional[float]:
    """The required-work share of one of the program's kernel sources:
    the least time of a unit's required operations that
    ``work/<work>.py`` gives to ``source`` (at the card's peaks), times
    the units of the traced span, over the device time of the kernels of
    ``kernels/<source>.json`` in it.  Work the kernels do twice, or do
    beyond what is required, lowers the share."""
    t = run.trace
    ops = [o for o in run.required if o[3] == source]
    if t is None or not ops or not run.trace_units:
        return None
    busy = tr.device_s(t, tr.kernel_pattern(
        registry.kernel_sources()[source]))
    if busy <= 0:
        return None
    return pct(run.trace_units * bound_s(*counts.total(ops)) / busy)


def required_s(run) -> float:
    """Least seconds of one unit's required work (``work/<work>.py``)."""
    return bound_s(*counts.total(run.required))


def mfu_step(run) -> Optional[float]:
    step = run.window.get("step_s")
    if not step:
        return None
    return pct(required_s(run) / step)


def mfu_request(run) -> Optional[float]:
    """Required work of the requests completed in the window, at the
    card's peaks, over the window."""
    w = run.window
    if "latencies" not in w or not w["units"]:
        return None
    return pct(required_s(run) * w["units"] / w["seconds"])
