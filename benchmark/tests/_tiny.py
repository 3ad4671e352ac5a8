"""A cell of the benchmark cut to a size the CPU runs in seconds (the
program's plain versions), for the harness's tests."""
from __future__ import annotations

from benchmark import registry


def tiny_cell(name):
    c = registry.cell(name)
    coarse = [6, 7, 8] if c.cfg["model"] == "svf" else [3, 4, 4]
    c.cfg = dict(c.cfg, vol_shape=[12, 14, 16], coarse_shape=coarse)
    c.traffic = dict(c.traffic, batch=2, subjects=2, labels=4,
                     trace_units=2, warmup=1, sample=2)
    return c
