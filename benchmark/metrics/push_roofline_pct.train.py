"""Kernel 2 (csrc/push.cu, csrc/fixed_splat.cuh: push, keep,
scale, convert): the required-work share.  The least time of the
work that ``work/<work>.py`` gives to push in a unit, at the card's
peaks, over the device time a unit of the kernels of
``kernels/push.json`` in the traced span, %."""
from benchmark.readings import roofline_pct


def read(run):
    return roofline_pct(run, "push")
