"""Kernel 1 (csrc/warp.cu): the required-work share.  The least time of the
work that ``work/<work>.py`` gives to warp in a unit, at the card's
peaks, over the device time a unit of the kernels of
``kernels/warp.json`` in the traced span, %."""
from benchmark.readings import roofline_pct


def read(run):
    return roofline_pct(run, "warp")
