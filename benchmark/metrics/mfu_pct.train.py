"""The least time of a step's required work (work/<work>.py) at the
card's peaks over the measured step time, %."""
from benchmark.readings import mfu_step


def read(run):
    return mfu_step(run)
