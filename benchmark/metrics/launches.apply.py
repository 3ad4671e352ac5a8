"""Device kernels a unit in the traced span."""
from benchmark.readings import launches


def read(run):
    return launches(run)
