"""Share of the traced window with no operation on the device, %."""
from benchmark.readings import idle_pct


def read(run):
    return idle_pct(run)
