"""Device ms a unit of every operation that is not the program's own
kernel: PyTorch's elementwise passes, reductions, cuBLAS, copies, sets."""
from benchmark.readings import other_ms


def read(run):
    return other_ms(run)
