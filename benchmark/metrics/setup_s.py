"""Set-up seconds: from the start of the process to the window
(imports, the CUDA context, the kernels built or loaded, inputs from the
seed, the warm-up steps or requests)."""


def read(run):
    return run.setup_s
