"""Milliseconds a step: the whole window (it ends with a synchronize)
over the optimizer steps done in it."""


def read(run):
    step = run.window.get("step_s")
    return None if step is None else 1e3 * step
