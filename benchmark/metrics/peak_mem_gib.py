"""Peak device memory allocated in the window
(``torch.cuda.max_memory_allocated`` after a reset), GiB."""


def read(run):
    return run.window_peak / 2 ** 30
