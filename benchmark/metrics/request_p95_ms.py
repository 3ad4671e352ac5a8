"""The 95th percentile of the latencies of all requests of the window,
from the host's issue of a request to its completion (a CUDA event a
request), ms."""
import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
