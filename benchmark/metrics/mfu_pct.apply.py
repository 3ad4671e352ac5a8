"""The least time of the required work (work/<work>.py) of the
requests completed in the window, at the card's peaks, over the
window, %."""
from benchmark.readings import mfu_request


def read(run):
    return mfu_request(run)
