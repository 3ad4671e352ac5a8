"""Requests completed over the window: the closed loop's throughput
(the window ends with a synchronize once every request issued in it is
done)."""


def read(run):
    if "latencies" not in run.window:
        return None
    return run.window["units"] / run.window["seconds"]
