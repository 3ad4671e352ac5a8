"""The apply cell's closed loop on the CPU at a tiny size: every request
of the window is counted and timed, and the sample held to the reference
is drawn over the whole window."""
import random
from types import SimpleNamespace

import torch

from benchmark.drivers import apply
from benchmark.tests._tiny import tiny_cell


def _run(seed, sample=3, in_flight=2):
    cell = tiny_cell("svf_oasis.apply35")
    traffic = dict(cell.traffic, sample=sample, in_flight=in_flight)
    return SimpleNamespace(traffic=traffic, device=torch.device("cpu"),
                           rng=random.Random(seed))


def test_the_loop_issues_in_the_seeded_order_and_keeps_a_reservoir():
    run = _run(7)
    order = apply._order(run)
    seen = []

    def request(s):
        seen.append(s)
        return len(seen)
    st = dict(request=request, order=order)
    keep = {}
    ends, issued = apply._loop(run, st, 0.0, count=200, keep=keep)
    assert len(ends) == len(issued) == 200
    assert seen == [order[n % len(order)] for n in range(200)]
    # every subject equally often in a cycle
    assert sorted(order) == sorted(k % run.traffic["subjects"]
                                   for k in range(run.traffic["cycle"]))
    assert sorted(keep) == [0, 1, 2]
    # the reservoir reaches past the first requests of the window
    assert max(out for _, out in keep.values()) > 3


def test_the_window_counts_and_times_every_request():
    cell = tiny_cell("svf_oasis.apply35")
    from benchmark.run import run_cell
    out = run_cell(cell, 2 ** 31 + 101, 0.5, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    m = out["metrics"]
    assert m["requests_per_s"]["value"] > 0
    assert m["request_p95_ms"]["value"] > 0
