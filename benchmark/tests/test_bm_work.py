"""The counted work, checked by hand at small sizes, and the rooflines
read from it."""
from types import SimpleNamespace

import pytest

from benchmark import readings, registry, trace
from benchmark.work import counts, ffd_train, peaks, svf_apply, svf_train

CFG = dict(vol_shape=[4, 4, 4], coarse_shape=[2, 2, 2], steps=2,
           interpolation=3, jac_weight=0.1)


def test_warp_counts_reduce_to_the_cubic_single_channel_formulas():
    n, T = 5 * 6 * 7, 4
    forms = {   # chip_smoke.py::dense_work, C = 1
        "value": (4 * (n + 3 * n + n), 2 * n * (T**3 + T**2 + T)),
        "grad": (4 * (n + 3 * n + 3 * n),
                 2 * n * (2 * T**3 + 3 * T**2 + 3 * T)),
        "push": (4 * (n + 3 * n + n), n * (2 * T**3 + T**2)),
        "pushgrad": (4 * (3 * n + 3 * n + n), n * (4 * T**3 + 4 * T**2)),
    }
    for mode, want in forms.items():
        assert counts.warp(mode, (3, 3, 3), 1, 1, (5, 6, 7)) == want


def test_warp_counts_by_hand():
    # n = 2 * 24 = 48 samples, cubic, one channel
    assert counts.warp("value", (3, 3, 3), 2, 1, (2, 3, 4)) == (
        4 * (48 + 144 + 48), 2 * 48 * (64 + 16 + 4))
    # 8 samples, linear, 3 channels: reads 24 + 24, writes 24
    assert counts.warp("push", (1, 1, 1), 1, 3, (2, 2, 2)) == (288, 480)
    assert counts.warp("value+grad", (1, 1, 1), 1, 3, (2, 2, 2)) == (
        4 * (24 + 24 + 24 + 72), 2 * 8 * 3 * (8 + 4 + 2)
        + 2 * 8 * 3 * (16 + 12 + 6))


def test_resize_counts_the_nonzero_taps_axis_by_axis():
    # 3 channels (2,2,2) -> (4,4,4): passes (4,2,2), (4,4,2), (4,4,4)
    assert counts.resize(3, 3, (2, 2, 2), (4, 4, 4)) == (
        4 * 3 * (8 + 64), 2 * 4 * 3 * (16 + 32 + 64))
    assert counts.resize(3, 3, (4, 4, 4), (2, 2, 2)) == (
        4 * 3 * (64 + 8), 2 * 4 * 3 * (32 + 16 + 8))


def test_cells_by_hand():
    b, f = counts.total(svf_train.required(CFG, {"batch": 1}))
    assert (b, f) == (27840, 104128)
    b, f = counts.total(ffd_train.required(CFG, {"batch": 1}))
    assert (b, f) == (4800, 38848)
    b, f = counts.total(svf_apply.required(CFG, {"label_order": 1}))
    assert (b, f) == (7648, 25984)
    # a batch of B pairs is B times one pair's work
    b4, f4 = counts.total(svf_train.required(CFG, {"batch": 4}))
    assert (b4, f4) == (4 * 27840, 4 * 104128)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 67e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 67e12) == 2.0


def test_each_required_operation_names_a_kernel_source_or_none():
    sources = set(registry.kernel_sources())
    for mod, traffic in ((svf_train, {"batch": 2}), (ffd_train, {"batch": 2}),
                         (svf_apply, {"label_order": 1})):
        for name, nbytes, flops, source in mod.required(CFG, traffic):
            assert source is None or source in sources, (name, source)
            assert nbytes > 0 and flops > 0


def _traced_run(required, device, units=2):
    t = trace.Trace(window=(0.0, 1.0), device=device)
    return SimpleNamespace(trace=t, required=required, trace_units=units)


def test_the_roofline_is_the_required_work_of_its_source_over_its_time():
    # 2 units of 3.35e9 bytes of kernel 1's work: 2 ms at the peak, in 8 ms
    # of warp_kernel; the push's and PyTorch's work and time do not count
    required = [("a", 3.35e9, 0.0, "warp"), ("b", 1e12, 0.0, "push"),
                ("c", 1e12, 0.0, None)]
    device = [("void warp_kernel<3, true>(Args)", 0.1, 0.108, "kernel"),
              ("void push_kernel<1, 0, true>(Args)", 0.2, 0.3, "kernel"),
              ("at::native::add_kernel", 0.3, 0.9, "kernel")]
    run = _traced_run(required, device)
    assert readings.roofline_pct(run, "warp") == pytest.approx(25.0)
    # a source the unit gives no work, or no kernel of it traced: nothing
    assert readings.roofline_pct(_traced_run(required[1:], device),
                                 "warp") is None
    assert readings.roofline_pct(_traced_run(required, device[1:]),
                                 "warp") is None
