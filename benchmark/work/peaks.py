"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): HBM3 at 3.35 TB/s, float32 outside the
tensor cores at 67 TFLOP/s.  A card set below 700 W runs slower under
load; the result line gives its ``power.limit`` beside every share."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for ``nbytes`` of HBM traffic and ``flops`` float32
    operations: the larger of the two bounds (``chip_smoke.py::bound``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
