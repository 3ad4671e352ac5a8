"""The kernel lab: rate probes of the card and a bf16 variant of the dense
pull, each a hand-written kernel (``csrc/lab.cu``) beside its plain
PyTorch version, and the runners that time them.

Counterparts of the Pallas functions of the JAX package's kernel lab
(``scripts/tpu_kernel_lab*.py``):

- :func:`fma` (``lab_fma``): ``tpu_kernel_lab.py::fma_probe``,
  ``fma_probe2`` and ``fma_probe3`` (and lab2's ``fma2bf``): ``nacc``
  chains of ``reps / nacc`` fused multiply-adds per element, float32 or
  bf16 pairs;
- :func:`gather` (``lab_gather``): ``tpu_kernel_lab.py::gather_probe`` and
  ``tpu_kernel_lab5.py::probe``: a per-row table gather, ``reps`` chained
  reads at ``(idx + i) % T`` summed, the table in shared memory or read
  from device memory (:func:`gather_and_path`: 16-byte copies and reads
  of an aligned table in shared memory);
- :func:`pull_bf16` (``lab_pull_bf16``, after :func:`pad_bf16`,
  ``lab_pad_bf16``): ``tpu_kernel_lab2.py::make_kernel_call`` with
  ``_kernel_v4``: the dense value pull with bf16 box values and z weights,
  their products summed in float32.

The lab's f32 pull variants (``pull_v1``/``v2``/``v3``, lab3's ``pull_v5``)
compute kernel 1a's function (``csrc/warp.cu``), and lab4's
``pull_adaptive`` kernel 1d's: :func:`pull_variants` times those under the
block shapes the dense gather can take (``cuda_warp.warp_block``) and the
adaptive mode beside the full window.  The XLA probes (``xla_fma_probe``,
``mxu_probe``) have yardsticks here, :func:`chain_probe` and
:func:`matmul_probe`: plain PyTorch calls, no kernel of the port.

Each wrapper takes CPU tensors to the plain version (``fma_plain``,
``gather_plain``, ``pad_bf16_plain``, ``pull_bf16_plain``) and CUDA
tensors to the kernel, raising on what the kernel does not take; it never
falls back.  Each
launch adds one to ``LAUNCHES_BY_MODE`` under its kernel's name.  The
runners time a kernel by its device time (:func:`device_ms`: the kernels
a call launches, traced by ``torch.profiler``) beside the time of one call
by CUDA events (:func:`cuda_ms`, the host's work inside the call
included), and name the card (``nvidia-smi``'s name and power limit)
beside every rate.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import statistics
import subprocess
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["fma", "fma_plain", "gather", "gather_and_path", "gather_plain",
           "lane_index",
           "pad_bf16", "pad_bf16_plain", "pad_margins", "pull_bf16",
           "pull_bf16_plain", "LAUNCHES_BY_MODE",
           "reset_launches", "uncounted", "FMA_VARIANTS",
           "GATHER_TABLES", "PULL_BLOCKS", "fma_probe", "gather_probe",
           "pull_variants", "pull_bf16_probe", "matmul_probe", "chain_probe",
           "smooth_grid", "lab_case", "card_line", "cuda_ms", "device_ms",
           "l2_evictor", "timed_once"]

LAUNCHES_BY_MODE: Dict[str, int] = {
    "lab_fma_f32": 0, "lab_fma_bf16x2": 0, "lab_gather_smem": 0,
    "lab_gather_global": 0, "lab_pad_bf16": 0, "lab_pull_bf16": 0}

# one H100 SXM at its 700 W limit: HBM and float32 rates from NVIDIA's
# data sheet; bf16 outside the tensor cores from the Hopper architecture
# white paper (H100 SXM5: 133.8 TFLOP/s, twice float32)
HBM_BYTES_PER_S, FP32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 133.8e12
SECTOR = 32                     # bytes a random device-memory read moves
L2_EVICT_BYTES = 4 * 50 * 2**20  # four times the card's L2 (50 MB)
SMEM_MAX = 232448               # dynamic shared memory a block can take


def reset_launches() -> None:
    for k in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[k] = 0


@contextlib.contextmanager
def uncounted():
    """Launches inside do not count (a kernel run to compare it with its
    plain version is not a launch of the path being driven)."""
    saved = dict(LAUNCHES_BY_MODE)
    try:
        yield
    finally:
        LAUNCHES_BY_MODE.update(saved)


_fns = {}


def _entry(name: str):
    """A C entry point of ``csrc/lab.cu``, built at first use."""
    if name not in _fns:
        from ._build import load_library
        from .cuda_warp import _WarpParams
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(load_library("lab"), name)
        fn.argtypes = {
            "lab_fma_f32": [vp, vp, vp, ll, i, i, i, vp],
            "lab_fma_bf16x2": [vp, vp, vp, ll, i, i, i, vp],
            "lab_gather": [vp, vp, vp, i, i, i, i, i, i,
                           ctypes.POINTER(i), vp],
            "lab_pad_bf16": [vp, vp, ll, i, i, i, i, vp],
            "lab_pull_bf16": [vp, vp, vp, ctypes.POINTER(_WarpParams), i,
                              i, vp],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _call(name, t, *args):
    """Launch on ``t``'s device and current stream; raise on a refusal."""
    fn = _entry(name)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _check(name, dtype, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device; "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if tensors[0].dtype != dtype:
        raise TypeError(f"{name}: takes {dtype}, got {tensors[0].dtype}")


# ------------------------------------------------------------------ FMA

NACCS = (1, 4, 8, 16)


def _fma_args(a, b, reps, nacc, dtype):
    if a.shape != b.shape:
        raise ValueError(f"fma: a {tuple(a.shape)} and b {tuple(b.shape)}")
    if nacc not in NACCS:
        raise ValueError(f"fma: nacc in {NACCS}, got {nacc}")
    if reps < 0 or reps % nacc:
        raise ValueError(f"fma: reps ({reps}) must be a multiple of nacc "
                         f"({nacc})")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fma: float32 or bfloat16 chains, got {dtype}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the nearest bf16 value (ties to even), as float64: the
    single rounding of a fused bf16 operation on an exact float64 result."""
    bits = x.view(torch.int64)
    lsb = (bits >> 45) & 1
    bits = (bits + ((1 << 44) - 1) + lsb) & ~((1 << 45) - 1)
    return bits.view(torch.float64)


def fma_plain(a: torch.Tensor, b: torch.Tensor, reps: int, nacc: int = 8,
              dtype=torch.float32, zero_init: bool = False) -> torch.Tensor:
    """The plain version of :func:`fma`: ``nacc`` chains per element start
    at ``a * (k + 1)`` (at 0 with ``zero_init``) and take ``reps / nacc``
    steps ``acc = a * b + acc`` each, one rounding per step (float64
    products and sums, exact for bf16 operands, rounded once to the chain's
    type); the chains are summed in order.  float32 (or bf16 with
    ``dtype``) chains of float32 inputs -> float32."""
    _fma_args(a, b, reps, nacc, dtype)
    if dtype == torch.bfloat16:
        x = a.to(torch.bfloat16).double()
        y = b.to(torch.bfloat16).double()
        rnd = _round_bf16
    else:
        x, y = a.double(), b.double()

        def rnd(v):
            return v.float().double()
    k = torch.arange(1, nacc + 1, dtype=torch.float64, device=a.device)
    k = k.reshape((nacc,) + (1,) * a.ndim)
    acc = torch.zeros_like(x).expand((nacc,) + x.shape).clone() \
        if zero_init else rnd(x * k)
    xy = x * y
    for _ in range(reps // nacc):
        acc = rnd(acc + xy)
    s = acc[0]
    for j in range(1, nacc):
        s = rnd(s + acc[j])
    return s.float()


def fma(a: torch.Tensor, b: torch.Tensor, reps: int, nacc: int = 8,
        dtype=torch.float32, zero_init: bool = False) -> torch.Tensor:
    """``nacc`` fused multiply-add chains of ``reps / nacc`` steps per
    element of float32 ``a``, ``b`` (same shape) -> float32, the chains'
    sum (:func:`fma_plain`).  ``dtype`` bfloat16: the chains in bf16 (the
    kernel rounds the inputs to bf16 as it reads them), two elements per
    instruction; the element count must be even."""
    if a.device.type == "cpu":
        return fma_plain(a, b, reps, nacc, dtype, zero_init)
    _fma_args(a, b, reps, nacc, dtype)
    _check("fma", torch.float32, a, b)
    out = torch.empty_like(a)
    n = a.numel()
    knobs = (nacc, reps // nacc, int(zero_init))
    if dtype == torch.bfloat16:
        if n % 2:
            raise ValueError("fma: bf16 pairs need an even element count")
        # the kernel reads float32 pairs (8-byte aligned) and rounds them
        a, b = (t if t.data_ptr() % 8 == 0 else t.clone() for t in (a, b))
        _call("lab_fma_bf16x2", a, a.data_ptr(), b.data_ptr(),
              out.data_ptr(), n // 2, *knobs)
        LAUNCHES_BY_MODE["lab_fma_bf16x2"] += 1
    else:
        _call("lab_fma_f32", a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
              n, *knobs)
        LAUNCHES_BY_MODE["lab_fma_f32"] += 1
    return out


# --------------------------------------------------------------- gather

def lane_index(coords: torch.Tensor, T: int) -> torch.Tensor:
    """``clip(int(coords), 0, T - 1)`` as int32: ``gather_probe``'s lane
    index (a cast toward zero, then a clip)."""
    return torch.clamp(coords.to(torch.int32), 0, T - 1)


def _gather_args(table, idx):
    if table.ndim != 3 or idx.ndim != 3 or table.shape[:2] != idx.shape[:2]:
        raise ValueError(f"gather: need table (G, S, T) and idx (G, S, L); "
                         f"got {tuple(table.shape)}, {tuple(idx.shape)}")


def gather_plain(table: torch.Tensor, idx: torch.Tensor,
                 reps: int = 1) -> torch.Tensor:
    """``out[g, s, l] = sum_{i < reps} table[g, s, (idx[g, s, l] + i) % T]``
    in float32, summed in order of ``i`` (``%`` a floor-mod)."""
    _gather_args(table, idx)
    T = table.shape[-1]
    k = torch.remainder(idx.long(), T)
    table = table.float()
    out = torch.zeros(idx.shape, dtype=torch.float32, device=table.device)
    for _ in range(reps):
        out = out + torch.gather(table, 2, k)
        k = torch.where(k + 1 == T, 0, k + 1)
    return out


def gather(table: torch.Tensor, idx: torch.Tensor, reps: int = 1,
           smem: bool = True) -> torch.Tensor:
    """The lane gather of :func:`gather_plain` on float32 ``table``
    (G, S, T) and int32 ``idx`` (G, S, L), the plain version's bits.
    ``smem``: each block copies its group's S x T table (at most 227 KB;
    on the vector path only the rows its outputs read) into shared memory
    and gathers there; otherwise it gathers from device memory.  The path
    (:func:`gather_and_path`) follows the mode and the table's shape and
    alignment."""
    return gather_and_path(table, idx, reps, smem)[0]


def gather_and_path(table: torch.Tensor, idx: torch.Tensor, reps: int = 1,
                    smem: bool = True):
    """(:func:`gather`'s output, the path ``lab_gather`` reported taking):
    ``"vector"`` where it ran the shared-memory kernel for tables whose
    rows all start on a 16-byte boundary (T % 4 == 0 and a 16-byte-aligned
    ``data_ptr()``): rows copied by 16-byte ``cp.async``, each run read as
    16-byte shared words; ``"scalar"`` where it ran one 4-byte read a step
    (every other shared table, and always from device memory); ``"plain"``
    on the CPU."""
    if table.device.type == "cpu":
        return gather_plain(table, idx, reps), "plain"
    _gather_args(table, idx)
    _check("gather", torch.float32, table)
    _check("gather", torch.int32, idx, table)
    G, S, T = table.shape
    L = idx.shape[-1]
    if smem and S * T * 4 > SMEM_MAX:
        raise ValueError(f"gather: a {S} x {T} table takes {S * T * 4} "
                         f"bytes, more than a block's {SMEM_MAX}")
    if max(G, S, T, L) >= 2**31 or reps < 0:
        raise ValueError("gather: sizes beyond int32")
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    vector = ctypes.c_int(0)
    _call("lab_gather", table, table.data_ptr(), idx.data_ptr(),
          out.data_ptr(), G, S, T, L, reps, int(smem), ctypes.byref(vector))
    LAUNCHES_BY_MODE["lab_gather_smem" if smem else "lab_gather_global"] += 1
    return out, "vector" if vector.value else "scalar"


# -------------------------------------------------------------- bf16 pull

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def pull_bf16_plain(inp: torch.Tensor, grid: torch.Tensor,
                    orders: Sequence[int], bounds: Sequence[int],
                    extrapolate: int, max_disp) -> torch.Tensor:
    """The dense value pull of ``window._pull_impl_torch`` (shift-FMA form)
    with ``_kernel_v4``'s rounding points: the padded volume's values and
    the z coefficient fields rounded to bf16, their products (exact in
    float32) summed in float32 over the z shifts, then weighted by the
    float32 product of the x and y fields; y shifts outer, x inner.
    (B, C, X, Y, Z), (B, X, Y, Z, 3) -> float32."""
    from .window import (_coef_fields, _mask, _pad_folded, _shift_ranges,
                         _slice_pad, _window_geom)
    D = grid.shape[-1]
    if D != 3:
        raise ValueError("pull_bf16: 3-D warps only")
    ishape = tuple(inp.shape[-3:])
    f32 = torch.float32
    inp, grid = inp.to(f32), grid.to(f32)
    ranges = _shift_ranges(orders, max_disp, None, D)
    lo, hi = _window_geom(ranges)
    vpad = _bf16(_pad_folded(inp, ishape, bounds, lo, hi, f32))
    cx, cy, cz = _coef_fields(grid, orders, ranges, f32)
    czb = [_bf16(c).float()[:, None] for c in cz]
    out = None
    for ky, sy in enumerate(range(ranges[1][0], ranges[1][1] + 1)):
        for kx, sx in enumerate(range(ranges[0][0], ranges[0][1] + 1)):
            zacc = None
            for kz, sz in enumerate(range(ranges[2][0], ranges[2][1] + 1)):
                t = czb[kz] * _slice_pad(vpad, (sx, sy, sz), lo,
                                         ishape).float()
                zacc = t if zacc is None else zacc + t
            term = (cx[kx] * cy[ky])[:, None] * zacc
            out = term if out is None else out + term
    mask = _mask(grid, ishape, extrapolate, f32, orders, max_disp, None)
    if mask is not None:
        out = out * mask[:, None]
    return out


def pad_margins(order: int, max_disp: float):
    """(zlo, zhi): the z margins of :func:`pad_bf16` that every tap of a
    sample inside the ``max_disp`` window reaches (``lab.cu``'s ``pad_lo``
    / ``pad_hi``)."""
    from .window import window_range
    smin, smax = window_range(int(order), float(max_disp))
    return max(0, -smin), max(0, smax)


def pad_bf16_plain(inp: torch.Tensor, bound: int, zlo: int,
                   zhi: int) -> torch.Tensor:
    """The last axis of ``inp`` (..., Z) extended by ``zlo`` / ``zhi``
    folded values, each times its fold sign under ``bound``, rounded to
    bf16: (..., zlo + Z + zhi) bfloat16."""
    from .bounds import fold_index, fold_sign
    Z = inp.shape[-1]
    i = np.arange(-zlo, Z + zhi)
    out = inp.float()[..., torch.as_tensor(fold_index(i, Z, bound),
                                           device=inp.device)]
    s = fold_sign(i, Z, bound, np.float32)
    if s is not None:
        out = out * torch.as_tensor(s, device=inp.device)
    return out.to(torch.bfloat16)


def pad_bf16(inp: torch.Tensor, bound: int, zlo: int,
             zhi: int) -> torch.Tensor:
    """:func:`pad_bf16_plain` on the card (``lab_pad_bf16``): float32
    ``inp`` (..., Z), a warp a row.  The result lies at the start of a
    buffer of 8 more values, which :func:`pull_bf16`'s 8-byte reads past
    the last row take (they reach no sum)."""
    if inp.device.type == "cpu":
        return pad_bf16_plain(inp, bound, zlo, zhi)
    _check("pad_bf16", torch.float32, inp)
    Z = inp.shape[-1] if inp.ndim else 0
    if Z < 1 or not 0 <= int(bound) <= 6 or zlo < 0 or zhi < 0 \
            or zlo + Z + zhi >= 2**31:
        raise ValueError(f"pad_bf16: shape {tuple(inp.shape)}, bound "
                         f"{bound}, margins ({zlo}, {zhi})")
    zp = zlo + Z + zhi
    rows = inp.numel() // Z
    buf = torch.empty(rows * zp + 8, dtype=torch.bfloat16,
                      device=inp.device)
    if rows:
        _call("lab_pad_bf16", inp, inp.data_ptr(), buf.data_ptr(), rows, Z,
              int(bound), zlo, zhi)
        LAUNCHES_BY_MODE["lab_pad_bf16"] += 1
    return buf[:rows * zp].view(*inp.shape[:-1], zp)


def pull_bf16(inp: torch.Tensor, grid: torch.Tensor, orders: Sequence[int],
              bounds: Sequence[int], extrapolate: int,
              max_disp) -> torch.Tensor:
    """:func:`pull_bf16_plain` on the card: float32 inp (B, C, X, Y, Z) and
    grid (B, X, Y, Z, 3), orders 0-3, the block tile of the dense gather
    (``cuda_warp.warp_block``).  :func:`pad_bf16` first writes the volume
    rounded to bf16, its z rows padded with the folded values the window
    can reach (:func:`pad_margins`), 2 bytes a value (the call's extra
    memory); then ``lab_pull_bf16`` reads each row's z taps from it as two
    aligned 8-byte words."""
    if inp.device.type == "cpu":
        return pull_bf16_plain(inp, grid, orders, bounds, extrapolate,
                               max_disp)
    from .cuda_warp import _launch_setup
    from .window import _md_tuple
    if grid.shape[-1] != 3 or not all(0 <= int(o) <= 3 for o in orders):
        raise ValueError("pull_bf16: 3-D warps of orders 0-3")
    setup = _launch_setup("pull_bf16", inp, grid, orders, bounds,
                          extrapolate, max_disp)
    out = torch.empty_like(inp)
    if setup is None:
        return out
    inp3, grid3, p, _, _ = setup
    zlo, zhi = pad_margins(orders[2], _md_tuple(max_disp, 3)[2])
    padded = pad_bf16(inp3, p.bound[2], zlo, zhi)
    _call("lab_pull_bf16", inp3, padded.data_ptr(), grid3.data_ptr(),
          out.data_ptr(), ctypes.byref(p), zlo, padded.shape[-1])
    LAUNCHES_BY_MODE["lab_pull_bf16"] += 1
    return out


# -------------------------------------------------------------- runners
# Each makes its inputs from a seed with numpy (as the JAX lab does), runs
# the kernel at the lab's shapes, optionally holds it to its plain version
# on the same inputs (that launch uncounted), and times it with CUDA
# events: the median of ``reps`` runs after a warm-up.

def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def l2_evictor():
    """(evict, keys): ``evict()`` reads a buffer of :data:`L2_EVICT_BYTES`
    on the current card, so that the next call finds none of its inputs in
    L2 and leaves it no dirty line to write back; ``keys``, the profiler
    keys of its kernels, which a timing of the call leaves out."""
    # row sums: each block reduces its own rows, so no semaphore memset
    buf = torch.ones((L2_EVICT_BYTES // 4096, 1024), device="cuda")

    def evict():
        buf.sum(1)
    # the keys of three traces: a trace now and then lacks a record
    keys = set()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            evict()
            torch.cuda.synchronize()
        keys |= {e.key for e in prof.key_averages()
                 if e.device_time_total > 0}
    if not keys:
        raise RuntimeError("l2_evictor: the profiler traced no launch")
    return evict, keys


def cuda_ms(fn, reps: int, warmup: int = 1, cold: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls;
    ``cold``: L2 evicted before each (:func:`l2_evictor`)."""
    evict = l2_evictor()[0] if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if evict:
            evict()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 2,
              cold: bool = False) -> float:
    """The device time in ms of one call of ``fn``: the kernels and copies
    it launches, traced by ``torch.profiler`` (CUDA activity) over ``reps``
    calls after ``warmup``; each kernel's mean duration a launch times its
    launches a call.  A trace now and then lacks some launches' records
    (the mean stands on those it has) or holds none (traced again, up to 5
    times).  The host's time inside a call, which an event pair around
    that one call counts while the device waits, is left out.  ``cold``:
    L2 evicted before each call (:func:`l2_evictor`, its kernels left
    out), so that inputs smaller than L2 come from HBM, as the bytes bound
    counts them."""
    evict, skip = l2_evictor() if cold else (None, set())
    for _ in range(warmup):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if evict:
                    evict()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key not in skip]
        if ev:
            return sum(e.device_time_total / e.count
                       * max(1, round(e.count / reps)) for e in ev) / 1e3
    raise RuntimeError("device_ms: the profiler traced no launch")


def timed_once(fn):
    """(fn(), its time in ms by CUDA events): one run, for the plain
    versions that take seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _held(kern, plain, tol):
    """Run the kernel (uncounted) and the plain version once on the same
    inputs: (max |kernel - plain|, the tolerance, plain ms); raise when the
    error exceeds ``tol * max(1, max |plain|)``."""
    with uncounted():
        out = kern()
    ref, p_ms = timed_once(plain)
    err = (out.double() - ref.double()).abs().max().item()
    lim = tol * max(1.0, ref.abs().max().item())
    if not err <= lim:
        raise AssertionError(f"kernel vs plain: err {err:.3g} > {lim:.3g}")
    return err, lim, p_ms


def _bound(nbytes, ops, rate=FP32_OPS_PER_S):
    ms_b, ms_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (ms_b, "bytes") if ms_b >= ms_o else (ms_o, "operations")


# name: (shape, reps, nacc, chain dtype, zero_init), the JAX lab's defaults
FMA_VARIANTS = {
    "fma": ((8, 256, 1024), 512, 1, torch.float32, True),
    "fma2": ((512, 8, 1024), 4096, 8, torch.float32, False),
    "fma2bf": ((512, 8, 1024), 4096, 8, torch.bfloat16, False),
    "fma3": ((256, 8, 1024), 1024, 8, torch.float32, False),
    "fma3n4": ((256, 8, 1024), 1024, 4, torch.float32, False),
    "fma3n16": ((256, 8, 1024), 1024, 16, torch.float32, False),
    "fma3bf": ((256, 16, 1024), 1024, 8, torch.bfloat16, False),
}
# the float32 kernel vs its plain version: chains of up to 4096 steps; the
# plain version's float64 sum rounds once more in about one step of 2^28
TOL_F32 = 1e-5
# bf16 chains: the plain version rounds each step once, as __hfma2 does;
# held at one bf16 rounding step of the largest sum
TOL_BF16 = 2.0 ** -8


def fma_probe(variant: str = "fma2", device="cuda", reps_t: int = 20,
              check: bool = True) -> dict:
    """The FMA rate of one :data:`FMA_VARIANTS` entry: T-FMA/s and TFLOP/s
    against the card's peak for the chain's type."""
    shape, reps, nacc, dtype, zero = FMA_VARIANTS[variant]
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device=device)
    b = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device=device)

    def kern():
        return fma(a, b, reps, nacc, dtype, zero)
    res = dict(variant=variant, shape=shape, reps=reps, nacc=nacc,
               dtype=str(dtype).replace("torch.", ""))
    if check:
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        res["max_abs_err"], res["tol"], res["plain_ms"] = _held(
            kern, lambda: fma_plain(a, b, reps, nacc, dtype, zero), tol)
    ms = device_ms(kern, reps_t)
    n = a.numel() * reps
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    b_ms, b_by = _bound(3 * 4 * a.numel(), 2 * n, rate)
    res.update(ms=ms, call_ms=cuda_ms(kern, reps_t, 2), tfma_s=n / ms / 1e9,
               tflop_s=2 * n / ms / 1e9, bound_ms=b_ms, bound_by=b_by,
               peak_tflop_s=rate / 1e12, card=card_line())
    return res


# name: (G, S, T, L, reps, smem): the table (G, S, T) and where it lives.
# lab5's default (256 x 8 x 2304, 64 chained reads of 128 lanes) in shared
# memory and, its 74 KB rows L1-resident, from device memory; then one
# (8, T) table read at random rows of 4 consecutive entries (a cubic z row
# of kernel 3), 2M lanes a row: 16M rows, kernel 3's at 1M cubic points,
# from a table inside L2 (8.4 MB), of kernel 3's 256^3 volume (67 MB), and
# beyond L2 (268 MB)
GATHER_TABLES = {
    "smem": (256, 8, 2304, 128, 64, True),
    "l1": (256, 8, 2304, 128, 64, False),
    "l2": (1, 8, 2**18, 2**21, 4, False),
    "vol256": (1, 8, 2**21, 2**21, 4, False),
    "hbm": (1, 8, 2**23, 2**21, 4, False),
}


def gather_probe(table: str = "smem", device="cuda", reps_t: int = 20,
                 check: bool = True, tab: int = None, reps: int = None,
                 groups: int = None, lanes: int = None) -> dict:
    """The lane-gather rate at one :data:`GATHER_TABLES` entry (``tab``,
    ``reps``, ``groups``, ``lanes`` override T, the chained reads, G and L,
    as the labs' CLIs take them), held to its plain version bit for bit:
    reads/s and the path taken (:func:`gather_and_path`), beside two
    bounds and the time's share of each: the bytes read once and the
    32-byte sectors a random device-memory read moves (one per run of
    consecutive entries, and one more where a run crosses a sector).
    Every timed call starts with L2 evicted, so that the table comes from
    HBM, as both bounds count it."""
    G, S, T, L, r, smem = GATHER_TABLES[table]
    G, T, L, r = groups or G, tab or T, lanes or L, reps or r
    gen = torch.Generator(device).manual_seed(0)
    tbl = torch.randn((G, S, T), generator=gen, device=device)
    idx = torch.randint(0, T, (G, S, L), generator=gen, device=device,
                        dtype=torch.int32)

    def kern():
        return gather(tbl, idx, r, smem)
    with uncounted():
        out, path = gather_and_path(tbl, idx, r, smem)
    res = dict(table=table, G=G, S=S, T=T, L=L, reps=r, smem=smem,
               table_mb=4 * G * S * T / 1e6, path=path)
    if check:
        # the same float32 sums in the same order: the plain version's bits
        ref, res["plain_ms"] = timed_once(lambda: gather_plain(tbl, idx, r))
        if not torch.equal(out, ref):
            raise AssertionError(f"gather {table}: differs from its plain "
                                 f"version")
        res["max_abs_err"] = (out - ref).abs().max().item()
        res["tol"] = 0.0
    ms = device_ms(kern, reps_t, cold=True)
    n = G * S * L
    nbytes = 4 * (G * S * T + 2 * n)
    b_ms, b_by = _bound(nbytes, n * r)
    # sectors: a run of r entries at a uniform offset covers
    # ceil((4 r + 28) / 32) sectors on average over the offsets
    per_run = sum(((o * 4) % SECTOR + 4 * r + SECTOR - 1) // SECTOR
                  for o in range(SECTOR // 4)) / (SECTOR // 4)
    sector_bytes = SECTOR * per_run * n + 8 * n
    sector_ms = sector_bytes / HBM_BYTES_PER_S * 1e3
    res.update(ms=ms, call_ms=cuda_ms(kern, reps_t, 2, cold=True),
               greads_s=n * r / ms / 1e6, bound_ms=b_ms,
               bound_by=b_by, sector_mb=sector_bytes / 1e6,
               sector_ms=sector_ms, bound_share=b_ms / ms,
               sector_share=sector_ms / ms, card=card_line())
    res.update(_gather_library(tbl, idx, r, reps_t, check))
    return res


def _gather_library(tbl, idx, r, reps_t, check):
    """The library calls beside the lane gather, timed (L2 evicted before
    each call, as the gather) and used nowhere else: ``torch.gather`` of
    the same lanes (each lane's ``r`` chained
    reads as (G, S, L*r) indices, built beforehand; the sum over ``r`` is
    left undone), and, where a lane reads one run of 4 entries from device
    memory (the random-row sweeps), ``index_select`` of the 16-byte rows
    that hold the runs: of the (rows, 4) float32 view, and of the same
    rows viewed as one 16-byte (complex128) element each."""
    G, S, T = tbl.shape
    L = idx.shape[-1]
    kk = torch.remainder(idx.long()[..., None]
                         + torch.arange(r, device=tbl.device), T)
    kk = kk.reshape(G, S, L * r)
    out = {"lib_gather_ms": device_ms(lambda: torch.gather(tbl, 2, kk),
                                      reps_t, cold=True), "lib_rows_ms": None,
           "lib_rows16_ms": None}
    if check:
        lib = torch.gather(tbl, 2, kk).reshape(G, S, L, r).sum(-1)
        ref = gather_plain(tbl, idx, r)
        out["lib_gather_err"] = (lib - ref).abs().max().item()
    del kk
    if r == 4 and T % 4 == 0 and L * S * G > 2**20:
        rows = tbl.reshape(-1, 4)
        base = (torch.arange(G * S, device=tbl.device) * T).reshape(G, S, 1)
        ridx = ((base + idx.long()) // 4).reshape(-1)
        out["lib_rows_ms"] = device_ms(
            lambda: torch.index_select(rows, 0, ridx), reps_t, cold=True)
        rows16 = rows.view(torch.complex128)[:, 0]
        out["lib_rows16_ms"] = device_ms(
            lambda: torch.index_select(rows16, 0, ridx), reps_t, cold=True)
    return out


def smooth_grid(N: int, max_disp: float, seed: int = 0, coarse: int = 2,
                device="cuda") -> torch.Tensor:
    """lab4's smooth dense warp: a cubic upsampling (scipy's ``zoom``) of a
    coarse uniform(-max_disp, max_disp) displacement, clipped, plus the
    identity: (N, N, N, 3) float32."""
    from scipy.ndimage import zoom
    rng = np.random.default_rng(seed)
    c = rng.uniform(-max_disp, max_disp, (coarse, coarse, coarse, 3))
    d = np.stack([zoom(c[..., i], N / coarse, order=3) for i in range(3)],
                 -1)
    d = np.clip(d, -max_disp, max_disp)
    ident = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"), -1)
    return torch.tensor((ident + d).astype(np.float32), device=device)


def lab_case(N: int = 128, max_disp: float = 2.0, device="cuda", seed=0):
    """The pull labs' inputs: an N^3 N(0, 1) volume and grid = identity +
    uniform(-max_disp, max_disp), as (1, 1, N, N, N) and (1, N, N, N, 3)."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((N, N, N)).astype(np.float32)
    ident = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"),
                     -1).astype(np.float32)
    grid = ident + rng.uniform(-max_disp, max_disp,
                               ident.shape).astype(np.float32)
    return (torch.tensor(vol, device=device)[None, None],
            torch.tensor(grid, device=device)[None])


def _pull_work(n):
    """Least bytes and float32 operations of a cubic value pull over n
    voxels, C=1: volume, grid and output once; 64 taps as FMAs."""
    return 4 * (n + 3 * n + n), 2 * n * (64 + 16 + 4)


# the block shapes swept (log2 of x, y, z): the default at 128^3 and 256^3
# (2 x 4 x 32), z rows of 32 with fewer rows, a full y x z plane tile, a
# cube, and a 128-wide z row (the TPU tile's)
PULL_BLOCKS = ((1, 2, 5), (0, 0, 5), (0, 2, 5), (0, 3, 5), (3, 3, 2),
               (2, 2, 4), (0, 1, 7))

# the bf16 pull vs its plain version: both round the same float32 weights
# and values to bf16 and sum their exact products in float32 in one order;
# held at the float32 gate, 1e-5 * max(1, max |plain|)
TOL_PULL_BF16 = 1e-5


def pull_bf16_probe(N: int = 128, max_disp: float = 2.0, device="cuda",
                    reps_t: int = 20, check: bool = True) -> dict:
    """``lab_pull_bf16`` at the lab's shapes (cubic, dct2): its device time
    (the bf16 pass and the pull), the f32 pull's (kernel 1a) beside it,
    each call's time by events, its extra device memory, and its distance
    from the f32 pull; under ``pad``, the bf16 pass alone (``lab_pad_bf16``)
    held to its plain version bit for bit, its device time and bound
    (bytes: the volume read, the padded volume written)."""
    from .cuda_warp import warp_cuda
    vol, grid = lab_case(N, max_disp, device)
    opts = ((3, 3, 3), (3, 3, 3), 1, max_disp)
    zlo, zhi = pad_margins(3, max_disp)

    def kern():
        return pull_bf16(vol, grid, *opts)

    def pad():
        return pad_bf16(vol, 3, zlo, zhi)
    res = dict(N=N, max_disp=max_disp, pad={})
    if check:
        res["max_abs_err"], res["tol"], res["plain_ms"] = _held(
            kern, lambda: pull_bf16_plain(vol, grid, *opts), TOL_PULL_BF16)
        with uncounted():
            got = pad()
        ref, p_ms = timed_once(lambda: pad_bf16_plain(vol, 3, zlo, zhi))
        if not torch.equal(got, ref):
            raise AssertionError("pad_bf16: differs from its plain version")
        res["pad"].update(max_abs_err=(got.float() - ref.float()).abs()
                          .max().item(), tol=0.0, plain_ms=p_ms)
    b_ms, b_by = _bound(4 * vol.numel() + 2 * (zlo + N + zhi) * N * N, 0)
    res["pad"].update(ms=device_ms(pad, reps_t), bound_ms=b_ms,
                      bound_by=b_by)
    ms = device_ms(kern, reps_t)
    with uncounted(), torch.no_grad():
        f32 = warp_cuda(vol, grid, *opts)[0]
        res["vs_f32"] = (kern() - f32).abs().max().item()
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kern()
        torch.cuda.synchronize()
        res["extra_mib"] = (torch.cuda.max_memory_allocated() - live
                            - 4 * vol.numel()) / 2**20
    f32 = lambda: warp_cuda(vol, grid, *opts)  # noqa: E731
    res.update(ms=ms, call_ms=cuda_ms(kern, reps_t, 2),
               ms_f32=device_ms(f32, reps_t),
               call_ms_f32=cuda_ms(f32, reps_t, 2))
    res["bound_ms"], res["bound_by"] = _bound(*_pull_work(vol.numel()))
    res["card"] = card_line()
    return res


def pull_variants(N: int = 128, max_disp: float = 2.0, device="cuda",
                  reps_t: int = 20, blocks=PULL_BLOCKS) -> list:
    """Kernel 1a (the f32 value pull of the lab's ``pull_v1`` / ``v2`` /
    ``v3`` / ``v5``) under each block shape of :data:`PULL_BLOCKS`, each
    held to the default block's output (``torch.equal``: one thread per
    voxel, the same sums), then kernel 1d (``tile_spread``, lab4's
    ``pull_adaptive``) beside 1a on :func:`smooth_grid`'s field at the
    spread that field needs (``required_tile_spread``: the port adapts
    every axis, lab4 left z's base at 0), with its distance from 1a."""
    from .api import required_tile_spread
    from .cuda_warp import warp_cuda
    vol, grid = lab_case(N, max_disp, device)
    opts = ((3, 3, 3), (3, 3, 3), 1, max_disp)
    b_ms, b_by = _bound(*_pull_work(vol.numel()))
    card = card_line()
    out = []
    with torch.no_grad():
        ref = warp_cuda(vol, grid, *opts)[0]
        for blk in blocks:
            def kern(blk=blk):
                return warp_cuda(vol, grid, *opts, block=blk)[0]
            if not torch.equal(kern(), ref):
                raise AssertionError(f"block {blk}: differs from the "
                                     f"default block's pull")
            out.append(dict(variant="1a block " + "x".join(
                str(1 << e) for e in blk), ms=device_ms(kern, reps_t),
                bound_ms=b_ms, bound_by=b_by, card=card))
        sg = smooth_grid(N, max_disp, device=device)[None]
        spread = required_tile_spread(sg)
        full = warp_cuda(vol, sg, *opts)[0]
        ad = warp_cuda(vol, sg, *opts, spread=spread)[0]
        err = (ad - full).abs().max().item()
        for name, sp in (("1a smooth grid", None), ("1d smooth grid", spread)):
            out.append(dict(variant=name, spread=sp, ms=device_ms(
                lambda sp=sp: warp_cuda(vol, sg, *opts, spread=sp),
                reps_t), bound_ms=b_ms, bound_by=b_by, card=card,
                **({"vs_full": err} if sp else {})))
    return out


def matmul_probe(dtype=torch.bfloat16, M: int = 1024, reps: int = 8,
                 device="cuda", reps_t: int = 10) -> dict:
    """``mxu_probe``'s yardstick: ``reps`` chained (M x M) products
    ``x = (x @ b)`` in ``dtype`` through ``torch.matmul`` (cuBLAS; float32
    without TF32 unless the caller enabled it)."""
    gen = torch.Generator(device).manual_seed(0)
    a = torch.randn((M, M), generator=gen, device=device).to(dtype)
    b = (torch.randn((M, M), generator=gen, device=device)
         / math.sqrt(M)).to(dtype)

    def run():
        x = a
        for _ in range(reps):
            x = torch.matmul(x, b)
        return x
    ms = cuda_ms(run, reps_t, 2)
    n = M ** 3 * reps
    return dict(dtype=str(dtype).replace("torch.", ""), M=M, reps=reps,
                ms=ms, tflop_s=2 * n / ms / 1e9, card=card_line())


def chain_probe(reps: int = 64, shape=(256, 256, 256), device="cuda",
                reps_t: int = 5) -> dict:
    """``xla_fma_probe``'s yardstick: ``reps`` steps of ``acc = acc + x * b;
    x = x * 1.0000001`` as PyTorch elementwise calls (three passes over the
    volume a step): a rate of the card's memory, not of its FMA units."""
    gen = torch.Generator(device).manual_seed(0)
    a = torch.randn(shape, generator=gen, device=device)
    b = torch.randn(shape, generator=gen, device=device)

    def run():
        acc, x = torch.zeros_like(a), a
        for _ in range(reps):
            acc = acc + x * b
            x = x * 1.0000001
        return acc
    ms = cuda_ms(run, reps_t, 2)
    n = a.numel() * reps
    return dict(reps=reps, shape=shape, ms=ms, tfma_s=n / ms / 1e9,
                card=card_line())
