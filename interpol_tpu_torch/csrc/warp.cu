// Dense-warp B-spline pull, spatial gradient and Hessian for Hopper
// (sm_90a).
//
// Replaces interpol_tpu/ops/pallas_warp.py::_warp_kernel in its value,
// grad and hess modes (pull_window / grad_window / hess_window forwards).
// The Pallas kernel sums a boundary-folded padded volume over a static
// max_disp shift window with per-voxel coefficient planes, because Mosaic
// has no general gather.  On Hopper the direct form is a gather, and far
// cheaper in operations: at cubic order and max_disp=4 the TPU form costs
// 12^3 = 1728 FMA per voxel, this one (3+1)^3 = 64 taps.
//
// Design:
//   - one thread per output voxel of (B, X, Y, Z); a block is a 3-D tile
//     of voxels, z fastest (32 z x 4 y x 2 x at 256^3; the extents are
//     powers of two chosen by ops/cuda_warp.py::warp_block), lying inside
//     one (8, 8, 128) TPU tile.  Neighbouring voxels read overlapping tap
//     rows, so a block's (order+1)^2 rows per voxel come into one SM's L1
//     together, where a block of one z-row fetched its rows alone;
//   - the tap setup per axis is the gathers' lean one (spline_taps.cuh):
//     node origin, closed-form weights (and first and second derivatives)
//     at orders 0-3, the recursion with constant reciprocals above; an
//     interior axis (all taps inside with sign 1) takes its taps unfolded,
//     the rest are folded through the boundary condition in-kernel
//     (ops/bounds.py) with the fold's sign in the weights: no padded copy
//     of the volume; tap offsets are 32-bit within a plane;
//   - interior z taps are read at immediate offsets from one address,
//     folded ones at their offsets; from order 2 a warp takes one of the
//     two loops for all its voxels (spline_taps.cuh::contiguous_z);
//   - the window semantics are reproduced exactly: a sample whose node
//     origin offset d0 = n0 - p lies outside [d0min, d0max] on some axis
//     gets no tap there and reads 0, as in window._coef_fields;
//   - mode 1d, adaptive (pallas_warp.py:172-235): the test becomes
//     d0 - base in [d0min, d0max] of the residual window, with the base of
//     the block's (8, 8, 128) TPU tile (WarpParams.base, computed once per
//     call by ops/tiles.py), loaded once per thread from the block's
//     origin.  A runtime branch shared by value, grad and hess: no
//     template of its own;
//   - the TPU kernel's chunked mode (active / d0_ranges: sub-windows under
//     the 16 MB VMEM cap, whose launches sum) needs no code here: the
//     gather keeps no window-sized state, so one launch takes any window
//     (max_disp=8 at cubic order, span 20, or a residual wider than 12) and
//     is the counterpart of the chunks' sum;
//   - the extrapolation mask is inbounds_mask (ndkernels.py): kept iff
//     thr_lo < g < thr_hi[d] on every axis, strict on both sides;
//   - channels loop inside the thread with the weights in registers; batch
//     and channel are written out (one launch per call) with 64-bit
//     (b, c) base offsets; each thread writes only its own voxel, so the
//     result is deterministic;
//   - hess mode reads the taps once and keeps six sums (xx, yy, zz from
//     the second-derivative weights; xy, xz, yz from products of first
//     derivatives), and writes the full symmetric 3x3 (JAX's layout).
//
// What bounds it on this card: instructions and L1 traffic per sample more
// than bytes.  The taps, (order+1)^3 x C per voxel (64 x C at cubic
// order), come mostly from L1/L2 when the warp is smooth.  A tap setup
// with an IEEE division per recursion term, a switch and modulos per tap
// and 64-bit offsets costs more instructions than the taps themselves;
// the lean one here halves the kernel's time at cubic order (PERF.md).
// The launch bounds keep enough warps resident to hide the read latency.
//
// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_warp(const float* inp, const float* grid, float* val,
//                     float* grad, float* hess, const WarpParams* p,
//                     int value, int want_grad, int want_hess,
//                     void* stream);
// inp (B, C, X, Y, Z), grid (B, X, Y, Z, 3), val (B, C, X, Y, Z),
// grad (B, C, X, Y, Z, 3), hess (B, C, X, Y, Z, 3, 3); all float32,
// contiguous; Y * Z < 2^31.  Hess runs alone; value and grad alone or
// together.  Returns the cudaError_t of the launch (0 on success).

#include "spline_taps.cuh"

namespace {

// NT = largest order + 1 over the three axes (taps per axis, 1..8); the
// launch bounds are the gathers' (spline_taps.cuh::gather_blocks).
template <int NT, bool VAL, bool GRAD, bool HESS>
__global__ void __launch_bounds__(256, (gather_blocks<NT, HESS>(true)))
    warp_kernel(const float* __restrict__ inp, const float* __restrict__ grid,
                float* __restrict__ val, float* __restrict__ grd,
                float* __restrict__ hes, const WarpParams p) {
  constexpr bool D1 = GRAD || HESS;  // first-derivative taps needed
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  // the block's tile: blockIdx.x runs over (y, z) tiles, z fastest,
  // blockIdx.y over x tiles, blockIdx.z over the batch; threadIdx.x runs
  // over the tile, z fastest
  const int lx = p.block[0], ly = p.block[1], lz = p.block[2];
  const int nbz = (Z + (1 << lz) - 1) >> lz;
  const int ky = blockIdx.x / nbz;
  const int x0 = blockIdx.y << lx, y0 = ky << ly,
            z0 = (blockIdx.x - ky * nbz) << lz;
  const long long b = blockIdx.z;
  // the window test's shift: the base of the block's TPU tile (adaptive
  // mode), 0 in the plain mode
  int sh[3] = {0, 0, 0};
  if (p.base[0] != nullptr) {
    const long long tl =
        ((b * p.ntile[0] + x0 / p.tile[0]) * p.ntile[1] + y0 / p.tile[1]) *
            p.ntile[2] +
        z0 / p.tile[2];
#pragma unroll
    for (int d = 0; d < 3; ++d) sh[d] = __ldg(p.base[d] + tl);
  }
  const int t = threadIdx.x;
  const int x = x0 + (t >> (lz + ly));
  const int y = y0 + ((t >> lz) & ((1 << ly) - 1));
  const int z = z0 + (t & ((1 << lz) - 1));
  if (x >= X || y >= Y || z >= Z) return;
  const int YZ = Y * Z;
  const long long nvox = (long long)X * YZ;
  const long long r = (long long)x * YZ + y * Z + z;
  const long long v = b * nvox + r;
  const float gx = grid[3 * v], gy = grid[3 * v + 1], gz = grid[3 * v + 2];

  bool keep = !p.masked || inside(gx, gy, gz, p.thr_lo, p.thr_hi);
  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];
  const float nx = node_origin(gx, ordx), ny = node_origin(gy, ordy),
              nz = node_origin(gz, ordz);
  const float d0[3] = {nx - (float)x, ny - (float)y, nz - (float)z};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // written so that a NaN coordinate fails the test
    keep = keep && d0[d] >= (float)(p.d0min[d] + sh[d]) &&
           d0[d] <= (float)(p.d0max[d] + sh[d]);
  }
  TapAxis<NT> ax, ay, az;
  bool zin = false;
  long long ox[NT];
  int oy[NT];
  if (keep) {
    tap_axis<NT, D1, HESS>(gx, nx, X, ordx, p.bound[0], ax);
    tap_axis<NT, D1, HESS>(gy, ny, Y, ordy, p.bound[1], ay);
    zin = tap_axis<NT, D1, HESS>(gz, nz, Z, ordz, p.bound[2], az);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ox[j] = (long long)ax.idx[j] * YZ;
      oy[j] = ay.idx[j] * Z;
    }
  }
  const bool contig = contiguous_z<NT>(zin, keep);
  for (long long c = 0; c < p.C; ++c) {
    const long long base = (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    TapSums s;
    if (keep) {
      if (contig)
        gather_taps<NT, VAL, GRAD, HESS, kZContig>(
            inp + base, ox, oy, ax, ay, az, ordx, ordy, ordz, s);
      else
        gather_taps<NT, VAL, GRAD, HESS, kZFolded>(
            inp + base, ox, oy, ax, ay, az, ordx, ordy, ordz, s);
    }
    store_sums<VAL, GRAD, HESS>(s, base + r, val, grd, hes);
  }
}

template <int NT, bool VAL, bool GRAD, bool HESS>
cudaError_t launch(const float* inp, const float* grid, float* val,
                   float* grd, float* hes, const WarpParams& p,
                   cudaStream_t stream) {
  long long nb[3];
  for (int d = 0; d < 3; ++d) {
    if (p.block[d] < 0 || p.block[d] > 8) return cudaErrorInvalidConfiguration;
    nb[d] = (p.shape[d] + (1LL << p.block[d]) - 1) >> p.block[d];
  }
  const int threads = 1 << (p.block[0] + p.block[1] + p.block[2]);
  if (threads > 256 || nb[1] * nb[2] > 0x7fffffffLL || nb[0] > 65535 ||
      p.B < 1 || p.B > 65535 ||
      (long long)p.shape[1] * p.shape[2] > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const dim3 blocks((unsigned)(nb[1] * nb[2]), (unsigned)nb[0],
                    (unsigned)p.B);
  warp_kernel<NT, VAL, GRAD, HESS>
      <<<blocks, threads, 0, stream>>>(inp, grid, val, grd, hes, p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mode(const float* inp, const float* grid, float* val,
                        float* grd, float* hes, const WarpParams& p,
                        int value, int grad, int hess, cudaStream_t stream) {
  if (hess) return launch<NT, false, false, true>(inp, grid, val, grd, hes, p, stream);
  if (value && grad) return launch<NT, true, true, false>(inp, grid, val, grd, hes, p, stream);
  if (grad) return launch<NT, false, true, false>(inp, grid, val, grd, hes, p, stream);
  return launch<NT, true, false, false>(inp, grid, val, grd, hes, p, stream);
}

}  // namespace

extern "C" int interpol_warp(const float* inp, const float* grid, float* val,
                             float* grd, float* hes, const WarpParams* p,
                             int value, int want_grad, int want_hess,
                             void* stream) {
  if (!value && !want_grad && !want_hess) return (int)cudaErrorInvalidValue;
  if (want_hess && (value || want_grad)) return (int)cudaErrorInvalidValue;
  if ((value && val == nullptr) || (want_grad && grd == nullptr) ||
      (want_hess && hes == nullptr))
    return (int)cudaErrorInvalidValue;
  int nt = 0;
  for (int d = 0; d < 3; ++d) {
    if (p->order[d] < 0 || p->order[d] > 7 || p->bound[d] < 0 ||
        p->bound[d] > 6 || p->shape[d] < 1)
      return (int)cudaErrorInvalidValue;
    nt = max(nt, p->order[d] + 1);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define INTERPOL_NT_CASE(N) \
  case N: err = launch_mode<N>(inp, grid, val, grd, hes, *p, value, want_grad, want_hess, s); break;
  switch (nt) {
    INTERPOL_NT_CASE(1)
    INTERPOL_NT_CASE(2)
    INTERPOL_NT_CASE(3)
    INTERPOL_NT_CASE(4)
    INTERPOL_NT_CASE(5)
    INTERPOL_NT_CASE(6)
    INTERPOL_NT_CASE(7)
    default: err = launch_mode<8>(inp, grid, val, grd, hes, *p, value, want_grad, want_hess, s); break;
  }
#undef INTERPOL_NT_CASE
  return (int)err;
}
