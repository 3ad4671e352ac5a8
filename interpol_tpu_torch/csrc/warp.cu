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
//   - one thread per output voxel of (B, X, Y, Z), z fastest, so the
//     threads of a warp read neighbouring addresses;
//   - per axis, the node origin and the taps' weights (and first and
//     second derivatives) come from the same Cox-de Boor recursion as
//     ops/splines.py, in registers (spline_taps.cuh, shared with the
//     splat kernel of push.cu);
//   - each tap index is folded through the boundary condition in-kernel
//     (ops/bounds.py): no padded copy of the volume; the fold's sign is
//     folded into the axis weights;
//   - the window semantics are reproduced exactly: a sample whose node
//     origin offset d0 = n0 - p lies outside [d0min, d0max] on some axis
//     gets no tap there and reads 0, as in window._coef_fields;
//   - mode 1d, adaptive (pallas_warp.py:172-235): the test becomes
//     d0 - base in [d0min, d0max] of the residual window, with the base of
//     the voxel's (8, 8, 128) TPU tile from three int32 arrays
//     (WarpParams.base, computed once per call by ops/tiles.py).  A runtime
//     branch, uniform over a tile, shared by value, grad and hess: no
//     template of its own.  The gather reads the same (order+1)^3 taps in
//     both modes; only the test moves;
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
// What bounds it on this card: the scattered tap reads, (order+1)^3 x C per
// voxel (64 x C at cubic order), served mostly from L1/L2 when the warp is
// smooth (neighbouring voxels read overlapping taps).  The arithmetic is
// ~2 FMA per tap (~7 in hess mode).  The launch bounds keep enough warps
// resident to hide the read latency.  Shared-memory tiles of the volume and
// TMA loads are the speed work of later changes; this kernel is the
// simple, right one.
//
// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_warp(const float* inp, const float* grid, float* val,
//                     float* grad, float* hess, const WarpParams* p,
//                     int value, int want_grad, int want_hess,
//                     void* stream);
// inp (B, C, X, Y, Z), grid (B, X, Y, Z, 3), val (B, C, X, Y, Z),
// grad (B, C, X, Y, Z, 3), hess (B, C, X, Y, Z, 3, 3); all float32,
// contiguous.  Hess runs alone; value and grad alone or together.
// Returns the cudaError_t of the launch (0 on success).

#include "spline_taps.cuh"

namespace {

// NT = largest order + 1 over the three axes (taps per axis, 1..8).
// Three resident blocks per SM cap the registers at 85 a thread: without
// the cap ptxas hoists the 64 cubic tap loads into ~200 registers, one
// block fits per SM, and the kernel runs 2.7-3.4x slower (H100, 256^3).
template <int NT, bool VAL, bool GRAD, bool HESS>
__global__ void __launch_bounds__(256, 3)
    warp_kernel(const float* __restrict__ inp, const float* __restrict__ grid,
                float* __restrict__ val, float* __restrict__ grd,
                float* __restrict__ hes, const WarpParams p) {
  constexpr bool D1 = GRAD || HESS;  // first-derivative taps needed
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const long long nvox = (long long)X * Y * Z;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.B * nvox) return;
  const long long b = v / nvox;
  const long long r = v - b * nvox;
  const int z = (int)(r % Z);
  const long long xy = r / Z;
  const int y = (int)(xy % Y);
  const int x = (int)(xy / Y);
  const float gx = grid[3 * v], gy = grid[3 * v + 1], gz = grid[3 * v + 2];

  bool keep = true;
  if (p.masked) {
    keep = gx > p.thr_lo && gx < p.thr_hi[0] && gy > p.thr_lo &&
           gy < p.thr_hi[1] && gz > p.thr_lo && gz < p.thr_hi[2];
  }
  long long ox[NT], oy[NT], oz[NT];
  float wx[NT], wy[NT], wz[NT], dx[NT], dy[NT], dz[NT];
  float hx[NT], hy[NT], hz[NT];
  unsigned lx, ly, lz;  // the gather reads sign-0 taps with weight 0
  int sh[3];            // the window test's shift (adaptive mode)
  tile_shift(p, b, x, y, z, sh);
  keep = keep &&
         axis_taps<NT, D1, HESS>(gx, x, X, p.order[0], p.bound[0],
                                 p.d0min[0] + sh[0], p.d0max[0] + sh[0],
                                 (long long)Y * Z, ox, wx, dx, hx, lx) &&
         axis_taps<NT, D1, HESS>(gy, y, Y, p.order[1], p.bound[1],
                                 p.d0min[1] + sh[1], p.d0max[1] + sh[1],
                                 (long long)Z, oy, wy, dy, hy, ly) &&
         axis_taps<NT, D1, HESS>(gz, z, Z, p.order[2], p.bound[2],
                                 p.d0min[2] + sh[2], p.d0max[2] + sh[2], 1LL,
                                 oz, wz, dz, hz, lz);
  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];

  for (long long c = 0; c < p.C; ++c) {
    const long long base = (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    float acc = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
    float hxx = 0.f, hyy = 0.f, hzz = 0.f, hxy = 0.f, hxz = 0.f, hyz = 0.f;
    if (keep) {
      const float* vol = inp + base;
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        if (jx > ordx) break;
        float yv = 0.f, ydy = 0.f, ydz = 0.f;
        float yhy = 0.f, yhz = 0.f, ydydz = 0.f;
#pragma unroll
        for (int jy = 0; jy < NT; ++jy) {
          if (jy > ordy) break;
          const float* row = vol + ox[jx] + oy[jy];
          float zv = 0.f, zd = 0.f, zh = 0.f;
#pragma unroll
          for (int jz = 0; jz < NT; ++jz) {
            if (jz > ordz) break;
            const float s = __ldg(row + oz[jz]);
            zv = fmaf(wz[jz], s, zv);
            if (D1) zd = fmaf(dz[jz], s, zd);
            if (HESS) zh = fmaf(hz[jz], s, zh);
          }
          yv = fmaf(wy[jy], zv, yv);
          if (D1) {
            ydy = fmaf(dy[jy], zv, ydy);
            ydz = fmaf(wy[jy], zd, ydz);
          }
          if (HESS) {
            yhy = fmaf(hy[jy], zv, yhy);
            yhz = fmaf(wy[jy], zh, yhz);
            ydydz = fmaf(dy[jy], zd, ydydz);
          }
        }
        if (VAL) acc = fmaf(wx[jx], yv, acc);
        if (GRAD) {
          ax = fmaf(dx[jx], yv, ax);
          ay = fmaf(wx[jx], ydy, ay);
          az = fmaf(wx[jx], ydz, az);
        }
        if (HESS) {
          hxx = fmaf(hx[jx], yv, hxx);
          hyy = fmaf(wx[jx], yhy, hyy);
          hzz = fmaf(wx[jx], yhz, hzz);
          hxy = fmaf(dx[jx], ydy, hxy);
          hxz = fmaf(dx[jx], ydz, hxz);
          hyz = fmaf(wx[jx], ydydz, hyz);
        }
      }
    }
    const long long o = base + r;
    if (VAL) val[o] = acc;
    if (GRAD) {
      grd[3 * o] = ax;
      grd[3 * o + 1] = ay;
      grd[3 * o + 2] = az;
    }
    if (HESS) {
      float* h = hes + 9 * o;
      h[0] = hxx; h[1] = hxy; h[2] = hxz;
      h[3] = hxy; h[4] = hyy; h[5] = hyz;
      h[6] = hxz; h[7] = hyz; h[8] = hzz;
    }
  }
}

template <int NT, bool VAL, bool GRAD, bool HESS>
cudaError_t launch(const float* inp, const float* grid, float* val,
                   float* grd, float* hes, const WarpParams& p,
                   cudaStream_t stream) {
  const long long total =
      p.B * (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_kernel<NT, VAL, GRAD, HESS>
      <<<(unsigned)blocks, threads, 0, stream>>>(inp, grid, val, grd, hes, p);
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
