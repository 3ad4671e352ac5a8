// Dense-warp B-spline pull and spatial gradient for Hopper (sm_90a).
//
// Replaces interpol_tpu/ops/pallas_warp.py::_warp_kernel in its value and
// grad modes (pull_window / grad_window forwards).  The Pallas kernel sums a
// boundary-folded padded volume over a static max_disp shift window with
// per-voxel coefficient planes, because Mosaic has no general gather.  On
// Hopper the direct form is a gather, and far cheaper in operations: at
// cubic order and max_disp=4 the TPU form costs 12^3 = 1728 FMA per voxel,
// this one (3+1)^3 = 64 taps.
//
// Design:
//   - one thread per output voxel of (B, X, Y, Z), z fastest, so the
//     threads of a warp read neighbouring addresses;
//   - per axis, the node origin and the taps' weights (and first
//     derivatives) come from the same Cox-de Boor recursion as
//     ops/splines.py, in registers;
//   - each tap index is folded through the boundary condition in-kernel
//     (ops/bounds.py): no padded copy of the volume; the fold's sign is
//     folded into the axis weights;
//   - the window semantics are reproduced exactly: a sample whose node
//     origin offset d0 = n0 - p lies outside [d0min, d0max] on some axis
//     gets no tap there and reads 0, as in window._coef_fields;
//   - the extrapolation mask is inbounds_mask (ndkernels.py): kept iff
//     thr_lo < g < thr_hi[d] on every axis, strict on both sides;
//   - channels loop inside the thread with the weights in registers; batch
//     and channel are written out (one launch per call) with 64-bit
//     (b, c) base offsets; each thread writes only its own voxel, so the
//     result is deterministic.
//
// What bounds it on this card: the scattered tap reads, (order+1)^3 x C per
// voxel (64 x C at cubic order), served mostly from L1/L2 when the warp is
// smooth (neighbouring voxels read overlapping taps).  The arithmetic is
// ~2 FMA per tap.  The launch bounds keep enough warps resident to hide
// the read latency.  Shared-memory tiles of the volume and TMA loads are
// the speed work of later changes; this kernel is the simple, right one.
//
// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_warp(const float* inp, const float* grid, float* val,
//                     float* grad, const WarpParams* p, int value,
//                     int want_grad, void* stream);
// inp (B, C, X, Y, Z), grid (B, X, Y, Z, 3), val (B, C, X, Y, Z),
// grad (B, C, X, Y, Z, 3); all float32, contiguous.  Returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

struct WarpParams {
  long long B, C;
  int shape[3];
  int order[3];
  int bound[3];
  int d0min[3];   // attainable node-origin offsets n0 - p of the window
  int d0max[3];
  float thr_hi[3];  // (n - 1) + thr, rounded to float32 on the host
  float thr_lo;     // -thr
  int masked;       // extrapolate != 1
};

namespace {

// BoundType numbering (options.py)
enum { kZero = 0, kReplicate, kDct1, kDct2, kDst1, kDst2, kDft };

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;  // C++ truncates toward zero; make it a floor-mod
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int fold_index(int i, int n, int bound) {
  switch (bound) {
    case kZero:
    case kReplicate:
      return min(max(i, 0), n - 1);
    case kDct2:
    case kDst2: {
      const int n2 = 2 * n;
      i = i < 0 ? (n2 - 1) - pmod(-i - 1, n2) : pmod(i, n2);
      return i >= n ? (n2 - 1) - i : i;
    }
    case kDct1: {
      if (n == 1) return 0;
      const int n2 = 2 * (n - 1);
      i = pmod(abs(i), n2);
      return i >= n ? n2 - i : i;
    }
    case kDst1: {
      const int n2 = 2 * (n + 1);
      i = i < 0 ? -i - 2 : i;
      i = pmod(i, n2);
      i = i > n ? (n2 - 2) - i : i;
      if (i == -1) i = 0;
      if (i == n) i = n - 1;
      return i;
    }
    default:  // kDft
      return pmod(i, n);
  }
}

__device__ __forceinline__ float fold_sign(int i, int n, int bound) {
  switch (bound) {
    case kZero:
      return (i >= 0 && i < n) ? 1.f : 0.f;
    case kDst2: {
      const int ii = i < 0 ? (n - 1) - i : i;  // >= 0
      return ((ii / n) & 1) ? -1.f : 1.f;
    }
    case kDst1: {
      if (n <= 1) return 1.f;
      const int n2 = 2 * (n + 1);
      const int ii = pmod(i < 0 ? -i + (n - 1) : i, n2);
      const float x = (ii == 0 || ii % (n + 1) == n) ? 0.f : 1.f;
      return ((ii / (n + 1)) & 1) ? -x : x;
    }
    default:
      return 1.f;
  }
}

// Weights w[0..P] (and first derivatives g[0..P]) of the P+1 taps at
// fractional offset t, by the Cox-de Boor recursion of ops/splines.py.
// The _rn intrinsics keep each product and sum rounded on its own, as the
// plain version computes them.
template <int P, int NT, bool GRAD>
__device__ __forceinline__ void bspline_taps(float t, float (&w)[NT],
                                             float (&g)[NT]) {
  float lv[P + 1];
  float lm1[P + 1];  // level P-1 (P entries)
  lv[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= P; ++k) {
    if (k == P) {
#pragma unroll
      for (int j = 0; j < P; ++j) lm1[j] = lv[j];
    }
    float nx[P + 1];
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      const float a = __fadd_rn(__fsub_rn(t, (float)j),
                                0.5f * (float)(2 * k + 1 - P));
      const float b = __fsub_rn(0.5f * (float)(P + 1) + (float)j, t);
      float term;
      if (j == 0) {
        term = __fmul_rn(b, lv[0]);
      } else if (j == k) {
        term = __fmul_rn(a, lv[j - 1]);
      } else {
        term = __fadd_rn(__fmul_rn(a, lv[j - 1]), __fmul_rn(b, lv[j]));
      }
      nx[j] = __fdiv_rn(term, (float)k);
    }
#pragma unroll
    for (int j = 0; j <= k; ++j) lv[j] = nx[j];
  }
#pragma unroll
  for (int j = 0; j <= P; ++j) w[j] = lv[j];
  if (GRAD) {
    // beta_P'(t - j) = A_{j-1}^(P-1) - A_j^(P-1)
#pragma unroll
    for (int j = 0; j <= P; ++j) {
      const float left = j >= 1 ? lm1[j >= 1 ? j - 1 : 0] : 0.f;
      const float right = j < P ? lm1[j < P ? j : 0] : 0.f;
      g[j] = __fsub_rn(left, right);
    }
  }
}

// One axis: window test, taps, folded offsets (index * stride) and signed
// weights.  Returns false when the sample gets no tap on this axis.
template <int NT, bool GRAD>
__device__ __forceinline__ bool axis_taps(float g, int p, int n, int order,
                                          int bound, int d0min, int d0max,
                                          long long stride,
                                          long long (&off)[NT],
                                          float (&w)[NT], float (&dw)[NT]) {
  // order 0 rounds half to even (rintf), as torch.round / jnp.round do
  const float n0f =
      order == 0 ? rintf(g) : floorf(g - 0.5f * (float)(order - 1));
  const float d0 = n0f - (float)p;
  // written so that a NaN coordinate fails the test
  if (!(d0 >= (float)d0min && d0 <= (float)d0max)) return false;
  const float t = g - n0f;
#define INTERPOL_TAPS_CASE(P) \
  case P:                     \
    bspline_taps<(P < NT ? P : NT - 1), NT, GRAD>(t, w, dw); \
    break;
  switch (order) {
    INTERPOL_TAPS_CASE(0)
    INTERPOL_TAPS_CASE(1)
    INTERPOL_TAPS_CASE(2)
    INTERPOL_TAPS_CASE(3)
    INTERPOL_TAPS_CASE(4)
    INTERPOL_TAPS_CASE(5)
    INTERPOL_TAPS_CASE(6)
    default:
      bspline_taps<NT - 1, NT, GRAD>(t, w, dw);
  }
#undef INTERPOL_TAPS_CASE
  const int n0 = (int)n0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j > order) break;
    const int i = n0 + j;
    const float s = fold_sign(i, n, bound);
    off[j] = (long long)fold_index(i, n, bound) * stride;
    w[j] *= s;
    if (GRAD) dw[j] *= s;
  }
  return true;
}

// NT = largest order + 1 over the three axes (taps per axis, 1..8).
// Three resident blocks per SM cap the registers at 85 a thread: without
// the cap ptxas hoists the 64 cubic tap loads into ~200 registers, one
// block fits per SM, and the kernel runs 2.7-3.4x slower (H100, 256^3).
template <int NT, bool VAL, bool GRAD>
__global__ void __launch_bounds__(256, 3)
    warp_kernel(const float* __restrict__ inp, const float* __restrict__ grid,
                float* __restrict__ val, float* __restrict__ grd,
                const WarpParams p) {
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
  keep = keep &&
         axis_taps<NT, GRAD>(gx, x, X, p.order[0], p.bound[0], p.d0min[0],
                             p.d0max[0], (long long)Y * Z, ox, wx, dx) &&
         axis_taps<NT, GRAD>(gy, y, Y, p.order[1], p.bound[1], p.d0min[1],
                             p.d0max[1], (long long)Z, oy, wy, dy) &&
         axis_taps<NT, GRAD>(gz, z, Z, p.order[2], p.bound[2], p.d0min[2],
                             p.d0max[2], 1LL, oz, wz, dz);
  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];

  for (long long c = 0; c < p.C; ++c) {
    const long long base = (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    float acc = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
    if (keep) {
      const float* vol = inp + base;
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        if (jx > ordx) break;
        float yv = 0.f, ydy = 0.f, ydz = 0.f;
#pragma unroll
        for (int jy = 0; jy < NT; ++jy) {
          if (jy > ordy) break;
          const float* row = vol + ox[jx] + oy[jy];
          float zv = 0.f, zd = 0.f;
#pragma unroll
          for (int jz = 0; jz < NT; ++jz) {
            if (jz > ordz) break;
            const float s = __ldg(row + oz[jz]);
            zv = fmaf(wz[jz], s, zv);
            if (GRAD) zd = fmaf(dz[jz], s, zd);
          }
          yv = fmaf(wy[jy], zv, yv);
          if (GRAD) {
            ydy = fmaf(dy[jy], zv, ydy);
            ydz = fmaf(wy[jy], zd, ydz);
          }
        }
        if (VAL) acc = fmaf(wx[jx], yv, acc);
        if (GRAD) {
          ax = fmaf(dx[jx], yv, ax);
          ay = fmaf(wx[jx], ydy, ay);
          az = fmaf(wx[jx], ydz, az);
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
  }
}

template <int NT, bool VAL, bool GRAD>
cudaError_t launch(const float* inp, const float* grid, float* val,
                   float* grd, const WarpParams& p, cudaStream_t stream) {
  const long long total =
      p.B * (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_kernel<NT, VAL, GRAD>
      <<<(unsigned)blocks, threads, 0, stream>>>(inp, grid, val, grd, p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mode(const float* inp, const float* grid, float* val,
                        float* grd, const WarpParams& p, int value, int grad,
                        cudaStream_t stream) {
  if (value && grad) return launch<NT, true, true>(inp, grid, val, grd, p, stream);
  if (grad) return launch<NT, false, true>(inp, grid, val, grd, p, stream);
  return launch<NT, true, false>(inp, grid, val, grd, p, stream);
}

}  // namespace

extern "C" int interpol_warp(const float* inp, const float* grid, float* val,
                             float* grd, const WarpParams* p, int value,
                             int want_grad, void* stream) {
  if (!value && !want_grad) return (int)cudaErrorInvalidValue;
  if ((value && val == nullptr) || (want_grad && grd == nullptr))
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
  switch (nt) {
    case 1: err = launch_mode<1>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 2: err = launch_mode<2>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 3: err = launch_mode<3>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 4: err = launch_mode<4>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 5: err = launch_mode<5>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 6: err = launch_mode<6>(inp, grid, val, grd, *p, value, want_grad, s); break;
    case 7: err = launch_mode<7>(inp, grid, val, grd, *p, value, want_grad, s); break;
    default: err = launch_mode<8>(inp, grid, val, grd, *p, value, want_grad, s); break;
  }
  return (int)err;
}
