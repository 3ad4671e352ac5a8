// Per-axis B-spline taps of one sample, shared by every kernel of the port
// so that they cannot drift apart: the kernel parameters, boundary folding
// (ops/bounds.py), the Cox-de Boor tap weights and their first and second
// derivatives (ops/splines.py), the node origin, the extrapolation mask
// (ops/ndkernels.py::inbounds_mask) and the window test of one axis
// (ops/window.py).  Users: the dense-warp gather (warp.cu) and splat
// (push.cu), the scattered gather (gather.cu) and splat (splat.cu).

#pragma once

#include <cuda_runtime.h>

struct WarpParams {
  long long B, C;
  int shape[3];
  int order[3];
  int bound[3];
  int d0min[3];   // attainable node-origin offsets n0 - p of the window
  int d0max[3];   // (adaptive mode: of the residual window, minus the base)
  float thr_hi[3];  // (n - 1) + thr, rounded to float32 on the host
  float thr_lo;     // -thr
  int masked;       // extrapolate != 1
  // adaptive mode (pallas_warp.py:172-235, 669-685): per axis, the int32
  // base displacement of each tile of the TPU kernel's grid, laid out
  // (B, ntile[0], ntile[1], ntile[2]); a sample's window test is shifted
  // by its tile's base.  Null pointers: the plain window.
  const int* base[3];
  int tile[3];
  int ntile[3];
};

// A scattered cloud: B batches of P points (B, P, 3) in a volume of
// ``shape``; C channels.
struct PointParams {
  long long B, C, P;
  int shape[3];
  int order[3];
  int bound[3];
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

// Weights w[0..P], first derivatives g[0..P] (GRAD) and second
// derivatives h[0..P] (HESS) of the P+1 taps at fractional offset t, by
// the Cox-de Boor recursion of ops/splines.py.  The _rn intrinsics keep
// each product and sum rounded on its own, as the plain version computes
// them.
template <int P, int NT, bool GRAD, bool HESS>
__device__ __forceinline__ void bspline_taps(float t, float (&w)[NT],
                                             float (&g)[NT],
                                             float (&h)[NT]) {
  float lv[P + 1];
  float lm1[P + 1];  // level P-1 (P entries)
  float lm2[P + 1];  // level P-2 (P-1 entries)
  lv[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= P; ++k) {
    if (k == P - 1) {
#pragma unroll
      for (int j = 0; j < P - 1; ++j) lm2[j] = lv[j];
    }
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
  if (HESS) {
    // beta_P''(t - j) = A_{j-2}^(P-2) - 2 A_{j-1}^(P-2) + A_j^(P-2),
    // zero for orders 0 and 1
#pragma unroll
    for (int j = 0; j <= P; ++j) {
      if (P < 2) {
        h[j] = 0.f;
      } else {
        const float a = (j >= 2 && j - 2 < P - 1) ? lm2[j >= 2 ? j - 2 : 0]
                                                   : 0.f;
        const float b = (j >= 1 && j - 1 < P - 1) ? lm2[j >= 1 ? j - 1 : 0]
                                                   : 0.f;
        const float c = j < P - 1 ? lm2[j < P - 1 ? j : 0] : 0.f;
        h[j] = __fadd_rn(__fsub_rn(a, __fmul_rn(2.f, b)), c);
      }
    }
  }
}

// The kept-sample test of inbounds_mask: thr_lo < g < thr_hi[d] on every
// axis, strict on both sides (a NaN coordinate fails it).
__device__ __forceinline__ bool inside(float gx, float gy, float gz,
                                       float thr_lo, const float* thr_hi) {
  return gx > thr_lo && gx < thr_hi[0] && gy > thr_lo && gy < thr_hi[1] &&
         gz > thr_lo && gz < thr_hi[2];
}

// First support node of a sample, as a float: order 0 rounds half to even
// (rintf), as torch.round / jnp.round do.
__device__ __forceinline__ float node_origin(float g, int order) {
  return order == 0 ? rintf(g) : floorf(g - 0.5f * (float)(order - 1));
}

// The node origin as an index, clamped to +-2^30 so that a huge or NaN
// coordinate (whose weights are NaN or meaningless) never overflows the
// index arithmetic.
__device__ __forceinline__ int node_index(float n0f) {
  return (int)fminf(fmaxf(n0f, -1073741824.f), 1073741824.f);
}

// Unfolded weights (and derivatives) of the order+1 taps at offset t.
template <int NT, bool GRAD, bool HESS>
__device__ __forceinline__ void axis_weights(float t, int order,
                                             float (&w)[NT], float (&dw)[NT],
                                             float (&hw)[NT]) {
#define INTERPOL_TAPS_CASE(P) \
  case P:                     \
    bspline_taps<(P < NT ? P : NT - 1), NT, GRAD, HESS>(t, w, dw, hw); \
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
      bspline_taps<NT - 1, NT, GRAD, HESS>(t, w, dw, hw);
  }
#undef INTERPOL_TAPS_CASE
}

// Fold the taps n0 .. n0+order of one axis through the bound: offsets
// (folded index * stride) and signed weights (and derivatives).  Bit j of
// ``live`` is set when tap j's fold sign is not 0 (zero bound outside the
// volume, dst1 at its mirror nodes carry sign 0).
template <int NT, bool GRAD, bool HESS>
__device__ __forceinline__ void fold_taps(int n0, int n, int order,
                                          int bound, long long stride,
                                          long long (&off)[NT],
                                          float (&w)[NT], float (&dw)[NT],
                                          float (&hw)[NT], unsigned& live) {
  live = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j > order) break;
    const int i = n0 + j;
    const float s = fold_sign(i, n, bound);
    off[j] = (long long)fold_index(i, n, bound) * stride;
    if (s != 0.f) live |= 1u << j;
    w[j] *= s;
    if (GRAD) dw[j] *= s;
    if (HESS) hw[j] *= s;
  }
}

// The window-test shift of voxel (b, x, y, z) on each axis: its tile's base
// in adaptive mode, 0 in the plain mode.  Uniform over a TPU tile, so a
// warp's threads take the same branch and mostly read one base.
__device__ __forceinline__ void tile_shift(const WarpParams& p, long long b,
                                           int x, int y, int z,
                                           int (&sh)[3]) {
  sh[0] = sh[1] = sh[2] = 0;
  if (p.base[0] == nullptr) return;
  const long long t =
      ((b * p.ntile[0] + x / p.tile[0]) * p.ntile[1] + y / p.tile[1]) *
          p.ntile[2] +
      z / p.tile[2];
#pragma unroll
  for (int d = 0; d < 3; ++d) sh[d] = __ldg(p.base[d] + t);
}

// One axis of a dense warp: window test, taps, folded offsets and signed
// weights.  Returns false when the sample gets no tap on this axis.
template <int NT, bool GRAD, bool HESS>
__device__ __forceinline__ bool axis_taps(float g, int p, int n, int order,
                                          int bound, int d0min, int d0max,
                                          long long stride,
                                          long long (&off)[NT],
                                          float (&w)[NT], float (&dw)[NT],
                                          float (&hw)[NT], unsigned& live) {
  const float n0f = node_origin(g, order);
  const float d0 = n0f - (float)p;
  // written so that a NaN coordinate fails the test
  if (!(d0 >= (float)d0min && d0 <= (float)d0max)) return false;
  axis_weights<NT, GRAD, HESS>(g - n0f, order, w, dw, hw);
  fold_taps<NT, GRAD, HESS>((int)n0f, n, order, bound, stride, off, w, dw,
                            hw, live);
  return true;
}

}  // namespace
