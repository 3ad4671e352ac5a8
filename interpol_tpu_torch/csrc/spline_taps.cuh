// Per-axis B-spline taps of one sample, shared by every kernel of the port
// so that they cannot drift apart: the kernel parameters, boundary folding
// (ops/bounds.py), the Cox-de Boor tap weights and their first and second
// derivatives (ops/splines.py), the node origin, the extrapolation mask
// (ops/ndkernels.py::inbounds_mask) and the window test of one axis
// (ops/window.py).  Users: the dense-warp gather (warp.cu) and splat
// (push.cu), the scattered gather (gather.cu) and splat (splat.cu).  The
// two gathers share a leaner tap setup and the tap loop (the end of this
// file): closed-form weights, unfolded interior taps, 32-bit offsets
// within a plane.

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
  // the dense gather's block tile (warp.cu): log2 of its extent per axis,
  // chosen by ops/cuda_warp.py::warp_block so that a block lies inside
  // one TPU tile
  int block[3];
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
// RCP: multiply by the constant reciprocal of each level's divisor in
// place of the IEEE division (the gathers; a few ulp from the plain
// recursion).
template <int P, int NT, bool GRAD, bool HESS, bool RCP = false>
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
      nx[j] = RCP ? __fmul_rn(term, 1.f / (float)k)
                  : __fdiv_rn(term, (float)k);
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

// ------------------------------------------------------------ the gathers
// Tap setup and tap loop of warp.cu and gather.cu.  Per sample, the setup
// runs once per axis and the loop once per channel, so the setup is kept
// lean: closed-form weights without divisions, an interior path with no
// fold, no modulo and no sign, and 32-bit offsets within a plane (only the
// order+1 plane offsets and the (b, c) base are 64-bit).

// Resident 256-thread blocks per SM that a gather's launch bounds ask for,
// hence its register cap (65536 / (256 x blocks)).  Without a cap ptxas
// hoists every tap load into registers (~200 at cubic order), one block
// fits per SM, and the dense gather runs 2.7-3.4x slower (H100, 256^3).
// Chosen in turns on the H100 (PERF.md): 4 (64 registers) at orders 2-3
// and for the scattered gather at orders <= 1, 8 (32 registers, full
// occupancy) for the dense warp at orders <= 1, 3 (85 registers, the
// earlier cap) for the Hessians and orders >= 4, where 64 registers spill.
template <int NT, bool HESS>
__host__ __device__ constexpr int gather_blocks(bool dense) {
  return (HESS || NT > 4) ? 3 : NT > 2 ? 4 : dense ? 8 : 4;
}

// Weights w[0..order], first derivatives g (GRAD) and second derivatives
// h (HESS) of the taps at offset t = coordinate - node origin: closed
// forms at orders 0-3 (the orders the main paths run), the Cox-de Boor
// recursion with constant reciprocals above.  Within a few ulp of the
// plain recursion.
template <int NT, bool GRAD, bool HESS>
__device__ __forceinline__ void fast_weights(float t, int order,
                                             float (&w)[NT], float (&g)[NT],
                                             float (&h)[NT]) {
  switch (order) {
    case 0:
      w[0] = 1.f;
      if (GRAD) g[0] = 0.f;
      if (HESS) h[0] = 0.f;
      return;
    case 1:
      if constexpr (NT >= 2) {
        w[0] = 1.f - t;
        w[1] = t;
        if (GRAD) { g[0] = -1.f; g[1] = 1.f; }
        if (HESS) { h[0] = 0.f; h[1] = 0.f; }
      }
      return;
    case 2:  // t in [0.5, 1.5)
      if constexpr (NT >= 3) {
        const float a = 1.5f - t, b = t - 0.5f, c = t - 1.f;
        w[0] = 0.5f * a * a;
        w[1] = 0.75f - c * c;
        w[2] = 0.5f * b * b;
        if (GRAD) { g[0] = -a; g[1] = -2.f * c; g[2] = b; }
        if (HESS) { h[0] = 1.f; h[1] = -2.f; h[2] = 1.f; }
      }
      return;
    case 3:  // t in [1, 2): u = t - 1, v = 1 - u
      if constexpr (NT >= 4) {
        const float u = t - 1.f, v = 2.f - t;
        const float u2 = u * u, v2 = v * v;
        w[0] = (1.f / 6.f) * v2 * v;
        w[1] = (2.f / 3.f) + u2 * (0.5f * u - 1.f);
        w[2] = (2.f / 3.f) + v2 * (0.5f * v - 1.f);
        w[3] = (1.f / 6.f) * u2 * u;
        if (GRAD) {
          g[0] = -0.5f * v2;
          g[1] = u * (1.5f * u - 2.f);
          g[2] = v * (2.f - 1.5f * v);
          g[3] = 0.5f * u2;
        }
        if (HESS) { h[0] = v; h[1] = 3.f * u - 2.f; h[2] = 3.f * v - 2.f; h[3] = u; }
      }
      return;
#define INTERPOL_RCP_CASE(P)                                             \
  case P:                                                                \
    bspline_taps<(P < NT ? P : NT - 1), NT, GRAD, HESS, true>(t, w, g, h); \
    return;
    INTERPOL_RCP_CASE(4)
    INTERPOL_RCP_CASE(5)
    INTERPOL_RCP_CASE(6)
    default:
      bspline_taps<NT - 1, NT, GRAD, HESS, true>(t, w, g, h);
#undef INTERPOL_RCP_CASE
  }
}

// One axis of a gather's sample: the tap weights (and derivatives) with
// the fold signs in them, and the taps' indices along the axis.
template <int NT>
struct TapAxis {
  float w[NT], d[NT], h[NT];
  int idx[NT];
};

// Fill ``a`` for coordinate g with node origin n0f.  Returns true when the
// taps are interior, n0 .. n0+order inside the axis with fold sign 1: tap
// j is then index n0 + j, with no fold, no modulo and no sign (dst1's sign
// is 0 at index 0, so its interior starts at 1).  Otherwise each tap is
// folded through the bound and its sign goes into the weights.
template <int NT, bool GRAD, bool HESS>
__device__ __forceinline__ bool tap_axis(float g, float n0f, int n,
                                         int order, int bound,
                                         TapAxis<NT>& a) {
  fast_weights<NT, GRAD, HESS>(g - n0f, order, a.w, a.d, a.h);
  const int n0 = node_index(n0f);
  const int lo = (bound == kDst1 && n > 1) ? 1 : 0;
  if (n0 >= lo && n0 + order < n) {
#pragma unroll
    for (int j = 0; j < NT; ++j) a.idx[j] = n0 + j;
    return true;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j > order) break;
    const int i = n0 + j;
    const float s = fold_sign(i, n, bound);
    a.idx[j] = fold_index(i, n, bound);
    a.w[j] *= s;
    if (GRAD) a.d[j] *= s;
    if (HESS) a.h[j] *= s;
  }
  return false;
}

// The sums of one sample in one channel: value, gradient, Hessian (the
// six distinct entries).
struct TapSums {
  float v = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  float hxx = 0.f, hyy = 0.f, hzz = 0.f, hxy = 0.f, hxz = 0.f, hyz = 0.f;
};

// How a gather reads the z taps of a row: at folded indices, or at the
// interior indices n0 .. n0+order, immediate offsets from one address.
enum { kZFolded = 0, kZContig = 1 };

// Whether a thread takes the contiguous tap loop.  From order 2, when
// every active sample of its warp has interior z taps (or none at all), so
// that a warp runs one loop, never both (the folded loop reads interior
// taps too).  At orders <= 1 the loops are short and the vote costs the
// dense gather spills under its 32-register cap: each thread chooses
// alone (both measured in turns on the H100, PERF.md).
template <int NT>
__device__ __forceinline__ bool contiguous_z(bool zin, bool keep) {
  if constexpr (NT <= 2) return zin;
  return __all_sync(__activemask(), zin || !keep);
}

template <int NT, int ZM>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         const TapAxis<NT>& az, int ordz,
                                         float (&tap)[NT]) {
  if constexpr (ZM == kZFolded) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j > ordz) break;
      tap[j] = __ldg(row + az.idx[j]);
    }
  } else {
    const float* r = row + az.idx[0];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j > ordz) break;
      tap[j] = __ldg(r + j);
    }
  }
}

// Sum the taps of one sample in the channel volume ``vol``: plane offsets
// ox (64-bit), row offsets oy (32-bit, within a plane), z taps read as ZM
// says; VAL / GRAD / HESS select the sums.  The sums run in the order of
// the plain formulation's axes (z innermost), the same for every ZM.
template <int NT, bool VAL, bool GRAD, bool HESS, int ZM>
__device__ __forceinline__ void gather_taps(
    const float* __restrict__ vol, const long long (&ox)[NT],
    const int (&oy)[NT], const TapAxis<NT>& ax, const TapAxis<NT>& ay,
    const TapAxis<NT>& az, int ordx, int ordy, int ordz, TapSums& s) {
  constexpr bool D1 = GRAD || HESS;  // first-derivative taps needed
#pragma unroll
  for (int jx = 0; jx < NT; ++jx) {
    if (jx > ordx) break;
    const float* plane = vol + ox[jx];
    float yv = 0.f, ydy = 0.f, ydz = 0.f;
    float yhy = 0.f, yhz = 0.f, ydydz = 0.f;
#pragma unroll
    for (int jy = 0; jy < NT; ++jy) {
      if (jy > ordy) break;
      float tap[NT];
      load_row<NT, ZM>(plane + oy[jy], az, ordz, tap);
      float zv = 0.f, zd = 0.f, zh = 0.f;
#pragma unroll
      for (int jz = 0; jz < NT; ++jz) {
        if (jz > ordz) break;
        zv = fmaf(az.w[jz], tap[jz], zv);
        if (D1) zd = fmaf(az.d[jz], tap[jz], zd);
        if (HESS) zh = fmaf(az.h[jz], tap[jz], zh);
      }
      yv = fmaf(ay.w[jy], zv, yv);
      if (D1) {
        ydy = fmaf(ay.d[jy], zv, ydy);
        ydz = fmaf(ay.w[jy], zd, ydz);
      }
      if (HESS) {
        yhy = fmaf(ay.h[jy], zv, yhy);
        yhz = fmaf(ay.w[jy], zh, yhz);
        ydydz = fmaf(ay.d[jy], zd, ydydz);
      }
    }
    if (VAL) s.v = fmaf(ax.w[jx], yv, s.v);
    if (GRAD) {
      s.gx = fmaf(ax.d[jx], yv, s.gx);
      s.gy = fmaf(ax.w[jx], ydy, s.gy);
      s.gz = fmaf(ax.w[jx], ydz, s.gz);
    }
    if (HESS) {
      s.hxx = fmaf(ax.h[jx], yv, s.hxx);
      s.hyy = fmaf(ax.w[jx], yhy, s.hyy);
      s.hzz = fmaf(ax.w[jx], yhz, s.hzz);
      s.hxy = fmaf(ax.d[jx], ydy, s.hxy);
      s.hxz = fmaf(ax.d[jx], ydz, s.hxz);
      s.hyz = fmaf(ax.w[jx], ydydz, s.hyz);
    }
  }
}

// Write one sample's sums at output index o: value, gradient (3), and the
// full symmetric 3x3 Hessian (JAX's layout).
template <bool VAL, bool GRAD, bool HESS>
__device__ __forceinline__ void store_sums(const TapSums& s, long long o,
                                           float* __restrict__ val,
                                           float* __restrict__ grd,
                                           float* __restrict__ hes) {
  if (VAL) val[o] = s.v;
  if (GRAD) {
    grd[3 * o] = s.gx;
    grd[3 * o + 1] = s.gy;
    grd[3 * o + 2] = s.gz;
  }
  if (HESS) {
    float* h = hes + 9 * o;
    h[0] = s.hxx; h[1] = s.hxy; h[2] = s.hxz;
    h[3] = s.hxy; h[4] = s.hyy; h[5] = s.hyz;
    h[6] = s.hxz; h[7] = s.hyz; h[8] = s.hzz;
  }
}

}  // namespace
