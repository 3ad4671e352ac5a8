// Scattered B-spline splat for Hopper (sm_90a): push, pushgrad and
// pushhess of any cloud of points (grid_push, grid_count = push of ones,
// and the adjoints of grid_pull / grid_grad in the image).
//
// Replaces interpol_tpu/ops/scattered.py::_splat_kernel.  The TPU kernel
// sorts the points into boxes and densifies each box's splats as one
// one-hot MXU matmul per box, because Mosaic has no scatter; the patches
// are then overlap-added and folded through the bounds in XLA.  That is
// race-free by construction, so the JAX push is bit-reproducible.
//
// Here every tap is a 64-bit fixed-point integer (fixed_splat.cuh, read
// its notes first), whose sums do not depend on their order, so no sort is
// needed for the bits.  Two designs, the same bits:
//   - direct (splat_direct_kernel): one thread per point, in input order;
//     its taps folded through the bounds (outliers included) and added
//     straight to the int64 accumulator, each with an atomicAdd whose result
//     is unused (a reduction, RED, in L2).  No sort, no host work;
//   - box (splat_box_kernel): the points sorted by box
//     (ops/scattered.py::box_schedule, one torch.sort); one block of 256
//     threads per (box, channel) (the channels on a grid-stride loop over
//     gridDim.y) adds its points' taps to a patch in shared
//     memory (the box plus the spline's reach, splat_margins), then every
//     non-zero cell once to the accumulator, folded; the outliers (points
//     outside [0, n-1] on some axis that the mask keeps, the sort's last
//     segment) go through the direct kernel, their range read on the card.
// A point is kept by the extrapolation mask (fixed_splat.cuh::point_kept);
// a masked one adds nothing, and the slice's scale sums |v| over the kept
// points only, read in input order from the unsorted cloud, as the JAX
// kernel gives invalid slots v = 0 (scattered.py:1033): a masked point
// whose value is 1e30, inf or NaN changes no bit of the output, in either
// design.  ops/cuda_scattered.py picks the design by points per output
// voxel (PERF.md).  A template SPEC selects push (1 value row), pushgrad
// (3 rows, first-derivative taps) and pushhess (6 rows: xx, yy, zz and the
// summed symmetric pairs xy, xz, yz), as the JAX spec does
// (scattered.py:1359).
//
// What bounds it on this card: the atomics, (order+1)^3 per point per
// channel (the least traffic is the points, values and output once: 83 MB
// for 1M points into 256^3, 0.0248 ms).
//
// C interface (loaded with ctypes by ops/cuda_scattered.py):
//   int interpol_splat(const float* coords, const float* rows,
//                      const float* coords_orig, const float* vals_orig,
//                      long long n_orig,
//                      const int* keys, const long long* seg, void* ws,
//                      float* out, const PointParams* p,
//                      const SplatGeom* g, int spec, void* stream);
// coords (B*P, 3) and rows (C, NV, B*P): in input order (direct, keys and
// seg null) or sorted by box (keys the sorted int32 box keys, seg the
// (B*tiles + B + 2) segment starts, g the boxes); coords_orig (B*P, 3) and
// vals_orig (B, C, P[, D[, D]]), n_orig elements per slice, the cloud and
// the caller's values in input order (the scale pass); ws the zeroed
// workspace; out (B, C, X, Y, Z); all contiguous.  Returns the first
// failing cudaError_t.

#include "fixed_splat.cuh"

namespace {

template <int SPEC>
__device__ __forceinline__ void load_rows(float* v, const float* rows,
                                          long long c, long long ntot,
                                          long long k) {
  constexpr int NV = Spec<SPEC>::NV;
#pragma unroll
  for (int r = 0; r < NV; ++r) v[r] = __ldg(rows + (c * NV + r) * ntot + k);
}

// One point's taps as the direct kernel's warp shares them (shared memory):
// per axis the folded indices and the signed factors, the live taps
// (fold_taps), the values of the current channel and the batch (-1: the
// point adds nothing).
template <int NT, int SPEC>
struct Staged {
  static constexpr int ND = SPEC >= 1 ? NT : 1, NH = SPEC == 2 ? NT : 1;
  float w[3][NT], d[3][ND], h[3][NH];
  int idx[3][NT];
  float v[Spec<SPEC>::NV];
  unsigned live[3];
  int b;
};

// Every kept point of [k0, k1) straight to the accumulator: all points in
// input order (keys null: the batch is k / P, k1 = B*P), or the outliers
// of a box-sorted cloud (``tiles`` = B x boxes: the range seg[tiles],
// seg[tiles + B] read here, the batch from the key).  Each thread stages one
// point (mask, factors, fold) into its warp's shared buffer; then the warp
// adds its points' taps, the lanes split as (32 / zt) points x zt z taps
// (zt = order_z + 1), so that one atomic instruction covers whole z runs
// of several points: a run of zt contiguous voxels per point, and for
// points in order (a reslice) overlapping runs.
template <int NT, int SPEC>
__global__ void __launch_bounds__(kThreads)
    splat_direct_kernel(const float* __restrict__ coords,
                        const float* __restrict__ rows, Workspace w,
                        const PointParams p, const int* __restrict__ keys,
                        const long long* __restrict__ seg,
                        long long tiles) {
  extern __shared__ unsigned long long smem[];
  using St = Staged<NT, SPEC>;
  const int lane = threadIdx.x & 31;
  St* st = reinterpret_cast<St*>(smem) + (threadIdx.x - lane);
  St& me = st[lane];
  const long long ntot = p.B * p.P;
  const long long nvox = (long long)p.shape[0] * p.shape[1] * p.shape[2];
  long long k0 = 0, k1 = ntot;
  if (keys != nullptr) {
    k0 = seg[tiles];
    k1 = seg[tiles + p.B];
  }
  const int zt = p.order[2] + 1;
  const int G = 32 / zt;  // points per group of lanes
  for (long long base = k0 + (long long)blockIdx.x * kThreads +
                        (threadIdx.x - lane);
       base < k1; base += (long long)gridDim.x * kThreads) {
    const long long k = base + lane;
    me.b = -1;
    if (k < k1) {
      const long long b = keys != nullptr ? keys[k] - tiles : k / p.P;
      const float g[3] = {coords[3 * k], coords[3 * k + 1],
                          coords[3 * k + 2]};
      if (point_kept(p, g)) {
        if (!(isfinite(g[0]) && isfinite(g[1]) && isfinite(g[2]))) {
          for (long long c = 0; c < p.C; ++c)
            atomicOr(w.bad + b * p.C + c, 1u);
        } else {
          ItemTaps<NT, SPEC> it;
          long long idx[NT];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            stage_axis(it, d, g[d], p.order[d]);
            fold_taps<NT, (SPEC >= 1), (SPEC == 2)>(
                it.n0[d], p.shape[d], p.order[d], p.bound[d], 1LL, idx,
                it.w[d], it.d[d], it.h[d], me.live[d]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              me.idx[d][j] = (int)idx[j];
              me.w[d][j] = it.w[d][j];
              if constexpr (SPEC >= 1) me.d[d][j] = it.d[d][j];
              if constexpr (SPEC == 2) me.h[d][j] = it.h[d][j];
            }
          }
          me.b = (int)b;
        }
      }
    }
    for (long long c = 0; c < p.C; ++c) {
      if (me.b >= 0) {
        constexpr int NV = Spec<SPEC>::NV;
#pragma unroll
        for (int r = 0; r < NV; ++r)
          me.v[r] = __ldg(rows + (c * NV + r) * ntot + k);
      }
      __syncwarp();
      for (int g0 = 0; g0 < 32; g0 += G) {
        const int q = g0 + lane / zt, jz = lane - (lane / zt) * zt;
        if (lane >= G * zt || q >= 32) continue;
        const St& s = st[q];
        if (s.b < 0 || !((s.live[2] >> jz) & 1u)) continue;
        const long long slice = (long long)s.b * p.C + c;
        float vs[Spec<SPEC>::NV];
        scaled<SPEC>(vs, s.v, pow2f(w.kexp[slice]));
        unsigned long long* acc = w.acc + slice * nvox + s.idx[2][jz];
#pragma unroll
        for (int jy = 0; jy < NT; ++jy) {
          if (jy > p.order[1]) break;
          if (!((s.live[1] >> jy) & 1u)) continue;
          const Column col = column<SPEC>(s, vs, jy, jz);
#pragma unroll
          for (int jx = 0; jx < NT; ++jx) {
            if (jx > p.order[0]) break;
            if (!((s.live[0] >> jx) & 1u)) continue;
            atomicAdd(acc + ((long long)s.idx[0][jx] * p.shape[1] +
                             s.idx[1][jy]) * p.shape[2],
                      column_tap<SPEC>(s, col, jx));
          }
        }
      }
      __syncwarp();
    }
  }
}

// One block per (box b * tiles + t, channel), the channels on a
// grid-stride loop over gridDim.y: the box's points into its patch, then
// the flush.
template <int NT, int SPEC>
__global__ void __launch_bounds__(kThreads)
    splat_box_kernel(const float* __restrict__ coords,
                     const float* __restrict__ rows,
                     const long long* __restrict__ seg, Workspace w,
                     const PointParams p, const SplatGeom g) {
  extern __shared__ unsigned long long smem[];
  const long long ntot = p.B * p.P;
  const long long nvox = (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const long long ntile = (long long)g.NB[0] * g.NB[1] * g.NB[2];
  const long long bt = blockIdx.x;
  const long long b = bt / ntile, tile = bt - b * ntile;
  const long long k0 = seg[bt], k1 = seg[bt + 1];
  if (k0 == k1) return;
  const int tix[3] = {(int)(tile / ((long long)g.NB[1] * g.NB[2])),
                      (int)((tile / g.NB[2]) % g.NB[1]),
                      (int)(tile % g.NB[2])};
  int origin[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) origin[d] = tix[d] * g.T[d] + g.lo[d];
  for (long long c = blockIdx.y; c < p.C; c += gridDim.y) {
    const long long slice = b * p.C + c;
    const float scale = pow2f(w.kexp[slice]);
    const PatchSmem ps = patch_begin(smem, g.E, origin, p.shape, p.bound);
    for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
      ItemTaps<NT, SPEC> it;
      bool in = true;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        stage_axis(it, d, coords[3 * k + d], p.order[d]);
        // every tap inside the patch (the host's margins guarantee it)
        const int l = it.n0[d] - origin[d];
        in = in && l >= 0 && l + p.order[d] < g.E[d];
      }
      if (!in) continue;
      float v[Spec<SPEC>::NV];
      load_rows<SPEC>(v, rows, c, ntot, k);
      patch_add(ps, it, v, p.order, origin, g.E[1], g.E[2], scale);
    }
    patch_flush(ps, g.E, w.acc + slice * nvox, p.shape[1], p.shape[2]);
    __syncthreads();  // the next channel zeroes the patch
  }
}

int max_nt(const PointParams* p) {
  int nt = 0;
  for (int d = 0; d < 3; ++d) {
    if (p->order[d] < 0 || p->order[d] > 7 || p->bound[d] < 0 ||
        p->bound[d] > 6 || p->shape[d] < 1)
      return 0;
    nt = max(nt, p->order[d] + 1);
  }
  return nt;
}

template <int NT, int SPEC>
cudaError_t launch_splat(const float* coords, const float* rows,
                         const float* coords_orig, const float* vals_orig,
                         long long n_orig,
                         const int* keys, const long long* seg,
                         const Workspace& w, float* out,
                         const PointParams& p, const SplatGeom& g,
                         cudaStream_t s) {
  const long long S = p.B * p.C;
  const long long nvox = (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const long long ntot = p.B * p.P;
  // the scale over the kept points, in input order: n_orig / P values a
  // point (1, D or D^2 of the caller's layout)
  cudaError_t e = launch_scale(vals_orig, p.B, p.C, n_orig, n_orig / p.P,
                               Spec<SPEC>::kMass,
                               PointItems{coords_orig, p}, w, out, nvox, s);
  if (e != cudaSuccess) return e;
  const long long blocks = (ntot + kThreads - 1) / kThreads;
  const long long tiles = p.B * (long long)g.NB[0] * g.NB[1] * g.NB[2];
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t direct_smem = sizeof(Staged<NT, SPEC>) * kThreads;
  e = allow_smem(splat_direct_kernel<NT, SPEC>, direct_smem);
  if (e != cudaSuccess) return e;
  if (seg == nullptr) {
    splat_direct_kernel<NT, SPEC>
        <<<(unsigned)blocks, kThreads, direct_smem, s>>>(coords, rows, w, p,
                                                         nullptr, nullptr, 0);
  } else {
    if (tiles < 1 || tiles > 0x7fffffffLL)
      return cudaErrorInvalidConfiguration;
    const size_t smem = patch_bytes(g.E);
    e = allow_smem(splat_box_kernel<NT, SPEC>, smem);
    if (e != cudaSuccess) return e;
    splat_box_kernel<NT, SPEC>
        <<<dim3((unsigned)tiles, rows_y(p.C)), kThreads, smem, s>>>(
            coords, rows, seg, w, p, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    // the outliers: a grid-stride pass over their range, read on the card
    splat_direct_kernel<NT, SPEC><<<264, kThreads, direct_smem, s>>>(
        coords, rows, w, p, keys, seg, tiles);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_convert(w, out, S, nvox, s);
}

}  // namespace

extern "C" int interpol_splat(const float* coords, const float* rows,
                              const float* coords_orig,
                              const float* vals_orig, long long n_orig,
                              const int* keys, const long long* seg,
                              void* ws, float* out, const PointParams* p,
                              const SplatGeom* g, int spec, void* stream) {
  const int nt = max_nt(p);
  if (nt == 0 || spec < 0 || spec > 2 || coords == nullptr ||
      rows == nullptr || coords_orig == nullptr || vals_orig == nullptr ||
      n_orig < 1 || p->P < 1 ||
      ws == nullptr || out == nullptr || (seg == nullptr) != (keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const Workspace w = workspace(
      ws, p->B * p->C, (long long)p->shape[0] * p->shape[1] * p->shape[2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define INTERPOL_SPLAT_CASE(N, S)                                           \
  case N * 3 + S:                                                           \
    err = launch_splat<N, S>(coords, rows, coords_orig, vals_orig, n_orig,  \
                             keys, seg, w, out, *p, *g, s);                 \
    break;
#define INTERPOL_SPLAT_NT(N) \
  INTERPOL_SPLAT_CASE(N, 0) INTERPOL_SPLAT_CASE(N, 1) INTERPOL_SPLAT_CASE(N, 2)
  switch (nt * 3 + spec) {
    INTERPOL_SPLAT_NT(1)
    INTERPOL_SPLAT_NT(2)
    INTERPOL_SPLAT_NT(3)
    INTERPOL_SPLAT_NT(4)
    INTERPOL_SPLAT_NT(5)
    INTERPOL_SPLAT_NT(6)
    INTERPOL_SPLAT_NT(7)
    INTERPOL_SPLAT_NT(8)
    default: err = cudaErrorInvalidValue; break;
  }
#undef INTERPOL_SPLAT_NT
#undef INTERPOL_SPLAT_CASE
  return (int)err;
}
