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
// Why not atomics: an atomicAdd splat sums each voxel's taps in an order
// that changes from run to run, so grid_push and every image gradient of
// grid_pull would differ between runs in the last bits.  This kernel keeps
// the TPU's box design, done in shared memory (patch_splat.cuh, whose
// notes describe it):
//   - the host sorts the points by box key (ops/scattered.py: one
//     torch.sort, searchsorted segment starts); a box is a T^3 core of
//     voxels, and a point belongs to the box of floor(g);
//   - one warp per (box, channel) reads its segment in sorted order, 32
//     points at a time, one per lane, and accumulates their taps into a
//     patch in shared memory: the core plus the spline support on each side
//     (cubic, T=16: 21^3 floats, 37 KB), all lanes at the same tap;
//   - overlap_fold_kernel sums the patches per output voxel in a fixed
//     order and folds them through the bounds;
//   - outliers, the points outside [0, n-1] on some axis that the mask
//     keeps, are the last segment: outlier_taps_kernel folds each of their
//     taps directly into (destination, contribution) pairs, the host sorts
//     the pairs by destination (stable, so ties keep point order), and
//     segsum_kernel adds each destination's run, in order, to the output.
//     No point is dropped or handed to the plain version.
// A template SPEC selects push (1 value row), pushgrad (3 rows, first
// derivative taps) and pushhess (6 rows: xx, yy, zz and the summed
// symmetric pairs xy, xz, yz), as the JAX spec does (scattered.py:1359).
//
// What bounds it on this card: one __syncwarp and one shared-memory
// read-modify-write per tap step, (order+1)^3 steps for 32 points; the
// host's sort of the keys; and the patch scratch written once and read
// once (2.3x the output at 16^3 cores and cubic order).  The least traffic
// is the points, values and output once: 83 MB for 1M points into 256^3.
//
// C interface (loaded with ctypes by ops/cuda_scattered.py):
//   int interpol_splat(const float* coords, const float* vals,
//                      const long long* seg, float* scratch, float* out,
//                      const PointParams* p, const PatchGeom* g, int spec,
//                      void* stream);
//   int interpol_splat_outliers(const float* coords, const float* vals,
//                               const int* keys, long long begin,
//                               long long count, long long key_base,
//                               long long* dest, float* contrib,
//                               const PointParams* p, int spec,
//                               void* stream);
//   int interpol_splat_segsum(const long long* dest, const float* contrib,
//                             long long count, float* out,
//                             const PointParams* p, void* stream);
// coords (B*P, 3) and vals (C, NV, B*P) in sorted order, keys the sorted
// box keys, seg (B*tiles + 1) segment starts; scratch (C, B, tiles, E0,
// E1, E2); out (B, C, X, Y, Z); dest (count * NT^3) and contrib (C, count
// * NT^3) for the outliers (NT = largest order + 1); all contiguous.
// Each returns the first failing cudaError_t.

#include "patch_splat.cuh"

namespace {

template <int NT, int SPEC>
__global__ void __launch_bounds__(kWarp)
    splat_patch_kernel(const float* __restrict__ coords,
                       const float* __restrict__ vals,
                       const long long* __restrict__ seg,
                       float* __restrict__ scratch, const PointParams p,
                       const PatchGeom g) {
  extern __shared__ float patch[];
  constexpr int NV = Spec<SPEC>::NV;
  const int lane = threadIdx.x;
  const long long ntot = p.B * p.P;
  const long long ntile = (long long)g.NB[0] * g.NB[1] * g.NB[2];
  const long long bt = blockIdx.x;  // b * ntile + tile
  const long long tile = bt % ntile;
  const long long c = blockIdx.y;
  const int tix[3] = {(int)(tile / ((long long)g.NB[1] * g.NB[2])),
                      (int)((tile / g.NB[2]) % g.NB[1]),
                      (int)(tile % g.NB[2])};
  int origin[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) origin[d] = tix[d] * g.T[d] + g.lo[d];
  const long long k0 = seg[bt], k1 = seg[bt + 1];
  const long long psize = (long long)g.E[0] * g.E[1] * g.E[2];
  float* dst = scratch + (c * g.B * ntile + bt) * psize;
  const int order[3] = {p.order[0], p.order[1], p.order[2]};
  // this block's x-slab of the patch
  const int x0 = blockIdx.z * g.xslab;
  const int ex = min(g.xslab, g.E[0] - x0);
  const int count = ex * g.E[1] * g.E[2];
  zero_slab(patch, count);
  for (long long base = k0; base < k1; base += kWarp) {
    const long long k = base + lane;
    Item<NT, SPEC> it;
    it.live = false;
    it.n0[0] = it.n0[1] = it.n0[2] = 0;
    if (k < k1) {
      bool live = true;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (!live) break;
        const float gd = coords[3 * k + d];
        const float n0f = node_origin(gd, order[d]);
        const int l = node_index(n0f) - origin[d];
        // every tap inside the patch (the host's margins guarantee it)
        live = l >= 0 && l + order[d] < g.E[d];
        if (live) {
          it.n0[d] = l;
          stage_axis<NT, SPEC>(it, d, gd - n0f, order[d]);
        }
      }
#pragma unroll
      for (int r = 0; r < NV; ++r) it.v[r] = vals[(c * NV + r) * ntot + k];
      it.live = live;
    }
    splat_round<NT, SPEC>(patch, it, order, x0, ex, g.E[1], g.E[2]);
  }
  store_slab(dst + (long long)x0 * g.E[1] * g.E[2], patch, count);
}

// One thread per outlier point: its taps folded through the bounds, as
// (destination b * V + voxel, contribution per channel) pairs; taps past
// the axis order or with fold sign 0 get destination -1.
template <int NT, int SPEC>
__global__ void __launch_bounds__(128)
    outlier_taps_kernel(const float* __restrict__ coords,
                        const float* __restrict__ vals,
                        const int* __restrict__ keys, long long begin,
                        long long count, long long key_base,
                        long long* __restrict__ dest,
                        float* __restrict__ contrib, const PointParams p) {
  constexpr bool D1 = SPEC >= 1, D2 = SPEC == 2;
  constexpr int NV = Spec<SPEC>::NV, NT3 = NT * NT * NT;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  const long long k = begin + j;
  const long long b = keys[k] - key_base;
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const long long nvox = (long long)X * Y * Z;
  const long long ntot = p.B * p.P;
  long long o[3][NT];
  float w[3][NT], dw[3][NT], hw[3][NT];
  unsigned live[3];
  const long long stride[3] = {(long long)Y * Z, (long long)Z, 1LL};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float gd = coords[3 * k + d];
    const float n0f = node_origin(gd, p.order[d]);
    axis_weights<NT, D1, D2>(gd - n0f, p.order[d], w[d], dw[d], hw[d]);
    fold_taps<NT, D1, D2>(node_index(n0f), p.shape[d], p.order[d],
                          p.bound[d], stride[d], o[d], w[d], dw[d], hw[d],
                          live[d]);
  }
  for (int jx = 0; jx < NT; ++jx) {
    for (int jy = 0; jy < NT; ++jy) {
      for (int jz = 0; jz < NT; ++jz) {
        const long long idx = j * NT3 + (jx * NT + jy) * NT + jz;
        const bool on = jx <= p.order[0] && jy <= p.order[1] &&
                        jz <= p.order[2] && ((live[0] >> jx) & 1u) &&
                        ((live[1] >> jy) & 1u) && ((live[2] >> jz) & 1u);
        dest[idx] = on ? b * nvox + o[0][jx] + o[1][jy] + o[2][jz] : -1;
        for (long long c = 0; c < p.C; ++c) {
          float v[NV];
#pragma unroll
          for (int r = 0; r < NV; ++r) v[r] = vals[(c * NV + r) * ntot + k];
          contrib[c * count * NT3 + idx] =
              on ? spec_coef<SPEC>(v, w[0][jx], w[1][jy], w[2][jz],
                                   dw[0][jx], dw[1][jy], dw[2][jz],
                                   hw[0][jx], hw[1][jy], hw[2][jz])
                 : 0.f;
        }
      }
    }
  }
}

// One thread per run of equal destinations in the sorted pairs: adds the
// run, in order, to the output (each destination has one run: no race).
__global__ void __launch_bounds__(256)
    segsum_kernel(const long long* __restrict__ dest,
                  const float* __restrict__ contrib, long long count,
                  float* __restrict__ out, const PointParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const long long d = dest[i];
  if (d < 0 || (i > 0 && dest[i - 1] == d)) return;
  const long long nvox = (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const long long b = d / nvox, r = d - b * nvox;
  for (long long c = 0; c < p.C; ++c) {
    const float* src = contrib + c * count;
    float acc = 0.f;
    for (long long k = i; k < count && dest[k] == d; ++k) acc += src[k];
    out[(b * p.C + c) * nvox + r] += acc;
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
cudaError_t launch_splat(const float* coords, const float* vals,
                         const long long* seg, float* scratch, float* out,
                         const PointParams& p, const PatchGeom& g,
                         cudaStream_t s) {
  const long long tiles = p.B * (long long)g.NB[0] * g.NB[1] * g.NB[2];
  if (tiles < 1 || tiles > 0x7fffffffLL || p.C > 65535 || g.E[0] > 65535 * g.xslab)
    return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)g.xslab * g.E[1] * g.E[2] * sizeof(float);
  const int nslab = (g.E[0] + g.xslab - 1) / g.xslab;
  cudaError_t e = allow_smem(splat_patch_kernel<NT, SPEC>, smem);
  if (e != cudaSuccess) return e;
  splat_patch_kernel<NT, SPEC>
      <<<dim3((unsigned)tiles, (unsigned)p.C, (unsigned)nslab), kWarp,
         smem, s>>>(
          coords, vals, seg, scratch, p, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_overlap(scratch, out, g, s);
}

template <int NT, int SPEC>
cudaError_t launch_outliers(const float* coords, const float* vals,
                            const int* keys, long long begin,
                            long long count, long long key_base,
                            long long* dest, float* contrib,
                            const PointParams& p, cudaStream_t s) {
  const long long blocks = (count + 127) / 128;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  outlier_taps_kernel<NT, SPEC><<<(unsigned)blocks, 128, 0, s>>>(
      coords, vals, keys, begin, count, key_base, dest, contrib, p);
  return cudaGetLastError();
}

}  // namespace

#define INTERPOL_DISPATCH(FN, ...)                                   \
  switch (nt * 3 + spec) {                                           \
    case 3: err = FN<1, 0>(__VA_ARGS__); break;                      \
    case 4: err = FN<1, 1>(__VA_ARGS__); break;                      \
    case 5: err = FN<1, 2>(__VA_ARGS__); break;                      \
    case 6: err = FN<2, 0>(__VA_ARGS__); break;                      \
    case 7: err = FN<2, 1>(__VA_ARGS__); break;                      \
    case 8: err = FN<2, 2>(__VA_ARGS__); break;                      \
    case 9: err = FN<3, 0>(__VA_ARGS__); break;                      \
    case 10: err = FN<3, 1>(__VA_ARGS__); break;                     \
    case 11: err = FN<3, 2>(__VA_ARGS__); break;                     \
    case 12: err = FN<4, 0>(__VA_ARGS__); break;                     \
    case 13: err = FN<4, 1>(__VA_ARGS__); break;                     \
    case 14: err = FN<4, 2>(__VA_ARGS__); break;                     \
    case 15: err = FN<5, 0>(__VA_ARGS__); break;                     \
    case 16: err = FN<5, 1>(__VA_ARGS__); break;                     \
    case 17: err = FN<5, 2>(__VA_ARGS__); break;                     \
    case 18: err = FN<6, 0>(__VA_ARGS__); break;                     \
    case 19: err = FN<6, 1>(__VA_ARGS__); break;                     \
    case 20: err = FN<6, 2>(__VA_ARGS__); break;                     \
    case 21: err = FN<7, 0>(__VA_ARGS__); break;                     \
    case 22: err = FN<7, 1>(__VA_ARGS__); break;                     \
    case 23: err = FN<7, 2>(__VA_ARGS__); break;                     \
    case 24: err = FN<8, 0>(__VA_ARGS__); break;                     \
    case 25: err = FN<8, 1>(__VA_ARGS__); break;                     \
    default: err = FN<8, 2>(__VA_ARGS__); break;                     \
  }

extern "C" int interpol_splat(const float* coords, const float* vals,
                              const long long* seg, float* scratch,
                              float* out, const PointParams* p,
                              const PatchGeom* g, int spec, void* stream) {
  const int nt = max_nt(p);
  if (nt == 0 || spec < 0 || spec > 2 || seg == nullptr ||
      scratch == nullptr || out == nullptr || g->xslab < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  INTERPOL_DISPATCH(launch_splat, coords, vals, seg, scratch, out, *p, *g, s)
  return (int)err;
}

extern "C" int interpol_splat_outliers(const float* coords,
                                       const float* vals,
                                       const int* keys,
                                       long long begin, long long count,
                                       long long key_base, long long* dest,
                                       float* contrib, const PointParams* p,
                                       int spec, void* stream) {
  const int nt = max_nt(p);
  if (nt == 0 || spec < 0 || spec > 2 || count < 1 || dest == nullptr ||
      contrib == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  INTERPOL_DISPATCH(launch_outliers, coords, vals, keys, begin, count,
                    key_base, dest, contrib, *p, s)
  return (int)err;
}

extern "C" int interpol_splat_segsum(const long long* dest,
                                     const float* contrib, long long count,
                                     float* out, const PointParams* p,
                                     void* stream) {
  if (count < 1 || dest == nullptr || contrib == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (count + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  segsum_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(dest, contrib,
                                                            count, out, *p);
  return (int)cudaGetLastError();
}
