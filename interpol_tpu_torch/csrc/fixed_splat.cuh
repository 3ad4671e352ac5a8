// The order-independent splat shared by the dense-warp push (push.cu) and
// the scattered splat (splat.cu): every tap is rounded to a 64-bit
// fixed-point integer and added with integer atomics.
//
// Why: a float sum depends on the order of its terms, so a float atomicAdd
// splat gives other bits on every run.  Integer addition is associative and
// exact, so the same taps give the same bits in any order, on any schedule
// and under any launch geometry, as the JAX package's race-free splats do.
// Steps of one splat, all on the card's stream, no host sync:
//
//   1. the scale: per slice (b, c), S = mass * sum |v| over the values of
//      the items that the splat keeps bounds the absolute sum any voxel of
//      the slice can receive (mass: the spec's largest tap mass per item,
//      below); k = 62 - ceil(log2 S), the slice's taps are scaled by 2^k.
//      Every partial sum, in any order, then stays below 2^63.  An item is
//      a scattered point or a dense site.  keep_kernel runs the keep test
//      that the splat kernels call (point_kept: the extrapolation mask;
//      site_kept: the mask and the window test) once per item, on the
//      caller's coordinates in their original order, into a bit per item
//      (kept in the output, which step 3 overwrites, where they fit); so a
//      box sort or a site tile never reaches S.  An item the splat
//      drops adds nothing to S either: whatever its value (1e30, inf, NaN),
//      the rest of the slice keeps the bits it has without it.
//      scale_kernel sums in float64 in a fixed order (128 chunks of the
//      slice's values, a fixed tree in each, the last block of a slice sums
//      the chunks), so k depends on the values and the keep bits alone;
//      where every item is kept, S has the bits of the sum over every
//      value;
//   2. the splat kernels round each tap t (float32, the product of the
//      value scaled by 2^k and the unfolded factors, in the column form
//      below) to q = rint(t), an int64 (scaling a float32 by a power of
//      two is exact), and add q to a
//      patch in shared memory or to the accumulator (B, C, *oshape) int64
//      in device memory (the wrapper zeroes it); a patch is flushed to the
//      accumulator, each non-zero cell once, folded through the bounds per
//      axis, its sign applied to the integer (rint is odd, so -q is the
//      rounding of -t and a folded tap gives the same bits either way);
//   3. convert_kernel: out = acc * 2^-k in float32, the only pass over the
//      output.
//
// Precision: a voxel's sum is exact up to half a quantum (2^-k <= 2 S
// 2^-62) per tap that reaches it, besides the float32 rounding of each tap
// and of the result: an absolute error per slice, where a float sum's is
// relative per voxel.  A non-finite value of a kept item of slice (b, c)
// (S not finite), or a non-finite coordinate of a kept point of batch b
// (scattered; a dense site with one fails the window test), makes the whole
// output slice NaN; a dropped item's value never does.
//
// Launch geometry: slices, channels and batches run on grid-stride loops
// over gridDim.y (at most 65535), so no count of them is refused.
//
// Tap masses (sum over an axis's taps of |factor|): the weights are
// non-negative and sum to 1 at every order; a first derivative is a
// difference of two order-1-lower weight rows, so its mass is at most 2 (2
// at order 1, 0 at order 0); a second derivative is a row combination (1,
// -2, 1), mass at most 4 (4 at order 2, 0 at orders 0-1).  So per item: push
// 1 |v|, pushgrad 2 (|vx| + |vy| + |vz|), pushhess 4 sum |v_ij| (d_i d_j
// has mass 2 x 2).
//
// 64-bit shared-memory atomics: on sm_90a an atomicAdd on an unsigned long
// long in shared memory compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64 in cuobjdump -sass of the build; global ones are one
// REDG.E.ADD.64).  So a patch cell is two 32-bit words, each added with the
// native ATOMS.ADD: the low word's add returns its old value, whose carry
// goes into the high word's add (skipped when that is 0).  The 64-bit sum
// is exact in any order of the adds.

#pragma once

#include "spline_taps.cuh"

// The dense push's site tiles (push.cu); the scattered box splat uses T,
// lo, E, NB with boxes of points.  E[0] == 0: no patch, every tap goes
// straight to the accumulator.
struct SplatGeom {
  int T[3];    // tile core (items anchored in a core)
  int lo[3];   // least tap offset from the core's first index
  int E[3];    // patch extent: the core plus the taps' reach
  int NB[3];   // tiles per axis
};

namespace {

constexpr int kChunks = 128;   // scale partial sums per slice
constexpr int kThreads = 256;  // threads of every splat block

// SPEC 0: push (1 value, weights); 1: pushgrad (3 values, weights and first
// derivatives); 2: pushhess (6 values xx, yy, zz, xy, xz, yz, the symmetric
// pairs of the cotangent summed; weights, first and second derivatives).
template <int SPEC> struct Spec {
  static constexpr int NV = SPEC == 0 ? 1 : (SPEC == 1 ? 3 : 6);
  static constexpr float kMass = SPEC == 0 ? 1.f : (SPEC == 1 ? 2.f : 4.f);
};

// Workspace of one splat, zeroed by the wrapper: acc (S * V int64), then
// the scale partials (S * kChunks float64), then per slice the finished
// chunk count, the non-finite flag and k (3 x S uint32), then, where they
// do not fit the output (S x V float32, which keeps them until
// convert_kernel overwrites it), the keep bits of the items (B x words
// uint32, written whole by keep_kernel).
struct Workspace {
  unsigned long long* acc;
  double* partial;
  unsigned* done;
  unsigned* bad;
  int* kexp;
  unsigned* keep;  // the tail
};

__host__ __device__ inline Workspace workspace(void* base, long long S,
                                               long long V) {
  Workspace w;
  w.acc = static_cast<unsigned long long*>(base);
  w.partial = reinterpret_cast<double*>(w.acc + S * V);
  w.done = reinterpret_cast<unsigned*>(w.partial + S * kChunks);
  w.bad = w.done + S;
  w.kexp = reinterpret_cast<int*>(w.bad + S);
  w.keep = reinterpret_cast<unsigned*>(w.kexp + S);
  return w;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// k = 62 - ceil(log2 S), at most 127 (so 2^k is a normal float32: a slice
// of tiny values keeps a quantum of 2^-127); 0 for S = 0.
__device__ __forceinline__ int scale_exp(double S) {
  if (!(S > 0.0)) return 0;
  int e;
  const double m = frexp(S, &e);
  return min(62 - (m == 0.5 ? e - 1 : e), 127);
}

// The keep test of a scattered point at g (splat.cu and the scale pass):
// the extrapolation mask.
__device__ __forceinline__ bool point_kept(const PointParams& p,
                                           const float* g) {
  return !p.masked || inside(g[0], g[1], g[2], p.thr_lo, p.thr_hi);
}

// The keep test of a dense site at pos whose sample is g (push.cu and the
// scale pass): the mask, then on each axis the window test of its node
// origin's offset d0 = n0 - pos, shifted by ``sh`` (the base of the site's
// TPU tile in adaptive mode, warp.cu's tile_shift; 0 otherwise).  Written
// so that a NaN coordinate fails it.
__device__ __forceinline__ bool site_kept(const WarpParams& p, const float* g,
                                          const int* pos, const int* sh) {
  if (p.masked && !inside(g[0], g[1], g[2], p.thr_lo, p.thr_hi))
    return false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float d0 = node_origin(g[d], p.order[d]) - (float)pos[d];
    if (!(d0 >= (float)(p.d0min[d] + sh[d]) &&
          d0 <= (float)(p.d0max[d] + sh[d])))
      return false;
  }
  return true;
}

// The items of a scale pass, by (batch, item index in original order
// within the batch, of the keep pass's index type I).  Dense push: the
// sites of the lifted grid (B, X, Y, Z, 3).
struct SiteItems {
  const float* grid;
  WarpParams p;
  bool all_kept() const { return false; }
  template <class I>
  __device__ __forceinline__ bool kept(long long b, I r) const {
    const I YZ = (I)p.shape[1] * p.shape[2];
    const I x = r / YZ, ryz = r - x * YZ, y = ryz / p.shape[2];
    const int pos[3] = {(int)x, (int)y, (int)(ryz - y * p.shape[2])};
    const float* gp = grid + 3 * ((long long)b * p.shape[0] * YZ + r);
    const float g[3] = {__ldg(gp), __ldg(gp + 1), __ldg(gp + 2)};
    int sh[3];
    tile_shift(p, b, pos[0], pos[1], pos[2], sh);
    return site_kept(p, g, pos, sh);
  }
};

// Scattered splat: the points of the cloud (B*P, 3) in input order.
struct PointItems {
  const float* coords;
  PointParams p;
  bool all_kept() const { return !p.masked; }
  template <class I>
  __device__ __forceinline__ bool kept(long long b, I k) const {
    const float* gp = coords + 3 * ((long long)b * p.P + k);
    const float g[3] = {__ldg(gp), __ldg(gp + 1), __ldg(gp + 2)};
    return point_kept(p, g);
  }
};

// The first pass of the scale (skipped where every item is kept; the
// bits are then null): the keep test of every item once, at full
// occupancy, as bits (B, words), 32 items a word (a warp's ballot).
// Batches on a grid-stride loop over y (64-bit), a batch's items over x;
// the loop runs over whole warps (32 divides words x 32), so every lane
// takes part in each ballot.  I: the index of an item within its batch,
// int unless a batch holds more than 2^31 - 2^21 items.
template <class Items, class I>
__global__ void __launch_bounds__(kThreads)
    keep_kernel(Items items, long long B, I n_items, I words,
                unsigned* __restrict__ bits) {
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    unsigned* row = bits + b * words;
    for (I k = (I)blockIdx.x * kThreads + threadIdx.x; k < words * 32;
         k += (I)gridDim.x * kThreads) {
      // the test unconditional (k clamped), so that its loads overlap
      const bool kept = items.kept(b, k < n_items ? k : n_items - 1);
      const unsigned word = __ballot_sync(0xffffffffu, kept && k < n_items);
      if ((k & 31) == 0) row[k >> 5] = word;
    }
  }
}

// Chunk [i0, i1) of a slice's values v: thread t's sum of |v| over the
// kept items' values i0 + t, i0 + t + 256, ... in float64, in that order.
// BITS: read the keep bits (keep, words of the slice's batch) of item j /
// vpi (ONE: vpi is 1; else the item carried from step to step in 32 bits,
// launch_scale refusing a batch of 2^32 items or more); a dropped item
// adds 0.0, a no-op on the non-negative sum, so where every item is kept
// the sum has the bits of one over every value.  The choices are template
// arguments: a runtime branch in this loop, or 64-bit index steps, stop
// its loads from overlapping (2-4x slower on the H100).
template <bool BITS, bool ONE>
__device__ __forceinline__ double chunk_sum(const float* __restrict__ v,
                                            const unsigned* __restrict__ keep,
                                            long long vpi, long long i0,
                                            long long i1) {
  double acc = 0.0;
  const long long j0 = i0 + threadIdx.x;
  const unsigned d = (unsigned)vpi, step = kThreads / d,
                 sr = kThreads - step * d;
  unsigned item = 0, rem = 0;
  if constexpr (BITS && !ONE) {
    item = (unsigned)(j0 / vpi);
    rem = (unsigned)(j0 - (long long)item * vpi);
  }
  for (long long j = j0; j < i1; j += kThreads) {
    const float x = __ldg(v + j);
    bool in = true;
    if constexpr (BITS) {
      const long long it = ONE ? j : (long long)item;
      in = (__ldg(keep + (it >> 5)) >> (it & 31)) & 1u;
      if constexpr (!ONE) {
        item += step;
        rem += sr;
        const bool wrap = rem >= d;
        rem -= wrap ? d : 0;
        item += wrap;
      }
    }
    acc += in ? fabs((double)x) : 0.0;
  }
  return acc;
}

// vals (S, n), S = B x C slices on a grid-stride loop over y, the values
// of an item next to each other (vpi values an item).  Block (chunk
// blockIdx.x, slice s) sums its chunk (chunk_sum), then a fixed tree; the
// slice's last block sums the chunks in order and writes k and the
// non-finite flag.
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const float* __restrict__ vals, long long S, long long C,
                 long long n, long long vpi, const unsigned* __restrict__ bits,
                 long long words, float mass, Workspace w) {
  __shared__ double part[kThreads / 32];
  __shared__ bool last;
  const long long per = (n + kChunks - 1) / kChunks;
  const long long i0 = blockIdx.x * per, i1 = min(n, i0 + per);
  for (long long s = blockIdx.y; s < S; s += gridDim.y) {
    const float* v = vals + s * n;
    const unsigned* keep = bits ? bits + (s / C) * words : nullptr;
    double acc;
    if (keep == nullptr)
      acc = chunk_sum<false, true>(v, keep, vpi, i0, i1);
    else if (vpi == 1)
      acc = chunk_sum<true, true>(v, keep, vpi, i0, i1);
    else
      acc = chunk_sum<true, false>(v, keep, vpi, i0, i1);
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = 0.0;
#pragma unroll
      for (int j = 0; j < kThreads / 32; ++j) t += part[j];
      w.partial[s * kChunks + blockIdx.x] = t;
      __threadfence();
      last = atomicAdd(w.done + s, 1u) == kChunks - 1;
    }
    __syncthreads();
    if (last && threadIdx.x < 32) {
      __threadfence();
      double t = 0.0;
      for (int j = threadIdx.x; j < kChunks; j += 32)
        t += __ldcg(w.partial + s * kChunks + j);
      t = warp_sum(t) * (double)mass;
      if (threadIdx.x == 0) {
        const int k = scale_exp(t);
        w.kexp[s] = max(k, -126);
        if (!isfinite(t) || k < -126) w.bad[s] = 1u;
      }
    }
    __syncthreads();  // part and last are reused
  }
}

// 2^k as a float32, k in [-126, 127].
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((k + 127) << 23);
}

// The values of an item times its slice's scale 2^k: exact (no result
// leaves float32's range: |v| 2^k <= S 2^k <= 2^62, and a product that
// would fall below the normal range rounds to 0 quanta either way), so a
// tap computed from them is already in quanta.
template <int SPEC>
__device__ __forceinline__ void scaled(float* vs, const float* v,
                                       float scale) {
#pragma unroll
  for (int r = 0; r < Spec<SPEC>::NV; ++r) vs[r] = v[r] * scale;
}

// out (S, V) = acc * 2^-k per slice, NaN over a flagged slice; slices on a
// grid-stride loop over y.
__global__ void __launch_bounds__(kThreads)
    convert_kernel(Workspace w, float* __restrict__ out, long long S,
                   long long V) {
  for (long long s = blockIdx.y; s < S; s += gridDim.y) {
    const double inv = ldexp(1.0, -w.kexp[s]);
    const bool nan = w.bad[s] != 0u;
    const long long* acc = reinterpret_cast<const long long*>(w.acc) + s * V;
    float* o = out + s * V;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < V;
         i += (long long)gridDim.x * kThreads)
      o[i] = nan ? __int_as_float(0x7fc00000) : (float)((double)acc[i] * inv);
  }
}

// gridDim.y of a grid-stride loop over n rows.
inline unsigned rows_y(long long n) {
  return (unsigned)(n < 65535 ? n : 65535);
}

// The scale of B x C slices of n values each, vpi values an item: the keep
// bits (in the output out, S x V float32, where they fit; none where every
// item is kept, as in an unmasked cloud), then the sums.  Refuses a batch
// of 2^32 items or more with several values an item (32 GiB of values and
// 48 GiB of coordinates, more than the card holds).
template <class Items>
cudaError_t launch_scale(const float* vals, long long B, long long C,
                         long long n, long long vpi, float mass,
                         const Items& items, const Workspace& w, float* out,
                         long long V, cudaStream_t s) {
  if (B < 1 || C < 1 || n < 1 || vpi < 1 || n % vpi != 0 ||
      (vpi > 1 && n / vpi > 0xffffffffLL))
    return cudaErrorInvalidConfiguration;
  const long long n_items = n / vpi, words = (n_items + 31) / 32;
  unsigned* bits = nullptr;
  if (!items.all_kept()) {
    bits = B * words <= B * C * V ? reinterpret_cast<unsigned*>(out) : w.keep;
    const dim3 blocks(
        (unsigned)min((words * 32 + kThreads - 1) / kThreads, 8192LL),
        rows_y(B));
    // int where a batch's item index plus the stride fits it
    if (words * 32 <= (1LL << 31) - 8192LL * kThreads)
      keep_kernel<Items, int><<<blocks, kThreads, 0, s>>>(
          items, B, (int)n_items, (int)words, bits);
    else
      keep_kernel<Items, long long><<<blocks, kThreads, 0, s>>>(
          items, B, n_items, words, bits);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  scale_kernel<<<dim3(kChunks, rows_y(B * C)), kThreads, 0, s>>>(
      vals, B * C, C, n, vpi, bits, words, mass, w);
  return cudaGetLastError();
}

cudaError_t launch_convert(const Workspace& w, float* out, long long S,
                           long long V, cudaStream_t s) {
  const long long blocks = min((V + kThreads - 1) / kThreads, 2048LL);
  convert_kernel<<<dim3((unsigned)blocks, rows_y(S)), kThreads, 0, s>>>(
      w, out, S, V);
  return cudaGetLastError();
}

// One item's taps: the node origin per axis (index) and the unfolded
// factors per axis and tap (weights w, first derivatives d, second h), as
// ops/splines.py computes them (the Cox-de Boor recursion of
// spline_taps.cuh).  Dense and scattered splats share it, so the same item
// gives the same float32 taps in both.
template <int NT, int SPEC>
struct ItemTaps {
  int n0[3];
  float w[3][NT], d[3][NT], h[3][NT];
};

// Stage axis dim of an item at coordinate g: its node origin and factors.
template <int NT, int SPEC>
__device__ __forceinline__ void stage_axis(ItemTaps<NT, SPEC>& it, int dim,
                                           float g, int order) {
  const float n0f = node_origin(g, order);
  it.n0[dim] = node_index(n0f);
  axis_weights<NT, (SPEC >= 1), (SPEC == 2)>(g - n0f, order, it.w[dim],
                                              it.d[dim], it.h[dim]);
}

// The taps of one column (jy, jz) of an item, as up to three constants
// against which tap jx is a product with the x factors: push a = vs wy wz
// (tap wx a); pushgrad a = vs0 wy wz, b = vs1 w'y wz + vs2 wy w'z (tap w'x
// a + wx b); pushhess a = vxx wy wz, b = vyy w''y wz + vzz wy w''z + vyz
// w'y w'z, c = vxy w'y wz + vxz wy w'z (tap w''x a + wx b + w'x c).
// ``it``: ItemTaps or any struct with the factor arrays w, d, h; ``vs``:
// the scaled values.  Every kernel forms its taps with these two
// functions, so the same item gives the same integers in every kernel.
struct Column {
  float a, b, c;
};

template <int SPEC, typename Taps>
__device__ __forceinline__ Column column(const Taps& it, const float* vs,
                                         int jy, int jz) {
  Column col;
  const float wy = it.w[1][jy], wz = it.w[2][jz];
  col.a = vs[0] * (wy * wz);
  if constexpr (SPEC >= 1) {
    const float dy = it.d[1][jy], dz = it.d[2][jz];
    if constexpr (SPEC == 1) {
      col.b = vs[1] * (dy * wz) + vs[2] * (wy * dz);
    } else {
      const float hy = it.h[1][jy], hz = it.h[2][jz];
      col.b = vs[1] * (hy * wz) + vs[2] * (wy * hz) + vs[5] * (dy * dz);
      col.c = vs[3] * (dy * wz) + vs[4] * (wy * dz);
    }
  }
  return col;
}

// Tap jx of a column, rounded to quanta (half to even).
template <int SPEC, typename Taps>
__device__ __forceinline__ unsigned long long column_tap(const Taps& it,
                                                         const Column& col,
                                                         int jx) {
  const float wx = it.w[0][jx];
  float t;
  if constexpr (SPEC == 0) {
    t = wx * col.a;
  } else if constexpr (SPEC == 1) {
    t = it.d[0][jx] * col.a + wx * col.b;
  } else {
    t = it.h[0][jx] * col.a + wx * col.b + it.d[0][jx] * col.c;
  }
  return (unsigned long long)__float2ll_rn(t);
}

// cell += q, the cell as two 32-bit words in shared memory (see above).
__device__ __forceinline__ void shared_add(unsigned* lo, unsigned* hi,
                                           unsigned long long q) {
  const unsigned ql = (unsigned)q;
  const unsigned old = atomicAdd(lo, ql);
  const unsigned h = (unsigned)(q >> 32) + (old + ql < old ? 1u : 0u);
  if (h != 0u) atomicAdd(hi, h);
}

// The shared patch of a block: per cell a low and a high word, then per
// axis the folded index (int) and sign (int8) of each patch cell.
struct PatchSmem {
  unsigned* lo;
  unsigned* hi;
  int* idx[3];
  signed char* sgn[3];
};

// Add an item's taps to a shared patch of extents (., Ey, Ez) whose cell 0
// is unfolded index ``origin``; every tap lies inside (the caller's
// geometry guarantees it).
template <int NT, int SPEC>
__device__ __forceinline__ void patch_add(const PatchSmem& patch,
                                          const ItemTaps<NT, SPEC>& it,
                                          const float* v, const int* order,
                                          const int* origin, int Ey, int Ez,
                                          float scale) {
  const int lx = it.n0[0] - origin[0], ly = it.n0[1] - origin[1];
  const int lz = it.n0[2] - origin[2];
  const int plane = Ey * Ez;
  float vs[Spec<SPEC>::NV];
  scaled<SPEC>(vs, v, scale);
#pragma unroll
  for (int jy = 0; jy < NT; ++jy) {
    if (jy > order[1]) break;
#pragma unroll
    for (int jz = 0; jz < NT; ++jz) {
      if (jz > order[2]) break;
      const Column col = column<SPEC>(it, vs, jy, jz);
      const int cell = (lx * Ey + ly + jy) * Ez + lz + jz;
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        if (jx > order[0]) break;
        shared_add(patch.lo + cell + jx * plane, patch.hi + cell + jx * plane,
                   column_tap<SPEC>(it, col, jx));
      }
    }
  }
}

// Fold an item's taps through the bounds of a volume of shape n (X, Y,
// Z): per axis the voxel offsets, the sign in the factors (fold_taps) and
// the taps of non-zero sign (bit j of live).
template <int NT, int SPEC>
struct Folded {
  long long off[3][NT];
  unsigned live[3];
};

template <int NT, int SPEC>
__device__ __forceinline__ void fold_item(ItemTaps<NT, SPEC>& it,
                                          Folded<NT, SPEC>& f,
                                          const int* order, const int* n,
                                          const int* bound) {
  const long long stride[3] = {(long long)n[1] * n[2], (long long)n[2], 1LL};
#pragma unroll
  for (int d = 0; d < 3; ++d)
    fold_taps<NT, (SPEC >= 1), (SPEC == 2)>(it.n0[d], n[d], order[d],
                                             bound[d], stride[d], f.off[d],
                                             it.w[d], it.d[d], it.h[d],
                                             f.live[d]);
}

// Add a folded item's taps straight to the slice ``acc``.
template <int NT, int SPEC>
__device__ __forceinline__ void direct_add(unsigned long long* acc,
                                           const ItemTaps<NT, SPEC>& it,
                                           const Folded<NT, SPEC>& f,
                                           const float* v, const int* order,
                                           float scale) {
  float vs[Spec<SPEC>::NV];
  scaled<SPEC>(vs, v, scale);
#pragma unroll
  for (int jy = 0; jy < NT; ++jy) {
    if (jy > order[1]) break;
    if (!((f.live[1] >> jy) & 1u)) continue;
#pragma unroll
    for (int jz = 0; jz < NT; ++jz) {
      if (jz > order[2]) break;
      if (!((f.live[2] >> jz) & 1u)) continue;
      const Column col = column<SPEC>(it, vs, jy, jz);
      unsigned long long* cell = acc + f.off[1][jy] + f.off[2][jz];
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        if (jx > order[0]) break;
        if (!((f.live[0] >> jx) & 1u)) continue;
        atomicAdd(cell + f.off[0][jx], column_tap<SPEC>(it, col, jx));
      }
    }
  }
}

// Shared memory of a patch block (PatchSmem).
__host__ __device__ inline size_t patch_bytes(const int* E) {
  const size_t cells = (size_t)E[0] * E[1] * E[2];
  const size_t sumE = (size_t)E[0] + E[1] + E[2];
  return cells * 8 + sumE * 5;
}

// Carve the block's shared memory, zero the patch and fold each axis's
// cells [origin, origin + E) through the bound (ops/bounds.py), as the
// gathers fold their taps.  Ends with __syncthreads.
__device__ __forceinline__ PatchSmem patch_begin(void* smem, const int* E,
                                                 const int* origin,
                                                 const int* n,
                                                 const int* bound) {
  PatchSmem p;
  const int cells = E[0] * E[1] * E[2];
  p.lo = static_cast<unsigned*>(smem);
  p.hi = p.lo + cells;
  int* ip = reinterpret_cast<int*>(p.hi + cells);
  p.idx[0] = ip;
  p.idx[1] = ip + E[0];
  p.idx[2] = ip + E[0] + E[1];
  signed char* sp = reinterpret_cast<signed char*>(ip + E[0] + E[1] + E[2]);
  p.sgn[0] = sp;
  p.sgn[1] = sp + E[0];
  p.sgn[2] = sp + E[0] + E[1];
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) p.lo[i] = 0u;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    for (int l = threadIdx.x; l < E[d]; l += blockDim.x) {
      const int u = origin[d] + l;
      p.idx[d][l] = fold_index(u, n[d], bound[d]);
      p.sgn[d][l] = (signed char)fold_sign(u, n[d], bound[d]);
    }
  __syncthreads();
  return p;
}

// After the items: add each non-zero cell to its folded voxel of the slice
// ``acc`` (Y, Z its last extents), the fold sign applied to the integer.
// The adds' results are unused, so they compile to reductions (RED).
__device__ __forceinline__ void patch_flush(const PatchSmem& p, const int* E,
                                            unsigned long long* acc, int Y,
                                            int Z) {
  __syncthreads();
  const int plane = E[1] * E[2];
  const int cells = E[0] * plane;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long q =
        ((unsigned long long)p.hi[i] << 32) | p.lo[i];
    if (q == 0ull) continue;
    const int lx = i / plane, r = i - lx * plane;
    const int ly = r / E[2], lz = r - ly * E[2];
    const int sgn = p.sgn[0][lx] * p.sgn[1][ly] * p.sgn[2][lz];
    if (sgn == 0) continue;
    atomicAdd(acc + ((long long)p.idx[0][lx] * Y + p.idx[1][ly]) * Z +
                  p.idx[2][lz],
              sgn > 0 ? q : 0ull - q);
  }
}

// Allow a block more than the default 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
