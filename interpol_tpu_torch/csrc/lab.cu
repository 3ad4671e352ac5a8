// The kernel lab on Hopper (sm_90a): rate probes of the card and a
// bf16-multiply variant of the dense pull.
//
// Replaces the Pallas functions of the JAX package's kernel lab
// (scripts/tpu_kernel_lab*.py).  They measured the TPU schedule of the
// dense pull and the rates that bound it; here they measure what bounds
// the port's kernels on this card.
//
// lab_fma<T, NACC>: replaces tpu_kernel_lab.py::fma_probe (:431, one chain
//   from 0), fma_probe2 (:343, 8 chains in a loop) and fma_probe3 (:372,
//   NACC chains unrolled).  Per element, NACC independent chains start at
//   a * (k + 1) (at 0 for fma_probe's one chain) and each takes reps / NACC
//   fused multiply-adds acc = a * b + acc; the chains are then summed in
//   order.  float: fmaf, one rounding (fma_probe's ``a + 1e-30`` guard
//   against common-subexpression elimination is the identity in float32
//   on its inputs and is left out: an fma keeps its own rounding, so no
//   compiler folds the chain); __nv_bfloat162: __hfma2 on two elements at
//   once, the JAX probe at bfloat16 (lab2's fma2bf), bf16 sums rounded at
//   every step as the JAX kernel rounds them.  The function fixes every
//   rounding, so any schedule gives the same bits.
//   Bound: operations, the card's peak issue rate (float32 67 TFLOP/s;
//   bf16 outside the tensor cores 133.8 TFLOP/s, NVIDIA's Hopper
//   architecture white paper).  A dependent fma waits about 4 cycles, and
//   each SM sub-partition issues one warp instruction a cycle, so the
//   probe is held back by every instruction that is not an fma and by
//   every cycle a sub-partition has no warp ready.  Design: one block a
//   tile; at one chain an element (fma_probe) 4 elements a thread, so a
//   thread runs 4 independent chains, each in its own order, and 1 element
//   a thread above; the steps unrolled 16 deep (one loop test per 16 x 4
//   or 16 x NACC fmas).  Measured and not kept (PERF.md): 1, 2 or 8
//   elements a thread at one chain, an unroll of 4, and resident blocks
//   on a grid-stride loop (no faster on the device, and each call paid
//   an occupancy query on the host).
//
// lab_gather<SMEM>: replaces tpu_kernel_lab.py::gather_probe (:461, one
//   lane gather out[g, s, l] = table[g, s, idx[g, s, l]]) and
//   tpu_kernel_lab5.py::probe (:42, reps chained gathers
//   table[g, s, (idx + i) % T], summed in order).  Table (G, S, T), idx
//   (G, S, L) int32, out (G, S, L).  SMEM: the table in dynamic shared
//   memory (the VMEM counterpart; up to 227 KB); otherwise read from
//   device memory through the read-only path, so the table's size picks
//   L1, L2 (50 MB) or HBM.  Bound: bytes (the table, the indices and the
//   output once), but a random read from device memory moves a 32-byte
//   sector for 4 useful bytes, so beyond L2 the sector traffic bounds it:
//   the random-read rate the scattered gather (kernel 3, gather.cu) meets.
//   A block takes 1024 consecutive outputs of one group (4 a thread); the
//   chunks of every group lie on one grid axis (up to 2^31 - 1 blocks), so
//   no group count past 65535 is refused.  Two designs:
//   - gather_smem_kernel, in shared memory where every row starts on a
//     16-byte boundary (T % 4 == 0 and a 16-byte-aligned table): a block
//     copies only the rows its outputs read, by 16-byte cp.async in one
//     commit group a slice of 256 outputs, and gathers each slice as soon
//     as its rows have landed; a run is read as the aligned 16-byte shared
//     words that hold it (16 or 17 for lab 5's 64 reads), its entries
//     taken out in registers in run order.  A 4-byte read a step was bound
//     by its read instructions: a map of each warp's lanes to distinct
//     banks, a skewed schedule and four chains a thread did not move it;
//     with the table in HBM, one TMA bulk copy a slice took 2-3 % off and
//     issuing the copy before the index reads nothing (PERF.md);
//   - gather_kernel, everywhere else: one thread an output at a time, its
//     reps 4-byte reads in a dependent-free loop, the group's table copied
//     whole before a __syncthreads in shared memory.  From device memory
//     16-byte words lost at runs of 4 from L2 (5-8 %) and won only at runs
//     of 64 from L1 (PERF.md), so its 4-byte reads stay.
//   The C entry chooses the design and reports it (*vector_path).  Every
//   design sums each run from +0 in order with __fadd_rn: the same bits
//   on every path.
//
// lab_pull_bf16: replaces tpu_kernel_lab2.py::make_kernel_call (:166) with
//   _kernel_v4 (:125): the dense-warp value pull of kernel 1 (warp.cu)
//   with the box values and the z weights rounded to bf16, their products
//   (exact in float32: 8 x 8 significant bits) summed in float32 per
//   (x, y) tap pair, then weighted by the float32 x * y weight.  The
//   window semantics are kernel 1's (WarpParams d0min / d0max): a sample
//   whose node origin leaves the max_disp window on some axis reads 0, so
//   contract-breaking grids drop the same samples.  Orders 0-3, any of
//   the 7 bounds, any C.  The weights come from the Cox-de Boor recursion
//   with every operation rounded on its own and each level's division a
//   product with a float32 reciprocal (rcp_weights below), as the plain
//   version computes them on the card, so both round the same float32
//   weights to bf16; the sums run in the plain version's order (y taps
//   outer, x inner, z innermost, as _kernel_v4):
//     zacc = sum_jz fadd(zacc, fmul(wz, vb)),
//     acc  = fadd(acc, fmul(fmul(wx, wy), zacc)).
//   Bound: bytes (the volume, the grid and the output once).  Like kernel
//   1 it is bound by the L1 requests of its taps and by instructions, not
//   by bytes.  Design:
//   - one pass (lab_pad_bf16, a kernel of its own) writes the volume
//     rounded to bf16, 2 bytes a value, each z row padded on both sides
//     with the folded values the window lets a kept sample reach (zlo + Z
//     + zhi values);
//     each tap then reads 2 bytes and widens them with a shift.  A fold
//     sign s is -1, 0 or 1, and under round-to-nearest-even round(s v) =
//     s round(v): the padded row holds round(s_z v), and the x and y
//     signs move into the weights (wx s_x, wy s_y: a product with +-1 or
//     0 rounds nothing), so every non-zero product is the one the
//     taps-then-round form computes, to the bit.  A product with a sign-0
//     weight is +-0, and a sum that starts at +0 is never -0, so it adds
//     nothing: every finite input gives the bits of a pull that multiplies
//     each tap by its signs and then rounds it (this lab's earlier
//     kernel).  A non-finite value at a tap of sign 0 reads as 0 x inf =
//     NaN here, as it did there (0 x v, then rounded: NaN);
//   - the x and y axes take kernel 1's tap setup (spline_taps.cuh::
//     tap_axis with these weights): an interior axis unfolded, a folded
//     one with its signs in the weights, 32-bit offsets within a plane;
//     z needs no fold, no warp vote and no second loop: every kept
//     sample's z taps are n0 + zlo .. n0 + zlo + order of its padded row;
//   - a row's 2 to 4 z taps come from the two aligned 8-byte words that
//     hold them (the second one read only when the taps cross into it),
//     shifted out in registers: two L1 requests a row where kernel 1
//     makes order + 1 (one 2-byte read a tap at immediate offsets took
//     1.2-1.3x as long at 128^3 and 256^3, PERF.md);
//   - blocks, weights and launch as kernel 1: a 3-D tile of voxels a block
//     (cuda_warp.warp_block), every tile, x tile and batch on one grid
//     axis (up to 2^31 - 1 blocks), the channels looped inside the thread
//     with the weights in registers.
//   Extra device memory: the padded bf16 volume, 2 B C X Y (Z + zlo +
//   zhi) + 16 bytes (half the float32 volume and the margins).
//
// C interface (loaded with ctypes by ops/lab.py); each returns the
// cudaError_t of its launch (0 on success):
//   int lab_fma_f32(const float* a, const float* b, float* out,
//                   long long n, int nacc, int iters, int zero_init,
//                   void* stream);
//   int lab_fma_bf16x2(const void* a, const void* b, float* out,
//                      long long npairs, int nacc, int iters, int zero_init,
//                      void* stream);
//   int lab_gather(const float* table, const int* idx, float* out, int G,
//                  int S, int T, int L, int reps, int smem,
//                  int* vector_path, void* stream);
//     (*vector_path: 1 where gather_smem_kernel ran, else 0; the path
//     follows smem, T % 4 and the table's alignment)
//   int lab_pad_bf16(const float* inp, void* out, long long rows, int Z,
//                    int bound, int zlo, int zhi, void* stream);
//   int lab_pull_bf16(const void* padded, const float* grid, float* val,
//                     const WarpParams* p, int zlo, int zp, void* stream);
// lab_pad_bf16 writes rows x (zlo + Z + zhi) bf16 values; the pull reads
// rows of zp = zlo + Z + zhi values with zlo >= pad_lo(p) and zp - zlo - Z
// >= pad_hi(p) (below), and 8 values past the last row (its 8-byte reads
// take them; they reach no sum).

#include <cuda_bf16.h>

#include "spline_taps.cuh"

namespace {

constexpr int kThreads = 256;

// The chain arithmetic of one type: a step, the sum of two chains, a
// chain's start and the stored result.
struct F32Chain {
  using In = float;
  using T = float;
  using O = float;
  static __device__ __forceinline__ T load(const In* p) { return __ldg(p); }
  static __device__ __forceinline__ T fma(T x, T y, T acc) {
    return __fmaf_rn(x, y, acc);
  }
  static __device__ __forceinline__ T add(T s, T t) { return __fadd_rn(s, t); }
  static __device__ __forceinline__ T start(T x, int k, int zero) {
    return zero ? 0.f : __fmul_rn(x, (float)(k + 1));
  }
  static __device__ __forceinline__ O out(T s) { return s; }
};

struct Bf16x2Chain {
  using In = float2;
  using T = __nv_bfloat162;
  using O = float2;
  // two float32 inputs rounded to nearest even (as torch's cast)
  static __device__ __forceinline__ T load(const In* p) {
    const float2 f = __ldg(p);
    return __floats2bfloat162_rn(f.x, f.y);
  }
  static __device__ __forceinline__ T fma(T x, T y, T acc) {
    return __hfma2(x, y, acc);
  }
  static __device__ __forceinline__ T add(T s, T t) { return __hadd2(s, t); }
  static __device__ __forceinline__ T start(T x, int k, int zero) {
    return zero ? __float2bfloat162_rn(0.f)
                : __hmul2(x, __float2bfloat162_rn((float)(k + 1)));
  }
  static __device__ __forceinline__ O out(T s) {
    return __bfloat1622float2(s);
  }
};

// One block a tile of kThreads x EPT elements, EPT = 4 at one chain an
// element and 1 above; element e of
// the thread at (blockIdx.x EPT + e) kThreads + threadIdx.x, so a warp
// reads consecutive elements.  Past the end a thread reads element n - 1
// and stores nothing.  The steps run unrolled 16 deep.
template <class K, int NACC>
__global__ void __launch_bounds__(kThreads)
    fma_kernel(const typename K::In* __restrict__ a,
               const typename K::In* __restrict__ b,
               typename K::O* __restrict__ out, long long n, int iters,
               int zero_init) {
  using T = typename K::T;
  constexpr int EPT = NACC == 1 ? 4 : 1, UNROLL = 16;
  T x[EPT], y[EPT], acc[EPT][NACC];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    long long i = ((long long)blockIdx.x * EPT + e) * kThreads + threadIdx.x;
    i = i < n ? i : n - 1;
    x[e] = K::load(a + i);
    y[e] = K::load(b + i);
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[e][k] = K::start(x[e], k, zero_init);
  }
  int r = 0;
  for (; r + UNROLL <= iters; r += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < EPT; ++e)
#pragma unroll
        for (int k = 0; k < NACC; ++k)
          acc[e][k] = K::fma(x[e], y[e], acc[e][k]);
  }
#pragma unroll 1
  for (; r < iters; ++r) {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[e][k] = K::fma(x[e], y[e], acc[e][k]);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    T s = acc[e][0];
#pragma unroll
    for (int k = 1; k < NACC; ++k) s = K::add(s, acc[e][k]);
    const long long i =
        ((long long)blockIdx.x * EPT + e) * kThreads + threadIdx.x;
    if (i < n) out[i] = K::out(s);
  }
}

template <class K, int NACC>
cudaError_t launch_fma_at(const typename K::In* a, const typename K::In* b,
                          typename K::O* out, long long n, int iters,
                          int zero_init, cudaStream_t stream) {
  constexpr long long tile = (long long)kThreads * (NACC == 1 ? 4 : 1);
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fma_kernel<K, NACC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, b, out, n, iters, zero_init);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_fma(int nacc, const typename K::In* a,
                       const typename K::In* b, typename K::O* out,
                       long long n, int iters, int zero_init,
                       cudaStream_t s) {
  if (n < 1 || iters < 0) return cudaErrorInvalidConfiguration;
  switch (nacc) {
    case 1: return launch_fma_at<K, 1>(a, b, out, n, iters, zero_init, s);
    case 4: return launch_fma_at<K, 4>(a, b, out, n, iters, zero_init, s);
    case 8: return launch_fma_at<K, 8>(a, b, out, n, iters, zero_init, s);
    case 16: return launch_fma_at<K, 16>(a, b, out, n, iters, zero_init, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------- lane gather
// Outputs of one block: a block covers kChunk consecutive (s, l) of one
// group, so a group of S x L outputs takes nb = ceil(S L / kChunk) blocks
// (each copies the group's table in SMEM mode); block i runs chunk i % nb
// of group i / nb.
constexpr int kChunk = 1024;

template <bool SMEM>
__global__ void __launch_bounds__(256)
    gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  float* __restrict__ out, int S, int T, int L, int reps,
                  unsigned nb) {
  extern __shared__ float tab_s[];
  const unsigned kg = blockIdx.x / nb;
  const long long g = kg;
  const long long SL = (long long)S * L;
  const float* tg = table + g * S * (long long)T;
  if (SMEM) {
    for (int i = threadIdx.x; i < S * T; i += blockDim.x) tab_s[i] = tg[i];
    __syncthreads();
  }
  const long long e0 = (long long)(blockIdx.x - kg * nb) * kChunk;
  const long long e1 = min(e0 + kChunk, SL);
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int s = (int)(e / L);
    const long long o = g * SL + e;
    int k = idx[o] % T;  // a floor-mod, as jnp's % on int32
    if (k < 0) k += T;
    float acc = 0.f;
    if (SMEM) {
      const float* row = tab_s + s * T;
      for (int r = 0; r < reps; ++r) {
        acc = __fadd_rn(acc, row[k]);
        k = (k + 1 == T) ? 0 : k + 1;
      }
    } else {
      const float* row = tg + (long long)s * T;
      for (int r = 0; r < reps; ++r) {
        acc = __fadd_rn(acc, __ldg(row + k));
        k = (k + 1 == T) ? 0 : k + 1;
      }
    }
    out[o] = acc;
  }
}

// 16-byte asynchronous copies from device to shared memory (cp.async,
// through L2 only) in commit groups; a thread waits for its own groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Slices of a chunk: thread t takes the chunk's outputs j kThreads + t,
// j < kSlices, as the loop of gather_kernel does.
constexpr int kSlices = kChunk / kThreads;

// wait for this thread's groups 0 .. j of kSlices
__device__ __forceinline__ void cp_async_wait_slice(int j) {
  static_assert(kSlices == 4, "one case a slice");
  switch (kSlices - 1 - j) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>();
  }
}

// One run from a shared row of W 16-byte words: reps entries from entry
// k (past the row's end it goes on at word 0), summed in order from +0,
// read as the aligned words that hold them, two a step; the entries are
// taken out in registers.
__device__ __forceinline__ float word_run(const float4* rw, int k, int W,
                                          int reps) {
  int cur = k >> 2;
  const int o = k & 3;
  float acc = 0.f;
  // words a run reaches: ceil((o + reps) / 4) <= (reps + 6) / 4
  const unsigned nw = ((unsigned)reps + 6) >> 2, lim = (unsigned)reps + o;
  for (unsigned w = 0; w < nw; w += 2) {
    // word w holds run steps 4 w - o .. 4 w - o + 3
    const int c1 = cur + 1 == W ? 0 : cur + 1;
    const float4 a = 4 * w < lim ? rw[cur] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b =
        4 * w + 4 < lim ? rw[c1] : make_float4(0.f, 0.f, 0.f, 0.f);
    cur = c1 + 1 == W ? 0 : c1 + 1;
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const unsigned p0 = 4 * w - (unsigned)o;  // step of v[0]
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (p0 + e < (unsigned)reps) acc = __fadd_rn(acc, v[e]);
  }
  return acc;
}

// The lane gather from shared memory where every row starts on a 16-byte
// boundary (T % 4 == 0, a 16-byte-aligned table); blocks and outputs as
// gather_kernel's.  The block copies only the rows its chunk reaches, by
// 16-byte cp.async in one commit group a slice (the rows that slice's
// outputs reach and no earlier group copied), and gathers slice j as soon
// as groups 0 .. j have landed, so the copy of later rows overlaps it.
// Each output's run is read as 16-byte shared words (word_run).
__global__ void __launch_bounds__(kThreads)
    gather_smem_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int S, int T, int L, int reps, unsigned nb) {
  extern __shared__ float4 tab_w[];
  const unsigned kg = blockIdx.x / nb;
  const long long g = kg;
  const long long SL = (long long)S * L;
  const long long e0 = (long long)(blockIdx.x - kg * nb) * kChunk;
  const int n = (int)min((long long)kChunk, SL - e0);
  // the chunk's first row once a block; rows below count from it
  const long long s0 = e0 / L;
  const unsigned rem0 = (unsigned)(e0 - s0 * L), uL = (unsigned)L;
  const int t = threadIdx.x, W = T >> 2;
  const float4* tg =
      reinterpret_cast<const float4*>(table + (g * S + s0) * (long long)T);
  const int* ib = idx + g * SL + e0;
  float* ob = out + g * SL + e0;
  // each slice's row: one 32-bit division a thread, then steps of kThreads
  unsigned sr[kSlices];
  int k[kSlices];
  {
    unsigned s = (rem0 + t) / uL, rm = rem0 + t - s * uL;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      sr[j] = s;
      const int i = j * kThreads + t;
      k[j] = i < n ? pmod(__ldg(ib + i), T) : 0;  // a floor-mod, as jnp's %
      rm += kThreads;
      const unsigned q = rm / uL;
      s += q;
      rm -= q * uL;
    }
  }
  int done = 0;  // rows that earlier groups copy
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    const int last = min((j + 1) * kThreads, n) - 1;
    const int hi = last >= j * kThreads
                       ? (int)((rem0 + (unsigned)last) / uL) + 1
                       : done;
    for (int w = done * W + t; w < hi * W; w += kThreads)
      cp_async16(tab_w + w, tg + w);
    cp_async_commit();
    done = max(done, hi);
  }
#pragma unroll
  for (int j = 0; j < kSlices; ++j) {
    cp_async_wait_slice(j);
    __syncthreads();
    const int i = j * kThreads + t;
    if (i < n) ob[i] = word_run(tab_w + sr[j] * W, k[j], W, reps);
  }
}

// ------------------------------------------------------------ bf16 pull

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The z margins of the padded bf16 volume: every tap of a sample that
// passes the window test (node origin offset d0 in [d0min, d0max]) lies
// in [-zlo, Z - 1 + zhi].
__host__ __device__ __forceinline__ int pad_lo(const WarpParams& p) {
  return max(0, -p.d0min[2]);
}
__host__ __device__ __forceinline__ int pad_hi(const WarpParams& p) {
  return max(0, p.d0max[2] + p.order[2]);
}

// The volume with its z rows padded by zlo / zhi folded values, each
// value times its fold sign rounded to bf16 (round to nearest even, as the
// plain version's cast), 2 bytes a value: row r (of B C X Y) holds
// sign(i) inp[r, fold(i)] for i in [-zlo, Z + zhi).  A warp a row.
__global__ void __launch_bounds__(256)
    pad_bf16_kernel(const float* __restrict__ inp,
                    unsigned short* __restrict__ out, long long rows, int Z,
                    int bound, int zlo, int zp) {
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       r < rows; r += warps) {
    const float* src = inp + r * Z;
    unsigned short* dst = out + r * zp;
    // the interior, where the fold is the identity (dst1's sign is 0 at
    // index 0)
    const int lo = (bound == kDst1 && Z > 1) ? 1 : 0;
    for (int k = lane; k < zp; k += 32) {
      const int i = k - zlo;
      const float v =
          (i >= lo && i < Z)
              ? src[i]
              : fold_sign(i, Z, bound) * src[fold_index(i, Z, bound)];
      dst[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
  }
}

// a bf16 value's bits -> float32 (exact)
__device__ __forceinline__ float widen(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

// The tap weights by the recursion, each level's division a product with
// the float32 reciprocal of its divisor: what PyTorch's CUDA division of a
// tensor by a scalar computes, hence the plain version's weights on the
// card to the bit (on the CPU it divides, a few ulp away).
template <int NT>
__device__ __forceinline__ void rcp_weights(float t, int order,
                                            float (&w)[NT]) {
  float dw[NT], hw[NT];
#define INTERPOL_RCP_W(P)                                               \
  case P:                                                               \
    bspline_taps<(P < NT ? P : NT - 1), NT, false, false, true>(t, w, dw, \
                                                                 hw);    \
    break;
  switch (order) {
    INTERPOL_RCP_W(0)
    INTERPOL_RCP_W(1)
    INTERPOL_RCP_W(2)
    default:
      bspline_taps<NT - 1, NT, false, false, true>(t, w, dw, hw);
  }
#undef INTERPOL_RCP_W
}

// The x or y axis of a sample: the tap weights with the fold signs in
// them and the taps' indices; an interior axis (taps n0 .. n0 + order
// inside with sign 1) unfolded, as spline_taps.cuh::tap_axis.
template <int NT>
__device__ __forceinline__ void bf16_axis(float g, float n0f, int n,
                                          int order, int bound,
                                          float (&w)[NT], int (&idx)[NT]) {
  rcp_weights<NT>(__fsub_rn(g, n0f), order, w);
  const int n0 = node_index(n0f);
  const int lo = (bound == kDst1 && n > 1) ? 1 : 0;
  if (n0 >= lo && n0 + order < n) {
#pragma unroll
    for (int j = 0; j < NT; ++j) idx[j] = n0 + j;
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j > order) break;
    const int i = n0 + j;
    idx[j] = fold_index(i, n, bound);
    w[j] = __fmul_rn(w[j], fold_sign(i, n, bound));
  }
}

// The z taps of a padded row, r[0] .. r[ordz]: from the aligned 8-byte
// words that hold them (slots k .. k + ordz of the 8 in two words; the
// second word is read only when the taps reach it).
template <int NT>
__device__ __forceinline__ void load_row_bf16(
    const unsigned short* __restrict__ r, int ordz, float (&tap)[NT]) {
  if constexpr (NT == 1) {
    tap[0] = widen(__ldg(r));
  } else {
    const size_t addr = reinterpret_cast<size_t>(r);
    const uint2* q = reinterpret_cast<const uint2*>(addr & ~(size_t)7);
    const int k = (int)(addr >> 1) & 3;
    const uint2 w01 = __ldg(q);
    uint2 w23 = make_uint2(0u, 0u);
    if (k + ordz >= 4) w23 = __ldg(q + 1);
    // the three words from the one that holds slot k (two slots a word,
    // the lower slot in the low half)
    const bool up = k & 2;
    const unsigned a0 = up ? w01.y : w01.x, a1 = up ? w23.x : w01.y,
                   a2 = up ? w23.y : w23.x;
    const unsigned sh = (unsigned)(k & 1) << 4;
    const unsigned u = __funnelshift_r(a0, a1, sh);
    tap[0] = __uint_as_float(u << 16);
    tap[1] = __uint_as_float(u & 0xffff0000u);
    if constexpr (NT >= 3) {
      const unsigned v = __funnelshift_r(a1, a2, sh);
      tap[2] = __uint_as_float(v << 16);
      if constexpr (NT >= 4) tap[3] = __uint_as_float(v & 0xffff0000u);
    }
  }
}

// The sums of one sample in one channel of the padded bf16 volume; vol
// points at the sample's first z tap in plane 0, row 0.
template <int NT>
__device__ __forceinline__ float bf16_taps(
    const unsigned short* __restrict__ vol, const long long (&ox)[NT],
    const int (&oy)[NT], const float (&wx)[NT], const float (&wy)[NT],
    const float (&wz)[NT], int ordx, int ordy, int ordz) {
  float acc = 0.f;
#pragma unroll
  for (int jy = 0; jy < NT; ++jy) {
    if (jy > ordy) break;
#pragma unroll
    for (int jx = 0; jx < NT; ++jx) {
      if (jx > ordx) break;
      float tap[NT];
      load_row_bf16<NT>(vol + ox[jx] + oy[jy], ordz, tap);
      // each product of two bf16 values is exact; no contraction
      float zacc = 0.f;
#pragma unroll
      for (int jz = 0; jz < NT; ++jz) {
        if (jz > ordz) break;
        zacc = __fadd_rn(zacc, __fmul_rn(wz[jz], tap[jz]));
      }
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wx[jx], wy[jy]), zacc));
    }
  }
  return acc;
}

// NT = largest order + 1 over the three axes; block geometry, window test
// and launch bounds as warp.cu's warp_kernel (value mode).  vb: the padded
// bf16 volume, rows of zp = zlo + Z + zhi values.
template <int NT>
__global__ void __launch_bounds__(256, (gather_blocks<NT, false>(true)))
    pull_bf16_kernel(const unsigned short* __restrict__ vb,
                     const float* __restrict__ grid, float* __restrict__ val,
                     const WarpParams p, int zlo, int zp) {
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const int lx = p.block[0], ly = p.block[1], lz = p.block[2];
  const unsigned nbx = (X + (1 << lx) - 1) >> lx;
  const unsigned nbz = (Z + (1 << lz) - 1) >> lz;
  const unsigned nyz = ((Y + (1 << ly) - 1) >> ly) * nbz;
  const unsigned kbx = blockIdx.x / nyz, kyz = blockIdx.x - kbx * nyz;
  const unsigned kb = kbx / nbx, kx = kbx - kb * nbx, ky = kyz / nbz;
  const long long b = kb;
  const int t = threadIdx.x;
  const int x = ((int)kx << lx) + (t >> (lz + ly));
  const int y = ((int)ky << ly) + ((t >> lz) & ((1 << ly) - 1));
  const int z = ((int)(kyz - ky * nbz) << lz) + (t & ((1 << lz) - 1));
  if (x >= X || y >= Y || z >= Z) return;
  const int YZ = Y * Z, YZp = Y * zp;
  const long long nvox = (long long)X * YZ, npad = (long long)X * YZp;
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
    keep = keep && d0[d] >= (float)p.d0min[d] && d0[d] <= (float)p.d0max[d];
  }
  float wx[NT], wy[NT], wz[NT];
  int ix[NT], iy[NT];
  long long ox[NT];
  int oy[NT], oz = 0;
  if (keep) {
    bf16_axis<NT>(gx, nx, X, ordx, p.bound[0], wx, ix);
    bf16_axis<NT>(gy, ny, Y, ordy, p.bound[1], wy, iy);
    // z: the padded row holds the signs; the taps are zlo + n0 .. on
    rcp_weights<NT>(__fsub_rn(gz, nz), ordz, wz);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j > ordz) break;
      wz[j] = bf16_round(wz[j]);
    }
    oz = zlo + node_index(nz);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ox[j] = (long long)ix[j] * YZp;
      oy[j] = iy[j] * zp;
    }
  }
  for (long long c = 0; c < p.C; ++c) {
    const long long bc = b * p.C + c;  // 64-bit (b, c) offsets
    float acc = 0.f;
    if (keep)
      acc = bf16_taps<NT>(vb + bc * npad + oz, ox, oy, wx, wy, wz, ordx, ordy,
                          ordz);
    val[bc * nvox + r] = acc;
  }
}

template <int NT>
void launch_pull_bf16(unsigned blocks, int threads, cudaStream_t s,
                      const unsigned short* vb, const float* grid,
                      float* val, const WarpParams& p, int zlo, int zp) {
  pull_bf16_kernel<NT><<<blocks, threads, 0, s>>>(vb, grid, val, p, zlo, zp);
}

}  // namespace

extern "C" int lab_fma_f32(const float* a, const float* b, float* out,
                           long long n, int nacc, int iters, int zero_init,
                           void* stream) {
  return (int)launch_fma<F32Chain>(nacc, a, b, out, n, iters, zero_init,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int lab_fma_bf16x2(const float* a, const float* b, float* out,
                              long long npairs, int nacc, int iters,
                              int zero_init, void* stream) {
  return (int)launch_fma<Bf16x2Chain>(
      nacc, reinterpret_cast<const float2*>(a),
      reinterpret_cast<const float2*>(b), reinterpret_cast<float2*>(out),
      npairs, iters, zero_init, static_cast<cudaStream_t>(stream));
}

extern "C" int lab_gather(const float* table, const int* idx, float* out,
                          int G, int S, int T, int L, int reps, int smem,
                          int* vector_path, void* stream) {
  *vector_path = 0;
  const long long SL = (long long)S * L;
  const long long nb = (SL + kChunk - 1) / kChunk;
  if (G < 1 || S < 1 || T < 1 || L < 1 || reps < 0 ||
      nb * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(nb * G);
  if (smem) {
    size_t bytes = (size_t)S * T * sizeof(float);
    if (bytes > 232448) return (int)cudaErrorInvalidConfiguration;
    // every row starts on a 16-byte boundary: 16-byte copies and reads
    if (T % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0) {
      *vector_path = 1;
      // the rows a chunk reaches: at most 1023 / L + 2, and S
      bytes = (size_t)min((long long)S, 1023LL / L + 2) * T * sizeof(float);
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (err != cudaSuccess) return (int)err;
      }
      gather_smem_kernel<<<blocks, kThreads, bytes, s>>>(
          table, idx, out, S, T, L, reps, (unsigned)nb);
      return (int)cudaGetLastError();
    }
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    gather_kernel<true><<<blocks, 256, bytes, s>>>(table, idx, out, S, T, L,
                                                   reps, (unsigned)nb);
  } else {
    gather_kernel<false><<<blocks, 256, 0, s>>>(table, idx, out, S, T, L,
                                                reps, (unsigned)nb);
  }
  return (int)cudaGetLastError();
}

extern "C" int lab_pad_bf16(const float* inp, void* out, long long rows,
                            int Z, int bound, int zlo, int zhi,
                            void* stream) {
  const long long zp = (long long)zlo + Z + zhi;
  if (rows < 1 || Z < 1 || bound < 0 || bound > 6 || zlo < 0 || zhi < 0 ||
      zp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  pad_bf16_kernel<<<(unsigned)min((rows + 7) / 8, 132LL * 64), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      inp, static_cast<unsigned short*>(out), rows, Z, bound, zlo, (int)zp);
  return (int)cudaGetLastError();
}

extern "C" int lab_pull_bf16(const void* padded, const float* grid,
                             float* val, const WarpParams* p, int zlo, int zp,
                             void* stream) {
  long long nb[3];
  int nt = 0;
  for (int d = 0; d < 3; ++d) {
    if (p->order[d] < 0 || p->order[d] > 3 || p->bound[d] < 0 ||
        p->bound[d] > 6 || p->shape[d] < 1 || p->block[d] < 0 ||
        p->block[d] > 8)
      return (int)cudaErrorInvalidValue;
    nb[d] = (p->shape[d] + (1LL << p->block[d]) - 1) >> p->block[d];
    nt = max(nt, p->order[d] + 1);
  }
  // the padded rows must hold every tap a kept sample reads
  if (zlo < pad_lo(*p) || (long long)zp - zlo - p->shape[2] < pad_hi(*p))
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (p->block[0] + p->block[1] + p->block[2]);
  const long long blocks = nb[0] * nb[1] * nb[2] * p->B;
  if (threads > 256 || p->B < 1 || p->C < 1 || blocks > 0x7fffffffLL ||
      (long long)p->shape[1] * zp > 0x7fffffffLL || p->base[0] != nullptr)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned short* vb = static_cast<const unsigned short*>(padded);
  const unsigned g = (unsigned)blocks;
  switch (nt) {
    case 1: launch_pull_bf16<1>(g, threads, s, vb, grid, val, *p, zlo, zp); break;
    case 2: launch_pull_bf16<2>(g, threads, s, vb, grid, val, *p, zlo, zp); break;
    case 3: launch_pull_bf16<3>(g, threads, s, vb, grid, val, *p, zlo, zp); break;
    case 4: launch_pull_bf16<4>(g, threads, s, vb, grid, val, *p, zlo, zp); break;
  }
  return (int)cudaGetLastError();
}
