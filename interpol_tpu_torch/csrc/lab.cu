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
//   every step as the JAX kernel rounds them.
//   Bound: operations, the card's peak issue rate (float32 67 TFLOP/s;
//   bf16 outside the tensor cores 133.8 TFLOP/s, NVIDIA's Hopper
//   architecture white paper).  One chain is latency-bound (4 cycles per
//   dependent fma): NACC chains in registers hide the latency, which is
//   what the probe measures.  One thread per element (pair), the chains
//   in registers, nothing in memory but one read of a and b and one write.
//
// lab_gather<SMEM>: replaces tpu_kernel_lab.py::gather_probe (:461, one
//   lane gather out[g, s, l] = table[g, s, idx[g, s, l]]) and
//   tpu_kernel_lab5.py::probe (:42, reps chained gathers
//   table[g, s, (idx + i) % T], summed in order).  Table (G, S, T), idx
//   (G, S, L) int32, out (G, S, L).  SMEM: a block copies its group's
//   S x T table into dynamic shared memory (the VMEM counterpart; up to
//   227 KB) and gathers from there; otherwise it gathers from device
//   memory through the read-only path, so the table's size picks L1, L2
//   (50 MB) or HBM.  Bound: bytes (the table, the indices and the output
//   once), but a random read from device memory moves a 32-byte sector
//   for 4 useful bytes, so beyond L2 the sector traffic bounds it: the
//   random-read rate the scattered gather (kernel 3, gather.cu) meets.
//   One thread per output, its reps reads in a dependent-free loop.
//
// lab_pull_bf16: replaces tpu_kernel_lab2.py::make_kernel_call (:166) with
//   _kernel_v4 (:125): the dense-warp value pull of kernel 1 (warp.cu)
//   with the box values and the z weights rounded to bf16, their products
//   (exact in float32: 8 x 8 significant bits) summed in float32 per
//   (x, y) tap pair, then weighted by the float32 x * y weight.  The
//   window semantics are kernel 1's (WarpParams d0min / d0max): a sample
//   whose node origin leaves the max_disp window on some axis reads 0, so
//   contract-breaking grids drop the same samples.  Orders 0-3.  The
//   weights come from the Cox-de Boor recursion with every operation
//   rounded on its own and each level's division a product with a float32
//   reciprocal (rcp_weights below), as the plain version computes them on
//   the card, so both round the same float32 weights to bf16; the sums
//   run in the plain version's order (y taps outer, x inner, z innermost,
//   as _kernel_v4).  Bound:
//   bytes (the volume, the grid and the output once); like kernel 1 it
//   is bound by instructions per tap, which the bf16 rounding adds to:
//   this is a probe of the TPU's bf16 multiply, not a faster pull.
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
//                  int S, int T, int L, int reps, int smem, void* stream);
//   int lab_pull_bf16(const float* inp, const float* grid, float* val,
//                     const WarpParams* p, void* stream);

#include <cuda_bf16.h>

#include "spline_taps.cuh"

namespace {

template <int NACC>
__global__ void __launch_bounds__(256)
    fma_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, long long n, int iters,
                   int zero_init) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i];
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k)
    acc[k] = zero_init ? 0.f : __fmul_rn(x, (float)(k + 1));
#pragma unroll 4
  for (int r = 0; r < iters; ++r) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = __fmaf_rn(x, y, acc[k]);
  }
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) s = __fadd_rn(s, acc[k]);
  out[i] = s;
}

template <int NACC>
__global__ void __launch_bounds__(256)
    fma_bf16x2_kernel(const __nv_bfloat162* __restrict__ a,
                      const __nv_bfloat162* __restrict__ b,
                      float2* __restrict__ out, long long n, int iters,
                      int zero_init) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const __nv_bfloat162 x = a[i], y = b[i];
  __nv_bfloat162 acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k)
    acc[k] = zero_init ? __float2bfloat162_rn(0.f)
                       : __hmul2(x, __float2bfloat162_rn((float)(k + 1)));
#pragma unroll 4
  for (int r = 0; r < iters; ++r) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = __hfma2(x, y, acc[k]);
  }
  __nv_bfloat162 s = acc[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) s = __hadd2(s, acc[k]);
  out[i] = __bfloat1622float2(s);
}

constexpr int kThreads = 256;

template <int NACC>
struct FmaF32 {
  static void run(dim3 g, cudaStream_t s, const float* a, const float* b,
                  float* o, long long n, int iters, int z) {
    fma_f32_kernel<NACC><<<g, kThreads, 0, s>>>(a, b, o, n, iters, z);
  }
};

template <int NACC>
struct FmaBf16 {
  static void run(dim3 g, cudaStream_t s, const __nv_bfloat162* a,
                  const __nv_bfloat162* b, float2* o, long long n, int iters,
                  int z) {
    fma_bf16x2_kernel<NACC><<<g, kThreads, 0, s>>>(a, b, o, n, iters, z);
  }
};

template <template <int> class K, typename A, typename O>
cudaError_t launch_fma(int nacc, const A* a, const A* b, O* out, long long n,
                       int iters, int zero_init, cudaStream_t stream) {
  const long long nb = (n + kThreads - 1) / kThreads;
  if (n < 1 || nb > 0x7fffffffLL || iters < 0)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)nb);
  switch (nacc) {
    case 1: K<1>::run(grid, stream, a, b, out, n, iters, zero_init); break;
    case 4: K<4>::run(grid, stream, a, b, out, n, iters, zero_init); break;
    case 8: K<8>::run(grid, stream, a, b, out, n, iters, zero_init); break;
    case 16: K<16>::run(grid, stream, a, b, out, n, iters, zero_init); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Outputs of one block: a block covers kChunk consecutive (s, l) of one
// group, so a group of S x L outputs takes ceil(S L / kChunk) blocks (each
// copies the group's table in SMEM mode).
constexpr int kChunk = 1024;

template <bool SMEM>
__global__ void __launch_bounds__(256)
    gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  float* __restrict__ out, int S, int T, int L, int reps) {
  extern __shared__ float tab_s[];
  const long long g = blockIdx.y;
  const long long SL = (long long)S * L;
  const float* tg = table + g * S * (long long)T;
  if (SMEM) {
    for (int i = threadIdx.x; i < S * T; i += blockDim.x) tab_s[i] = tg[i];
    __syncthreads();
  }
  const long long e0 = (long long)blockIdx.x * kChunk;
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

// The value pull with bf16 rounding points; block geometry and window test
// as warp.cu's warp_kernel.  NT = 4: orders 0-3.
constexpr int kNT = 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The tap weights by the recursion, each level's division a product with
// the float32 reciprocal of its divisor: what PyTorch's CUDA division of a
// tensor by a scalar computes, hence the plain version's weights on the
// card to the bit (on the CPU it divides, a few ulp away).
__device__ __forceinline__ void rcp_weights(float t, int order,
                                            float (&w)[kNT]) {
  float dw[kNT], hw[kNT];
  switch (order) {
    case 0: bspline_taps<0, kNT, false, false, true>(t, w, dw, hw); break;
    case 1: bspline_taps<1, kNT, false, false, true>(t, w, dw, hw); break;
    case 2: bspline_taps<2, kNT, false, false, true>(t, w, dw, hw); break;
    default: bspline_taps<3, kNT, false, false, true>(t, w, dw, hw);
  }
}

__global__ void __launch_bounds__(256)
    pull_bf16_kernel(const float* __restrict__ inp,
                     const float* __restrict__ grid, float* __restrict__ val,
                     const WarpParams p) {
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const int lx = p.block[0], ly = p.block[1], lz = p.block[2];
  const int nbz = (Z + (1 << lz) - 1) >> lz;
  const int ky = blockIdx.x / nbz;
  const int x0 = blockIdx.y << lx, y0 = ky << ly,
            z0 = (blockIdx.x - ky * nbz) << lz;
  const long long b = blockIdx.z;
  const int t = threadIdx.x;
  const int x = x0 + (t >> (lz + ly));
  const int y = y0 + ((t >> lz) & ((1 << ly) - 1));
  const int z = z0 + (t & ((1 << lz) - 1));
  if (x >= X || y >= Y || z >= Z) return;
  const long long YZ = (long long)Y * Z;
  const long long nvox = (long long)X * YZ;
  const long long r = (long long)x * YZ + (long long)y * Z + z;
  const long long v = b * nvox + r;
  const float g[3] = {grid[3 * v], grid[3 * v + 1], grid[3 * v + 2]};
  const int pos[3] = {x, y, z};
  bool keep = !p.masked || inside(g[0], g[1], g[2], p.thr_lo, p.thr_hi);
  float w[3][kNT];
  long long off[3][kNT];
  float sg[3][kNT];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float n0f = node_origin(g[d], p.order[d]);
    const float d0 = n0f - (float)pos[d];
    // written so that a NaN coordinate fails the test
    keep = keep && d0 >= (float)p.d0min[d] && d0 <= (float)p.d0max[d];
    rcp_weights(__fsub_rn(g[d], n0f), p.order[d], w[d]);
    const int n0 = node_index(n0f);
    const long long stride = d == 0 ? YZ : (d == 1 ? (long long)Z : 1LL);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      off[d][j] = (long long)fold_index(n0 + j, p.shape[d], p.bound[d]) *
                  stride;
      sg[d][j] = fold_sign(n0 + j, p.shape[d], p.bound[d]);
    }
  }
  float wz[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) wz[j] = bf16_round(w[2][j]);
  const int ox = p.order[0], oy = p.order[1], oz = p.order[2];
  for (long long c = 0; c < p.C; ++c) {
    const float* src = inp + (b * p.C + c) * nvox;
    float acc = 0.f;
    if (keep) {
#pragma unroll
      for (int jy = 0; jy < kNT; ++jy) {
        if (jy > oy) break;
#pragma unroll
        for (int jx = 0; jx < kNT; ++jx) {
          if (jx > ox) break;
          const float sxy = sg[0][jx] * sg[1][jy];
          const float* row = src + off[0][jx] + off[1][jy];
          float zacc = 0.f;
#pragma unroll
          for (int jz = 0; jz < kNT; ++jz) {
            if (jz > oz) break;
            // the padded volume's value (fold sign in it), rounded to bf16;
            // the product of two bf16 values is exact in float32
            const float vb =
                bf16_round(sxy * sg[2][jz] * __ldg(row + off[2][jz]));
            zacc = __fadd_rn(zacc, __fmul_rn(wz[jz], vb));
          }
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w[0][jx], w[1][jy]), zacc));
        }
      }
    }
    val[(b * p.C + c) * nvox + r] = acc;
  }
}

}  // namespace

extern "C" int lab_fma_f32(const float* a, const float* b, float* out,
                           long long n, int nacc, int iters, int zero_init,
                           void* stream) {
  return (int)launch_fma<FmaF32>(nacc, a, b, out, n, iters, zero_init,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int lab_fma_bf16x2(const void* a, const void* b, float* out,
                              long long npairs, int nacc, int iters,
                              int zero_init, void* stream) {
  return (int)launch_fma<FmaBf16>(
      nacc, static_cast<const __nv_bfloat162*>(a),
      static_cast<const __nv_bfloat162*>(b), reinterpret_cast<float2*>(out),
      npairs, iters, zero_init, static_cast<cudaStream_t>(stream));
}

extern "C" int lab_gather(const float* table, const int* idx, float* out,
                          int G, int S, int T, int L, int reps, int smem,
                          void* stream) {
  const long long SL = (long long)S * L;
  const long long nb = (SL + kChunk - 1) / kChunk;
  if (G < 1 || G > 65535 || S < 1 || T < 1 || L < 1 || reps < 0 ||
      nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nb, (unsigned)G);
  if (smem) {
    const size_t bytes = (size_t)S * T * sizeof(float);
    if (bytes > 232448) return (int)cudaErrorInvalidConfiguration;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    gather_kernel<true><<<grid, 256, bytes, s>>>(table, idx, out, S, T, L,
                                                  reps);
  } else {
    gather_kernel<false><<<grid, 256, 0, s>>>(table, idx, out, S, T, L,
                                               reps);
  }
  return (int)cudaGetLastError();
}

extern "C" int lab_pull_bf16(const float* inp, const float* grid, float* val,
                             const WarpParams* p, void* stream) {
  long long nb[3];
  for (int d = 0; d < 3; ++d) {
    if (p->order[d] < 0 || p->order[d] >= kNT || p->bound[d] < 0 ||
        p->bound[d] > 6 || p->shape[d] < 1 || p->block[d] < 0 ||
        p->block[d] > 8)
      return (int)cudaErrorInvalidValue;
    nb[d] = (p->shape[d] + (1LL << p->block[d]) - 1) >> p->block[d];
  }
  const int threads = 1 << (p->block[0] + p->block[1] + p->block[2]);
  if (threads > 256 || nb[1] * nb[2] > 0x7fffffffLL || nb[0] > 65535 ||
      p->B < 1 || p->B > 65535 || p->base[0] != nullptr)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 blocks((unsigned)(nb[1] * nb[2]), (unsigned)nb[0],
                    (unsigned)p->B);
  pull_bf16_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      inp, grid, val, *p);
  return (int)cudaGetLastError();
}
