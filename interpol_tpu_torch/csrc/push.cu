// Dense-warp B-spline splat (push) and its first-derivative form
// (pushgrad) for Hopper (sm_90a).
//
// Replaces interpol_tpu/ops/pallas_warp.py::_push_kernel in its plain,
// deriv and adaptive modes (push_window / pushgrad_window forwards): the
// exact adjoints of the pull and gradient modes of warp.cu.  The Pallas
// kernel splats each tile into a private halo-extended box and
// overlap-adds the boxes, then folds the pad margins back through the
// boundary: race-free by construction, so the JAX push is bit-reproducible.
// Here every tap is a 64-bit fixed-point integer (fixed_splat.cuh, read its
// notes first), whose sums do not depend on their order:
//   - one block of 256 threads per (batch, site tile) and channel (the
//     channels on a grid-stride loop over gridDim.y), one site per thread
//     at a time; the tile's patch (the tile plus the window's
//     shifts on each side, int64 cells in shared memory) takes each tap
//     with a shared-memory atomicAdd, then every non-zero cell is added
//     once to the int64 accumulator at its folded voxel (the overlap-add
//     and the pad-margin fold, window._fold_pad_margins, in one pass);
//   - a site's keep test (fixed_splat.cuh::site_kept: the mask,
//     inbounds_mask, and the window test: a site whose node origin leaves
//     the window on some axis adds nothing, as in window._coef_fields) and
//     its unfolded tap factors as the gather of warp.cu computes them
//     (spline_taps.cuh);
//   - the slice's scale sums |v| over the kept sites only (the same
//     site_kept, on the caller's values and the grid in their own order),
//     as the JAX kernel multiplies a value by its mask
//     (pallas_warp.py:833-838) and drops the window's taps: a masked or
//     dropped site whose value is 1e30, inf or NaN changes no bit of the
//     output;
//   - mode 2c, adaptive (pallas_warp.py:669-685): a site's test is
//     d0 - base in [d0min, d0max] of the residual window, with the base of
//     its (8, 8, 128) TPU push tile; a site tile lies inside one TPU tile
//     (the host's tiles divide it), so its sites share the base, and the
//     patch spans the residual window only and moves with the base;
//   - deriv mode takes three cotangent components per site and splats
//     v_x (w'_x w_y w_z) + v_y (w_x w'_y w_z) + v_z (w_x w_y w'_z), as
//     pallas_warp.py:715-727 does;
//   - the host picks the site tile (ops/cuda_warp.py::push_tile) whose
//     patch fits 56 KB, or up to 227 KB for a wide window (one block an
//     SM); when none does, each tap goes straight to the accumulator,
//     folded, with the same bits.
// Extra memory: the accumulator, twice the output (the keep bits of the
// sites lie in the output until it is written).
//
// What bounds it on this card: the shared-memory atomics, (order+1)^3 per
// site (the least traffic is the values, grid and output once: 335.5 MB
// for push at 256^3, 0.100 ms).

// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_push(const float* vals, const float* vals_orig,
//                     long long n_orig, const float* grid, void* ws,
//                     float* out, const WarpParams* p, const SplatGeom* g,
//                     int deriv, void* stream);
// vals (B, C, X, Y, Z) or, with deriv, (B, C, X, Y, Z, 3) (lifted to 3-D);
// vals_orig the caller's values (B, C, *ishape[, D]), n_orig elements per
// slice, read with grid by the scale pass;
// grid (B, X, Y, Z, 3); ws the zeroed workspace (fixed_splat.cuh); out
// (B, C, X, Y, Z); all float32, contiguous.  Returns the first failing
// cudaError_t.

#include "fixed_splat.cuh"

namespace {

// Stage the site at pos of batch b: the keep test (site_kept: mask, window
// test shifted by ``sh``, the base of the site's tile in adaptive mode),
// then the factors; false if it adds nothing.
template <int NT, int SPEC>
__device__ __forceinline__ bool stage_site(ItemTaps<NT, SPEC>& it,
                                           const float* __restrict__ grid,
                                           const WarpParams& p, long long b,
                                           const int* pos, const int* sh,
                                           long long r, long long nvox) {
  const float* gp = grid + 3 * (b * nvox + r);
  const float gg[3] = {gp[0], gp[1], gp[2]};
  if (!site_kept(p, gg, pos, sh)) return false;
#pragma unroll
  for (int d = 0; d < 3; ++d) stage_axis(it, d, gg[d], p.order[d]);
  return true;
}

template <int SPEC>
__device__ __forceinline__ void load_vals(float* v, const float* vals,
                                          long long o) {
  if constexpr (SPEC == 0) {
    v[0] = vals[o];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = vals[3 * o + k];
  }
}

// PATCH: the tile's sites into a shared patch, then the flush; otherwise
// every tap straight to the accumulator.  Block (b * tiles + tile,
// blockIdx.y) takes the channels blockIdx.y, + gridDim.y, ...
template <int NT, int SPEC, bool PATCH>
__global__ void __launch_bounds__(kThreads)
    push_kernel(const float* __restrict__ vals,
                const float* __restrict__ grid, Workspace w,
                const WarpParams p, const SplatGeom g) {
  extern __shared__ unsigned long long smem[];
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const long long nvox = (long long)X * Y * Z;
  const long long ntile = (long long)g.NB[0] * g.NB[1] * g.NB[2];
  const long long bt = blockIdx.x;  // b * ntile + tile
  const long long b = bt / ntile, tile = bt - b * ntile;
  const int tix[3] = {(int)(tile / ((long long)g.NB[1] * g.NB[2])),
                      (int)((tile / g.NB[2]) % g.NB[1]),
                      (int)(tile % g.NB[2])};
  int s0[3], sn[3], origin[3], sh[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) s0[d] = tix[d] * g.T[d];
  // the site tile lies inside one TPU tile: one base for all its sites
  tile_shift(p, b, s0[0], s0[1], s0[2], sh);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    sn[d] = min(g.T[d], p.shape[d] - s0[d]);
    origin[d] = s0[d] + g.lo[d] + sh[d];
  }
  const int nsites = sn[0] * sn[1] * sn[2];
  for (long long c = blockIdx.y; c < p.C; c += gridDim.y) {
    const long long slice = b * p.C + c;
    unsigned long long* acc = w.acc + slice * nvox;
    const float scale = pow2f(w.kexp[slice]);
    PatchSmem ps;
    if constexpr (PATCH)
      ps = patch_begin(smem, g.E, origin, p.shape, p.bound);
    for (int i = threadIdx.x; i < nsites; i += kThreads) {
      const int pos[3] = {s0[0] + i / (sn[1] * sn[2]),
                          s0[1] + (i / sn[2]) % sn[1], s0[2] + i % sn[2]};
      const long long r = ((long long)pos[0] * Y + pos[1]) * Z + pos[2];
      ItemTaps<NT, SPEC> it;
      if (!stage_site(it, grid, p, b, pos, sh, r, nvox)) continue;
      float v[Spec<SPEC>::NV];
      load_vals<SPEC>(v, vals, slice * nvox + r);
      if constexpr (PATCH)
        patch_add(ps, it, v, p.order, origin, g.E[1], g.E[2], scale);
      else {
        Folded<NT, SPEC> f;
        fold_item(it, f, p.order, p.shape, p.bound);
        direct_add(acc, it, f, v, p.order, scale);
      }
    }
    if constexpr (PATCH) {
      patch_flush(ps, g.E, acc, Y, Z);
      __syncthreads();  // the next channel zeroes the patch
    }
  }
}

template <int NT, int SPEC>
cudaError_t launch(const float* vals, const float* vals_orig,
                   long long n_orig, const float* grid, const Workspace& w,
                   float* out, const WarpParams& p, const SplatGeom& g,
                   cudaStream_t s) {
  const long long S = p.B * p.C;
  const long long nvox = (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const long long tiles = p.B * (long long)g.NB[0] * g.NB[1] * g.NB[2];
  if (tiles < 1 || tiles > 0x7fffffffLL || p.C < 1)
    return cudaErrorInvalidConfiguration;
  // the scale over the kept sites: the values per site are n_orig / nvox
  // (1, or the unlifted D of pushgrad)
  cudaError_t e =
      launch_scale(vals_orig, p.B, p.C, n_orig, n_orig / nvox,
                   Spec<SPEC>::kMass, SiteItems{grid, p}, w, out, nvox, s);
  if (e != cudaSuccess) return e;
  const dim3 grid_dim((unsigned)tiles, rows_y(p.C));
  if (g.E[0] > 0) {
    const size_t smem = patch_bytes(g.E);
    e = allow_smem(push_kernel<NT, SPEC, true>, smem);
    if (e != cudaSuccess) return e;
    push_kernel<NT, SPEC, true><<<grid_dim, kThreads, smem, s>>>(vals, grid,
                                                                 w, p, g);
  } else {
    push_kernel<NT, SPEC, false><<<grid_dim, kThreads, 0, s>>>(vals, grid,
                                                               w, p, g);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_convert(w, out, S, nvox, s);
}

template <int NT>
cudaError_t launch_mode(const float* vals, const float* vals_orig,
                        long long n_orig, const float* grid,
                        const Workspace& w, float* out, const WarpParams& p,
                        const SplatGeom& g, int deriv, cudaStream_t s) {
  if (deriv)
    return launch<NT, 1>(vals, vals_orig, n_orig, grid, w, out, p, g, s);
  return launch<NT, 0>(vals, vals_orig, n_orig, grid, w, out, p, g, s);
}

}  // namespace

extern "C" int interpol_push(const float* vals, const float* vals_orig,
                             long long n_orig, const float* grid, void* ws,
                             float* out, const WarpParams* p,
                             const SplatGeom* g, int deriv, void* stream) {
  if (vals == nullptr || vals_orig == nullptr || grid == nullptr ||
      ws == nullptr || out == nullptr || n_orig < 1)
    return (int)cudaErrorInvalidValue;
  int nt = 0;
  for (int d = 0; d < 3; ++d) {
    if (p->order[d] < 0 || p->order[d] > 7 || p->bound[d] < 0 ||
        p->bound[d] > 6 || p->shape[d] < 1 || g->T[d] < 1)
      return (int)cudaErrorInvalidValue;
    nt = max(nt, p->order[d] + 1);
  }
  const Workspace w = workspace(
      ws, p->B * p->C, (long long)p->shape[0] * p->shape[1] * p->shape[2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define INTERPOL_NT_CASE(N)                                                \
  case N:                                                                  \
    err = launch_mode<N>(vals, vals_orig, n_orig, grid, w, out, *p, *g,    \
                         deriv, s);                                        \
    break;
  switch (nt) {
    INTERPOL_NT_CASE(1)
    INTERPOL_NT_CASE(2)
    INTERPOL_NT_CASE(3)
    INTERPOL_NT_CASE(4)
    INTERPOL_NT_CASE(5)
    INTERPOL_NT_CASE(6)
    INTERPOL_NT_CASE(7)
    default:
      err = launch_mode<8>(vals, vals_orig, n_orig, grid, w, out, *p, *g,
                           deriv, s);
      break;
  }
#undef INTERPOL_NT_CASE
  return (int)err;
}
