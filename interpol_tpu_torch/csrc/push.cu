// Dense-warp B-spline splat (push) and its first-derivative form
// (pushgrad) for Hopper (sm_90a).
//
// Replaces interpol_tpu/ops/pallas_warp.py::_push_kernel in its plain and
// deriv modes (push_window / pushgrad_window forwards): the exact adjoints
// of the pull and gradient modes of warp.cu.  The Pallas kernel splats
// each tile into a private halo-extended box and overlap-adds the boxes,
// then folds the pad margins back through the boundary: race-free by
// construction.  This kernel keeps that design, in shared memory.
//
// Design: the race-free patch splat of patch_splat.cuh (read its notes
// first), with the grid sites as items:
//   - one warp per (batch, 8x8x8 site tile) and channel; its patch is the
//     tile plus the window's shifts [smin, smax] on each axis (19^3 floats,
//     27 KB, at cubic order and max_disp=4); each lane takes one site, 32
//     sites at a time, and the warp walks their taps in step;
//   - a site's mask (inbounds_mask), window test (a site whose node origin
//     leaves the window on some axis adds nothing, as in
//     window._coef_fields) and unfolded tap factors are computed as the
//     gather kernel of warp.cu computes them (spline_taps.cuh);
//   - mode 2c, adaptive (pallas_warp.py:669-685): a site's test is
//     d0 - base in [d0min, d0max] of the residual window, with the base of
//     its (8, 8, 128) TPU push tile (an 8^3 site tile lies inside one), as
//     in warp.cu; the patch then spans the union of the shifted windows,
//     [-B + smin, T - 1 + B + smax] with B = ceil(max_disp) (x/y [-7, 14],
//     z [-9, 17] at cubic order, max_disp=4 and tile_spread (1.5, 1.5, 4)),
//     so that the per-axis fold tables stay as they are.  A patch that
//     shrinks to the residual window and moves with the base needs a fold
//     that is not separable: later work;
//   - deriv mode takes three cotangent components per site and splats
//     v_x (w'_x w_y w_z) + v_y (w_x w'_y w_z) + v_z (w_x w_y w'_z), as
//     pallas_warp.py:715-727 does;
//   - the patches go to a scratch buffer (C, B, tiles, 19^3): 899 MB per
//     channel at 256^3, cubic, max_disp=4, 13x the output; then
//     overlap_fold_kernel sums them per output voxel and folds the pad
//     margins through the bound (window._fold_pad_margins).
// Two runs on the same inputs give the same bits.
//
// What bounds it on this card: one __syncwarp and one shared-memory
// read-modify-write per tap step, (order+1)^3 steps for 32 sites; the few
// warps a multiprocessor holds (a 27 KB patch each); and the scratch
// traffic (the patches written once and read once).

// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_push(const float* vals, const float* grid, float* scratch,
//                     float* out, const WarpParams* p, const PatchGeom* g,
//                     int deriv, void* stream);
// vals (B, C, X, Y, Z) or, with deriv, (B, C, X, Y, Z, 3); grid
// (B, X, Y, Z, 3); scratch (C, B, tiles, E0, E1, E2); out (B, C, X, Y, Z);
// all float32, contiguous.  Returns the first failing cudaError_t.

#include "patch_splat.cuh"

namespace {

template <int NT, int SPEC>
__global__ void __launch_bounds__(kWarp)
    push_patch_kernel(const float* __restrict__ vals,
                      const float* __restrict__ grid,
                      float* __restrict__ scratch, const WarpParams p,
                      const PatchGeom g) {
  extern __shared__ float patch[];
  const int lane = threadIdx.x;
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const long long nvox = (long long)X * Y * Z;
  const long long ntile = (long long)g.NB[0] * g.NB[1] * g.NB[2];
  const long long bt = blockIdx.x;  // b * ntile + tile
  const long long b = bt / ntile, tile = bt - b * ntile;
  const long long c = blockIdx.y;
  const int tix[3] = {(int)(tile / ((long long)g.NB[1] * g.NB[2])),
                      (int)((tile / g.NB[2]) % g.NB[1]),
                      (int)(tile % g.NB[2])};
  int s0[3], sn[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s0[d] = tix[d] * g.T[d];
    sn[d] = min(g.T[d], p.shape[d] - s0[d]);
  }
  const int nsites = sn[0] * sn[1] * sn[2];
  const long long psize = (long long)g.E[0] * g.E[1] * g.E[2];
  float* dst = scratch + (c * g.B * ntile + bt) * psize;
  const int order[3] = {p.order[0], p.order[1], p.order[2]};
  // this block's x-slab of the patch
  const int x0 = blockIdx.z * g.xslab;
  const int ex = min(g.xslab, g.E[0] - x0);
  const int count = ex * g.E[1] * g.E[2];
  zero_slab(patch, count);
  for (int base = 0; base < nsites; base += kWarp) {
    const int i = base + lane;
    Item<NT, SPEC> it;
    it.live = false;
    it.n0[0] = it.n0[1] = it.n0[2] = 0;
    if (i < nsites) {
      const int pos[3] = {s0[0] + i / (sn[1] * sn[2]),
                          s0[1] + (i / sn[2]) % sn[1], s0[2] + i % sn[2]};
      const long long r = ((long long)pos[0] * Y + pos[1]) * Z + pos[2];
      const float* gp = grid + 3 * (b * nvox + r);
      const float gg[3] = {gp[0], gp[1], gp[2]};
      bool live = !p.masked || inside(gg[0], gg[1], gg[2], p.thr_lo,
                                      p.thr_hi);
      int sh[3];  // the window test's shift (adaptive mode)
      tile_shift(p, b, pos[0], pos[1], pos[2], sh);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (!live) break;
        const float n0f = node_origin(gg[d], order[d]);
        const float d0 = n0f - (float)pos[d];
        live = d0 >= (float)(p.d0min[d] + sh[d]) &&
               d0 <= (float)(p.d0max[d] + sh[d]);
        if (live) {
          it.n0[d] = (int)n0f - (s0[d] + g.lo[d]);
          stage_axis<NT, SPEC>(it, d, gg[d] - n0f, order[d]);
        }
      }
      if (live) {
        const long long o = (b * p.C + c) * nvox + r;
        if constexpr (SPEC == 0) {
          it.v[0] = vals[o];
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) it.v[k] = vals[3 * o + k];
        }
      }
      it.live = live;
    }
    splat_round<NT, SPEC>(patch, it, order, x0, ex, g.E[1], g.E[2]);
  }
  store_slab(dst + (long long)x0 * g.E[1] * g.E[2], patch, count);
}

template <int NT, int SPEC>
cudaError_t launch(const float* vals, const float* grid, float* scratch,
                   float* out, const WarpParams& p, const PatchGeom& g,
                   cudaStream_t s) {
  const long long tiles = p.B * (long long)g.NB[0] * g.NB[1] * g.NB[2];
  if (tiles < 1 || tiles > 0x7fffffffLL || p.C > 65535 || g.E[0] > 65535 * g.xslab)
    return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)g.xslab * g.E[1] * g.E[2] * sizeof(float);
  const int nslab = (g.E[0] + g.xslab - 1) / g.xslab;
  cudaError_t e = allow_smem(push_patch_kernel<NT, SPEC>, smem);
  if (e != cudaSuccess) return e;
  push_patch_kernel<NT, SPEC>
      <<<dim3((unsigned)tiles, (unsigned)p.C, (unsigned)nslab), kWarp,
         smem, s>>>(
          vals, grid, scratch, p, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_overlap(scratch, out, g, s);
}

template <int NT>
cudaError_t launch_mode(const float* vals, const float* grid, float* scratch,
                        float* out, const WarpParams& p, const PatchGeom& g,
                        int deriv, cudaStream_t s) {
  if (deriv) return launch<NT, 1>(vals, grid, scratch, out, p, g, s);
  return launch<NT, 0>(vals, grid, scratch, out, p, g, s);
}

}  // namespace

extern "C" int interpol_push(const float* vals, const float* grid,
                             float* scratch, float* out, const WarpParams* p,
                             const PatchGeom* g, int deriv, void* stream) {
  if (vals == nullptr || grid == nullptr || scratch == nullptr ||
      out == nullptr || g->xslab < 1)
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
  case N: err = launch_mode<N>(vals, grid, scratch, out, *p, *g, deriv, s); break;
  switch (nt) {
    INTERPOL_NT_CASE(1)
    INTERPOL_NT_CASE(2)
    INTERPOL_NT_CASE(3)
    INTERPOL_NT_CASE(4)
    INTERPOL_NT_CASE(5)
    INTERPOL_NT_CASE(6)
    INTERPOL_NT_CASE(7)
    default: err = launch_mode<8>(vals, grid, scratch, out, *p, *g, deriv, s); break;
  }
#undef INTERPOL_NT_CASE
  return (int)err;
}
