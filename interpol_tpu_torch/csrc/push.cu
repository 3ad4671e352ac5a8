// Dense-warp B-spline splat (push) and its first-derivative form
// (pushgrad) for Hopper (sm_90a).
//
// Replaces interpol_tpu/ops/pallas_warp.py::_push_kernel in its plain and
// deriv modes (push_window / pushgrad_window forwards): the exact adjoints
// of the pull and gradient modes of warp.cu.  The Pallas kernel splats
// each tile into a private halo-extended box and overlap-adds the boxes in
// XLA, then folds the pad margins back through the boundary, because
// Mosaic has no scatter.  None of that is carried over.
//
// Design:
//   - one thread per grid site of (B, X, Y, Z), z fastest;
//   - the mask, the window test and the folded tap offsets and signed
//     weights come from spline_taps.cuh, exactly as the gather kernel of
//     warp.cu computes them;
//   - channels loop inside the thread; each tap gets atomicAdd(w_x w_y w_z
//     v) into the output, which the wrapper zeroes (torch.zeros).  Folding
//     each tap index directly through the bound is the same linear map as
//     the JAX package's pad-then-_fold_pad_margins;
//   - taps whose fold sign is 0 (zero bound outside the volume, dst1 at its
//     mirror nodes) are skipped rather than adding zeros at a clamped
//     address;
//   - deriv mode takes three cotangent components per site and splats
//     v_x (w'_x w_y w_z) + v_y (w_x w'_y w_z) + v_z (w_x w_y w'_z), as
//     pallas_warp.py:715-727 does.
//
// Determinism: the atomics make the order of the float32 sums vary from
// run to run, so two runs may differ in the last bits.  The JAX package's
// push is deterministic (docs/DESIGN.md:143); the divergence is logged in
// ROADMAP queue 3, and the tests compare with a tolerance.  The gather
// form, in which each output voxel sums the sites that land on it, is
// deterministic, but at cubic order and max_disp=4 it visits 12^3 = 1728
// candidate sites per voxel against 64 taps for this scatter, so it is
// not the first kernel.
//
// What bounds it on this card: the atomic adds, (order+1)^3 per site and
// channel, 1.07 G at 256^3 cubic for one channel, resolved in L2, against
// a least HBM traffic of 335 MB (values and grid read once, output written
// once).  Later changes could accumulate each block's splats in a
// shared-memory halo box and make one atomic pass per box.
//
// C interface (loaded with ctypes by ops/cuda_warp.py):
//   int interpol_push(const float* vals, const float* grid, float* out,
//                     const WarpParams* p, int deriv, void* stream);
// vals (B, C, X, Y, Z) or, with deriv, (B, C, X, Y, Z, 3); grid
// (B, X, Y, Z, 3); out (B, C, X, Y, Z), zeroed by the caller; all
// float32, contiguous.  Returns the cudaError_t of the launch.

#include "spline_taps.cuh"

namespace {

template <int NT, bool DERIV>
__global__ void __launch_bounds__(256, 3)
    push_kernel(const float* __restrict__ vals,
                const float* __restrict__ grid, float* __restrict__ out,
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

  // masked sites carry value 0: nothing to splat
  if (p.masked && !(gx > p.thr_lo && gx < p.thr_hi[0] && gy > p.thr_lo &&
                    gy < p.thr_hi[1] && gz > p.thr_lo && gz < p.thr_hi[2]))
    return;
  long long ox[NT], oy[NT], oz[NT];
  float wx[NT], wy[NT], wz[NT], dx[NT], dy[NT], dz[NT];
  float hx[NT], hy[NT], hz[NT];  // unused: no second derivatives here
  unsigned lx, ly, lz;
  if (!(axis_taps<NT, DERIV, false>(gx, x, X, p.order[0], p.bound[0],
                                    p.d0min[0], p.d0max[0],
                                    (long long)Y * Z, ox, wx, dx, hx, lx) &&
        axis_taps<NT, DERIV, false>(gy, y, Y, p.order[1], p.bound[1],
                                    p.d0min[1], p.d0max[1], (long long)Z,
                                    oy, wy, dy, hy, ly) &&
        axis_taps<NT, DERIV, false>(gz, z, Z, p.order[2], p.bound[2],
                                    p.d0min[2], p.d0max[2], 1LL, oz, wz,
                                    dz, hz, lz)))
    return;  // a node origin outside the window: no tap on that axis
  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];

  for (long long c = 0; c < p.C; ++c) {
    const long long base = (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    float val = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
    if (DERIV) {
      const float* vp = vals + 3 * (base + r);
      vx = vp[0];
      vy = vp[1];
      vz = vp[2];
    } else {
      val = vals[base + r];
    }
    float* dst = out + base;
#pragma unroll
    for (int jx = 0; jx < NT; ++jx) {
      if (jx > ordx) break;
      if (!((lx >> jx) & 1u)) continue;
#pragma unroll
      for (int jy = 0; jy < NT; ++jy) {
        if (jy > ordy) break;
        if (!((ly >> jy) & 1u)) continue;
        // the (x, y) part of the tap's coefficient
        float a, az = 0.f;
        if (DERIV) {
          a = fmaf(vx * dx[jx], wy[jy], vy * wx[jx] * dy[jy]);
          az = vz * wx[jx] * wy[jy];
        } else {
          a = val * wx[jx] * wy[jy];
        }
        float* row = dst + ox[jx] + oy[jy];
#pragma unroll
        for (int jz = 0; jz < NT; ++jz) {
          if (jz > ordz) break;
          if (!((lz >> jz) & 1u)) continue;
          const float w = DERIV ? fmaf(a, wz[jz], az * dz[jz]) : a * wz[jz];
          atomicAdd(row + oz[jz], w);
        }
      }
    }
  }
}

template <int NT, bool DERIV>
cudaError_t launch(const float* vals, const float* grid, float* out,
                   const WarpParams& p, cudaStream_t stream) {
  const long long total =
      p.B * (long long)p.shape[0] * p.shape[1] * p.shape[2];
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  push_kernel<NT, DERIV>
      <<<(unsigned)blocks, threads, 0, stream>>>(vals, grid, out, p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mode(const float* vals, const float* grid, float* out,
                        const WarpParams& p, int deriv, cudaStream_t s) {
  if (deriv) return launch<NT, true>(vals, grid, out, p, s);
  return launch<NT, false>(vals, grid, out, p, s);
}

}  // namespace

extern "C" int interpol_push(const float* vals, const float* grid,
                             float* out, const WarpParams* p, int deriv,
                             void* stream) {
  if (vals == nullptr || grid == nullptr || out == nullptr)
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
    case 1: err = launch_mode<1>(vals, grid, out, *p, deriv, s); break;
    case 2: err = launch_mode<2>(vals, grid, out, *p, deriv, s); break;
    case 3: err = launch_mode<3>(vals, grid, out, *p, deriv, s); break;
    case 4: err = launch_mode<4>(vals, grid, out, *p, deriv, s); break;
    case 5: err = launch_mode<5>(vals, grid, out, *p, deriv, s); break;
    case 6: err = launch_mode<6>(vals, grid, out, *p, deriv, s); break;
    case 7: err = launch_mode<7>(vals, grid, out, *p, deriv, s); break;
    default: err = launch_mode<8>(vals, grid, out, *p, deriv, s); break;
  }
  return (int)err;
}
