// Scattered B-spline pull, spatial gradient and Hessian for Hopper
// (sm_90a).
//
// Replaces interpol_tpu/ops/scattered.py::_gather_kernel (value, grad and
// hess planes, and the fused value+grad and grad+hess modes that the
// custom VJPs _pullgrad_sc / _gradhess_sc run): grid_pull / grid_grad on
// any cloud of points.  The TPU kernel sorts the points into boxes,
// copies boundary-folded box tables, gathers each tap through a
// shuffle-and-select cascade within 128-lane rows and returns the results
// with a second sort, all because Mosaic has no general gather.  None of
// that is carried over: on Hopper a gather is one load.
//
// Design:
//   - one thread per point of (B, P), reading its (order+1)^3 taps straight
//     from the (C, X, Y, Z) volume; per axis, the node origin, the tap
//     weights (and first and second derivatives) and each tap index folded
//     through its bound come from spline_taps.cuh (no window test: every
//     point gets all its taps, as ndkernels.pull_core);
//   - the extrapolation mask is inbounds_mask (ndkernels.py);
//   - channels loop inside the thread with the weights in registers; each
//     thread writes only its own point: deterministic;
//   - template flags select the value, grad and hess planes; hess keeps six
//     sums and writes the full symmetric 3x3 (JAX's layout).
// 1-D and 2-D clouds arrive lifted to 3-D by the host (ops/scattered.py):
// trailing size-1 axes of order 0 and coordinate 0.
//
// What bounds it on this card: the scattered tap reads, (order+1)^3 x C per
// point (64 x C at cubic order), from L2 when neighbouring threads hold
// nearby points and from HBM when they do not (a random cloud reads a
// 32-byte sector per tap row).  At 1M random points in a 256^3 volume the
// least traffic (volume, coordinates and output once) is 83 MB, far below
// what the scattered reads move; the launch bounds keep enough warps
// resident to hide their latency.
//
// C interface (loaded with ctypes by ops/cuda_scattered.py):
//   int interpol_gather(const float* inp, const float* grid, float* val,
//                       float* grad, float* hess, const PointParams* p,
//                       int value, int want_grad, int want_hess,
//                       void* stream);
// inp (B, C, X, Y, Z), grid (B, P, 3), val (B, C, P), grad (B, C, P, 3),
// hess (B, C, P, 3, 3); all float32, contiguous.  Modes: value, grad,
// hess, value+grad, grad+hess.  Returns the cudaError_t of the launch.

#include "spline_taps.cuh"

namespace {

template <int NT, bool VAL, bool GRAD, bool HESS>
__global__ void __launch_bounds__(256, 3)
    gather_kernel(const float* __restrict__ inp,
                  const float* __restrict__ grid, float* __restrict__ val,
                  float* __restrict__ grd, float* __restrict__ hes,
                  const PointParams p) {
  constexpr bool D1 = GRAD || HESS;  // first-derivative taps needed
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const long long nvox = (long long)X * Y * Z;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.B * p.P) return;
  const long long b = v / p.P;
  const long long pt = v - b * p.P;
  const float gx = grid[3 * v], gy = grid[3 * v + 1], gz = grid[3 * v + 2];
  const bool keep = !p.masked || inside(gx, gy, gz, p.thr_lo, p.thr_hi);

  long long ox[NT], oy[NT], oz[NT];
  float wx[NT], wy[NT], wz[NT], dx[NT], dy[NT], dz[NT];
  float hx[NT], hy[NT], hz[NT];
  unsigned lx, ly, lz;  // the gather reads sign-0 taps with weight 0
  const float nx = node_origin(gx, p.order[0]);
  const float ny = node_origin(gy, p.order[1]);
  const float nz = node_origin(gz, p.order[2]);
  axis_weights<NT, D1, HESS>(gx - nx, p.order[0], wx, dx, hx);
  axis_weights<NT, D1, HESS>(gy - ny, p.order[1], wy, dy, hy);
  axis_weights<NT, D1, HESS>(gz - nz, p.order[2], wz, dz, hz);
  fold_taps<NT, D1, HESS>(node_index(nx), X, p.order[0], p.bound[0],
                          (long long)Y * Z, ox, wx, dx, hx, lx);
  fold_taps<NT, D1, HESS>(node_index(ny), Y, p.order[1], p.bound[1],
                          (long long)Z, oy, wy, dy, hy, ly);
  fold_taps<NT, D1, HESS>(node_index(nz), Z, p.order[2], p.bound[2], 1LL,
                          oz, wz, dz, hz, lz);
  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];

  for (long long c = 0; c < p.C; ++c) {
    const float* vol = inp + (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    float acc = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
    float hxx = 0.f, hyy = 0.f, hzz = 0.f, hxy = 0.f, hxz = 0.f, hyz = 0.f;
    if (keep) {
#pragma unroll
      for (int jx = 0; jx < NT; ++jx) {
        if (jx > ordx) break;
        float yv = 0.f, ydy = 0.f, ydz = 0.f;
        float yhy = 0.f, yhz = 0.f, ydydz = 0.f;
#pragma unroll
        for (int jy = 0; jy < NT; ++jy) {
          if (jy > ordy) break;
          const float* row = vol + ox[jx] + oy[jy];
          float zv = 0.f, zd = 0.f, zh = 0.f;
#pragma unroll
          for (int jz = 0; jz < NT; ++jz) {
            if (jz > ordz) break;
            const float s = __ldg(row + oz[jz]);
            zv = fmaf(wz[jz], s, zv);
            if (D1) zd = fmaf(dz[jz], s, zd);
            if (HESS) zh = fmaf(hz[jz], s, zh);
          }
          yv = fmaf(wy[jy], zv, yv);
          if (D1) {
            ydy = fmaf(dy[jy], zv, ydy);
            ydz = fmaf(wy[jy], zd, ydz);
          }
          if (HESS) {
            yhy = fmaf(hy[jy], zv, yhy);
            yhz = fmaf(wy[jy], zh, yhz);
            ydydz = fmaf(dy[jy], zd, ydydz);
          }
        }
        if (VAL) acc = fmaf(wx[jx], yv, acc);
        if (GRAD) {
          ax = fmaf(dx[jx], yv, ax);
          ay = fmaf(wx[jx], ydy, ay);
          az = fmaf(wx[jx], ydz, az);
        }
        if (HESS) {
          hxx = fmaf(hx[jx], yv, hxx);
          hyy = fmaf(wx[jx], yhy, hyy);
          hzz = fmaf(wx[jx], yhz, hzz);
          hxy = fmaf(dx[jx], ydy, hxy);
          hxz = fmaf(dx[jx], ydz, hxz);
          hyz = fmaf(wx[jx], ydydz, hyz);
        }
      }
    }
    const long long o = (b * p.C + c) * p.P + pt;
    if (VAL) val[o] = acc;
    if (GRAD) {
      grd[3 * o] = ax;
      grd[3 * o + 1] = ay;
      grd[3 * o + 2] = az;
    }
    if (HESS) {
      float* h = hes + 9 * o;
      h[0] = hxx; h[1] = hxy; h[2] = hxz;
      h[3] = hxy; h[4] = hyy; h[5] = hyz;
      h[6] = hxz; h[7] = hyz; h[8] = hzz;
    }
  }
  (void)lx; (void)ly; (void)lz;
}

template <int NT, bool VAL, bool GRAD, bool HESS>
cudaError_t launch(const float* inp, const float* grid, float* val,
                   float* grd, float* hes, const PointParams& p,
                   cudaStream_t stream) {
  const long long total = p.B * p.P;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gather_kernel<NT, VAL, GRAD, HESS>
      <<<(unsigned)blocks, threads, 0, stream>>>(inp, grid, val, grd, hes, p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mode(const float* inp, const float* grid, float* val,
                        float* grd, float* hes, const PointParams& p,
                        int value, int grad, int hess, cudaStream_t s) {
  if (hess && grad) return launch<NT, false, true, true>(inp, grid, val, grd, hes, p, s);
  if (hess) return launch<NT, false, false, true>(inp, grid, val, grd, hes, p, s);
  if (value && grad) return launch<NT, true, true, false>(inp, grid, val, grd, hes, p, s);
  if (grad) return launch<NT, false, true, false>(inp, grid, val, grd, hes, p, s);
  return launch<NT, true, false, false>(inp, grid, val, grd, hes, p, s);
}

}  // namespace

extern "C" int interpol_gather(const float* inp, const float* grid,
                               float* val, float* grd, float* hes,
                               const PointParams* p, int value,
                               int want_grad, int want_hess, void* stream) {
  if (!value && !want_grad && !want_hess) return (int)cudaErrorInvalidValue;
  if (want_hess && value) return (int)cudaErrorInvalidValue;
  if ((value && val == nullptr) || (want_grad && grd == nullptr) ||
      (want_hess && hes == nullptr) || inp == nullptr || grid == nullptr)
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
  case N: err = launch_mode<N>(inp, grid, val, grd, hes, *p, value, want_grad, want_hess, s); break;
  switch (nt) {
    INTERPOL_NT_CASE(1)
    INTERPOL_NT_CASE(2)
    INTERPOL_NT_CASE(3)
    INTERPOL_NT_CASE(4)
    INTERPOL_NT_CASE(5)
    INTERPOL_NT_CASE(6)
    INTERPOL_NT_CASE(7)
    default: err = launch_mode<8>(inp, grid, val, grd, hes, *p, value, want_grad, want_hess, s); break;
  }
#undef INTERPOL_NT_CASE
  return (int)err;
}
