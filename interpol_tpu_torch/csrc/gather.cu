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
//   - one thread per point of (B, P), in the cloud's order, reading its
//     (order+1)^3 taps straight from the (C, X, Y, Z) volume (no window
//     test: every point gets all its taps, as ndkernels.pull_core);
//   - the tap setup per axis is the gathers' lean one (spline_taps.cuh):
//     closed-form weights at orders 0-3, the recursion with constant
//     reciprocals above; interior taps unfolded, the rest folded through
//     the bound with the fold's sign in the weights; 32-bit offsets within
//     a plane;
//   - interior z taps are read at immediate offsets from one address,
//     folded ones at their offsets; from order 2 a warp takes one of the
//     two loops for all its points (spline_taps.cuh::contiguous_z);
//   - the extrapolation mask is inbounds_mask (ndkernels.py);
//   - channels loop inside the thread with the weights in registers; each
//     thread writes only its own point: deterministic;
//   - template flags select the value, grad and hess planes; hess keeps six
//     sums and writes the full symmetric 3x3 (JAX's layout).
// 1-D and 2-D clouds arrive lifted to 3-D by the host (ops/scattered.py):
// trailing size-1 axes of order 0 and coordinate 0.
//
// What bounds it on this card: the scattered tap reads, (order+1)^2 rows
// of order+1 floats x C per point (16 rows x 4 floats at cubic order),
// from L2 when neighbouring threads hold nearby points and from HBM when
// they do not (a random cloud reads a 32-byte sector per tap row).  At 1M
// random points in a 256^3 volume the least traffic (volume, coordinates
// and output once) is 83 MB, far below what the scattered reads move; a
// leaner tap setup left that case's time where it was, while an ordered
// cloud (an affine reslice) gained by it (PERF.md).  The launch bounds
// keep enough warps resident to hide the reads' latency.
//
// C interface (loaded with ctypes by ops/cuda_scattered.py):
//   int interpol_gather(const float* inp, const float* grid, float* val,
//                       float* grad, float* hess, const PointParams* p,
//                       int value, int want_grad, int want_hess,
//                       void* stream);
// inp (B, C, X, Y, Z), grid (B, P, 3), val (B, C, P), grad (B, C, P, 3),
// hess (B, C, P, 3, 3); all float32, contiguous; Y * Z < 2^31.  Modes:
// value, grad, hess, value+grad, grad+hess.  Returns the cudaError_t of
// the launch.

#include "spline_taps.cuh"

namespace {

template <int NT, bool VAL, bool GRAD, bool HESS>
__global__ void __launch_bounds__(256, (gather_blocks<NT, HESS>(false)))
    gather_kernel(const float* __restrict__ inp,
                  const float* __restrict__ grid, float* __restrict__ val,
                  float* __restrict__ grd, float* __restrict__ hes,
                  const PointParams p) {
  constexpr bool D1 = GRAD || HESS;  // first-derivative taps needed
  const int X = p.shape[0], Y = p.shape[1], Z = p.shape[2];
  const int YZ = Y * Z;
  const long long nvox = (long long)X * YZ;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.B * p.P) return;
  const long long b = v / p.P;
  const long long pt = v - b * p.P;
  const float gx = grid[3 * v], gy = grid[3 * v + 1], gz = grid[3 * v + 2];
  const bool keep = !p.masked || inside(gx, gy, gz, p.thr_lo, p.thr_hi);

  const int ordx = p.order[0], ordy = p.order[1], ordz = p.order[2];
  TapAxis<NT> ax, ay, az;
  tap_axis<NT, D1, HESS>(gx, node_origin(gx, ordx), X, ordx, p.bound[0],
                         ax);
  tap_axis<NT, D1, HESS>(gy, node_origin(gy, ordy), Y, ordy, p.bound[1],
                         ay);
  const bool zin = tap_axis<NT, D1, HESS>(gz, node_origin(gz, ordz), Z, ordz,
                                          p.bound[2], az);
  long long ox[NT];
  int oy[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    ox[j] = (long long)ax.idx[j] * YZ;
    oy[j] = ay.idx[j] * Z;
  }

  const bool contig = contiguous_z<NT>(zin, keep);
  for (long long c = 0; c < p.C; ++c) {
    const float* vol = inp + (b * p.C + c) * nvox;  // 64-bit (b, c) offset
    TapSums s;
    if (keep) {
      if (contig) {
        gather_taps<NT, VAL, GRAD, HESS, kZContig>(vol, ox, oy, ax, ay, az,
                                                   ordx, ordy, ordz, s);
      } else {
        gather_taps<NT, VAL, GRAD, HESS, kZFolded>(vol, ox, oy, ax, ay, az,
                                                   ordx, ordy, ordz, s);
      }
    }
    store_sums<VAL, GRAD, HESS>(s, (b * p.C + c) * p.P + pt, val, grd, hes);
  }
}

template <int NT, bool VAL, bool GRAD, bool HESS>
cudaError_t launch(const float* inp, const float* grid, float* val,
                   float* grd, float* hes, const PointParams& p,
                   cudaStream_t stream) {
  const long long total = p.B * p.P;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL ||
      (long long)p.shape[1] * p.shape[2] > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
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
