// The race-free splat shared by the dense-warp push (push.cu) and the
// scattered splat (splat.cu).
//
// Why not atomics: an atomicAdd splat sums each output voxel's taps in an
// order that changes from run to run, so push, pushgrad and every gradient
// through them would differ between runs in the last bits.  The JAX
// package's splats are bit-reproducible by construction (docs/DESIGN.md,
// "race-free"), and so is this one:
//
//   1. one block (one warp) per tile of items (a site tile of the dense
//      warp, a box of sorted points) accumulates the items' taps into a
//      private *patch* in shared memory: the tile plus the taps' reach on
//      each side, in unfolded index space.  The warp takes its items 32 at
//      a time, one per lane, with the item's node origin, tap factors and
//      values in registers, and walks the (order+1)^3 taps in a fixed
//      order, all lanes at the same tap, a __syncwarp between taps.  Two
//      lanes write one cell at one tap only when their items share a node
//      origin; such items are ranked by lane (__match_any_sync) and splat
//      in turn, one rank per pass over the taps.  So within a step no two
//      lanes touch one address, and every cell sums its taps in an order
//      fixed by the input alone;
//   2. a patch too large for one block's shared memory is cut into x-slabs,
//      one block each; every block of a tile walks the same items and keeps
//      the taps on its slab, then writes its slab to a scratch buffer
//      (C, B, tiles, patch);
//   3. overlap_fold_kernel gives each output voxel q the sum of the patch
//      cells that fold onto it, in a fixed order: per axis, a host table
//      lists the cells (each unfolded index u with fold(u) = q and a
//      non-zero sign, and each tile whose patch covers u) as scratch
//      offsets and signs, and a voxel's cells are the products of its three
//      lists.  That is the overlap-add and the pad-margin fold
//      (window._fold_pad_margins) in one gather, written once per voxel,
//      no zeroing and no atomics.
//
// Why not give each lane its own patch cells (say its (y, z) columns):
// every lane must then read every item, a walk that costs the same at
// every order, while at linear order only 4 of 32 lanes have a tap to add.

#pragma once

#include "spline_taps.cuh"

// Tile and patch geometry of one splat, and the per-axis fold tables.
struct PatchGeom {
  long long B, C;
  int n[3];    // output volume
  int T[3];    // tile core (items whose anchor index lies in a core)
  int lo[3];   // least tap offset from the anchor: patch = [t*T+lo, +E)
  int E[3];    // patch extent
  int NB[3];   // tiles per axis
  int xslab;   // patch x-rows of one block (its slab of the patch)
  // axis d: the patch cells folding onto q are k in [cell_start[d][q],
  // cell_start[d][q+1]): scratch offset cell_off[d][k] along the axis
  // (tile and in-patch terms), fold sign cell_sign[d][k] (never 0)
  const int* cell_start[3];
  const long long* cell_off[3];
  const float* cell_sign[3];
};

namespace {

// SPEC 0: push (1 value, weights); 1: pushgrad (3 values, weights and
// first derivatives); 2: pushhess (6 values xx, yy, zz, xy, xz, yz, the
// symmetric pairs of the cotangent summed; weights, first and second
// derivatives).
template <int SPEC> struct Spec {
  static constexpr int NF = SPEC + 1;             // factor kinds per axis
  static constexpr int NV = SPEC == 0 ? 1 : (SPEC == 1 ? 3 : 6);
};

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// One lane's item: the patch-local node origin, the per-axis tap factors
// ([axis][w, d, h][tap]) and the values, all in registers.
template <int NT, int SPEC>
struct Item {
  bool live;  // false: the item adds nothing
  int n0[3];
  float f[3][Spec<SPEC>::NF][NT];
  float v[Spec<SPEC>::NV];
};

// Coefficient of one tap from its per-axis factors w, d (first
// derivative) and h (second derivative) and the item's values (the
// outliers' direct pass).
template <int SPEC>
__device__ __forceinline__ float spec_coef(const float* v, float wx,
                                           float wy, float wz, float dx,
                                           float dy, float dz, float hx,
                                           float hy, float hz) {
  if constexpr (SPEC == 0) {
    return v[0] * (wx * wy * wz);
  } else if constexpr (SPEC == 1) {
    return v[0] * (dx * wy * wz) + v[1] * (wx * dy * wz) +
           v[2] * (wx * wy * dz);
  } else {
    return v[0] * (hx * wy * wz) + v[1] * (wx * hy * wz) +
           v[2] * (wx * wy * hz) + v[3] * (dx * dy * wz) +
           v[4] * (dx * wy * dz) + v[5] * (wx * dy * dz);
  }
}

// The (y, z) column (jy, jz) of an item as up to three constants, so that
// tap jx is  f0[jx] a + f1[jx] b + f2[jx] c  with f the x factors: push
// a = v wy wz (with wx); pushgrad a = v0 wy wz (with w'x), b = v1 w'y wz +
// v2 wy w'z (with wx); pushhess a = vxx wy wz (with w''x), b = vyy w''y wz
// + vzz wy w''z + vyz w'y w'z (with wx), c = vxy w'y wz + vxz wy w'z (with
// w'x).
template <int NT, int SPEC>
__device__ __forceinline__ void column(const Item<NT, SPEC>& it, int jy,
                                       int jz, float& a, float& b,
                                       float& c) {
  const float* v = it.v;
  const float wy = it.f[1][0][jy], wz = it.f[2][0][jz];
  if constexpr (SPEC == 0) {
    a = v[0] * (wy * wz);
  } else {
    const float dy = it.f[1][1][jy], dz = it.f[2][1][jz];
    if constexpr (SPEC == 1) {
      a = v[0] * (wy * wz);
      b = v[1] * (dy * wz) + v[2] * (wy * dz);
    } else {
      const float hy = it.f[1][2][jy], hz = it.f[2][2][jz];
      a = v[0] * (wy * wz);
      b = v[1] * (hy * wz) + v[2] * (wy * hz) + v[5] * (dy * dz);
      c = v[3] * (dy * wz) + v[4] * (wy * dz);
    }
  }
}

// Tap jx of a column: the x factors against the column's constants.
template <int NT, int SPEC>
__device__ __forceinline__ float column_tap(const Item<NT, SPEC>& it,
                                            int jx, float a, float b,
                                            float c) {
  const float wx = it.f[0][0][jx];
  if constexpr (SPEC == 0) {
    return wx * a;
  } else if constexpr (SPEC == 1) {
    return it.f[0][1][jx] * a + wx * b;
  } else {
    return it.f[0][2][jx] * a + wx * b + it.f[0][1][jx] * c;
  }
}

// The per-axis factors of an item: weights at offset t (and derivatives
// as the spec needs), unfolded.
template <int NT, int SPEC>
__device__ __forceinline__ void stage_axis(Item<NT, SPEC>& it, int d,
                                           float t, int order) {
  float w[NT], dw[NT], hw[NT];
  axis_weights<NT, (SPEC >= 1), (SPEC == 2)>(t, order, w, dw, hw);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    it.f[d][0][j] = w[j];
    if constexpr (SPEC >= 1) it.f[d][1][j] = dw[j];
    if constexpr (SPEC == 2) it.f[d][2][j] = hw[j];
  }
}

// Splat the warp's 32 items, one per lane, into the patch slab that holds
// patch x-rows [x0, x0 + ex) (module notes, step 1).  Every lane runs the
// same passes and taps, so the __syncwarp calls match.
template <int NT, int SPEC>
__device__ __forceinline__ void splat_round(float* patch,
                                            const Item<NT, SPEC>& it,
                                            const int* order, int x0, int ex,
                                            int Ey, int Ez) {
  const int lane = threadIdx.x;
  // lanes whose items share a node origin would meet at every tap
  const unsigned key =
      it.live ? (unsigned)((it.n0[0] * Ey + it.n0[1]) * Ez + it.n0[2])
              : 0x80000000u + (unsigned)lane;
  const unsigned peers = __match_any_sync(kFull, key);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const long long plane = (long long)Ey * Ez;
  for (int r = 0; __any_sync(kFull, it.live && rank >= r); ++r) {
    const bool mine = it.live && rank == r;
#pragma unroll
    for (int jy = 0; jy < NT; ++jy) {
      if (jy > order[1]) break;
#pragma unroll
      for (int jz = 0; jz < NT; ++jz) {
        if (jz > order[2]) break;
        float a = 0.f, b = 0.f, c = 0.f;
        column<NT, SPEC>(it, jy, jz, a, b, c);
        float* col = patch + (it.n0[1] + jy) * Ez + it.n0[2] + jz;
#pragma unroll
        for (int jx = 0; jx < NT; ++jx) {
          if (jx > order[0]) break;
          const int lx = it.n0[0] + jx - x0;
          if (mine && lx >= 0 && lx < ex)
            col[lx * plane] += column_tap<NT, SPEC>(it, jx, a, b, c);
          __syncwarp();
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_slab(float* patch, int count) {
  for (int i = threadIdx.x; i < count; i += kWarp) patch[i] = 0.f;
  __syncwarp();
}

// Copy a finished slab to its place in the block's scratch patch.
__device__ __forceinline__ void store_slab(float* dst, const float* patch,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += kWarp) dst[i] = patch[i];
  __syncwarp();
}

// out (B, C, n0, n1, n2): each voxel sums the patch cells that fold onto
// it (module notes, step 3), in the fixed order of the host's tables.
// scratch is (C, B, NB0, NB1, NB2, E0, E1, E2); a cell's offset in one
// (c, b) block is the sum of its three axes' offsets.
__global__ void __launch_bounds__(256)
    overlap_fold_kernel(const float* __restrict__ scratch,
                        float* __restrict__ out, const PatchGeom g) {
  const long long nvox = (long long)g.n[0] * g.n[1] * g.n[2];
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= g.B * g.C * nvox) return;
  const long long bc = v / nvox;
  const long long r = v - bc * nvox;
  const int q2 = (int)(r % g.n[2]);
  const long long r01 = r / g.n[2];
  const int q1 = (int)(r01 % g.n[1]);
  const int q0 = (int)(r01 / g.n[1]);
  const long long b = bc / g.C, c = bc - b * g.C;
  const long long block = (long long)g.NB[0] * g.NB[1] * g.NB[2] * g.E[0] *
                          g.E[1] * g.E[2];
  const float* base = scratch + (c * g.B + b) * block;
  const int e0 = g.cell_start[0][q0 + 1], e1 = g.cell_start[1][q1 + 1];
  const int e2 = g.cell_start[2][q2 + 1];
  float acc = 0.f;
  for (int i0 = g.cell_start[0][q0]; i0 < e0; ++i0) {
    const long long o0 = g.cell_off[0][i0];
    const float s0 = g.cell_sign[0][i0];
    for (int i1 = g.cell_start[1][q1]; i1 < e1; ++i1) {
      const float* row = base + o0 + g.cell_off[1][i1];
      float sum = 0.f;
      for (int i2 = g.cell_start[2][q2]; i2 < e2; ++i2)
        sum += g.cell_sign[2][i2] * __ldg(row + g.cell_off[2][i2]);
      acc += (s0 * g.cell_sign[1][i1]) * sum;
    }
  }
  out[v] = acc;
}

// Allow a patch kernel more than the default 48 KB of dynamic shared
// memory (the host keeps patch + stage under the card's 227 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch_overlap(const float* scratch, float* out,
                           const PatchGeom& g, cudaStream_t s) {
  const long long total = g.B * g.C * (long long)g.n[0] * g.n[1] * g.n[2];
  const long long blocks = (total + 255) / 256;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  overlap_fold_kernel<<<(unsigned)blocks, 256, 0, s>>>(scratch, out, g);
  return cudaGetLastError();
}

}  // namespace
