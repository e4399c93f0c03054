// Closest-hit best-key sweep for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel simple_spectral_tpu/render/intersect_pallas.py
// `_kernel` (launched by `intersect_best_key`).  For every ray it runs the
// Woop/Benthin/Wald watertight test (reference src/geometry.cpp:12-101)
// against all T triangles and returns one int32 per ray:
//
//     min over t of  valid ? (bits(dist) & ~idx_mask) | t  :  INF_BITS
//
// INF_BITS (0x7F800000) means a miss; positive-float bits are monotonic as
// int32, so the min key is the closest hit, ties within the dropped mantissa
// bits going to the lower triangle index.
//
// Arithmetic: the sheared coordinates are computed as the JAX package's
// `intersect_rays_soa2` does (render/intersect.py:448-483): first v - o, then
// the shear, in plain FP32.  The TPU kernel's matmul projection is not
// carried over (K = 3 leaves nothing for tensor cores).  Built with
// -fmad=false, every operation is one IEEE-rounded FP32 op in the same order
// as the plain PyTorch twin (render/intersect_pallas.py `best_key_plain`), so
// the two agree key for key.
//
// Bound on the card: per (ray, triangle) test 38 FP32 operations run
// unconditionally (9 subtractions for v - o, 12 for the shear, 9 for the
// scaled barycentrics, 2 for det, 6 for the scaled distance) plus one
// division for the candidates.  At the main path's N = 262144 rays and
// T = 38 that is 0.38 GFLOP, about 5.6 us at the H100's 67 TFLOP/s of
// non-tensor FP32, against 8.4 MB of ray traffic (24 B of ray, 4 B of ignore
// id in, 4 B of key out per ray: 2.5 us at 3.35 TB/s).  The sweep is
// compute bound.  The design spends its instructions on the tests: one
// thread per ray keeps its ray, shear and running best key in registers;
// the block stages the triangle rows into shared memory once per tile of
// 1024 triangles, where every thread of a warp reads the same triangle
// (a broadcast).  The per-lane axis permutation is folded into the shared
// memory row index instead of select instructions; a row stride of
// TILE + 1 words keeps the three permuted rows of one triangle in distinct
// banks.  The division runs only for candidates that passed the edge, det,
// sign and ignore tests.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 1024;
constexpr int kStride = kTile + 1;
constexpr int kInfBits = 0x7F800000;

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__global__ void __launch_bounds__(kBlock)
best_key_kernel(const float* __restrict__ rays,   // [6, n]: ox oy oz dx dy dz
                const int* __restrict__ ignore,   // [n]
                const float* __restrict__ tris,   // [t, 9]: v0xyz v1xyz v2xyz
                const int* __restrict__ prim,     // [t]
                int* __restrict__ out,            // [n]
                int n, int t, int idx_mask, float eps) {
  __shared__ float s_v[9 * kStride];
  __shared__ int s_prim[kTile];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float o[3] = {0.f, 0.f, 0.f};
  float d[3] = {0.f, 0.f, 1.f};
  int ign = -1;
  if (live) {
    for (int a = 0; a < 3; ++a) {
      o[a] = rays[(size_t)a * n + i];
      d[a] = rays[(size_t)(3 + a) * n + i];
    }
    ign = ignore[i];
  }

  // Per-lane axis permutation and shear (reference src/geometry.cpp:16-45).
  const float adx = fabsf(d[0]), ady = fabsf(d[1]), adz = fabsf(d[2]);
  const bool x_wins = (adx > ady) && (adx > adz);
  const bool y_wins = !x_wins && (ady > adz);
  const int kz = x_wins ? 0 : (y_wins ? 1 : 2);
  int kx = (kz == 2) ? 0 : kz + 1;
  int ky = (kx == 2) ? 0 : kx + 1;
  const float d_kz = sel3(kz, d[0], d[1], d[2]);
  if (d_kz < 0.f) {
    const int tmp = kx;
    kx = ky;
    ky = tmp;
  }
  // A zero d[kz] only comes from an all-zero direction (render/intersect.py:86).
  const float inv_dz = 1.0f / (d_kz == 0.f ? 1.0f : d_kz);
  const float sx = sel3(kx, d[0], d[1], d[2]) * inv_dz;
  const float sy = sel3(ky, d[0], d[1], d[2]) * inv_dz;
  const float sz = inv_dz;
  const float o_kx = sel3(kx, o[0], o[1], o[2]);
  const float o_ky = sel3(ky, o[0], o[1], o[2]);
  const float o_kz = sel3(kz, o[0], o[1], o[2]);
  const int row_x = kx * kStride, row_y = ky * kStride, row_z = kz * kStride;

  int best = kInfBits;
  for (int base = 0; base < t; base += kTile) {
    const int cnt = min(kTile, t - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kBlock) {
      const float* r = tris + (size_t)(base + j) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) s_v[k * kStride + j] = r[k];
      s_prim[j] = prim[base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      // sheared coordinates of (v - o) for the three vertices
      float ax[3], ay[3], az[3];
#pragma unroll
      for (int vert = 0; vert < 3; ++vert) {
        const float* sv = s_v + vert * 3 * kStride + j;
        const float r_kx = sv[row_x] - o_kx;
        const float r_ky = sv[row_y] - o_ky;
        const float r_kz = sv[row_z] - o_kz;
        ax[vert] = r_kx - sx * r_kz;
        ay[vert] = r_ky - sy * r_kz;
        az[vert] = r_kz;
      }
      // scaled barycentrics (reference src/geometry.cpp:52-56)
      const float u = ay[1] * ax[2] - ax[1] * ay[2];
      const float v = ay[2] * ax[0] - ax[2] * ay[0];
      const float w = ay[0] * ax[1] - ax[0] * ay[1];
      // edge test, zeros counted inside (render/intersect.py:115-116)
      const bool inside = (u >= 0.f && v >= 0.f && w >= 0.f) || (u <= 0.f && v <= 0.f && w <= 0.f);
      const float det = u + v + w;
      const float t_scaled = sz * (u * az[0] + v * az[1] + w * az[2]);
      const bool same_sign = (__float_as_int(det) < 0) == (__float_as_int(t_scaled) < 0);
      if (inside && fabsf(det) > eps && same_sign && s_prim[j] != ign) {
        const float dist = t_scaled / det;
        if (dist >= eps) {
          const int key = (__float_as_int(dist) & ~idx_mask) | (base + j);
          best = min(best, key);
        }
      }
    }
  }
  if (live) out[i] = best;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int intersect_best_key_launch(const float* rays, const int* ignore, const float* tris,
                                         const int* prim, int* out, int n, int t, int idx_mask,
                                         float eps, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  best_key_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(rays, ignore, tris, prim, out, n, t,
                                                                         idx_mask, eps);
  return static_cast<int>(cudaGetLastError());
}
