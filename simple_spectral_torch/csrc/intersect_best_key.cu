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
// bits going to the lower triangle index.  That quantized key is the Pallas
// kernel's, and the one of the JAX package's "xla2" sweep.
//
// The second, exact width returns one 64-bit key per ray:
//
//     min over t of  valid ? (uint64(bits(dist)) << 32) | t  :  INF_BITS << 32
//
// whose minimum is the least distance, exact-equal distances going to the
// first index: the winner of the JAX package's "xla" sweep (`jnp.argmin`).
//
// The test and its arithmetic are in closest_hit.cuh, shared with S1.  The
// TPU kernel's matmul projection is not carried over (K = 3 leaves nothing
// for tensor cores).  Built with -fmad=false, the kernel agrees key for key
// with the plain PyTorch twin (render/intersect_pallas.py `best_key_plain`).
//
// Bound on the card: per (ray, triangle) test 38 FP32 operations run
// unconditionally (9 subtractions for v - o, 12 for the shear, 9 for the
// scaled barycentrics, 2 for det, 6 for the scaled distance) plus one
// division for the candidates.  At the main path's N = 262144 rays and
// T = 38 that is 0.38 GFLOP, 5.6 us at the H100's 67 TFLOP/s of non-tensor
// FP32 (a rate that counts an FMA as two; -fmad=false leaves the test none,
// so its 38 operations take 38 issue slots), against 7.3 MB of ray traffic
// (24 B of ray and 4 B of ignore id in, 4 or 8 B of key out per ray: 2.2 us
// at 3.35 TB/s).  What bounds the kernel is the instructions it issues per
// test: at 128 thread-instructions per clock per SM, 132 SMs and 1.98 GHz,
// each instruction per test costs 0.3 us of issue over the main path's
// sweep.  One ray per thread over a tile of nine permuted rows issues 73
// per test (an issue floor of 21.7 us): the 38 operations, 9 shared loads
// at permuted addresses, one for the primitive id, 12 compares and
// predicate operations, and 13 of loop and address arithmetic that
// recompute the three permuted row addresses every test.  This kernel
// issues 55.75 (16.6 us): the 38 operations, 3 shared loads, the compares
// and 2 of loop (tools/kernel_report.py counts them in the SASS and prints
// that floor).
//
// The design spends the issue slots on the tests:
//   - the tile holds each triangle in all six axis orders (closest_hit.cuh),
//     so a test reads its nine vertex words and the primitive id with two
//     16-byte and one 8-byte load from its ray's copy, and the loads of a
//     step take immediate offsets from one pointer per ray;
//   - a thread takes kRays rays, each with its own shear and running best in
//     registers, and the loop runs kUnroll triangles per step; a step runs
//     its kRays x kUnroll candidate tests with no branch between them and
//     branches once, to the divisions of its candidates;
//   - the running best is (distance bits, index), compared on the bits
//     alone and packed once at the end, for both widths;
//   - the rays come as six f32[N] component arrays, as the render keeps
//     them, so no stacked copy is made per sweep;
//   - the grid is sized to what is resident (CTAs per SM from the occupancy
//     API, times the SMs), each CTA striding over groups of rays; the
//     triangles go through shared memory in tiles of kTile (18.5 KB with
//     the six copies), staged once per CTA when T fits one tile (the main
//     path's 38) and per tile and group otherwise.  A 1024-triangle tile
//     (41 KB) would hold an SM to 5 CTAs whatever T is.
// tools/kernel_variants.py times each of these choices undone, and
// PERF.md holds the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

using closest_hit::kInfBits;

constexpr int kBlock = 128;
constexpr int kMinBlocks = 8;  // CTAs per SM the registers must allow
constexpr int kRays = 2;       // rays per thread
constexpr int kUnroll = 2;     // triangles per loop step
constexpr int kTile = 64;      // triangles per shared-memory tile

// Bits of the running best and the packed key, per width.
template <bool kWide>
struct Key;

template <>
struct Key<false> {
  using Bits = int;
  using T = int;
  __device__ static T pack(Bits bits, int idx) { return bits == kInfBits ? kInfBits : (bits | idx); }
};

template <>
struct Key<true> {
  using Bits = unsigned;
  using T = unsigned long long;
  __device__ static T pack(Bits bits, int idx) {
    return (static_cast<T>(bits) << 32) | (bits == static_cast<Bits>(kInfBits) ? 0u : static_cast<unsigned>(idx));
  }
};

struct Identity {
  int base;
  __device__ int operator()(int j) const { return base + j; }
};

// Stage triangles [base, base + cnt) into the tile, one thread per
// triangle.
__device__ __forceinline__ void stage(const float* __restrict__ tris, const int* __restrict__ prim, int base, int cnt,
                                      float* s_t) {
  for (int j = threadIdx.x; j < cnt; j += kBlock) {
    float v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = tris[(size_t)(base + j) * 9 + k];
    closest_hit::stage(s_t, kTile, j, v, prim[base + j]);
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
best_key_kernel(const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
                const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
                const int* __restrict__ ignore,   // [n]
                const float* __restrict__ tris,   // [t, 9]: v0xyz v1xyz v2xyz
                const int* __restrict__ prim,     // [t]
                typename Key<kWide>::T* __restrict__ out,  // [n]
                int n, int t, int idx_mask, float eps) {
  using K = Key<kWide>;
  __shared__ __align__(16) float s_t[closest_hit::tile_words(kTile)];
  const int keep = kWide ? ~0 : ~idx_mask;
  const bool one_tile = t <= kTile;
  if (one_tile) {
    stage(tris, prim, 0, t, s_t);
    __syncthreads();
  }
  // Every thread of a CTA runs the same groups, so the barriers below are
  // reached by all of them.
  for (int group = blockIdx.x * kBlock * kRays; group < n; group += gridDim.x * kBlock * kRays) {
    closest_hit::Ray rays[kRays];
    typename K::Bits best_bits[kRays];
    int best_idx[kRays];
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int i = group + q * kBlock + threadIdx.x;
      const bool live = i < n;
      rays[q] = closest_hit::shear(live ? ox[i] : 0.f, live ? oy[i] : 0.f, live ? oz[i] : 0.f, live ? dx[i] : 0.f,
                                   live ? dy[i] : 0.f, live ? dz[i] : 1.f, live ? ignore[i] : -1, kTile);
      best_bits[q] = static_cast<typename K::Bits>(kInfBits);
      best_idx[q] = 0;
    }
    for (int base = 0; base < t; base += kTile) {
      const int cnt = min(kTile, t - base);
      if (!one_tile) {
        __syncthreads();
        stage(tris, prim, base, cnt, s_t);
        __syncthreads();
      }
      closest_hit::sweep<kRays, kUnroll>(s_t, cnt, Identity{base}, rays, keep, eps, best_bits, best_idx);
    }
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int i = group + q * kBlock + threadIdx.x;
      if (i < n) out[i] = K::pack(best_bits[q], best_idx[q]);
    }
  }
}

template <bool kWide>
int grid_for(int n) {
  static int ctas_per_sm = 0;  // per width; the occupancy depends on the build alone
  if (ctas_per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, best_key_kernel<kWide>, kBlock, 0) != cudaSuccess)
    ctas_per_sm = 1;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (n + kBlock * kRays - 1) / (kBlock * kRays);
  return min(groups, max(1, ctas_per_sm) * sms);
}

}  // namespace

// Launch on `stream`; `out` is int32[n] (wide = 0) or uint64[n] (wide = 1).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int intersect_best_key_launch(const float* ox, const float* oy, const float* oz, const float* dx,
                                         const float* dy, const float* dz, const int* ignore, const float* tris,
                                         const int* prim, void* out, int n, int t, int idx_mask, float eps, int wide,
                                         void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    best_key_kernel<true><<<grid_for<true>(n), kBlock, 0, s>>>(ox, oy, oz, dx, dy, dz, ignore, tris, prim,
                                                               static_cast<unsigned long long*>(out), n, t,
                                                               idx_mask, eps);
  } else {
    best_key_kernel<false><<<grid_for<false>(n), kBlock, 0, s>>>(ox, oy, oz, dx, dy, dz, ignore, tris, prim,
                                                                 static_cast<int*>(out), n, t, idx_mask, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
