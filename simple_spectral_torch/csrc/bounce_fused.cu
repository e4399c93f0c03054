// One fused bounce step for Hopper (sm_90a): kernel S1 of the port.
//
// Replaces the TPU spike tools/bench_megakernel.py `_kernel` (a Pallas
// kernel over 1024-lane blocks that runs `_bounce_jnp` with the scene in
// VMEM).  Per lane, with rays f32[8, N] (ox oy oz dx dy dz ignore pad) and
// uniforms f32[4, N], it computes, all in registers:
//
//   1. the closest hit over the 40 rows of the cornell scene (38 triangles,
//      2 padding rows), watertight shear test, key (bits(dist) & ~63) | row,
//      the least key winning (a miss leaves row 0);
//   2. the winner's normal and primitive id bits;
//   3. an area sample on the light quad, normalised with rsqrtf;
//   4. the shadow closest hit from the hit point, ignoring the winner's
//      primitive;
//   5. a cosine-hemisphere direction around the normal (Duff et al.'s ONB);
//
// and writes f32[8, N]: dist (quantized, inf on a miss), prim bits, shadow
// prim bits, wi xyz, n.wi, 0.  The row layout is the spike's: word 0 the
// kind (1.0f a triangle), words 2..10 the vertices, word 11 the prim id's
// int32 bits, words 12..14 the normal.  Primitive ids are compared as bits,
// never as floats: ids are denormals as floats, which a flush-to-zero
// machine (the TPU, XLA on the CPU) reads as 0.
//
// Arithmetic follows the plain PyTorch twin
// (simple_spectral_torch/tools/bench_megakernel.py `bounce_plain`) operation
// for operation; built with -fmad=false every FP32 operation rounds once, as
// the twin's unfused torch operations do, and sqrtf/sinf/cosf/rsqrtf are the
// functions torch's CUDA kernels call, so the two agree bit for bit on the
// card.  Both sweeps are K1's (closest_hit.cuh), with the key's six low bits
// holding the row.  Two departures from the twin's form change no result:
// the division runs only for candidates (the twin divides everywhere and
// masks the same lanes), and the sign test reads sign bits where the twin
// compares with 0 (they differ only on a zero det, which fails |det| > eps,
// or a zero t_scaled, whose distance of zero fails dist >= eps = 1e-3).
//
// Bound on the card: each sweep runs 38 FP32 operations per (lane, triangle)
// (K1's count) over the 38 triangle rows, twice, plus about 84 per lane for
// the light sample, the hit point, the axis picks and the ONB: ~2970 per
// lane, 0.78 GFLOP at N = 262144, 11.6 us at 67 TFLOP/s (which counts an
// FMA as two), against 80 B per lane in and out (21 MB, 6.3 us at
// 3.35 TB/s).  As in K1 the instructions issued per test bound the sweeps:
// one lane per thread that divides for every row (76 IEEE divisions per
// lane) and tests the kind word of every row issues 87 per test (an issue
// floor of 51.8 us for the two sweeps of 262144 lanes), this kernel 55
// (32.8 us; tools/kernel_report.py).  The design is K1's: the six-copy
// tile, two lanes per thread, the row loop unrolled by two with one branch
// per step to the candidates' divisions, and the grid sized to what is
// resident with each CTA striding over groups of lanes.  Staging keeps only
// the rows whose kind word is 1.0f, in order, with their row numbers, once
// per CTA, so the sweeps run no kind test and no padding row; the rays are
// read again after the first sweep and the winner's words after the
// second, rather than held in registers through a sweep.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "closest_hit.cuh"

namespace {

using closest_hit::kInfBits;

constexpr int kBlock = 128;
constexpr int kLanes = 2;      // lanes per thread
constexpr int kUnroll = 2;     // rows per loop step
constexpr int kRows = 40;      // rows of the scene block
constexpr int kSel = 38;       // rows whose normal and prim a winner can select
constexpr int kRowWidth = 128;
constexpr int kKeep = ~63;     // the key's distance bits
constexpr float kEps = 1e-3f;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi)

struct RowOf {
  const int* s_row;
  __device__ int operator()(int j) const { return s_row[j]; }
};

// Closest hit of each ray over the staged triangle rows: the winning key,
// (bits(dist) & ~63) | row, or INF_BITS (row 0) on a miss.
__device__ __forceinline__ void closest(const float* s_t, const int* s_row, int cnt,
                                        const closest_hit::Ray (&rays)[kLanes], int (&key)[kLanes]) {
  int bits[kLanes], row[kLanes];
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    bits[q] = kInfBits;
    row[q] = 0;
  }
  closest_hit::sweep<kLanes, kUnroll>(s_t, cnt, RowOf{s_row}, rays, kKeep, kEps, bits, row);
#pragma unroll
  for (int q = 0; q < kLanes; ++q) key[q] = bits[q] | row[q];
}

// No minimum of CTAs per SM: uncapped, the compiler takes 56 registers and
// 9 CTAs fit an SM; a cap at 8 or 9 CTAs spills (tools/kernel_variants.py).
__global__ void __launch_bounds__(kBlock)
bounce_kernel(const float* __restrict__ rows,   // [40, 128]
              const float* __restrict__ light,  // [8, 128]; row 0: corner, edge u, edge v
              const float* __restrict__ rays,   // [8, n]
              const float* __restrict__ u,      // [4, n]
              float* __restrict__ out,          // [8, n]
              int n) {
  __shared__ __align__(16) float s_t[closest_hit::tile_words(kRows)];  // the triangle rows, as K1's tile
  __shared__ int s_row[kRows];  // their row numbers
  __shared__ float s_sel[4][kRows];   // words 11..14 of every row: prim bits, normal
  __shared__ float s_light[9];
  __shared__ int s_cnt;

  // Rows of kind 1.0f, in order: warp 0 ranks them with a ballot.
  if (threadIdx.x < 32) {
    int cnt = 0;
    for (int r0 = 0; r0 < kRows; r0 += 32) {
      const int r = r0 + threadIdx.x;
      const bool tri = r < kRows && rows[r * kRowWidth] == 1.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, tri);
      if (tri) {
        const int j = cnt + __popc(ballot & ((1u << threadIdx.x) - 1u));
        s_row[j] = r;
        float v[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) v[k] = rows[r * kRowWidth + 2 + k];
        closest_hit::stage(s_t, kRows, j, v, __float_as_int(rows[r * kRowWidth + 11]));
      }
      cnt += __popc(ballot);
    }
    if (threadIdx.x == 0) s_cnt = cnt;
  }
  for (int k = threadIdx.x; k < 4 * kRows; k += kBlock)
    s_sel[k / kRows][k % kRows] = rows[(k % kRows) * kRowWidth + 11 + k / kRows];
  if (threadIdx.x < 9) s_light[threadIdx.x] = light[threadIdx.x];
  __syncthreads();
  const int cnt = s_cnt;
  const size_t sn = static_cast<size_t>(n);

  for (int group = blockIdx.x * kBlock * kLanes; group < n; group += gridDim.x * kBlock * kLanes) {
    // 1-2. closest hit, the winner's normal and prim
    closest_hit::Ray ray[kLanes];
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = group + q * kBlock + threadIdx.x;
      const bool live = i < n;
      ray[q] = closest_hit::shear(live ? rays[i] : 0.f, live ? rays[sn + i] : 0.f, live ? rays[2 * sn + i] : 0.f,
                                  live ? rays[3 * sn + i] : 0.f, live ? rays[4 * sn + i] : 0.f,
                                  live ? rays[5 * sn + i] : 1.f, live ? __float_as_int(rays[6 * sn + i]) : -1,
                                  kRows);
    }
    int win[kLanes];
    closest(s_t, s_row, cnt, ray, win);

    // the rays are read again (from the cache), and the winner's words after
    // the shadow sweep, rather than held through a sweep
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = group + q * kBlock + threadIdx.x;
      const bool live = i < n;
      const float ox = live ? rays[i] : 0.f, oy = live ? rays[sn + i] : 0.f, oz = live ? rays[2 * sn + i] : 0.f;
      const float dx = live ? rays[3 * sn + i] : 0.f, dy = live ? rays[4 * sn + i] : 0.f;
      const float dz = live ? rays[5 * sn + i] : 1.f;
      const float u0 = live ? u[i] : 0.f, u1 = live ? u[sn + i] : 0.f;
      const int wrow = win[q] & 63;
      const float dist = win[q] < kInfBits ? __int_as_float(win[q] & ~63) : INFINITY;
      const bool hit = isfinite(dist);
      const float sd = hit ? dist : 0.f;
      const float hx = ox + sd * dx, hy = oy + sd * dy, hz = oz + sd * dz;
      const float wprim = wrow < kSel ? s_sel[0][wrow] : 0.f;

      // 3. area sample on the light quad, the shadow ray
      const float lx = s_light[0] + u0 * s_light[3] + u1 * s_light[6];
      const float ly = s_light[1] + u0 * s_light[4] + u1 * s_light[7];
      const float lz = s_light[2] + u0 * s_light[5] + u1 * s_light[8];
      float sx = lx - hx, sy = ly - hy, sz = lz - hz;
      const float sl = rsqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
      sx = sx * sl;
      sy = sy * sl;
      sz = sz * sl;
      ray[q] = closest_hit::shear(hx, hy, hz, sx, sy, sz, __float_as_int(wprim), kRows);
    }
    // 4. shadow closest hit
    int swin[kLanes];
    closest(s_t, s_row, cnt, ray, swin);

#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = group + q * kBlock + threadIdx.x;
      if (i >= n) continue;
      const int srow = swin[q] & 63;
      const float sprim = srow < kSel ? s_sel[0][srow] : 0.f;
      const int wrow = win[q] & 63;
      const float dist = win[q] < kInfBits ? __int_as_float(win[q] & ~63) : INFINITY;
      const bool sel = wrow < kSel;
      const float wprim = sel ? s_sel[0][wrow] : 0.f;
      const float nx = sel ? s_sel[1][wrow] : 0.f;
      const float ny = sel ? s_sel[2][wrow] : 0.f;
      const float nz = sel ? s_sel[3][wrow] : 0.f;

      // 5. cosine-hemisphere direction around the normal (Duff ONB)
      const float ang = u[2 * sn + i] * kTwoPi;
      const float r2 = u[3 * sn + i];
      const float rad = sqrtf(r2);
      const float yy = sqrtf(fmaxf(1.0f - r2, 0.f));
      const float sign = nz >= 0.f ? 1.0f : -1.0f;
      const float a = -1.0f / (sign + nz);
      const float b = nx * ny * a;
      const float bx0 = 1.0f + sign * nx * nx * a, bx1 = sign * b, bx2 = -sign * nx;
      const float bz0 = b, bz1 = sign + ny * ny * a, bz2 = -ny;
      const float ca = cosf(ang), sa = sinf(ang);
      const float rca = rad * ca, rsa = rad * sa;
      const float wix = rca * bx0 + yy * nx + rsa * bz0;
      const float wiy = rca * bx1 + yy * ny + rsa * bz1;
      const float wiz = rca * bx2 + yy * nz + rsa * bz2;
      const float ndl = wix * nx + wiy * ny + wiz * nz;

      out[i] = dist;
      out[sn + i] = wprim;
      out[2 * sn + i] = sprim;
      out[3 * sn + i] = wix;
      out[4 * sn + i] = wiy;
      out[5 * sn + i] = wiz;
      out[6 * sn + i] = ndl;
      out[7 * sn + i] = 0.f;
    }
  }
}

int grid_for(int n) {
  static int ctas_per_sm = 0;  // the occupancy depends on the build alone
  if (ctas_per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, bounce_kernel, kBlock, 0) != cudaSuccess)
    ctas_per_sm = 1;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (n + kBlock * kLanes - 1) / (kBlock * kLanes);
  return min(groups, max(1, ctas_per_sm) * sms);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int bounce_fused_launch(const float* rows, const float* light, const float* rays, const float* u,
                                   float* out, int n, void* stream) {
  if (n <= 0) return 0;
  bounce_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(rows, light, rays, u, out, n);
  return static_cast<int>(cudaGetLastError());
}
