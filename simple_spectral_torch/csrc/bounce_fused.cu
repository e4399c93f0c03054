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
// card.
//
// Bound on the card: each sweep runs 38 FP32 operations per (lane, triangle)
// (K1's count) over the 38 triangle rows, twice, plus about 84 per lane for
// the light sample, the hit point, the axis picks and the ONB: ~2970 per
// lane, 0.78 GFLOP at N = 262144, 11.6 us at 67 TFLOP/s, against 80 B per
// lane in and out (21 MB, 6.3 us at 3.35 TB/s).  Compute bound.  The design
// keeps both sweeps in registers: one thread per lane, the 15 used words of
// the 40 rows and the 9 light words staged in shared memory once per block
// (every thread of a warp reads the same row: a broadcast), and the padding
// rows skipped on the kind word, which is uniform across the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRows = 40;     // rows of the scene block
constexpr int kSel = 38;      // rows whose normal and prim a winner can select
constexpr int kWords = 15;    // words 0..14 of a row
constexpr int kRowWidth = 128;
constexpr int kInfBits = 0x7F800000;
constexpr float kEps = 1e-3f;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi)

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// Closest hit of one ray over the rows; returns the winning key.
__device__ __forceinline__ int closest(const float (*s_rows)[kRows], float ox, float oy, float oz, float dx,
                                       float dy, float dz, int ign_bits) {
  const float aax = fabsf(dx), aay = fabsf(dy), aaz = fabsf(dz);
  const bool x_wins = (aax > aay) && (aax > aaz);
  const bool y_wins = !x_wins && (aay > aaz);
  const int kz = x_wins ? 0 : (y_wins ? 1 : 2);
  int kx = (kz == 2) ? 0 : kz + 1;
  int ky = (kx == 2) ? 0 : kx + 1;
  const float d_kz = sel3(kz, dx, dy, dz);
  if (d_kz < 0.f) {
    const int tmp = kx;
    kx = ky;
    ky = tmp;
  }
  const float inv_dz = 1.0f / (d_kz == 0.f ? 1.0f : d_kz);
  const float sx = sel3(kx, dx, dy, dz) * inv_dz;
  const float sy = sel3(ky, dx, dy, dz) * inv_dz;
  const float o_kx = sel3(kx, ox, oy, oz), o_ky = sel3(ky, ox, oy, oz), o_kz = sel3(kz, ox, oy, oz);

  int best = 0x7FFFFFFF;
  for (int r = 0; r < kRows; ++r) {
    int key = kInfBits | r;  // the key of a row that does not hit
    if (s_rows[0][r] == 1.0f) {
      float ax[3], ay[3], az[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float r_kx = s_rows[2 + 3 * v + kx][r] - o_kx;
        const float r_ky = s_rows[2 + 3 * v + ky][r] - o_ky;
        const float r_kz = s_rows[2 + 3 * v + kz][r] - o_kz;
        ax[v] = r_kx - sx * r_kz;
        ay[v] = r_ky - sy * r_kz;
        az[v] = r_kz;
      }
      const float uu = ay[1] * ax[2] - ax[1] * ay[2];
      const float vv = ay[2] * ax[0] - ax[2] * ay[0];
      const float ww = ay[0] * ax[1] - ax[0] * ay[1];
      const bool inside = (uu >= 0.f && vv >= 0.f && ww >= 0.f) || (uu <= 0.f && vv <= 0.f && ww <= 0.f);
      const float det = uu + vv + ww;
      const float t_scaled = inv_dz * (uu * az[0] + vv * az[1] + ww * az[2]);
      const bool same_sign = (det < 0.f) == (t_scaled < 0.f);
      const float dist = t_scaled / (det == 0.f ? 1.0f : det);
      if (inside && fabsf(det) > kEps && same_sign && dist >= kEps && __float_as_int(s_rows[11][r]) != ign_bits) {
        key = (__float_as_int(dist) & ~63) | r;
      }
    }
    best = min(best, key);
  }
  return best;
}

__global__ void __launch_bounds__(kBlock)
bounce_kernel(const float* __restrict__ rows,   // [40, 128]
              const float* __restrict__ light,  // [8, 128]; row 0: corner, edge u, edge v
              const float* __restrict__ rays,   // [8, n]
              const float* __restrict__ u,      // [4, n]
              float* __restrict__ out,          // [8, n]
              int n) {
  __shared__ float s_rows[kWords][kRows];
  __shared__ float s_light[9];
  for (int k = threadIdx.x; k < kWords * kRows; k += kBlock) {
    const int w = k / kRows, r = k % kRows;
    s_rows[w][r] = rows[r * kRowWidth + w];
  }
  if (threadIdx.x < 9) s_light[threadIdx.x] = light[threadIdx.x];
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t sn = static_cast<size_t>(n);
  const float ox = rays[i], oy = rays[sn + i], oz = rays[2 * sn + i];
  const float dx = rays[3 * sn + i], dy = rays[4 * sn + i], dz = rays[5 * sn + i];
  const int ign = __float_as_int(rays[6 * sn + i]);
  const float u0 = u[i], u1 = u[sn + i], u2 = u[2 * sn + i], u3 = u[3 * sn + i];

  // 1-2. closest hit, the winner's normal and prim
  const int win = closest(s_rows, ox, oy, oz, dx, dy, dz, ign);
  const int wrow = win & 63;
  const float dist = win < kInfBits ? __int_as_float(win & ~63) : INFINITY;
  const bool hit = isfinite(dist);
  const float sd = hit ? dist : 0.f;
  const float hx = ox + sd * dx, hy = oy + sd * dy, hz = oz + sd * dz;
  const bool sel = wrow < kSel;
  const float nx = sel ? s_rows[12][wrow] : 0.f;
  const float ny = sel ? s_rows[13][wrow] : 0.f;
  const float nz = sel ? s_rows[14][wrow] : 0.f;
  const float wprim = sel ? s_rows[11][wrow] : 0.f;

  // 3-4. area sample on the light quad, shadow closest hit
  const float lx = s_light[0] + u0 * s_light[3] + u1 * s_light[6];
  const float ly = s_light[1] + u0 * s_light[4] + u1 * s_light[7];
  const float lz = s_light[2] + u0 * s_light[5] + u1 * s_light[8];
  float sx = lx - hx, sy = ly - hy, sz = lz - hz;
  const float sl = rsqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
  sx = sx * sl;
  sy = sy * sl;
  sz = sz * sl;
  const int swin = closest(s_rows, hx, hy, hz, sx, sy, sz, __float_as_int(wprim));
  const int srow = swin & 63;
  const float sprim = srow < kSel ? s_rows[11][srow] : 0.f;

  // 5. cosine-hemisphere direction around the normal (Duff ONB)
  const float ang = u2 * kTwoPi;
  const float r2 = u3;
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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int bounce_fused_launch(const float* rows, const float* light, const float* rays, const float* u,
                                   float* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bounce_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(rows, light, rays, u, out, n);
  return static_cast<int>(cudaGetLastError());
}
