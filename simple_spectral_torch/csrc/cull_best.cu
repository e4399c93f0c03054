// Block-cull closest hit for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the TPU kernel simple_spectral_tpu/render/cull.py `_kernel`
// (launched by `_cull_best`).  One CTA takes one block of 1024 ray lanes, one
// thread per lane, and walks the block's front-to-back cluster list from the
// slab cull (render/cull.py `cull_lists`).  For each listed cluster it
//
//   - prunes each lane whose AABB slab test misses or starts beyond the
//     lane's running best distance;
//   - tests the cluster's rows (1..L, L <= 63) on the live lanes: the
//     watertight triangle test (reference src/geometry.cpp:12-101) or the
//     nearest sphere root >= eps, skipping the lane's ignored primitive;
//   - keeps per lane the least key (bits(dist) & ~63) | row over the tile,
//     and takes it, with the flat slot c * (1 + L) + 1 + row, only if it is
//     strictly below the running best key.
//
// and writes i32[2, Np]: row 0 the quantized key (INF_BITS = miss), row 1
// the slot.  The winner is the least (quantized distance, list position,
// row), as on the TPU.
//
// Early exit: the list is sorted by the block's least entry distance, so
// once the next entry's bits exceed every real lane's best key, every later
// cluster fails every lane's prune (its slab tn is at least that entry,
// computed by the same FP32 operations as the cull), and the walk stops.
// The vote is one __syncthreads_or per cluster; lanes from n_valid on (the
// padding of the last block) take no part and write (INF_BITS, 0).
//
// Staging: each cluster tile is copied into shared memory with cp.async,
// double-buffered, the next tile's copy in flight while the current one is
// tested.  Only the 12 words of each row that the tests read are copied
// (three 16-byte chunks per row); the rows in device memory are 128 words
// wide, the TPU's alignment.  Every thread of the CTA tests the same row at
// the same time, so a row is a shared-memory broadcast and its kind is a
// uniform branch: a triangle row runs only the triangle test, a sphere row
// only the quadratic (the TPU computed both for every row).
//
// Arithmetic: built with -fmad=false, every operation is one IEEE-rounded
// FP32 operation in the order of the plain twin (render/cull.py
// `cull_best_plain`), so kernel and twin agree key for key and slot for
// slot.  The slab expressions are those of the cull, which makes the early
// exit exact.
//
// Bound on the card: each (block, cluster) pair the walk visits costs 1024
// lanes x 22 FP32 operations for the slab test, and each lane that passes
// the prune 38 per triangle row and 21 per sphere row, against 3 KB of tile
// read; at the H100's 67 TFLOP/s of non-tensor FP32 and 3.35 TB/s the walk
// is bound by operations.  With ``visits`` given, the kernel counts that
// work per block: clusters walked, triangle tests and sphere tests.  The
// design spends its instructions on the tests: ray, shear and best key stay
// in registers, the tile rows are broadcasts from shared memory, and a lane
// whose prune fails skips the cluster's rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 1024;  // lanes per ray block = threads per CTA
constexpr int kRowW = 12;      // words of a row the tests read
constexpr int kMaxRows = 64;   // 1 + L with L <= 63
constexpr int kInfBits = 0x7F800000;
constexpr int kKindTri = 1;
constexpr int kKindSphere = 2;

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying the first 12 words of each row of tile `c` into `dst`
// (rows x 12 floats), as one cp.async group per thread.
__device__ __forceinline__ void stage_tile(float* dst, const float* tiles, int c, int rows, int tile_w) {
  const float* src = tiles + (size_t)c * rows * tile_w;
  for (int k = threadIdx.x; k < rows * 3; k += blockDim.x) {
    const int r = k / 3, q = k - 3 * (k / 3);
    cp_async16(dst + r * kRowW + 4 * q, src + (size_t)r * tile_w + 4 * q);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kBlockN, 1)
cull_best_kernel(const float* __restrict__ tiles,    // [C, rows, tile_w]
                 int c_total, int rows, int tile_w,
                 const int* __restrict__ counts,     // [NB]
                 const int* __restrict__ lists,      // [NB, C]
                 const int* __restrict__ entries,    // [NB, C] f32 bits, ascending
                 const float* __restrict__ rays,     // [8, n_pad]: o, d, ignore bits, 0
                 int n_pad, int n_valid, float eps,
                 int* __restrict__ out,              // [2, n_pad]
                 int* __restrict__ visits) {         // [3, NB] or null
  __shared__ __align__(16) float s_tile[2][kMaxRows * kRowW];

  const int b = blockIdx.x;
  const int i = b * kBlockN + threadIdx.x;
  const bool real = i < n_valid;
  const float ox = rays[i], oy = rays[(size_t)n_pad + i], oz = rays[2 * (size_t)n_pad + i];
  const float dx = rays[3 * (size_t)n_pad + i], dy = rays[4 * (size_t)n_pad + i],
              dz = rays[5 * (size_t)n_pad + i];
  const int ign = __float_as_int(rays[6 * (size_t)n_pad + i]);

  // per-lane watertight shear (reference src/geometry.cpp:16-45)
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool x_wins = (adx > ady) && (adx > adz);
  const bool y_wins = !x_wins && (ady > adz);
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
  const float sz = inv_dz;
  const float ivx = 1.0f / (fabsf(dx) < 1e-30f ? 1e-30f : dx);
  const float ivy = 1.0f / (fabsf(dy) < 1e-30f ? 1e-30f : dy);
  const float ivz = 1.0f / (fabsf(dz) < 1e-30f ? 1e-30f : dz);

  const int count = counts[b];
  const int* list = lists + (size_t)b * c_total;
  const int* entry = entries + (size_t)b * c_total;
  const int n_rows = rows - 1;

  int best_key = kInfBits, best_slot = 0;
  int walked = 0, tri_tests = 0, sphere_tests = 0;
  if (count > 0) stage_tile(s_tile[0], tiles, list[0], rows, tile_w);
  for (int j = 0; j < count; ++j) {
    const int c = list[j];
    if (j + 1 < count) {
      stage_tile(s_tile[(j + 1) & 1], tiles, list[j + 1], rows, tile_w);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* t = s_tile[j & 1];
    walked = j + 1;

    // per-lane AABB prune against the running best (quantized) distance
    const float best_dist = __int_as_float(best_key);
    const float t1x = (t[2] - ox) * ivx, t2x = (t[5] - ox) * ivx;
    const float t1y = (t[3] - oy) * ivy, t2y = (t[6] - oy) * ivy;
    const float t1z = (t[4] - oz) * ivz, t2z = (t[7] - oz) * ivz;
    const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    if (real && tn <= tf && tf >= eps && tn <= best_dist) {
      int tile_key = kInfBits;
      for (int r = 0; r < n_rows; ++r) {
        const float* row = t + (1 + r) * kRowW;
        const int kind = __float_as_int(row[0]);
        if (__float_as_int(row[11]) == ign) continue;
        float dist;
        bool ok;
        if (kind == kKindTri) {
          ++tri_tests;
          float ax[3], ay[3], az[3];
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float rx = row[2 + 3 * v] - ox;
            const float ry = row[3 + 3 * v] - oy;
            const float rz = row[4 + 3 * v] - oz;
            const float r_kx = sel3(kx, rx, ry, rz);
            const float r_ky = sel3(ky, rx, ry, rz);
            const float r_kz = sel3(kz, rx, ry, rz);
            ax[v] = r_kx - sx * r_kz;
            ay[v] = r_ky - sy * r_kz;
            az[v] = r_kz;
          }
          const float u = ay[1] * ax[2] - ax[1] * ay[2];
          const float v = ay[2] * ax[0] - ax[2] * ay[0];
          const float w = ay[0] * ax[1] - ax[0] * ay[1];
          const bool inside = (u >= 0.f && v >= 0.f && w >= 0.f) || (u <= 0.f && v <= 0.f && w <= 0.f);
          const float det = u + v + w;
          const float t_scaled = sz * (u * az[0] + v * az[1] + w * az[2]);
          const bool same_sign = (det < 0.f) == (t_scaled < 0.f);
          dist = t_scaled / (det == 0.f ? 1.0f : det);
          ok = inside && fabsf(det) > eps && same_sign && dist >= eps;
        } else if (kind == kKindSphere) {
          ++sphere_tests;
          const float ocx = ox - row[2];
          const float ocy = oy - row[3];
          const float ocz = oz - row[4];
          const float r2 = row[5] * row[5];
          const float bq = ocx * dx + ocy * dy + ocz * dz;
          const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
          const float disc = bq * bq - cq;
          const float sq = sqrtf(fmaxf(disc, 0.f));
          const float s_near = -bq - sq;
          const float s_far = -bq + sq;
          dist = s_near >= eps ? s_near : s_far;
          ok = disc > 0.f && dist >= eps;
        } else {
          continue;  // padding row
        }
        if (ok) tile_key = min(tile_key, (__float_as_int(dist) & ~63) | r);
      }
      if (tile_key < best_key) {
        best_slot = c * rows + 1 + (tile_key & 63);
        best_key = tile_key & ~63;
      }
    }
    // early exit; the barrier also frees this buffer for the copy after next
    if (j + 1 >= count || !__syncthreads_or(real && best_key >= entry[j + 1])) break;
  }
  cp_async_wait<0>();  // drain a prefetch the exit left in flight

  out[i] = real ? best_key : kInfBits;
  out[(size_t)n_pad + i] = real ? best_slot : 0;
  if (visits != nullptr) {  // the walk's work, for the bound
    if (threadIdx.x == 0) visits[b] = walked;
    atomicAdd(visits + gridDim.x + b, tri_tests);
    atomicAdd(visits + 2 * gridDim.x + b, sphere_tests);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int cull_best_launch(const float* tiles, int c_total, int rows, int tile_w, const int* counts,
                                const int* lists, const float* entries, const float* rays, int n_pad,
                                int n_valid, float eps, int* out, int* visits, void* stream) {
  if (n_pad <= 0) return 0;
  if (n_pad % kBlockN != 0 || rows < 2 || rows > kMaxRows || tile_w < kRowW || tile_w % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n_pad / kBlockN;
  cull_best_kernel<<<grid, kBlockN, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, c_total, rows, tile_w, counts, lists, reinterpret_cast<const int*>(entries), rays, n_pad, n_valid,
      eps, out, visits);
  return static_cast<int>(cudaGetLastError());
}
