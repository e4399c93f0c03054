// Block-cull closest hit for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the TPU kernel simple_spectral_tpu/render/cull.py `_kernel`
// (launched by `_cull_best`).  Stage 2 (render/cull.py `cull_lists`) gives
// every block of 1024 ray lanes a front-to-back list of the clusters that
// any of its lanes hits, with each cluster's entry distance (the block's
// least max(tn, 0) over its lanes that hit the cluster's AABB), ascending.
// For each listed cluster a lane
//
//   - prunes itself when its AABB slab test misses or starts beyond the
//     lane's running best distance;
//   - tests the cluster's rows (1..L, L <= 63): the watertight triangle
//     test (reference src/geometry.cpp:12-101) or the nearest sphere root
//     >= eps, skipping the lane's ignored primitive;
//   - keeps the least key (bits(dist) & ~63) | row over the tile, and takes
//     it, with the flat slot c * (1 + L) + 1 + row, only if it is strictly
//     below the running best key;
//
// and the kernel writes i32[2, Np]: row 0 the quantized key (INF_BITS =
// miss), row 1 the slot.  The winner is the least (quantized distance, list
// position, row), as on the TPU.
//
// Each warp walks its block's list by itself.  The TPU kernel walked the
// list with all 1024 lanes of a block in step and stopped when the next
// entry exceeded every lane's best key.  Here each warp of 32 lanes stops
// on its own: before list position j it takes the largest best key of its
// real lanes (__reduce_max_sync) and stops once entry[j] exceeds it.  That is exact for any subset of a block's lanes:
// the entries ascend, and the entry of a cluster is no larger than max(tn, 0)
// of every lane of the block that hits the cluster's AABB, computed by the
// same FP32 operations as the prune here.  So when every lane of the warp
// holds a best key below entry[j], every cluster from j on has, for each of
// those lanes, an AABB that it misses or that starts beyond its best
// distance: each later prune fails, and no key or slot can change.  Each
// lane still sees the clusters it would test in the same order as in a walk
// of the whole list, so its key and slot are those of the full walk
// (render/cull.py `cull_best_plain`), bit for bit.  A warp whose lanes all
// fail a cluster's prune skips the cluster's rows whole.
//
// No barrier of the block inside the walk.  A warp stages the headers of
// 32 list positions at a time in its own slice of shared memory (lane k
// loads position j0 + k: the cluster id, the entry and the AABB, one
// coalesced load of the list and the entries and 32 independent AABB loads
// in flight), then reads each header as a broadcast.  When some lane of the
// warp passes a cluster's prune, the warp copies the 12 words of each row
// that the tests read into its own 3 KB tile in shared memory with cp.async
// (six 16-byte copies a lane, all in flight at once; the rows in device
// memory are 128 words wide, the TPU's alignment), and tests the rows from
// there in one of two ways:
//
//   - lane-parallel, when more than kRowParallelMax lanes are live: every
//     lane walks the rows with its own ray, reading each row as a
//     broadcast;
//   - row-parallel, otherwise: for each live lane in turn, the warp's 32
//     lanes take that lane's ray (shuffled from it) and test two rows each,
//     and a warp-wide minimum gives its tile key.
//
// On sorted bounce rays a warp that tests a cluster's rows has about four
// live lanes, so the lane-parallel walk would run 63 rows for four lanes'
// work; the row-parallel one runs two rows per live lane.  Both compute
// each (ray, row) key with the same operations, and the minimum over rows
// does not depend on their order, so both give the same tile key.  A row's
// kind is uniform across the warp in the lane-parallel walk: a triangle row
// runs only the triangle test, a sphere row only the quadratic.
//
// Small CTAs: 128 threads (4 warps) with 16 KB of shared memory each (a
// tile and 32 headers per warp), launch bounds for 8 CTAs (32 warps) per
// SM.  A full 262144-lane sweep is 2048 CTAs of 4 independent warps; a CTA
// ends with its slowest warp, not with the slowest of 32.  Bounds for 12
// CTAs (48 warps) cap a thread at 40 registers and 10 CTAs at 48, and the
// walk then spills to local memory; both ran slower on the card than 32
// warps with no spill (tools/kernel_variants.py times them; PERF.md).
// Lanes from n_valid on (the padding of the last block) take no part and
// write (INF_BITS, 0); a warp of padding only walks nothing.
//
// Arithmetic: built with -fmad=false, every operation is one IEEE-rounded
// FP32 operation in the order of the plain twin (render/cull.py
// `cull_best_plain`), so kernel and twin agree key for key and slot for
// slot.  The slab expressions are those of the cull, which makes the
// early exit exact.
//
// Bound on the card: operations (render/cull.py `cull_work` counts them for
// given inputs, whatever kernel does the walk: 22 FP32 operations for each
// slab test a lane needs up to its own exit, 38 for each triangle row and 21
// for each sphere row it tests).  With ``visits`` given, the kernel counts
// its own work per block: (warp, cluster) pairs walked, and the triangle
// and sphere tests its lanes ran.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 1024;  // lanes per ray block of stage 2's lists
constexpr int kThreads = 128;  // threads per CTA: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 8;   // 32 warps resident per SM, up to 64 registers a thread
constexpr int kBatch = 32;      // list positions a warp stages at a time
constexpr int kHdrW = 8;        // header words: AABB min xyz, max xyz, cluster id, entry bits
constexpr int kMaxRows = 64;    // 1 + L with L <= 63
constexpr int kRowW = 12;       // words of a row the tests read
// Most live lanes for which a warp tests a tile row-parallel (two rows per
// lane for each live lane) rather than lane-parallel (every row for all);
// tools/kernel_variants.py times 0, 8 and 32 against it.
constexpr int kRowParallelMax = 20;
constexpr int kInfBits = 0x7F800000;
constexpr int kKindTri = 1;
constexpr int kKindSphere = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One ray's origin and watertight shear (reference src/geometry.cpp:16-45),
// with the axes packed as kx | ky << 2 | kz << 4, and its lane, through
// which a sphere test reads the direction: the fewer words, the fewer
// registers a lane holds while it tests another lane's ray.
struct Ray {
  float ox, oy, oz, sx, sy, sz;
  int k, ign, i;
};

// The key (bits(dist) & ~63) | r of row r (12 words in `row`) for `ray`:
// the watertight triangle test or the nearest sphere root >= eps, kInfBits
// for a miss, the ray's ignored primitive or a padding row.  `rays` and
// `n_pad` locate the ray's direction.
template <bool kCount>
__device__ __forceinline__ int row_key(const float4* row, int r, const Ray& ray, const float* __restrict__ rays,
                                       int n_pad, float eps, int& tri_tests, int& sphere_tests) {
  const float4 w0 = row[0], w1 = row[1], w2 = row[2];
  const int kind = __float_as_int(w0.x);
  if (__float_as_int(w2.w) == ray.ign) return kInfBits;
  float dist;
  bool ok;
  if (kind == kKindTri) {
    if (kCount) ++tri_tests;
    const int kx = ray.k & 3, ky = (ray.k >> 2) & 3, kz = ray.k >> 4;
    const float vx[3] = {w0.z, w1.y, w2.x};
    const float vy[3] = {w0.w, w1.z, w2.y};
    const float vz[3] = {w1.x, w1.w, w2.z};
    float ax[3], ay[3], az[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float rx = vx[v] - ray.ox;
      const float ry = vy[v] - ray.oy;
      const float rz = vz[v] - ray.oz;
      const float r_kx = sel3(kx, rx, ry, rz);
      const float r_ky = sel3(ky, rx, ry, rz);
      const float r_kz = sel3(kz, rx, ry, rz);
      ax[v] = r_kx - ray.sx * r_kz;
      ay[v] = r_ky - ray.sy * r_kz;
      az[v] = r_kz;
    }
    const float u = ay[1] * ax[2] - ax[1] * ay[2];
    const float v = ay[2] * ax[0] - ax[2] * ay[0];
    const float w = ay[0] * ax[1] - ax[0] * ay[1];
    const bool inside = (u >= 0.f && v >= 0.f && w >= 0.f) || (u <= 0.f && v <= 0.f && w <= 0.f);
    const float det = u + v + w;
    const float t_scaled = ray.sz * (u * az[0] + v * az[1] + w * az[2]);
    const bool same_sign = (det < 0.f) == (t_scaled < 0.f);
    dist = t_scaled / (det == 0.f ? 1.0f : det);
    ok = inside && fabsf(det) > eps && same_sign && dist >= eps;
  } else if (kind == kKindSphere) {
    if (kCount) ++sphere_tests;
    const float dx = rays[3 * (size_t)n_pad + ray.i], dy = rays[4 * (size_t)n_pad + ray.i],
                dz = rays[5 * (size_t)n_pad + ray.i];
    const float ocx = ray.ox - w0.z;
    const float ocy = ray.oy - w0.w;
    const float ocz = ray.oz - w1.x;
    const float r2 = w1.y * w1.y;
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = bq * bq - cq;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float s_near = -bq - sq;
    const float s_far = -bq + sq;
    dist = s_near >= eps ? s_near : s_far;
    ok = disc > 0.f && dist >= eps;
  } else {
    return kInfBits;  // padding row
  }
  return ok ? (__float_as_int(dist) & ~63) | r : kInfBits;
}

// `ray` of lane `src`, to every lane of the warp.
__device__ __forceinline__ Ray shfl_ray(const Ray& ray, int src) {
  Ray out;
  out.ox = __shfl_sync(kFull, ray.ox, src);
  out.oy = __shfl_sync(kFull, ray.oy, src);
  out.oz = __shfl_sync(kFull, ray.oz, src);
  out.sx = __shfl_sync(kFull, ray.sx, src);
  out.sy = __shfl_sync(kFull, ray.sy, src);
  out.sz = __shfl_sync(kFull, ray.sz, src);
  out.k = __shfl_sync(kFull, ray.k, src);
  out.ign = __shfl_sync(kFull, ray.ign, src);
  out.i = __shfl_sync(kFull, ray.i, src);
  return out;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
cull_best_kernel(const float* __restrict__ tiles,    // [C, rows, tile_w]
                 int rows, int tile_w, int c_total,
                 const int* __restrict__ counts,     // [NB]
                 const int* __restrict__ lists,      // [NB, C]
                 const int* __restrict__ entries,    // [NB, C] f32 bits, ascending
                 const float* __restrict__ rays,     // [8, n_pad]: o, d, ignore bits, 0
                 int n_pad, int n_valid, float eps,
                 int* __restrict__ out,              // [2, n_pad]
                 int* __restrict__ visits) {         // [3, NB] when kCount
  __shared__ __align__(16) float s_hdr[kWarps][kBatch][kHdrW];
  __shared__ __align__(16) float s_tile[kWarps][kMaxRows * kRowW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int b = i / kBlockN;
  const bool real = i < n_valid;
  Ray ray;
  ray.ox = rays[i];
  ray.oy = rays[(size_t)n_pad + i];
  ray.oz = rays[2 * (size_t)n_pad + i];
  ray.ign = __float_as_int(rays[6 * (size_t)n_pad + i]);
  ray.i = i;
  const float dx = rays[3 * (size_t)n_pad + i], dy = rays[4 * (size_t)n_pad + i],
              dz = rays[5 * (size_t)n_pad + i];

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
  ray.sx = sel3(kx, dx, dy, dz) * inv_dz;
  ray.sy = sel3(ky, dx, dy, dz) * inv_dz;
  ray.sz = inv_dz;
  ray.k = kx | ky << 2 | kz << 4;
  const float ivx = 1.0f / (fabsf(dx) < 1e-30f ? 1e-30f : dx);
  const float ivy = 1.0f / (fabsf(dy) < 1e-30f ? 1e-30f : dy);
  const float ivz = 1.0f / (fabsf(dz) < 1e-30f ? 1e-30f : dz);

  const int count = counts[b];
  const int* list = lists + (size_t)b * c_total;
  const int* entry = entries + (size_t)b * c_total;
  const int n_rows = rows - 1;
  float(*hdr)[kHdrW] = s_hdr[warp];
  float* tile = s_tile[warp];
  const float4* tile4 = reinterpret_cast<const float4*>(tile);

  int best_key = kInfBits, best_slot = 0;
  // the largest best key of the warp's real lanes; -1 when it has none
  int warp_best = __reduce_max_sync(kFull, real ? best_key : -1);
  int walked = 0, tri_tests = 0, sphere_tests = 0;
  bool done = warp_best < 0;
  for (int j0 = 0; j0 < count && !done; j0 += kBatch) {
    // stage the headers of list positions j0 .. j0 + 31, one per lane
    const int p = j0 + lane;
    if (p < count) {
      const int c = list[p];
      const float4* box = reinterpret_cast<const float4*>(tiles + (size_t)c * rows * tile_w);
      const float4 lo = __ldg(box), hi = __ldg(box + 1);  // row 0 words 0..7; the AABB is words 2..7
      *reinterpret_cast<float4*>(hdr[lane]) = make_float4(lo.z, lo.w, hi.x, hi.y);
      *reinterpret_cast<float4*>(hdr[lane] + 4) =
          make_float4(hi.z, hi.w, __int_as_float(c), __int_as_float(entry[p]));
    }
    __syncwarp();
    const int n_here = min(kBatch, count - j0);
    for (int jj = 0; jj < n_here; ++jj) {
      const float4 h0 = *reinterpret_cast<const float4*>(hdr[jj]);
      const float4 h1 = *reinterpret_cast<const float4*>(hdr[jj] + 4);
      if (__float_as_int(h1.w) > warp_best) {  // exit: every later prune fails for every lane
        done = true;
        break;
      }
      const int c = __float_as_int(h1.z);
      if (kCount) ++walked;

      // per-lane AABB prune against the running best (quantized) distance
      const float best_dist = __int_as_float(best_key);
      const float t1x = (h0.x - ray.ox) * ivx, t2x = (h0.w - ray.ox) * ivx;
      const float t1y = (h0.y - ray.oy) * ivy, t2y = (h1.x - ray.oy) * ivy;
      const float t1z = (h0.z - ray.oz) * ivz, t2z = (h1.y - ray.oz) * ivz;
      const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      const bool live = real && tn <= tf && tf >= eps && tn <= best_dist;
      const unsigned live_mask = __ballot_sync(kFull, live);
      if (live_mask == 0) continue;  // the warp skips the cluster's rows

      // the 12 words of rows 1..L into the warp's tile
      const float* src = tiles + ((size_t)c * rows + 1) * tile_w;
      for (int k = lane; k < n_rows * 3; k += 32) {
        const int r = k / 3, q = k - 3 * r;
        cp_async16(tile + r * kRowW + 4 * q, src + (size_t)r * tile_w + 4 * q);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();

      int tile_key = kInfBits;
      if (__popc(live_mask) > kRowParallelMax) {
        if (live) {
          for (int r = 0; r < n_rows; ++r)
            tile_key = min(tile_key, row_key<kCount>(tile4 + 3 * r, r, ray, rays, n_pad, eps, tri_tests,
                                                     sphere_tests));
        }
      } else {
        for (unsigned todo = live_mask; todo != 0; todo &= todo - 1) {
          const int src_lane = __ffs(todo) - 1;
          const Ray other = shfl_ray(ray, src_lane);
          int key = kInfBits;
          for (int r = lane; r < n_rows; r += 32)
            key = min(key, row_key<kCount>(tile4 + 3 * r, r, other, rays, n_pad, eps, tri_tests, sphere_tests));
          key = __reduce_min_sync(kFull, key);
          if (lane == src_lane) tile_key = key;
        }
      }
      if (tile_key < best_key) {  // only live lanes hold a tile key
        best_slot = c * rows + 1 + (tile_key & 63);
        best_key = tile_key & ~63;
      }
      __syncwarp();  // every lane has read the tile before it is restaged
      warp_best = __reduce_max_sync(kFull, real ? best_key : -1);
    }
    __syncwarp();  // every lane has read the headers before they are restaged
  }

  out[i] = real ? best_key : kInfBits;
  out[(size_t)n_pad + i] = real ? best_slot : 0;
  if (kCount) {  // the walk's own work
    const int tri = __reduce_add_sync(kFull, tri_tests);
    const int sph = __reduce_add_sync(kFull, sphere_tests);
    if (lane == 0) {
      const int nb = n_pad / kBlockN;
      atomicAdd(visits + b, walked);
      atomicAdd(visits + nb + b, tri);
      atomicAdd(visits + 2 * nb + b, sph);
    }
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
  const int grid = n_pad / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ent = reinterpret_cast<const int*>(entries);
  // 8 CTAs of 16 KB need more of the SM's shared memory than the default carveout may give
  cudaError_t err = cudaFuncSetAttribute(cull_best_kernel<false>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cull_best_kernel<true>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (visits != nullptr) {
    cull_best_kernel<true><<<grid, kThreads, 0, s>>>(tiles, rows, tile_w, c_total, counts, lists, ent, rays, n_pad,
                                                     n_valid, eps, out, visits);
  } else {
    cull_best_kernel<false><<<grid, kThreads, 0, s>>>(tiles, rows, tile_w, c_total, counts, lists, ent, rays, n_pad,
                                                      n_valid, eps, out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
