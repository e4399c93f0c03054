// The closest-hit sweep that kernels K1 (intersect_best_key.cu) and S1
// (bounce_fused.cu) share: a ray's axis permutation and shear, and the
// Woop/Benthin/Wald watertight test (reference src/geometry.cpp:12-101) of
// each ray of a thread against each triangle of a tile in shared memory.
//
// Arithmetic: the sheared coordinates are computed as the JAX package's
// `intersect_rays_soa2` does (render/intersect.py:448-483): first v - o,
// then the shear, in plain FP32.  Built with -fmad=false, every operation
// is one IEEE-rounded FP32 op in the order of the plain PyTorch twins
// (render/intersect_pallas.py `best_key_plain`, tools/bench_megakernel.py
// `bounce_plain`), so kernels and twins agree bit for bit.
//
// Tile layout: a ray reads the vertex words of a triangle in its own axis
// order (v0[kx] v0[ky] v0[kz] v1[kx] ... v2[kz]), of which there are six,
// one per (kz, kx/ky swap).  So the tile holds each triangle six times, one
// copy per axis order, as a 12-word record: the nine words in that order,
// the primitive id's bits, two words of padding.  A test then reads its
// triangle with two 16-byte loads and one 8-byte load from its ray's copy,
// instead of nine 4-byte loads at permuted addresses and one for the id.
// Copy p starts kCopyPad words after copy p - 1 ends, 4p banks along, so
// the lanes of a warp, which read one triangle in up to six axis orders,
// read six distinct 16-byte bank groups.
//
// The running best of a ray is (distance bits, triangle index), replaced
// on a strict `<` of the bits alone.  A thread runs the triangles in
// ascending order, so of equal bits the first index stays: the pair packs,
// once at the end, into the minimum of the packed key `bits | index` (the
// quantized keys, bits with the index's low bits cleared) or
// `bits << 32 | index` (the exact key).  `Bits` is int for the quantized
// keys, whose minimum is a signed one, and unsigned for the exact key,
// whose high word compares unsigned.

#pragma once

#include <cuda_runtime.h>

namespace closest_hit {

constexpr int kInfBits = 0x7F800000;
constexpr int kOrders = 6;    // axis orders: kz in 0..2, kx and ky swapped or not
constexpr int kRecord = 12;   // words per (triangle, axis order)
constexpr int kCopyPad = 4;   // words between two copies

// Words of one copy, and of a tile, of `tris` triangles.
__host__ __device__ constexpr int copy_words(int tris) { return tris * kRecord + kCopyPad; }
__host__ __device__ constexpr int tile_words(int tris) { return kOrders * copy_words(tris); }

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// Write triangle j (v: v0xyz v1xyz v2xyz; its primitive id) into every
// copy of a tile of `tris` triangles.  Axis order 2 kz + swap has
// kx = (kz + 1) % 3 and ky = (kx + 1) % 3, exchanged when `swap`
// (reference src/geometry.cpp:16-45).
__device__ __forceinline__ void stage(float* s_t, int tris, int j, const float (&v)[9], int prim) {
#pragma unroll
  for (int order = 0; order < kOrders; ++order) {
    const int kz = order >> 1;
    int kx = kz == 2 ? 0 : kz + 1;
    int ky = kx == 2 ? 0 : kx + 1;
    if (order & 1) {
      const int tmp = kx;
      kx = ky;
      ky = tmp;
    }
    float* rec = s_t + order * copy_words(tris) + j * kRecord;
#pragma unroll
    for (int vert = 0; vert < 3; ++vert) {
      rec[3 * vert] = v[3 * vert + kx];
      rec[3 * vert + 1] = v[3 * vert + ky];
      rec[3 * vert + 2] = v[3 * vert + kz];
    }
    rec[9] = __int_as_float(prim);
  }
}

// One ray, sheared (reference src/geometry.cpp:16-45).
struct Ray {
  float o_kx, o_ky, o_kz, sx, sy, sz;
  int copy;  // word offset of the copy in the ray's axis order
  int ign;   // primitive id (bits) the ray ignores
};

__device__ __forceinline__ Ray shear(float ox, float oy, float oz, float dx, float dy, float dz, int ign,
                                     int tile_tris) {
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool x_wins = (adx > ady) && (adx > adz);
  const bool y_wins = !x_wins && (ady > adz);
  const int kz = x_wins ? 0 : (y_wins ? 1 : 2);
  int kx = (kz == 2) ? 0 : kz + 1;
  int ky = (kx == 2) ? 0 : kx + 1;
  const float d_kz = sel3(kz, dx, dy, dz);
  const bool swap = d_kz < 0.f;
  if (swap) {
    const int tmp = kx;
    kx = ky;
    ky = tmp;
  }
  // A zero d[kz] only comes from an all-zero direction (render/intersect.py:86).
  const float inv_dz = 1.0f / (d_kz == 0.f ? 1.0f : d_kz);
  Ray r;
  r.sx = sel3(kx, dx, dy, dz) * inv_dz;
  r.sy = sel3(ky, dx, dy, dz) * inv_dz;
  r.sz = inv_dz;
  r.o_kx = sel3(kx, ox, oy, oz);
  r.o_ky = sel3(ky, ox, oy, oz);
  r.o_kz = sel3(kz, ox, oy, oz);
  r.copy = (2 * kz + swap) * copy_words(tile_tris);
  r.ign = ign;
  return r;
}

// The candidate test of one triangle against one ray, `rec` the
// triangle's record in the ray's copy.  True when the triangle may hold
// the hit (edge, det, sign and ignore tests); then t_scaled / det is its
// distance.
__device__ __forceinline__ bool candidate(const float* rec, const Ray& r, float eps, float& t_scaled, float& det) {
  const float4 a = *reinterpret_cast<const float4*>(rec);
  const float4 b = *reinterpret_cast<const float4*>(rec + 4);
  const float2 c = *reinterpret_cast<const float2*>(rec + 8);
  const float w[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  // sheared coordinates of (v - o) for the three vertices
  float ax[3], ay[3], az[3];
#pragma unroll
  for (int vert = 0; vert < 3; ++vert) {
    const float r_kx = w[3 * vert] - r.o_kx;
    const float r_ky = w[3 * vert + 1] - r.o_ky;
    const float r_kz = w[3 * vert + 2] - r.o_kz;
    ax[vert] = r_kx - r.sx * r_kz;
    ay[vert] = r_ky - r.sy * r_kz;
    az[vert] = r_kz;
  }
  // scaled barycentrics (reference src/geometry.cpp:52-56)
  const float u = ay[1] * ax[2] - ax[1] * ay[2];
  const float v = ay[2] * ax[0] - ax[2] * ay[0];
  const float ww = ay[0] * ax[1] - ax[0] * ay[1];
  // edge test, zeros counted inside (render/intersect.py:115-116)
  const bool inside = (u >= 0.f && v >= 0.f && ww >= 0.f) || (u <= 0.f && v <= 0.f && ww <= 0.f);
  det = u + v + ww;
  t_scaled = r.sz * (u * az[0] + v * az[1] + ww * az[2]);
  const bool same_sign = (__float_as_int(det) < 0) == (__float_as_int(t_scaled) < 0);
  return inside && fabsf(det) > eps && same_sign && __float_as_int(c.y) != r.ign;
}

// Keep a candidate (index `idx` in the key) if it is the closest so far;
// `keep` clears the distance bits the key drops (~0 for the exact key).
template <typename Bits>
__device__ __forceinline__ void keep_closest(float t_scaled, float det, int idx, int keep, float eps, Bits& best_bits,
                                             int& best_idx) {
  const float dist = t_scaled / det;
  if (dist >= eps) {
    const Bits bits = static_cast<Bits>(__float_as_int(dist) & keep);
    if (bits < best_bits) {
      best_bits = bits;
      best_idx = idx;
    }
  }
}

// Test triangles [0, cnt) of the tile s_t against the kRays rays of a
// thread, kUnroll triangles per step; `idx_of(j)` is triangle j's index in
// the key.  Each ray walks one record pointer through its copy, so a step
// spends one addition per ray on addresses and every load of the step
// takes an immediate offset.  A step runs the candidate tests of its
// kUnroll x kRays (ray, triangle) pairs with no branch between them, then,
// only if one of them is a candidate, the divisions, in ascending order of
// the triangles for each ray.
template <int kRays, int kUnroll, typename Bits, typename IdxOf>
__device__ __forceinline__ void sweep(const float* s_t, int cnt, IdxOf idx_of, const Ray (&rays)[kRays], int keep,
                                      float eps, Bits (&best_bits)[kRays], int (&best_idx)[kRays]) {
  const float* rec[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) rec[q] = s_t + rays[q].copy;
  int j = 0;
  for (; j + kUnroll <= cnt; j += kUnroll) {
    bool cand[kUnroll][kRays];
    float t_scaled[kUnroll][kRays], det[kUnroll][kRays];
    bool any = false;
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        cand[s][q] = candidate(rec[q] + s * kRecord, rays[q], eps, t_scaled[s][q], det[s][q]);
        any |= cand[s][q];
      }
    }
    if (any) {
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
#pragma unroll
        for (int q = 0; q < kRays; ++q)
          if (cand[s][q]) keep_closest(t_scaled[s][q], det[s][q], idx_of(j + s), keep, eps, best_bits[q], best_idx[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRays; ++q) rec[q] += kUnroll * kRecord;
  }
  for (; j < cnt; ++j) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      float t_scaled, det;
      if (candidate(rec[q], rays[q], eps, t_scaled, det))
        keep_closest(t_scaled, det, idx_of(j), keep, eps, best_bits[q], best_idx[q]);
      rec[q] += kRecord;
    }
  }
}

}  // namespace closest_hit
