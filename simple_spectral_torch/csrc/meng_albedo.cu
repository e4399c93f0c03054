// Meng et al. 2015 textured albedo for Hopper (sm_90a): kernel M1 of the port.
//
// Replaces no Pallas kernel: the JAX package builds Meng's albedo from XLA
// ops, a point-weight tensor f32[186, N] (the six (point, weight) slots of
// each lane scattered over the grid's points by masked passes), its
// contraction with the 186 x 81 point spectra, and a window of hat weights
// for the hero wavelengths.  The port did the same eagerly: about 1.56 GB
// of f32[186, N] a bounce at N = 2,097,152, 0.63 of the Meng train step's
// device time, for at most 6 non-zero rows a lane and 2 of the 81 bins that
// each hero wavelength reads.  M1 goes from each lane's texel to its hero
// reflectances in one launch, bit for bit the twin's
// (upsample_meng.meng_albedo_hero_plain, same FP32 operations in the same
// order; built with -fmad=false):
//
//   1. the texel: "u32" a packed 0xRRGGBB sRGB word, decoded through a
//      256-entry table of srgb_to_lrgb built by the wrapper with the plain
//      function, then Meng's matrix x100 and the grid walk (uv position,
//      the cell's row, the fan search of boundary cells), as
//      meng_cell_weights_soa runs it: six (point, weight) slots with 1/norm
//      folded into the weights; "rows" reads the six slots precomputed,
//      f32[N, 12];
//   2. for each hero wavelength lambda_0 + s * step: its bin and fraction
//      in the 5-nm table, clamped to the table's edges, and the six slots
//      added in slot order, each w * (spec[p, j0] (1 - f) + spec[p, j1] f);
//   3. row s of f32[S, N] stored contiguous, so the stores coalesce.
//
// The grid's tables stay in shared memory for the whole launch: the point
// spectra, the cells' rows of 20 values (inside, num, 6 point ids, 6 u,
// 6 v), the decode table and the xy-to-uv matrix, 74,752 B for Meng's grid,
// taken as dynamic shared memory.  A grid sized to the blocks the card holds
// at once strides over the lanes, so each block fills its tables once.
//
// Bound on the card: bytes.  Each lane reads its texel word (4 B) and
// lambda_0 (4 B) and writes 4 S B: 24 B at S = 4, 50.3 MB at N = 2,097,152,
// 15.0 us at 3.35 TB/s (12.8 us with lambda_0 counted once a step, as the
// benchmark's floor counts it).  The FP32 work is small beside it (the walk
// about 150 operations, the hero sum 7 S x 6 a lane: under 3 us at 67
// TFLOP/s); the 12 S random shared-memory reads a lane (48 at S = 4) and
// the IEEE divisions of the walk and the bins are what keep it off the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 6;
constexpr int kCellRow = 20;  // inside, num, 6 point ids, 6 u, 6 v
constexpr int kCodes = 256;
constexpr int kUv = 6;
constexpr float kFltMax = 3.402823466e38f;
enum Format { kWords = 0, kRows = 1 };

struct Params {
  const int32_t* words;  // "u32": [n] packed sRGB
  const float* rows;     // "rows": [n, 12] point ids, then weights
  const float* lam0;     // [n]
  float* out;            // [n_hero, n]
  const float* spec;     // [n_pts, n_bins]
  const float* cells;    // [n_cells, 20]
  const float* uv;       // [6]
  const float* lut;      // [256]
  float m[9];            // Meng's lRGB -> XYZ matrix, row major
  int n, n_hero, n_pts, n_bins, n_cells, width, height;
  float hero_step;       // lambda_step
  float lam_min, lam_span, bins_last;  // the table's first wavelength, its span, n_bins - 1
  float u_hi, v_hi;      // width - 1e-4, height - 1e-4
};

// Meng's matrix x100 on the decoded lRGB (lrgb_to_xyz_meng).
__device__ __forceinline__ void lrgb_to_xyz(const Params& p, float r, float g, float b, float& x, float& y,
                                            float& z) {
  x = (p.m[0] * r + p.m[1] * g + p.m[2] * b) * 100.0f;
  y = (p.m[3] * r + p.m[4] * g + p.m[5] * b) * 100.0f;
  z = (p.m[6] * r + p.m[7] * g + p.m[8] * b) * 100.0f;
}

// The grid walk of meng_cell_weights_soa (grid.h:24-136): XYZ -> six
// (point id, weight) slots, 1/norm folded into the weights.
__device__ __forceinline__ void walk(const Params& p, const float* s_cells, const float* s_uv, float x, float y,
                                     float z, int pid[kSlots], float w[kSlots]) {
  // _uv_position
  const float ssum = x + y + z;
  const float norm = 1.0f / ssum;
  bool valid = norm < kFltMax;  // catches +inf and NaN
  const float xy_x = x * norm;
  const float xy_y = y * norm;
  const float u = s_uv[0] * xy_x + s_uv[1] * xy_y + s_uv[2];
  const float v = s_uv[3] * xy_x + s_uv[4] * xy_y + s_uv[5];
  valid = valid && u >= 0.0f && u < static_cast<float>(p.width) && v >= 0.0f && v < static_cast<float>(p.height);
  const float u_safe = fminf(fmaxf(valid ? u : 0.0f, 0.0f), p.u_hi);
  const float v_safe = fminf(fmaxf(valid ? v : 0.0f, 0.0f), p.v_hi);
  const int ui = static_cast<int>(floorf(u_safe));
  const int vi = static_cast<int>(floorf(v_safe));
  // _cell_values: the cell's row
  const float* row = s_cells + (ui + p.width * vi) * kCellRow;
  const int inside = static_cast<int>(row[0]);
  const int num = static_cast<int>(row[1]);
  float pu[kSlots], pv[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    pid[s] = static_cast<int>(row[2 + s]);
    pu[s] = row[8 + s];
    pv[s] = row[14 + s];
  }
  float wsel[kSlots];
  if (inside > 0) {
    // inner cells: bilinear over the quad (vertex layout 2 3 / 0 1)
    const float fu = u_safe - static_cast<float>(ui);
    const float fv = v_safe - static_cast<float>(vi);
    wsel[0] = (1.0f - fu) * (1.0f - fv);
    wsel[1] = fu * (1.0f - fv);
    wsel[2] = (1.0f - fu) * fv;
    wsel[3] = fu * fv;
    wsel[4] = 0.0f;
    wsel[5] = 0.0f;
  } else {
    // boundary cells: _fan_triangles, the fan around slot 0
    const float ex = u_safe - pu[0];
    const float ey = v_safe - pv[0];
    float e_x[kSlots], e_y[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      e_x[s] = pu[s] - pu[0];
      e_y[s] = pv[s] - pv[0];
      wsel[s] = 0.0f;
    }
    float e0x = e_x[1], e0y = e_y[1];
    float uu = e0x * ey - ex * e0y;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const bool closing = num == i + 2;
      const int nxt = i + 2 < 5 ? i + 2 : 5;
      const int bslot = i + 1;
      const float e1x = closing ? e_x[1] : e_x[nxt];
      const float e1y = closing ? e_y[1] : e_y[nxt];
      const float vv = ex * e1y - e1x * ey;
      const float area = e0x * e1y - e1x * e0y;
      const float inv_area = area != 0.0f ? 1.0f / area : 0.0f;
      const float bu = uu * inv_area;
      const float bv = vv * inv_area;
      const float bw = 1.0f - bu - bv;
      const bool take = bu >= 0.0f && bv >= 0.0f && bw >= 0.0f && num - 1 > i && !found;
      if (take) {
        wsel[0] = wsel[0] + bw;
        wsel[bslot] = wsel[bslot] + bv;
        if (closing) {
          wsel[1] = wsel[1] + bu;
        } else {
          wsel[nxt] = wsel[nxt] + bu;
        }
      }
      found = found || take;
      // not accepted: advance the fan edge (grid.h:120-124)
      uu = take ? uu : -vv;
      e0x = take ? e0x : e1x;
      e0y = take ? e0y : e1y;
    }
  }
  const float scale = valid && num > 0 ? ssum : 0.0f;  // p / norm == p * (X+Y+Z)
#pragma unroll
  for (int s = 0; s < kSlots; ++s) w[s] = wsel[s] * scale;
}

template <int kFormat>
__global__ void __launch_bounds__(kThreads) meng_albedo_kernel(const Params p) {
  extern __shared__ float smem[];
  float* s_spec = smem;
  float* s_cells = s_spec + p.n_pts * p.n_bins;
  float* s_lut = s_cells + p.n_cells * kCellRow;
  float* s_uv = s_lut + kCodes;
  for (int k = threadIdx.x; k < p.n_pts * p.n_bins; k += kThreads) s_spec[k] = p.spec[k];
  if (kFormat == kWords) {
    for (int k = threadIdx.x; k < p.n_cells * kCellRow; k += kThreads) s_cells[k] = p.cells[k];
    for (int k = threadIdx.x; k < kCodes; k += kThreads) s_lut[k] = p.lut[k];
    if (threadIdx.x < kUv) s_uv[threadIdx.x] = p.uv[threadIdx.x];
  }
  __syncthreads();

  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += stride) {
    int pid[kSlots];
    float w[kSlots];
    if (kFormat == kWords) {
      const int32_t word = p.words[i];
      float x, y, z;
      lrgb_to_xyz(p, s_lut[(word >> 16) & 0xFF], s_lut[(word >> 8) & 0xFF], s_lut[word & 0xFF], x, y, z);
      walk(p, s_cells, s_uv, x, y, z, pid, w);
    } else {
      const float* r = p.rows + static_cast<size_t>(i) * (2 * kSlots);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        pid[s] = static_cast<int>(r[s]);
        w[s] = r[kSlots + s];
      }
    }
    int base[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) base[s] = pid[s] * p.n_bins;
    const float lam = p.lam0[i];
    for (int h = 0; h < p.n_hero; ++h) {
      // hero_lams_soa, then spectrum_xyz_to_p_soa's clamped bin
      const float lam_h = lam + static_cast<float>(h) * p.hero_step;
      const float sb = fminf(fmaxf((lam_h - p.lam_min) / p.lam_span * p.bins_last, 0.0f), p.bins_last);
      const int j0 = static_cast<int>(floorf(sb));
      const int j1 = min(j0 + 1, p.n_bins - 1);
      const float f = sb - static_cast<float>(j0);
      const float g = 1.0f - f;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float term = w[s] * (s_spec[base[s] + j0] * g + s_spec[base[s] + j1] * f);
        acc = s == 0 ? term : acc + term;
      }
      p.out[static_cast<size_t>(h) * p.n + i] = acc;
    }
  }
}

// Blocks of one launch: as many as the card holds at once with `smem`
// bytes each, at most one per kThreads lanes.  The device's figures are
// read once per device and size.
struct Occupancy {
  int device = -1, smem = -1, per_sm = 0, sms = 0;
};
Occupancy g_occupancy[2][16];

template <int kFormat>
int resident_blocks(int smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Occupancy& o = g_occupancy[kFormat][dev & 15];
  if (o.device != dev || o.smem != smem) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(meng_albedo_kernel<kFormat>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, meng_albedo_kernel<kFormat>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    o = Occupancy{dev, smem, per_sm, sms};
  }
  *blocks = o.per_sm * o.sms;
  return 0;
}

template <int kFormat>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (p.n_pts * p.n_bins + (kFormat == kWords ? p.n_cells * kCellRow + kCodes + kUv : 0));
  int blocks = 0;
  const int err = resident_blocks<kFormat>(smem, &blocks);
  if (err != 0) return err;
  const int needed = static_cast<int>((static_cast<int64_t>(p.n) + kThreads - 1) / kThreads);
  meng_albedo_kernel<kFormat><<<needed < blocks ? needed : blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch M1 on `stream`: `texels` are n int32 words (format 0, "u32") or n
// rows of 12 float32 (format 1, "rows"); writes n_hero rows of n float32 to
// `out`.  `m` is Meng's matrix on the host, 9 float32 row major.  Returns
// the cudaError_t of the launch (0 = success).
extern "C" int meng_albedo_launch(int format, const void* texels, const float* lam0, float* out, int n, int n_hero,
                                  float hero_step, const float* spec, int n_pts, int n_bins, float lam_min,
                                  float lam_span, const float* cells, int n_cells, int width, int height, float u_hi,
                                  float v_hi, const float* uv, const float* lut, const float* m, void* stream) {
  if (n <= 0 || n_hero <= 0) return 0;
  if (n_pts <= 0 || n_bins <= 0 || (format == kWords && n_cells != width * height)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.words = static_cast<const int32_t*>(texels);
  p.rows = static_cast<const float*>(texels);
  p.lam0 = lam0;
  p.out = out;
  p.spec = spec;
  p.cells = cells;
  p.uv = uv;
  p.lut = lut;
  for (int k = 0; k < 9; ++k) p.m[k] = m[k];
  p.n = n;
  p.n_hero = n_hero;
  p.n_pts = n_pts;
  p.n_bins = n_bins;
  p.n_cells = n_cells;
  p.width = width;
  p.height = height;
  p.hero_step = hero_step;
  p.lam_min = lam_min;
  p.lam_span = lam_span;
  p.bins_last = static_cast<float>(n_bins - 1);
  p.u_hi = u_hi;
  p.v_hi = v_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (format) {
    case kWords:
      return launch<kWords>(p, s);
    case kRows:
      return launch<kRows>(p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
