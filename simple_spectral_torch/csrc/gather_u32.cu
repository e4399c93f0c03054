// u32 gather for Hopper (sm_90a): kernel gather_u32 of the port.
//
// Replaces the TPU spikes' Pallas gathers, five functions that compute one
// thing: tools/bench_pallas_gather.py `_dg0_kernel` / `_dg1_kernel`
// (`take_along_axis` on axis 0 / 1 of a [2048, 128] table), and the `gk`
// bodies of tools/bench_gather2.py (a flat take from the [T/128, 128] table),
// tools/bench_gather3.py and tools/bench_rng_gather.py (lane takes from an
// 8-row broadcast of the table, a flat take & (T - 1)).  For an index array
// idx[rows, cols] and a table of 32-bit words it writes
//
//     axis 0:  out[i, j] = table[(idx[i, j] & mask) * cols + j]
//     axis 1:  out[i, j] = table[i * cols + (idx[i, j] & mask)]
//
// (a flat take is axis 0 with cols = 1, and has its own case with no column
// arithmetic).  The wrapper admits only masks that keep every index inside
// the table, so the kernel reads no bounds.
//
// Bound on the card: bytes.  Each index is read once (4 B), each output
// written once (4 B), each table word the indices reach read once (4 B): at
// the spikes' 9 x 262144 indices about 19 MB, 6 us at 3.35 TB/s.  The index
// and output streams are what must cross device memory; the table (1 MB at
// the spikes' size) fits in the 50 MB L2 many times over, so its random
// reads can be L2 hits, one 32-byte sector for each 4-byte word.  The
// design is for that:
//
//   - Many loads in flight.  A thread takes 8 words of a block tile of
//     8 x 128 words: it issues its two 16-byte index loads (coalesced: load
//     l of the block's threads covers 2 KB in a row) before the first of its
//     8 table loads, and the 8 table loads before the first store.  The
//     grid is at most sixteen 128-thread blocks per SM and strides over the
//     tiles, every block taking as many tiles as the others.
//   - An L2 policy.  The table is read through ld.global.nc with an
//     L2::evict_last cache hint (createpolicy), so the index and output
//     streams pass through the L2 without pushing the table out.  The
//     streams themselves use plain loads and stores: ld/st.global.cs
//     (evict-first) ran slower on the card (tools/kernel_variants.py times
//     it, and 4 or 16 words per thread, against this kernel; PERF.md).
//
// Axis 1 gathers straight from the table as well: staging each tile's rows
// in shared memory first, tried on the card, was slower, since the rows'
// words are read anyway and the staging adds a barrier per tile.  Index
// counts that are not a multiple of four, rows of other widths than a
// multiple of four and unaligned views take the same scheme one word at a
// time (8 scalar index loads per thread, strided across the block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;                      // words per thread per tile
constexpr int kVec = kPerThread / 4;               // 16-byte index loads per thread per tile
constexpr int kTileWords = kThreads * kPerThread;  // 1024
constexpr int kBlocksPerSm = 16;                   // 2048 threads
enum Kind { kFlat, kAxis0, kAxis1 };

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// One table word through the read-only path, kept in L2 by `policy`.
__device__ __forceinline__ uint32_t table_word(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// Position in the table of output word i (column col of its row) for masked
// index k.
template <int kKind>
__device__ __forceinline__ size_t source(uint32_t k, int i, int col, int cols) {
  if (kKind == kFlat) return k;
  if (kKind == kAxis0) return static_cast<size_t>(k) * cols + col;
  return static_cast<size_t>(i - col) + k;
}

// Four words per index load: needs idx and out on 16-byte boundaries and,
// for an axis, cols % 4 == 0 (four consecutive words then share a row).
// Words from 4 * n4 to n (fewer than four) are done by block 0 one by one.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
gather4_kernel(const uint32_t* __restrict__ table, const uint4* __restrict__ idx, uint4* __restrict__ out, int n,
               int cols, uint32_t mask) {
  const uint64_t policy = evict_last_policy();
  const int n4 = n / 4;
  const int tiles = (n4 + kThreads * kVec - 1) / (kThreads * kVec);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int q0 = tile * kThreads * kVec + threadIdx.x;
    uint4 k[kVec];
#pragma unroll
    for (int l = 0; l < kVec; ++l) {
      const int q = q0 + l * kThreads;
      k[l] = q < n4 ? __ldg(idx + q) : make_uint4(0, 0, 0, 0);
    }
    uint4 v[kVec];
#pragma unroll
    for (int l = 0; l < kVec; ++l) {
      const int q = q0 + l * kThreads;
      if (q < n4) {
        const int i = 4 * q;
        const int col = kKind == kFlat ? 0 : i % cols;
        v[l].x = table_word(table + source<kKind>(k[l].x & mask, i, col, cols), policy);
        v[l].y = table_word(table + source<kKind>(k[l].y & mask, i + 1, col + 1, cols), policy);
        v[l].z = table_word(table + source<kKind>(k[l].z & mask, i + 2, col + 2, cols), policy);
        v[l].w = table_word(table + source<kKind>(k[l].w & mask, i + 3, col + 3, cols), policy);
      }
    }
#pragma unroll
    for (int l = 0; l < kVec; ++l) {
      const int q = q0 + l * kThreads;
      if (q < n4) out[q] = v[l];
    }
  }
  const int i = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const uint32_t* idx1 = reinterpret_cast<const uint32_t*>(idx);
    const int col = kKind == kFlat ? 0 : i % cols;
    reinterpret_cast<uint32_t*>(out)[i] = table_word(table + source<kKind>(idx1[i] & mask, i, col, cols), policy);
  }
}

// One word per index load, any alignment and row width: thread t of the
// block takes words tile * 1024 + l * 128 + t, l = 0..7.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
gather1_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ idx, uint32_t* __restrict__ out,
               int n, int cols, uint32_t mask) {
  const uint64_t policy = evict_last_policy();
  const int tiles = (n + kTileWords - 1) / kTileWords;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i0 = tile * kTileWords + threadIdx.x;
    uint32_t k[kPerThread];
#pragma unroll
    for (int l = 0; l < kPerThread; ++l) {
      const int i = i0 + l * kThreads;
      k[l] = i < n ? __ldg(idx + i) : 0u;
    }
    uint32_t v[kPerThread];
#pragma unroll
    for (int l = 0; l < kPerThread; ++l) {
      const int i = i0 + l * kThreads;
      if (i < n) v[l] = table_word(table + source<kKind>(k[l] & mask, i, kKind == kFlat ? 0 : i % cols, cols), policy);
    }
#pragma unroll
    for (int l = 0; l < kPerThread; ++l) {
      const int i = i0 + l * kThreads;
      if (i < n) out[i] = v[l];
    }
  }
}

// Blocks for `tiles` tiles: at most kBlocksPerSm per SM, each taking the
// same number of tiles, so that no block runs one tile more than most.
int grid_for(int tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_block = (tiles + sms * kBlocksPerSm - 1) / (sms * kBlocksPerSm);
  return (tiles + per_block - 1) / per_block;
}

template <int kKind>
void launch(const uint32_t* table, const uint32_t* idx, uint32_t* out, int n, int cols, unsigned mask,
            cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && (kKind == kFlat || cols % 4 == 0)) {
    gather4_kernel<kKind><<<grid_for((n / 4 + kThreads * kVec - 1) / (kThreads * kVec) + (n < 4)), kThreads, 0, s>>>(
        table, reinterpret_cast<const uint4*>(idx), reinterpret_cast<uint4*>(out), n, cols, mask);
  } else {
    gather1_kernel<kKind><<<grid_for((n + kTileWords - 1) / kTileWords), kThreads, 0, s>>>(table, idx, out, n, cols,
                                                                                          mask);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int gather_u32_launch(const uint32_t* table, const uint32_t* idx, uint32_t* out, int n, int cols,
                                 int axis, unsigned mask, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0 && cols == 1) {
    launch<kFlat>(table, idx, out, n, cols, mask, s);
  } else if (axis == 0) {
    launch<kAxis0>(table, idx, out, n, cols, mask, s);
  } else {
    launch<kAxis1>(table, idx, out, n, cols, mask, s);
  }
  return static_cast<int>(cudaGetLastError());
}
