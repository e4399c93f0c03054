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
// the spikes' 9 x 262144 indices about 19 MB, 6 us at 3.35 TB/s.  The TPU had
// no gather primitive that ran near its memory rate, hence the spikes; on
// Hopper a gather is a plain load, and a 1 MB table stays in the 50 MB L2,
// so the random reads of the table cost L2 traffic, not HBM traffic.  The
// design is one thread per four consecutive output words: the four indices
// come in one 16-byte load and the four words go out in one 16-byte store
// (coalesced across the warp), the table read through the read-only cache
// (__ldg).  Four consecutive words share a row when cols % 4 == 0, so the
// column is worked out once per thread.  Index counts that are not a
// multiple of four, rows of other widths and unaligned pointers take the
// one-word-per-thread kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
enum Kind { kFlat, kAxis0, kAxis1 };

// The word of output i (column col of its row) for masked index k.
template <int kKind>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ table, uint32_t k, int i, int col, int cols) {
  if (kKind == kFlat) return __ldg(table + k);
  if (kKind == kAxis0) return __ldg(table + static_cast<size_t>(k) * cols + col);
  return __ldg(table + static_cast<size_t>(i - col) + k);
}

template <int kKind>
__global__ void __launch_bounds__(kBlock)
gather4_kernel(const uint32_t* __restrict__ table, const uint4* __restrict__ idx, uint4* __restrict__ out, int n4,
               int cols, uint32_t mask) {
  const int q = blockIdx.x * kBlock + threadIdx.x;
  if (q >= n4) return;
  const uint4 k = __ldg(idx + q);
  const int i = 4 * q;
  const int col = kKind == kFlat ? 0 : i % cols;
  uint4 v;
  v.x = word<kKind>(table, k.x & mask, i, col, cols);
  v.y = word<kKind>(table, k.y & mask, i + 1, col + 1, cols);
  v.z = word<kKind>(table, k.z & mask, i + 2, col + 2, cols);
  v.w = word<kKind>(table, k.w & mask, i + 3, col + 3, cols);
  out[q] = v;
}

template <int kKind>
__global__ void __launch_bounds__(kBlock)
gather1_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ idx, uint32_t* __restrict__ out,
               int n, int cols, uint32_t mask) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  out[i] = word<kKind>(table, idx[i] & mask, i, kKind == kFlat ? 0 : i % cols, cols);
}

template <int kKind>
void launch(const uint32_t* table, const uint32_t* idx, uint32_t* out, int n, int cols, unsigned mask,
            cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && n % 4 == 0 && (kKind == kFlat || cols % 4 == 0)) {
    const int n4 = n / 4;
    gather4_kernel<kKind><<<(n4 + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        table, reinterpret_cast<const uint4*>(idx), reinterpret_cast<uint4*>(out), n4, cols, mask);
  } else {
    gather1_kernel<kKind><<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(table, idx, out, n, cols, mask);
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
