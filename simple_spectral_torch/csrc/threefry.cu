// Threefry2x32 draws for Hopper (sm_90a): kernel T1 of the port.
//
// Replaces no Pallas kernel: the JAX package draws through jax.random and
// leaves threefry to XLA, which fuses the hash into the ops around it.  The
// port evaluated it eagerly, each 32-bit word operation an int64 torch op
// (random.py's twins): about 180 launches a draw, 0.42 of the 2M-lane train
// step's device time and more than half of the host's launches.  T1 draws
// in one launch.  For a key (k0, k1) and each flat index i < 2^32 it hashes
// the counter (0, i) with the 20 rounds of threefry2x32 and ends in one of
// three epilogues, bit for bit those of the twins:
//
//     bits:     hi ^ lo, stored as int64 in [0, 2^32)
//     uniform:  float((bits >> 9) | 0x3F800000) - 1, at least 0, float32
//     randint:  under the two keys of split(key), hashed on the host,
//               hi = bits_a % width, lo = bits_b % width,
//               minval + (hi * mult + lo) % width in uint32, stored as int32
//
// Bound on the card: instruction issue.  A hash is 72 integer operations
// (the counter's key add, 20 rounds of add, rotate and xor, 5 key
// injections of two adds, the final xor); uniform adds 4 (shift, or,
// subtract, max) and randint runs two hashes and three moduli by a runtime
// width, about twice uniform's.  The SM issues 128 thread-instructions a
// clock (4 schedulers x 32 lanes), 33.4 T/s over 132 SMs at 1.98 GHz; the
// rotates and xors (SHF, LOP3: 43 of uniform's 76) run only on its 64-lane
// INT32 pipe, 16.7 T/s, while nvcc moves adds to the FMA pipe (IMAD).  So
// 2,097,152 uniforms take at least 5.4 us on the INT32 pipe (4.8 us of
// issue), while their 8.4 MB of float32 stores take 2.5 us at 3.35 TB/s.
// The design:
//   - rotations are one funnel shift each (__funnelshift_l, SHF), the
//     round constants immediates, the key schedule's sums of a key word and
//     a round number per-thread constants;
//   - no intermediate word leaves registers: nothing is read, and each
//     element's result is written once;
//   - a thread takes four consecutive counters, so that it stores one
//     16-byte vector (two for the int64 bits), neighbouring threads on
//     neighbouring addresses; the ragged tail is stored word by word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // consecutive counters per thread: one 16-byte store of 32-bit words
enum Kind { kBits = 0, kUniform = 1, kRandint = 2 };

struct Draw {
  uint32_t ka0, ka1;  // the key (randint: the first key of split(key))
  uint32_t kb0, kb1;  // randint: the second key of split(key)
  uint32_t n, width, mult, minval;
};

template <int kR>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, kR) ^ x0;
}

template <int kR0, int kR1, int kR2, int kR3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  mix<kR0>(x0, x1);
  mix<kR1>(x0, x1);
  mix<kR2>(x0, x1);
  mix<kR3>(x0, x1);
}

// hi ^ lo of threefry2x32 under the key (k0, k1) of the counter (0, i).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;  // the counter's high word is 0
  uint32_t x1 = i + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// The 32-bit word that the epilogue kKind makes of counter i.
template <int kKind>
__device__ __forceinline__ uint32_t word(const Draw& d, uint32_t i) {
  if (kKind == kRandint) {
    const uint32_t hi = threefry_bits(d.ka0, d.ka1, i) % d.width;
    const uint32_t lo = threefry_bits(d.kb0, d.kb1, i) % d.width;
    return d.minval + (hi * d.mult + lo) % d.width;
  }
  const uint32_t bits = threefry_bits(d.ka0, d.ka1, i);
  if (kKind == kUniform) return __float_as_uint(fmaxf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f));
  return bits;
}

// Thread q takes counters 4q .. 4q + 3.  32-bit words go out as one uint4;
// the int64 bits as two, each holding two words with a zero high word
// (little-endian), so every full group is stored in 16-byte vectors.
template <int kKind>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Draw d, void* __restrict__ out) {
  const uint32_t q = blockIdx.x * kThreads + threadIdx.x;
  const uint64_t i0 = static_cast<uint64_t>(q) * kPerThread;
  if (i0 >= d.n) return;
  uint32_t v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) v[j] = word<kKind>(d, static_cast<uint32_t>(i0) + j);
  if (i0 + kPerThread <= d.n) {
    uint4* o = reinterpret_cast<uint4*>(out);
    if (kKind == kBits) {
      o[2 * static_cast<size_t>(q)] = make_uint4(v[0], 0u, v[1], 0u);
      o[2 * static_cast<size_t>(q) + 1] = make_uint4(v[2], 0u, v[3], 0u);
    } else {
      o[q] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (i0 + j < d.n) {
      if (kKind == kBits) {
        reinterpret_cast<uint64_t*>(out)[i0 + j] = v[j];
      } else {
        reinterpret_cast<uint32_t*>(out)[i0 + j] = v[j];
      }
    }
  }
}

}  // namespace

// Launch on `stream` into `out` (n elements of the epilogue's type, 16-byte
// aligned); returns the cudaError_t of the launch (0 = success).
extern "C" int threefry_launch(int kind, unsigned ka0, unsigned ka1, unsigned kb0, unsigned kb1, unsigned n,
                               unsigned width, unsigned mult, unsigned minval, void* out, void* stream) {
  if (n == 0) return 0;
  const Draw d{ka0, ka1, kb0, kb1, n, width, mult, minval};
  const uint64_t groups = (static_cast<uint64_t>(n) + kPerThread - 1) / kPerThread;
  const unsigned blocks = static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBits:
      threefry_kernel<kBits><<<blocks, kThreads, 0, s>>>(d, out);
      break;
    case kUniform:
      threefry_kernel<kUniform><<<blocks, kThreads, 0, s>>>(d, out);
      break;
    case kRandint:
      if (width == 0) return static_cast<int>(cudaErrorInvalidValue);
      threefry_kernel<kRandint><<<blocks, kThreads, 0, s>>>(d, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
