// threefry_bits: JAX's partitionable threefry-2x32 draws, every key's words
// in one launch.
//
// The PRF behind every share, zero sharing, coin and shuffle of the engine is
// `jax.random.bits(key, shape, uint32)` under `jax_threefry_partitionable`
// (the reference draws it at src/repro/core/prf.py:51, which XLA lowers to
// elementwise integer code; there is no Pallas kernel for it). Element i of a
// draw hashes the 64-bit counter (0, i) with the key's two words through
// threefry-2x32's 20 rounds and keeps the XOR of the two output words. In
// plain PyTorch that is about 150 elementwise operations per draw, each a
// launch that reads and writes the whole draw; here one thread hashes one
// counter in registers and stores one word.
//
// Keys come two ways: as words passed by value (at most kMaxHostKeys keys,
// the engine's host-side pair keys, which no capture has to refill), or as
// an (R, 2) int32 tensor on the card (the per-operator cache's device keys:
// a replayed CUDA graph reads whatever keys the tensor holds then). Key r
// writes row r of the (R, n) output; blockIdx.y is the key.
//
// Bound: operations. Per word the hash is 20 rounds of add, rotate and XOR
// plus the five key injections (two adds each) and the final XOR, about 73
// integer operations, for 4 bytes written: 18 operations per byte, above the
// card's operations-per-byte ratio (33.5e12 / 3.35e12 = 10). Rotations are
// funnel shifts. Counters stay below 2^31 (the callers refuse larger draws),
// so the loop runs on 32-bit indices.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHostKeys = 4;
constexpr unsigned kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
constexpr uint32_t kParity = 0x1BD11BDAu;

struct HostKeys {
  uint32_t w[2 * kMaxHostKeys];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// threefry-2x32 of the counter (0, ctr) under the key (k0, k1): the XOR of
// the two output words.
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1, uint32_t ctr) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = k0;
  uint32_t x1 = ctr + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

// dk: the (R, 2) device keys, or null for the host keys hk.
__global__ void threefry_bits_kernel(HostKeys hk, const uint32_t* __restrict__ dk, uint32_t n,
                                     uint32_t* __restrict__ out) {
  const unsigned r = blockIdx.y;
  const uint32_t k0 = dk ? dk[2 * r] : hk.w[2 * r];
  const uint32_t k1 = dk ? dk[2 * r + 1] : hk.w[2 * r + 1];
  uint32_t* row = out + static_cast<size_t>(r) * n;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    row[i] = threefry_xor(k0, k1, i);
  }
}

}  // namespace

// out: (r_keys, n) int32 words, contiguous, written. With dev_keys null the
// keys are host_words[2r], host_words[2r + 1] (r_keys <= 4); else dev_keys is
// an (r_keys, 2) int32 tensor on the card (r_keys <= 65,535). n < 2^31.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside those ranges.
extern "C" int threefry_bits_launch(const int* host_words, int r_keys, const void* dev_keys,
                                    long long n, void* out, void* stream) {
  if (n <= 0 || r_keys <= 0) return 0;
  if (n >= (1LL << 31) || r_keys > 65535 || (dev_keys == nullptr && r_keys > kMaxHostKeys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HostKeys hk{};
  if (dev_keys == nullptr) {
    for (int i = 0; i < 2 * r_keys; ++i) hk.w[i] = static_cast<uint32_t>(host_words[i]);
  }
  const unsigned per_key = kMaxBlocks / static_cast<unsigned>(r_keys);
  const long long need = (n + kThreads - 1) / kThreads;
  const unsigned bx = static_cast<unsigned>(need < (per_key ? per_key : 1) ? need : (per_key ? per_key : 1));
  threefry_bits_kernel<<<dim3(bx, static_cast<unsigned>(r_keys)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      hk, static_cast<const uint32_t*>(dev_keys), static_cast<uint32_t>(n), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
