// bitonic_swap: one bitonic compare-exchange stage's conditional swap over
// all C columns of the sorted table.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitonic_stage/bitonic_stage.py (`bitonic_swap`, its body
// `_swap_kernel`). With the swap decision as a full-width XOR-shared mask m
// (3, N), the stage's columns own (3, C, N), their partner lanes other
// (3, C, N) and a zero sharing alpha (3, C, N), for every lane j, column c
// and share i:
//
//   d_i   = own_i ^ other_i
//   out_i = own_i ^ ((m_i & d_i) ^ (m_i & d_{i+1}) ^ (m_{i+1} & d_i) ^ alpha_i)
//
// the local body of the oblivious select `own ^ and_(m, own ^ other)`: the
// AND gate's cross terms over the share axis, rolled by one.
//
// Bound: bytes. Each lane reads its 3 mask words once and, per column, 9
// words of own / other / alpha, and writes 3: 4 * (3N + 4 * 3CN) bytes for
// the call, a dozen integer operations per column word. The TPU kernel pads
// the lanes to its block and runs a (3, C, BLOCK) tile per grid step; here
// one thread owns four lanes (16-byte loads and stores when N % 4 == 0 and
// every plane is 16-byte aligned, else one lane with the ragged edge masked
// by the grid-stride bound), keeps the lane's mask in registers and loops
// over the C columns. `other` is the partner gather, read as the caller
// passes it (the reference's interface); reading lane j ^ stride in the
// kernel would save its gather and one read, and is later work.
//
// Storage is int32 in PyTorch; the kernel reads the words as uint32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t swap1(uint32_t o, uint32_t t, uint32_t on,
                                          uint32_t tn, uint32_t m, uint32_t mn,
                                          uint32_t a) {
  const uint32_t d = o ^ t, dn = on ^ tn;
  return o ^ ((m & d) ^ (m & dn) ^ (mn & d) ^ a);
}

__device__ __forceinline__ void swap3(uint32_t m0, uint32_t m1, uint32_t m2,
                                      uint32_t o0, uint32_t o1, uint32_t o2,
                                      uint32_t t0, uint32_t t1, uint32_t t2,
                                      uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t& z0, uint32_t& z1, uint32_t& z2) {
  // share i pairs with share i+1 (mod 3): the roll over the share axis
  z0 = swap1(o0, t0, o1, t1, m0, m1, a0);
  z1 = swap1(o1, t1, o2, t2, m1, m2, a1);
  z2 = swap1(o2, t2, o0, t0, m2, m0, a2);
}

// n4 = N / 4 lane groups; plane stride of the columns: cn4 = C * n4.
__global__ void bitonic_swap_vec4(const uint4* __restrict__ mask,
                                  const uint4* __restrict__ own,
                                  const uint4* __restrict__ other,
                                  const uint4* __restrict__ alpha,
                                  uint4* __restrict__ out, int64_t c,
                                  int64_t n4) {
  const int64_t cn4 = c * n4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const uint4 m0 = mask[i], m1 = mask[i + n4], m2 = mask[i + 2 * n4];
    for (int64_t col = 0; col < c; ++col) {
      const int64_t k = col * n4 + i;
      const uint4 o0 = own[k], o1 = own[k + cn4], o2 = own[k + 2 * cn4];
      const uint4 t0 = other[k], t1 = other[k + cn4], t2 = other[k + 2 * cn4];
      const uint4 a0 = alpha[k], a1 = alpha[k + cn4], a2 = alpha[k + 2 * cn4];
      uint4 z0, z1, z2;
      swap3(m0.x, m1.x, m2.x, o0.x, o1.x, o2.x, t0.x, t1.x, t2.x, a0.x, a1.x, a2.x, z0.x, z1.x, z2.x);
      swap3(m0.y, m1.y, m2.y, o0.y, o1.y, o2.y, t0.y, t1.y, t2.y, a0.y, a1.y, a2.y, z0.y, z1.y, z2.y);
      swap3(m0.z, m1.z, m2.z, o0.z, o1.z, o2.z, t0.z, t1.z, t2.z, a0.z, a1.z, a2.z, z0.z, z1.z, z2.z);
      swap3(m0.w, m1.w, m2.w, o0.w, o1.w, o2.w, t0.w, t1.w, t2.w, a0.w, a1.w, a2.w, z0.w, z1.w, z2.w);
      out[k] = z0;
      out[k + cn4] = z1;
      out[k + 2 * cn4] = z2;
    }
  }
}

__global__ void bitonic_swap_scalar(const uint32_t* __restrict__ mask,
                                    const uint32_t* __restrict__ own,
                                    const uint32_t* __restrict__ other,
                                    const uint32_t* __restrict__ alpha,
                                    uint32_t* __restrict__ out, int64_t c,
                                    int64_t n) {
  const int64_t cn = c * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t m0 = mask[i], m1 = mask[i + n], m2 = mask[i + 2 * n];
    for (int64_t col = 0; col < c; ++col) {
      const int64_t k = col * n + i;
      uint32_t z0, z1, z2;
      swap3(m0, m1, m2, own[k], own[k + cn], own[k + 2 * cn], other[k],
            other[k + cn], other[k + 2 * cn], alpha[k], alpha[k + cn],
            alpha[k + 2 * cn], z0, z1, z2);
      out[k] = z0;
      out[k + cn] = z1;
      out[k + 2 * cn] = z2;
    }
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM

inline int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// mask: (3, n); own, other, alpha, out: (3, c, n), all contiguous ring words;
// out is written. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bitonic_swap_launch(const void* mask, const void* own,
                                   const void* other, const void* alpha,
                                   void* out, long long c, long long n,
                                   void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (n % 4 == 0) && aligned16(mask) && aligned16(own) &&
                   aligned16(other) && aligned16(alpha) && aligned16(out);
  if (vec) {
    const int64_t n4 = n / 4;
    bitonic_swap_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const uint4*>(mask), static_cast<const uint4*>(own),
        static_cast<const uint4*>(other), static_cast<const uint4*>(alpha),
        static_cast<uint4*>(out), c, n4);
  } else {
    bitonic_swap_scalar<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(own),
        static_cast<const uint32_t*>(other), static_cast<const uint32_t*>(alpha),
        static_cast<uint32_t*>(out), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}
