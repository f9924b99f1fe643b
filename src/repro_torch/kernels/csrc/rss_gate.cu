// rss_gate: the 1-round replicated-secret-sharing multiplication / AND gate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rss_gate/rss_gate.py
// (`rss_gate`, its body `_gate_kernel`). For every lane j and share i:
//
//   bool : z_i = (x_i & y_i) ^ (x_i & y_{i+1}) ^ (x_{i+1} & y_i) ^ alpha_i
//   arith: z_i =  x_i * y_i  +  x_i * y_{i+1}  +  x_{i+1} * y_i  + alpha_i
//
// over the canonical share triple, stored as three planes of n ring words at
// stride n. The TPU kernel rolls the share axis inside a VMEM block; here one
// thread owns four lanes, loads the three share words of x, y and alpha into
// registers, and the roll becomes a fixed permutation of those registers.
//
// Bound: bytes. Each lane reads 9 words and writes 3: 48 bytes per lane, a
// handful of integer operations per word. The design moves each byte once,
// with 16-byte loads and stores (n % 4 == 0 and 16-byte aligned planes),
// else one word per thread with the ragged tail masked. At one join tile
// (n = 65,536) the kernel moves 3 MiB, about 1 us at 3.35 TB/s, so there it is
// bound by the launch, not the bytes. The PRF draw of alpha stays outside
// (streamed in, as on the TPU); fusing it in is later work.
//
// Storage is int32 in PyTorch; the kernel reinterprets it as uint32, whose
// arithmetic wraps mod 2^32 as the ring requires.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kBool>
__device__ __forceinline__ uint32_t cross(uint32_t x, uint32_t xn, uint32_t y,
                                          uint32_t yn, uint32_t a) {
  if (kBool) return (x & y) ^ (x & yn) ^ (xn & y) ^ a;
  return x * y + x * yn + xn * y + a;
}

template <bool kBool>
__device__ __forceinline__ void gate3(uint32_t x0, uint32_t x1, uint32_t x2,
                                      uint32_t y0, uint32_t y1, uint32_t y2,
                                      uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t& z0, uint32_t& z1, uint32_t& z2) {
  // share i pairs with share i+1 (mod 3): the roll over the share axis
  z0 = cross<kBool>(x0, x1, y0, y1, a0);
  z1 = cross<kBool>(x1, x2, y1, y2, a1);
  z2 = cross<kBool>(x2, x0, y2, y0, a2);
}

template <bool kBool>
__global__ void rss_gate_vec4(const uint4* __restrict__ x,
                              const uint4* __restrict__ y,
                              const uint4* __restrict__ a,
                              uint4* __restrict__ z, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const uint4 x0 = x[i], x1 = x[i + n4], x2 = x[i + 2 * n4];
    const uint4 y0 = y[i], y1 = y[i + n4], y2 = y[i + 2 * n4];
    const uint4 a0 = a[i], a1 = a[i + n4], a2 = a[i + 2 * n4];
    uint4 z0, z1, z2;
    gate3<kBool>(x0.x, x1.x, x2.x, y0.x, y1.x, y2.x, a0.x, a1.x, a2.x, z0.x, z1.x, z2.x);
    gate3<kBool>(x0.y, x1.y, x2.y, y0.y, y1.y, y2.y, a0.y, a1.y, a2.y, z0.y, z1.y, z2.y);
    gate3<kBool>(x0.z, x1.z, x2.z, y0.z, y1.z, y2.z, a0.z, a1.z, a2.z, z0.z, z1.z, z2.z);
    gate3<kBool>(x0.w, x1.w, x2.w, y0.w, y1.w, y2.w, a0.w, a1.w, a2.w, z0.w, z1.w, z2.w);
    z[i] = z0;
    z[i + n4] = z1;
    z[i + 2 * n4] = z2;
  }
}

template <bool kBool>
__global__ void rss_gate_scalar(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                const uint32_t* __restrict__ a,
                                uint32_t* __restrict__ z, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t z0, z1, z2;
    gate3<kBool>(x[i], x[i + n], x[i + 2 * n], y[i], y[i + n], y[i + 2 * n],
                 a[i], a[i + n], a[i + 2 * n], z0, z1, z2);
    z[i] = z0;
    z[i + n] = z1;
    z[i + 2 * n] = z2;
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

// x, y, alpha, z: (3, n) planes of ring words, contiguous; z is written.
// boolean != 0 selects the XOR/AND gate, else the ring multiplication.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rss_gate_launch(const void* x, const void* y, const void* alpha,
                               void* z, long long n, int boolean,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (n % 4 == 0) && aligned16(x) && aligned16(y) &&
                   aligned16(alpha) && aligned16(z);
  if (vec) {
    const int64_t n4 = n / 4;
    auto* xv = static_cast<const uint4*>(x);
    auto* yv = static_cast<const uint4*>(y);
    auto* av = static_cast<const uint4*>(alpha);
    auto* zv = static_cast<uint4*>(z);
    if (boolean)
      rss_gate_vec4<true><<<blocks_for(n4), kThreads, 0, s>>>(xv, yv, av, zv, n4);
    else
      rss_gate_vec4<false><<<blocks_for(n4), kThreads, 0, s>>>(xv, yv, av, zv, n4);
  } else {
    auto* xs = static_cast<const uint32_t*>(x);
    auto* ys = static_cast<const uint32_t*>(y);
    auto* as = static_cast<const uint32_t*>(alpha);
    auto* zs = static_cast<uint32_t*>(z);
    if (boolean)
      rss_gate_scalar<true><<<blocks_for(n), kThreads, 0, s>>>(xs, ys, as, zs, n);
    else
      rss_gate_scalar<false><<<blocks_for(n), kThreads, 0, s>>>(xs, ys, as, zs, n);
  }
  return static_cast<int>(cudaGetLastError());
}
