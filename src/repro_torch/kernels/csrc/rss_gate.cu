// rss_gate: the 1-round replicated-secret-sharing multiplication / AND gate,
// on ring-32 and ring-64 words.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rss_gate/rss_gate.py
// (`rss_gate`, its body `_gate_kernel`). For every lane j and share i:
//
//   bool : z_i = (x_i & y_i) ^ (x_i & y_{i+1}) ^ (x_{i+1} & y_i) ^ alpha_i
//   arith: z_i =  x_i * y_i  +  x_i * y_{i+1}  +  x_{i+1} * y_i  + alpha_i
//
// over the canonical share triple, stored as three planes of n ring words at
// stride n. The TPU kernel rolls the share axis inside a VMEM block; here one
// thread owns one 16-byte group of lanes (a uint4 of four ring-32 words, a
// ulonglong2 of two ring-64 words), loads the three share words of x, y and
// alpha into registers, and the roll becomes a fixed permutation of those
// registers.
//
// Bound: bytes. Each lane reads 9 words and writes 3: 48 bytes per lane on
// ring-32, 96 on ring-64, a handful of integer operations per word. The
// design moves each byte once, with 16-byte loads and stores (n a multiple
// of the group and 16-byte aligned planes), else one word per thread with
// the ragged tail masked. At one join tile (n = 65,536) the kernel moves
// 3 MiB, about 1 us at 3.35 TB/s, so there it is bound by the launch, not
// the bytes. A 64-bit product is three 32-bit multiply-adds (the low
// product, widened, and the two cross halves), so the ring-64 arithmetic
// gate does about 1.6x its ring-32 build's instructions per lane for twice
// the bytes, still below the card's operations-per-byte ratio. The PRF draw
// of alpha stays outside (streamed in, as on the TPU); fusing it in is later
// work.
//
// Storage is int32 / int64 in PyTorch; the kernel reinterprets it as
// uint32_t / uint64_t, whose arithmetic wraps mod 2^32 / 2^64 as the ring
// requires. `rss_gate_launch` takes ring-32 planes, `rss_gate_launch_u64`
// ring-64 ones. Both are the one kernel template below, on the group a
// thread loads: a 16-byte vector of words, or one word for ragged or
// unaligned planes.
#include "ks_levels.cuh"

namespace {

template <bool kBool, typename T>
__device__ __forceinline__ T cross(T x, T xn, T y, T yn, T a) {
  if (kBool) return (x & y) ^ (x & yn) ^ (xn & y) ^ a;
  return x * y + x * yn + xn * y + a;
}

// The gate on one word: share i pairs with share i+1 (mod 3), the roll over
// the share axis.
template <bool kBool, typename T>
__device__ __forceinline__ void gate3(T x0, T x1, T x2, T y0, T y1, T y2, T a0, T a1, T a2,
                                      T& z0, T& z1, T& z2) {
  z0 = cross<kBool>(x0, x1, y0, y1, a0);
  z1 = cross<kBool>(x1, x2, y1, y2, a1);
  z2 = cross<kBool>(x2, x0, y2, y0, a2);
}

// ... and on each word of a 16-byte group.
template <bool kBool>
__device__ __forceinline__ void gate3(uint4 x0, uint4 x1, uint4 x2, uint4 y0, uint4 y1, uint4 y2,
                                      uint4 a0, uint4 a1, uint4 a2, uint4& z0, uint4& z1, uint4& z2) {
  gate3<kBool>(x0.x, x1.x, x2.x, y0.x, y1.x, y2.x, a0.x, a1.x, a2.x, z0.x, z1.x, z2.x);
  gate3<kBool>(x0.y, x1.y, x2.y, y0.y, y1.y, y2.y, a0.y, a1.y, a2.y, z0.y, z1.y, z2.y);
  gate3<kBool>(x0.z, x1.z, x2.z, y0.z, y1.z, y2.z, a0.z, a1.z, a2.z, z0.z, z1.z, z2.z);
  gate3<kBool>(x0.w, x1.w, x2.w, y0.w, y1.w, y2.w, a0.w, a1.w, a2.w, z0.w, z1.w, z2.w);
}

template <bool kBool>
__device__ __forceinline__ void gate3(ulonglong2 x0, ulonglong2 x1, ulonglong2 x2, ulonglong2 y0,
                                      ulonglong2 y1, ulonglong2 y2, ulonglong2 a0, ulonglong2 a1,
                                      ulonglong2 a2, ulonglong2& z0, ulonglong2& z1, ulonglong2& z2) {
  gate3<kBool>(x0.x, x1.x, x2.x, y0.x, y1.x, y2.x, a0.x, a1.x, a2.x, z0.x, z1.x, z2.x);
  gate3<kBool>(x0.y, x1.y, x2.y, y0.y, y1.y, y2.y, a0.y, a1.y, a2.y, z0.y, z1.y, z2.y);
}

// W: the group one thread owns (uint4, ulonglong2, or one word); m groups a
// plane.
template <bool kBool, typename W>
__global__ void rss_gate_kernel(const W* __restrict__ x, const W* __restrict__ y,
                                const W* __restrict__ a, W* __restrict__ z, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const W x0 = x[i], x1 = x[i + m], x2 = x[i + 2 * m];
    const W y0 = y[i], y1 = y[i + m], y2 = y[i + 2 * m];
    const W a0 = a[i], a1 = a[i + m], a2 = a[i + 2 * m];
    W z0, z1, z2;
    gate3<kBool>(x0, x1, x2, y0, y1, y2, a0, a1, a2, z0, z1, z2);
    z[i] = z0;
    z[i + m] = z1;
    z[i + 2 * m] = z2;
  }
}

template <bool kBool, typename W>
void launch(const void* x, const void* y, const void* a, void* z, int64_t m, cudaStream_t s) {
  rss_gate_kernel<kBool, W><<<blocks_for(m), kThreads, 0, s>>>(
      static_cast<const W*>(x), static_cast<const W*>(y), static_cast<const W*>(a),
      static_cast<W*>(z), m);
}

// T: the word; V: its 16-byte group.
template <typename T, typename V>
int rss_gate_run(const void* x, const void* y, const void* alpha, void* z, long long n,
                 int boolean, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok<T>(n, {x, y, alpha, z})) {
    if (boolean)
      launch<true, V>(x, y, alpha, z, n / kVec<T>, s);
    else
      launch<false, V>(x, y, alpha, z, n / kVec<T>, s);
  } else if (boolean) {
    launch<true, T>(x, y, alpha, z, n, s);
  } else {
    launch<false, T>(x, y, alpha, z, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y, alpha, z: (3, n) planes of ring words, contiguous int32 storage; z
// is written. boolean != 0 selects the XOR/AND gate, else the ring
// multiplication. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rss_gate_launch(const void* x, const void* y, const void* alpha,
                               void* z, long long n, int boolean,
                               void* stream) {
  return rss_gate_run<uint32_t, uint4>(x, y, alpha, z, n, boolean, stream);
}

// As rss_gate_launch on int64 storage (ring-64).
extern "C" int rss_gate_launch_u64(const void* x, const void* y, const void* alpha,
                                   void* z, long long n, int boolean, void* stream) {
  return rss_gate_run<uint64_t, ulonglong2>(x, y, alpha, z, n, boolean, stream);
}
