// a2b and bit2a: the share conversions, each in one launch, on ring-32 and
// ring-64 words.
//
// Replaces the Pallas TPU kernels src/repro/kernels/a2b_fused/a2b_fused.py
// `a2b_kernel` (body `_a2b_kernel`) and `bit2a_kernel` (body
// `_bit2a_kernel`). For every lane:
//
//   a2b:   the arithmetic shares x_0, x_1, x_2 become the trivial boolean
//          triples l0 = (x_0, 0, 0), l1 = (0, x_1, 0), l2 = (0, 0, x_2);
//          then s = ks_add(l0, l1), out = ks_add(s, l2), where
//          ks_add(x, y): g = AND(x, y) ^ alpha[init], p = x ^ y,
//          the Kogge-Stone levels on (g, p), and x ^ y ^ (g << 1).
//          alpha is (3, 2(1 + 2L), n): per adder [init, lvl0 pg, lvl0 pp, ...].
//   bit2a: the LSBs b_0, b_1, b_2 become trivial arithmetic triples a0, a1,
//          a2; u ^ v = u + v - 2uv, twice, with the ring products'
//          cross terms MUL(x, y)_s = x_s y_s + x_s y_{s+1} + x_{s+1} y_s:
//          t = a0 + a1 - 2 (MUL(a0, a1) + alpha[0]),
//          out = t + a2 - 2 (MUL(t, a2) + alpha[1])        (mod 2^k;
//          alpha is (3, 2, n), additive zero sharings).
//
// Both are templates on the word type: uint32_t (`a2b_launch`,
// `bit2a_launch`) and uint64_t (the `_u64` entries, ring-64: up to 6
// Kogge-Stone levels, shifts up to 63).
//
// Bound: bytes. Per lane, with L Kogge-Stone levels, a2b reads x (12 B) and
// 2(1 + 2L) alpha words of three shares (24(1 + 2L) B) and writes 12 B:
// 12 + 24(1 + 2L) + 12 bytes; bit2a moves 12 + 24 + 12 = 48 bytes (twice
// each on ring-64). A 64-bit product is three 32-bit multiply-adds (the
// low product, widened, and the two cross halves), so bit2a on ring-64 does
// some 1.6x the 32-bit instructions of its ring-32 build per lane for twice
// the bytes; it stays below the card's operations-per-byte ratio. The
// design is ks_prefix's (ks_levels.cuh): the legs, both adders' g and p, or
// the bit injection's t stay in registers, each alpha word is streamed in
// once with 16-byte loads where the planes allow, and only the result is
// written, where the gate-by-gate path makes 2(1 + L) round trips (a2b) or
// two (bit2a) through device memory.
#include "ks_levels.cuh"

namespace {

// One Kogge-Stone adder over boolean triples; its alpha words start at w0.
template <typename T, int V>
__device__ __forceinline__ void ks_add(const T (&x)[3][V], const T (&y)[3][V],
                                       const T* __restrict__ alpha, int64_t n, int words,
                                       int w0, int64_t j, const Shifts& sh, T (&out)[3][V]) {
  T a[3][V], g[3][V], p[3][V];
  load_alpha<T, V>(alpha, n, words, w0, j, a);
  and_gate<T, V>(x, y, a, g);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) p[s][v] = x[s][v] ^ y[s][v];
  }
  ks_levels<T, V>(g, p, alpha, n, words, w0 + 1, j, sh);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) out[s][v] = x[s][v] ^ y[s][v] ^ (g[s][v] << 1);
  }
}

template <typename T, int V>
__global__ void a2b_kernel(const T* __restrict__ x_in, const T* __restrict__ alpha,
                           T* __restrict__ out, int64_t n, Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  const int half = 1 + 2 * sh.n;  // alpha words of one adder
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    T xs[3][V];
    load3<T, V>(x_in + j, n, xs);
    T l0[3][V], l1[3][V], l2[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        l0[s][v] = s == 0 ? xs[0][v] : T(0);
        l1[s][v] = s == 1 ? xs[1][v] : T(0);
        l2[s][v] = s == 2 ? xs[2][v] : T(0);
      }
    }
    T sum[3][V], res[3][V];
    ks_add<T, V>(l0, l1, alpha, n, 2 * half, 0, j, sh, sum);
    ks_add<T, V>(sum, l2, alpha, n, 2 * half, half, j, sh, res);
    store3<T, V>(out + j, n, res);
  }
}

// Ring-product cross terms plus the zero sharing:
// z_s = x_s y_s + x_s y_{s+1} + x_{s+1} y_s + a_s.
template <typename T, int V>
__device__ __forceinline__ void mul_gate(const T (&x)[3][V], const T (&y)[3][V],
                                         const T (&a)[3][V], T (&z)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int t = (s + 1) % 3;
#pragma unroll
    for (int v = 0; v < V; ++v)
      z[s][v] = x[s][v] * y[s][v] + x[s][v] * y[t][v] + x[t][v] * y[s][v] + a[s][v];
  }
}

template <typename T, int V>
__global__ void bit2a_kernel(const T* __restrict__ b_in, const T* __restrict__ alpha,
                             T* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    T b[3][V];
    load3<T, V>(b_in + j, n, b);
    T a0[3][V], a1[3][V], a2[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a0[s][v] = s == 0 ? (b[0][v] & T(1)) : T(0);
        a1[s][v] = s == 1 ? (b[1][v] & T(1)) : T(0);
        a2[s][v] = s == 2 ? (b[2][v] & T(1)) : T(0);
      }
    }
    T al[3][V], m[3][V], t[3][V], res[3][V];
    load_alpha<T, V>(alpha, n, 2, 0, j, al);
    mul_gate<T, V>(a0, a1, al, m);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[s][v] = a0[s][v] + a1[s][v] - T(2) * m[s][v];
    }
    load_alpha<T, V>(alpha, n, 2, 1, j, al);
    mul_gate<T, V>(t, a2, al, m);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) res[s][v] = t[s][v] + a2[s][v] - T(2) * m[s][v];
    }
    store3<T, V>(out + j, n, res);
  }
}

template <typename T>
int a2b_run(const void* x, const void* alpha, void* out, long long n, const int* shifts,
            int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, 8 * sizeof(T), &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xi = static_cast<const T*>(x);
  auto* ai = static_cast<const T*>(alpha);
  auto* o = static_cast<T*>(out);
  constexpr int V = kVec<T>;
  if (vec_ok<T>(n, {x, alpha, out}))
    a2b_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(xi, ai, o, n, sh);
  else
    a2b_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(xi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bit2a_run(const void* b, const void* alpha, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* bi = static_cast<const T*>(b);
  auto* ai = static_cast<const T*>(alpha);
  auto* o = static_cast<T*>(out);
  constexpr int V = kVec<T>;
  if (vec_ok<T>(n, {b, alpha, out}))
    bit2a_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(bi, ai, o, n);
  else
    bit2a_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(bi, ai, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (3, n) planes of arithmetic shares; alpha: (3, 2(1 + 2 n_shifts), n);
// all contiguous int32 storage. shifts: n_shifts host ints in [0, 31],
// n_shifts <= 8. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int a2b_launch(const void* x, const void* alpha, void* out, long long n,
                          const int* shifts, int n_shifts, void* stream) {
  return a2b_run<uint32_t>(x, alpha, out, n, shifts, n_shifts, stream);
}

// As a2b_launch on int64 storage (ring-64); shifts in [0, 63].
extern "C" int a2b_launch_u64(const void* x, const void* alpha, void* out, long long n,
                              const int* shifts, int n_shifts, void* stream) {
  return a2b_run<uint64_t>(x, alpha, out, n, shifts, n_shifts, stream);
}

// b, out: (3, n) planes (b boolean, its LSB used; out arithmetic);
// alpha: (3, 2, n) additive zero sharings; as a2b_launch.
extern "C" int bit2a_launch(const void* b, const void* alpha, void* out, long long n,
                            void* stream) {
  return bit2a_run<uint32_t>(b, alpha, out, n, stream);
}

// As bit2a_launch on int64 storage (ring-64).
extern "C" int bit2a_launch_u64(const void* b, const void* alpha, void* out, long long n,
                                void* stream) {
  return bit2a_run<uint64_t>(b, alpha, out, n, stream);
}
