// a2b and bit2a: the share conversions, each in one launch.
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
//          out = t + a2 - 2 (MUL(t, a2) + alpha[1])        (mod 2^32;
//          alpha is (3, 2, n), additive zero sharings).
//
// Bound: bytes. Per lane, with L Kogge-Stone levels, a2b reads x (12 B) and
// 2(1 + 2L) alpha words of three shares (24(1 + 2L) B) and writes 12 B:
// 12 + 24(1 + 2L) + 12 bytes; bit2a moves 12 + 24 + 12 = 48 bytes. The
// design is ks_prefix's (ks_levels.cuh): the legs, both adders' g and p, or
// the bit injection's t stay in registers, each alpha word is streamed in
// once with 16-byte loads where the planes allow, and only the result is
// written, where the gate-by-gate path makes 2(1 + L) round trips (a2b) or
// two (bit2a) through device memory.
#include "ks_levels.cuh"

namespace {

// One Kogge-Stone adder over boolean triples; its alpha words start at w0.
template <int V>
__device__ __forceinline__ void ks_add(const uint32_t (&x)[3][V], const uint32_t (&y)[3][V],
                                       const uint32_t* __restrict__ alpha, int64_t n, int words,
                                       int w0, int64_t j, const Shifts& sh,
                                       uint32_t (&out)[3][V]) {
  uint32_t a[3][V], g[3][V], p[3][V];
  load_alpha<V>(alpha, n, words, w0, j, a);
  and_gate<V>(x, y, a, g);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) p[s][v] = x[s][v] ^ y[s][v];
  }
  ks_levels<V>(g, p, alpha, n, words, w0 + 1, j, sh);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) out[s][v] = x[s][v] ^ y[s][v] ^ (g[s][v] << 1);
  }
}

template <int V>
__global__ void a2b_kernel(const uint32_t* __restrict__ x_in, const uint32_t* __restrict__ alpha,
                           uint32_t* __restrict__ out, int64_t n, Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  const int half = 1 + 2 * sh.n;  // alpha words of one adder
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    uint32_t xs[3][V];
    load3<V>(x_in + j, n, xs);
    uint32_t l0[3][V], l1[3][V], l2[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        l0[s][v] = s == 0 ? xs[0][v] : 0u;
        l1[s][v] = s == 1 ? xs[1][v] : 0u;
        l2[s][v] = s == 2 ? xs[2][v] : 0u;
      }
    }
    uint32_t sum[3][V], res[3][V];
    ks_add<V>(l0, l1, alpha, n, 2 * half, 0, j, sh, sum);
    ks_add<V>(sum, l2, alpha, n, 2 * half, half, j, sh, res);
    store3<V>(out + j, n, res);
  }
}

// Ring-product cross terms plus the zero sharing:
// z_s = x_s y_s + x_s y_{s+1} + x_{s+1} y_s + a_s.
template <int V>
__device__ __forceinline__ void mul_gate(const uint32_t (&x)[3][V], const uint32_t (&y)[3][V],
                                         const uint32_t (&a)[3][V], uint32_t (&z)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int t = (s + 1) % 3;
#pragma unroll
    for (int v = 0; v < V; ++v)
      z[s][v] = x[s][v] * y[s][v] + x[s][v] * y[t][v] + x[t][v] * y[s][v] + a[s][v];
  }
}

template <int V>
__global__ void bit2a_kernel(const uint32_t* __restrict__ b_in, const uint32_t* __restrict__ alpha,
                             uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    uint32_t b[3][V];
    load3<V>(b_in + j, n, b);
    uint32_t a0[3][V], a1[3][V], a2[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a0[s][v] = s == 0 ? (b[0][v] & 1u) : 0u;
        a1[s][v] = s == 1 ? (b[1][v] & 1u) : 0u;
        a2[s][v] = s == 2 ? (b[2][v] & 1u) : 0u;
      }
    }
    uint32_t al[3][V], m[3][V], t[3][V], res[3][V];
    load_alpha<V>(alpha, n, 2, 0, j, al);
    mul_gate<V>(a0, a1, al, m);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[s][v] = a0[s][v] + a1[s][v] - 2u * m[s][v];
    }
    load_alpha<V>(alpha, n, 2, 1, j, al);
    mul_gate<V>(t, a2, al, m);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) res[s][v] = t[s][v] + a2[s][v] - 2u * m[s][v];
    }
    store3<V>(out + j, n, res);
  }
}

}  // namespace

// x, out: (3, n) planes of arithmetic shares; alpha: (3, 2(1 + 2 n_shifts), n);
// all contiguous int32 storage. shifts: n_shifts host ints in [0, 31],
// n_shifts <= 8. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int a2b_launch(const void* x, const void* alpha, void* out, long long n,
                          const int* shifts, int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xi = static_cast<const uint32_t*>(x);
  auto* ai = static_cast<const uint32_t*>(alpha);
  auto* o = static_cast<uint32_t*>(out);
  if (n % 4 == 0 && aligned16(x) && aligned16(alpha) && aligned16(out))
    a2b_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(xi, ai, o, n, sh);
  else
    a2b_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(xi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}

// b, out: (3, n) planes (b boolean, its LSB used; out arithmetic);
// alpha: (3, 2, n) additive zero sharings; as a2b_launch.
extern "C" int bit2a_launch(const void* b, const void* alpha, void* out, long long n,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* bi = static_cast<const uint32_t*>(b);
  auto* ai = static_cast<const uint32_t*>(alpha);
  auto* o = static_cast<uint32_t*>(out);
  if (n % 4 == 0 && aligned16(b) && aligned16(alpha) && aligned16(out))
    bit2a_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(bi, ai, o, n);
  else
    bit2a_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(bi, ai, o, n);
  return static_cast<int>(cudaGetLastError());
}
