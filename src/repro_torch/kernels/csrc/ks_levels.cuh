// Shared by ks_prefix.cu and a2b_fused.cu: lane-group loads and stores, the
// AND gate over the share triple, and the Kogge-Stone level loop.
//
// A share triple of n lanes is three planes of ring words at stride n; a
// zero-sharing operand of W words per lane is (3, W, n): word w of share s
// for lane j lies at (s * W + w) * n + j. One thread owns V consecutive
// lanes: V = 4 loads and stores each plane row with one 16-byte access
// (n % 4 == 0 and 16-byte aligned planes), V = 1 is the scalar path for
// ragged or unaligned planes. The share axis's roll by one becomes a fixed
// permutation of the three registers (share s pairs with share s + 1 mod 3).
// Storage is int32 in PyTorch; the kernels read it as uint32, so `>>` is the
// ring's logical shift and products wrap mod 2^32.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;  // shift lists of at most 8 levels
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM

// A level's shift list, passed to the kernel by value.
struct Shifts {
  int n;
  int d[kMaxLevels];
};

template <int V>
__device__ __forceinline__ void load(const uint32_t* __restrict__ p, uint32_t (&r)[V]) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = p[v];
  }
}

template <int V>
__device__ __forceinline__ void store(uint32_t* __restrict__ p, const uint32_t (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = r[v];
  }
}

// The three shares of V lanes starting at p, planes `plane` words apart.
template <int V>
__device__ __forceinline__ void load3(const uint32_t* __restrict__ p, int64_t plane,
                                      uint32_t (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) load<V>(p + s * plane, r[s]);
}

template <int V>
__device__ __forceinline__ void store3(uint32_t* __restrict__ p, int64_t plane,
                                       const uint32_t (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) store<V>(p + s * plane, r[s]);
}

// Word w of the (3, words, n) zero sharing, all three shares, V lanes at j.
template <int V>
__device__ __forceinline__ void load_alpha(const uint32_t* __restrict__ alpha, int64_t n,
                                           int words, int w, int64_t j,
                                           uint32_t (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) load<V>(alpha + ((int64_t)s * words + w) * n + j, r[s]);
}

// The 1-round AND gate: z_s = (x_s & y_s) ^ (x_s & y_{s+1}) ^ (x_{s+1} & y_s) ^ a_s.
template <int V>
__device__ __forceinline__ void and_gate(const uint32_t (&x)[3][V], const uint32_t (&y)[3][V],
                                         const uint32_t (&a)[3][V], uint32_t (&z)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int t = (s + 1) % 3;
#pragma unroll
    for (int v = 0; v < V; ++v)
      z[s][v] = (x[s][v] & y[s][v]) ^ (x[s][v] & y[t][v]) ^ (x[t][v] & y[s][v]) ^ a[s][v];
  }
}

// The Kogge-Stone levels, g and p kept in registers throughout. Level l,
// shift d = sh.d[l], uses alpha words w0 + 2l (pg) and w0 + 2l + 1 (pp):
//   pg = AND(p, g << d),  pp = AND(p, p << d),  g ^= pg,  p = pp.
template <int V>
__device__ __forceinline__ void ks_levels(uint32_t (&g)[3][V], uint32_t (&p)[3][V],
                                          const uint32_t* __restrict__ alpha, int64_t n,
                                          int words, int w0, int64_t j, const Shifts& sh) {
  for (int l = 0; l < sh.n; ++l) {
    const int d = sh.d[l];
    uint32_t gs[3][V], ps[3][V], a[3][V], pg[3][V], pp[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gs[s][v] = g[s][v] << d;
        ps[s][v] = p[s][v] << d;
      }
    }
    load_alpha<V>(alpha, n, words, w0 + 2 * l, j, a);
    and_gate<V>(p, gs, a, pg);
    load_alpha<V>(alpha, n, words, w0 + 2 * l + 1, j, a);
    and_gate<V>(p, ps, a, pp);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        g[s][v] ^= pg[s][v];
        p[s][v] = pp[s][v];
      }
    }
  }
}

inline int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Copies a host shift list into the by-value struct; false when it has more
// than kMaxLevels entries or a shift outside [0, 31].
inline bool make_shifts(const int* shifts, int n_shifts, Shifts* sh) {
  if (n_shifts < 0 || n_shifts > kMaxLevels) return false;
  sh->n = n_shifts;
  for (int l = 0; l < kMaxLevels; ++l) sh->d[l] = 0;
  for (int l = 0; l < n_shifts; ++l) {
    if (shifts[l] < 0 || shifts[l] > 31) return false;
    sh->d[l] = shifts[l];
  }
  return true;
}

}  // namespace
