// Shared by rss_gate.cu, ks_prefix.cu and a2b_fused.cu: lane-group loads and
// stores, the AND gate over the share triple, and the Kogge-Stone level loop.
//
// A share triple of n lanes is three planes of ring words at stride n; a
// zero-sharing operand of W words per lane is (3, W, n): word w of share s
// for lane j lies at (s * W + w) * n + j. One thread owns V consecutive
// lanes: V = 16 / sizeof(T) (4 words of ring-32, 2 of ring-64) loads and
// stores each plane row with one 16-byte access (n % V == 0 and 16-byte
// aligned planes), V = 1 is the scalar path for ragged or unaligned planes.
// The share axis's roll by one becomes a fixed permutation of the three
// registers (share s pairs with share s + 1 mod 3). The word type T is
// uint32_t (ring-32) or uint64_t (ring-64): storage is int32 / int64 in
// PyTorch, and the kernels read it unsigned, so `>>` is the ring's logical
// shift and products wrap mod 2^32 or 2^64.
#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;  // shift lists of at most 8 levels
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond 32 blocks per SM

// Lanes of one 16-byte access.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// A level's shift list, passed to the kernel by value.
struct Shifts {
  int n;
  int d[kMaxLevels];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&r)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else if constexpr (V == 2 && sizeof(T) == 8) {
    const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = p[v];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&r)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2 && sizeof(T) == 8) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(r[0], r[1]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = r[v];
  }
}

// The three shares of V lanes starting at p, planes `plane` words apart.
template <typename T, int V>
__device__ __forceinline__ void load3(const T* __restrict__ p, int64_t plane, T (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) load<T, V>(p + s * plane, r[s]);
}

template <typename T, int V>
__device__ __forceinline__ void store3(T* __restrict__ p, int64_t plane, const T (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) store<T, V>(p + s * plane, r[s]);
}

// Word w of the (3, words, n) zero sharing, all three shares, V lanes at j.
template <typename T, int V>
__device__ __forceinline__ void load_alpha(const T* __restrict__ alpha, int64_t n, int words,
                                           int w, int64_t j, T (&r)[3][V]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) load<T, V>(alpha + ((int64_t)s * words + w) * n + j, r[s]);
}

// The 1-round AND gate: z_s = (x_s & y_s) ^ (x_s & y_{s+1}) ^ (x_{s+1} & y_s) ^ a_s.
template <typename T, int V>
__device__ __forceinline__ void and_gate(const T (&x)[3][V], const T (&y)[3][V],
                                         const T (&a)[3][V], T (&z)[3][V]) {
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
template <typename T, int V>
__device__ __forceinline__ void ks_levels(T (&g)[3][V], T (&p)[3][V],
                                          const T* __restrict__ alpha, int64_t n,
                                          int words, int w0, int64_t j, const Shifts& sh) {
  for (int l = 0; l < sh.n; ++l) {
    const int d = sh.d[l];
    T gs[3][V], ps[3][V], a[3][V], pg[3][V], pp[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gs[s][v] = g[s][v] << d;
        ps[s][v] = p[s][v] << d;
      }
    }
    load_alpha<T, V>(alpha, n, words, w0 + 2 * l, j, a);
    and_gate<T, V>(p, gs, a, pg);
    load_alpha<T, V>(alpha, n, words, w0 + 2 * l + 1, j, a);
    and_gate<T, V>(p, ps, a, pp);
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
// than kMaxLevels entries or a shift outside [0, bits - 1].
inline bool make_shifts(const int* shifts, int n_shifts, int bits, Shifts* sh) {
  if (n_shifts < 0 || n_shifts > kMaxLevels) return false;
  sh->n = n_shifts;
  for (int l = 0; l < kMaxLevels; ++l) sh->d[l] = 0;
  for (int l = 0; l < n_shifts; ++l) {
    if (shifts[l] < 0 || shifts[l] >= bits) return false;
    sh->d[l] = shifts[l];
  }
  return true;
}

// Whether a launch over n lanes may take the 16-byte path: every plane row
// starts 16-byte aligned.
template <typename T>
inline bool vec_ok(int64_t n, std::initializer_list<const void*> ptrs) {
  if (n % kVec<T> != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace
