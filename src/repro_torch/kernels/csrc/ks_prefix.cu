// ks_prefix and and_fold: a whole Kogge-Stone prefix, and the equality AND
// tree, each in one launch, on ring-32 and ring-64 words.
//
// Replaces the Pallas TPU kernels src/repro/kernels/ks_prefix/ks_prefix.py
// `ks_prefix` (body `_ks_prefix_kernel`) and `and_fold` (body
// `_and_fold_kernel`). Over the XOR share triple, for every lane:
//
//   ks_prefix: per level l with shift d (1, 2, 4, ... < width):
//              pg = AND(p, g << d) ^ alpha[2l],  pp = AND(p, p << d) ^ alpha[2l+1],
//              g ^= pg,  p = pp;                         returns g
//   and_fold:  per level l with shift d (width/2, ..., 1):
//              v = AND(v, v >> d) ^ alpha[l]             (logical >>)
//
// where AND(x, y)_s = (x_s & y_s) ^ (x_s & y_{s+1}) ^ (x_{s+1} & y_s). The
// shift lists come from the caller (a width such as 18 gives ks shifts 1, 2,
// 4, 8, 16 and fold shifts 9, 4, 2, 1), and shifts act on the full word, as
// in the reference. Each kernel is a template on the word type: uint32_t
// (entries `ks_prefix_launch`, `and_fold_launch`; shifts up to 31, up to 5
// levels at width 32) and uint64_t (the `_u64` entries; shifts up to 63, 6
// levels at width 64).
//
// Bound: bytes. Per lane, with L levels and w-byte words, ks_prefix reads g
// and p (6w B) and 2L alpha words of three shares (6Lw B) and writes g
// (3w B); and_fold moves 3w + 3Lw + 3w. Each level costs about 15 integer
// operations per share word against two alpha words (twice as many 32-bit
// instructions on a 64-bit word: every AND, XOR and shift acts on two
// halves), still below the card's operations-per-byte ratio. The design
// moves each byte once: one thread keeps its lanes' g and p (or v) in
// registers across all levels, streams each level's alpha words in once
// (16-byte loads where the planes allow, else the scalar path, with no
// padding), and writes only the result, where the gate-by-gate path makes
// a round trip through device memory per level. The PRF draw of alpha stays
// outside (as on the TPU); fusing it in is later work.
#include "ks_levels.cuh"

namespace {

template <typename T, int V>
__global__ void ks_prefix_kernel(const T* __restrict__ g_in, const T* __restrict__ p_in,
                                 const T* __restrict__ alpha, T* __restrict__ out, int64_t n,
                                 Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    T g[3][V], p[3][V];
    load3<T, V>(g_in + j, n, g);
    load3<T, V>(p_in + j, n, p);
    ks_levels<T, V>(g, p, alpha, n, 2 * sh.n, 0, j, sh);
    store3<T, V>(out + j, n, g);
  }
}

template <typename T, int V>
__global__ void and_fold_kernel(const T* __restrict__ v_in, const T* __restrict__ alpha,
                                T* __restrict__ out, int64_t n, Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    T v[3][V];
    load3<T, V>(v_in + j, n, v);
    for (int l = 0; l < sh.n; ++l) {
      const int d = sh.d[l];
      T vs[3][V], a[3][V];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
#pragma unroll
        for (int k = 0; k < V; ++k) vs[s][k] = v[s][k] >> d;
      }
      load_alpha<T, V>(alpha, n, sh.n, l, j, a);
      T z[3][V];
      and_gate<T, V>(v, vs, a, z);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[s][k] = z[s][k];
      }
    }
    store3<T, V>(out + j, n, v);
  }
}

template <typename T>
int ks_prefix_run(const void* g, const void* p, const void* alpha, void* out, long long n,
                  const int* shifts, int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, 8 * sizeof(T), &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* gi = static_cast<const T*>(g);
  auto* pi = static_cast<const T*>(p);
  auto* ai = static_cast<const T*>(alpha);
  auto* o = static_cast<T*>(out);
  constexpr int V = kVec<T>;
  if (vec_ok<T>(n, {g, p, alpha, out}))
    ks_prefix_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(gi, pi, ai, o, n, sh);
  else
    ks_prefix_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(gi, pi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int and_fold_run(const void* v, const void* alpha, void* out, long long n, const int* shifts,
                 int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, 8 * sizeof(T), &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* vi = static_cast<const T*>(v);
  auto* ai = static_cast<const T*>(alpha);
  auto* o = static_cast<T*>(out);
  constexpr int V = kVec<T>;
  if (vec_ok<T>(n, {v, alpha, out}))
    and_fold_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(vi, ai, o, n, sh);
  else
    and_fold_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(vi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, p, out: (3, n) planes; alpha: (3, 2 * n_shifts, n); all contiguous
// int32 storage. shifts: n_shifts host ints in [0, 31], n_shifts <= 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ks_prefix_launch(const void* g, const void* p, const void* alpha, void* out,
                                long long n, const int* shifts, int n_shifts, void* stream) {
  return ks_prefix_run<uint32_t>(g, p, alpha, out, n, shifts, n_shifts, stream);
}

// As ks_prefix_launch on int64 storage (ring-64); shifts in [0, 63].
extern "C" int ks_prefix_launch_u64(const void* g, const void* p, const void* alpha, void* out,
                                    long long n, const int* shifts, int n_shifts, void* stream) {
  return ks_prefix_run<uint64_t>(g, p, alpha, out, n, shifts, n_shifts, stream);
}

// v, out: (3, n) planes; alpha: (3, n_shifts, n); as ks_prefix_launch.
extern "C" int and_fold_launch(const void* v, const void* alpha, void* out, long long n,
                               const int* shifts, int n_shifts, void* stream) {
  return and_fold_run<uint32_t>(v, alpha, out, n, shifts, n_shifts, stream);
}

// As and_fold_launch on int64 storage (ring-64); shifts in [0, 63].
extern "C" int and_fold_launch_u64(const void* v, const void* alpha, void* out, long long n,
                                   const int* shifts, int n_shifts, void* stream) {
  return and_fold_run<uint64_t>(v, alpha, out, n, shifts, n_shifts, stream);
}
