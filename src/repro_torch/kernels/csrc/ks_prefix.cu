// ks_prefix and and_fold: a whole Kogge-Stone prefix, and the equality AND
// tree, each in one launch.
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
// 4, 8, 16 and fold shifts 9, 4, 2, 1), and shifts act on the full 32-bit
// word, as in the reference.
//
// Bound: bytes. Per lane, with L levels, ks_prefix reads g and p (24 B) and
// 2L alpha words of three shares (24L B) and writes g (12 B): 24 + 24L + 12
// bytes; and_fold moves 12 + 12L + 12. Each level costs about 15 integer
// operations per share word against 8 bytes of alpha, far below the card's
// operations-per-byte ratio. The design moves each byte once: one thread
// keeps its lanes' g and p (or v) in registers across all levels, streams
// each level's alpha words in once (16-byte loads where the planes allow,
// else the scalar path, with no padding), and writes only the result, where
// the gate-by-gate path makes a round trip through device memory per level.
// The PRF draw of alpha stays outside (as on the TPU); fusing it in is later
// work.
#include "ks_levels.cuh"

namespace {

template <int V>
__global__ void ks_prefix_kernel(const uint32_t* __restrict__ g_in,
                                 const uint32_t* __restrict__ p_in,
                                 const uint32_t* __restrict__ alpha,
                                 uint32_t* __restrict__ out, int64_t n, Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    uint32_t g[3][V], p[3][V];
    load3<V>(g_in + j, n, g);
    load3<V>(p_in + j, n, p);
    ks_levels<V>(g, p, alpha, n, 2 * sh.n, 0, j, sh);
    store3<V>(out + j, n, g);
  }
}

template <int V>
__global__ void and_fold_kernel(const uint32_t* __restrict__ v_in,
                                const uint32_t* __restrict__ alpha,
                                uint32_t* __restrict__ out, int64_t n, Shifts sh) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = n / V;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const int64_t j = i * V;
    uint32_t v[3][V];
    load3<V>(v_in + j, n, v);
    for (int l = 0; l < sh.n; ++l) {
      const int d = sh.d[l];
      uint32_t vs[3][V], a[3][V];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
#pragma unroll
        for (int k = 0; k < V; ++k) vs[s][k] = v[s][k] >> d;
      }
      load_alpha<V>(alpha, n, sh.n, l, j, a);
      uint32_t z[3][V];
      and_gate<V>(v, vs, a, z);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[s][k] = z[s][k];
      }
    }
    store3<V>(out + j, n, v);
  }
}

}  // namespace

// g, p, out: (3, n) planes; alpha: (3, 2 * n_shifts, n); all contiguous
// int32 storage. shifts: n_shifts host ints in [0, 31], n_shifts <= 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ks_prefix_launch(const void* g, const void* p, const void* alpha, void* out,
                                long long n, const int* shifts, int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* gi = static_cast<const uint32_t*>(g);
  auto* pi = static_cast<const uint32_t*>(p);
  auto* ai = static_cast<const uint32_t*>(alpha);
  auto* o = static_cast<uint32_t*>(out);
  if (n % 4 == 0 && aligned16(g) && aligned16(p) && aligned16(alpha) && aligned16(out))
    ks_prefix_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(gi, pi, ai, o, n, sh);
  else
    ks_prefix_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(gi, pi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}

// v, out: (3, n) planes; alpha: (3, n_shifts, n); as ks_prefix_launch.
extern "C" int and_fold_launch(const void* v, const void* alpha, void* out, long long n,
                               const int* shifts, int n_shifts, void* stream) {
  Shifts sh;
  if (!make_shifts(shifts, n_shifts, &sh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* vi = static_cast<const uint32_t*>(v);
  auto* ai = static_cast<const uint32_t*>(alpha);
  auto* o = static_cast<uint32_t*>(out);
  if (n % 4 == 0 && aligned16(v) && aligned16(alpha) && aligned16(out))
    and_fold_kernel<4><<<blocks_for(n / 4), kThreads, 0, s>>>(vi, ai, o, n, sh);
  else
    and_fold_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(vi, ai, o, n, sh);
  return static_cast<int>(cudaGetLastError());
}
