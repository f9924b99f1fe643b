// shuffle_gather: the row gather of one secure-shuffle hop,
//
//   out[p, r, c] = in[p, perm[r], c]   for every share plane p,
//
// over (planes, n, cols) ring words, with perm an int64 permutation of [0, n);
// a row whose index lies outside [0, n) is written as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/shuffle_gather/
// shuffle_gather.py (`shuffle_gather`), which is called once per share plane
// and stages the whole plane in VMEM with the indices in SMEM; its wrapper
// falls back to an XLA gather above 8 MiB of VMEM. Neither limit is part of
// the semantics and neither carries over: here one launch covers all share
// planes and any n. One thread owns one output word: it loads its row's
// index (a coalesced read) and copies the word.
//
// Bound: bytes. Each output word is written once and each input word read
// once (a permutation touches every row exactly once), plus 8 bytes of index
// per row: (2 * planes * cols * 4 + 8) bytes per row. Writes are coalesced;
// reads are scattered 4-byte accesses, each of which costs a whole 32-byte
// sector when it misses the 50 MB L2. The grid's y axis is the plane, and the
// card dispatches blocks x-first, so the planes are gathered one after the
// other: the scattered reads of one plane (49 MB at the 12.2 M rows that the
// Resize after the join shuffles) share the L2 instead of three planes
// thrashing it. Sorting the reads, or vector loads for wide rows, is later
// work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void shuffle_gather_kernel(const uint32_t* __restrict__ in,
                                      const int64_t* __restrict__ perm,
                                      uint32_t* __restrict__ out, int64_t n,
                                      int64_t cols) {
  const int64_t plane = n * cols;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  // every call on the query path has one column: that branch is uniform
  // across the grid and skips the 64-bit division
  const int64_t r = cols == 1 ? i : i / cols;
  const int64_t c = i - r * cols;
  const int64_t src = perm[r];
  const int64_t base = (int64_t)blockIdx.y * plane;
  // an index outside [0, n) reads as zero, as in the plain version
  out[base + i] = (src >= 0 && src < n) ? in[base + src * cols + c] : 0u;
}

constexpr int kThreads = 256;

}  // namespace

// in, out: (planes, n, cols) contiguous ring words; perm: (n,) int64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shuffle_gather_launch(const void* in, const void* perm, void* out,
                                     int planes, long long n, long long cols,
                                     void* stream) {
  const int64_t work = (int64_t)n * cols;
  if (work <= 0 || planes <= 0) return 0;
  // grid x: 256 words a block (its 2^31 - 1 limit bounds a plane at about
  // 5.5e11 words); grid y: the planes (at most 65,535)
  const dim3 grid((unsigned)((work + kThreads - 1) / kThreads), (unsigned)planes);
  auto* src = static_cast<const uint32_t*>(in);
  auto* idx = static_cast<const int64_t*>(perm);
  auto* dst = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  shuffle_gather_kernel<<<grid, kThreads, 0, s>>>(src, idx, dst, n, cols);
  return static_cast<int>(cudaGetLastError());
}
