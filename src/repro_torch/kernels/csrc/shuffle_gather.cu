// shuffle_gather: the row gather of one secure-shuffle hop, for every column
// of the table at once,
//
//   out_c[p, r, :] = in_c[p, index[r], :]   for every column c and plane p,
//
// over (planes, n, w_c) ring words, with index an int64 permutation of [0, n);
// a row whose index lies outside [0, n) is written as zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/shuffle_gather/
// shuffle_gather.py (`shuffle_gather`), which gathers one (N, C) share plane
// per launch, staging the whole plane in VMEM with the indices in SMEM; its
// wrapper falls back to an XLA gather above 8 MiB of VMEM. Neither limit is
// part of the semantics and neither carries over.
//
// Bound: bytes. Every word is read once and written once and the index read
// once per row: (2 * 4 * planes * sum(w) + 4) bytes per row. What keeps a
// gather from it on this card is that every scattered 4-byte access is a
// transaction of its own: one that misses the 50 MB L2 moves a whole 32-byte
// sector, and even inside the L2 such accesses run at about 45 G a second
// (measured, PERF.md), a quarter of the card's byte rate at 4 bytes each. So
// the hop has two routes, chosen by the wrapper from the bytes it gathers:
//
// * direct (below the size rule's threshold): one launch, one thread per
//   output row of one (column, plane), the pairs one after the other on the
//   grid's y axis, so that the scattered reads of a plane hit the L2. Each
//   pair reads the index again: 8 bytes a row, coalesced.
//
// * two-pass (above that): every scattered access goes to shared memory.
//   The output rows are cut into chunks of `chunk_rows` and the source rows
//   into tiles of `tile_rows` (both at most 32,768, so that one word of
//   every row of a chunk or a tile fits in shared memory), and every output
//   row gets a slot in a staging buffer: chunk k's rows take the slots
//   [k * chunk_rows, (k + 1) * chunk_rows), grouped by the tile of their
//   source; rows whose index lies outside [0, n) form an extra last tile,
//   whose slots are written as zeros. With chunk_rows * tile_rows >= 32 n,
//   a (chunk, tile) run holds some 32 rows on average.
//     plan:    one block per chunk: reads the chunk's indices once (int64),
//              counts its rows per tile and scans the counts in shared
//              memory, places each row in its slot in shared memory, and
//              writes the chunk's slots coalesced, each as one word:
//              (row within the chunk) | (source row within its tile) << 16;
//              with the (chunks x tiles) counts and chunk-local starts.
//     pass 1:  one block per tile: scans the tile's counts over the chunks,
//              loads one word of every row of the tile into shared memory
//              with coalesced reads, then writes each of the tile's slots
//              (one run per chunk) from there.
//     pass 2:  one block per chunk: reads the chunk's slots coalesced,
//              scatters them into the chunk's rows in shared memory, and
//              writes the chunk out coalesced.
//   Each pass moves every column, plane and word of the hop in turn. The
//   order of rows inside one (chunk, tile) run is the order of the plan's
//   shared-memory atomics and may change from run to run; no output depends
//   on it, because every slot carries its own source and destination.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kThreads = 256;
// the two-pass kernels: 1,024 threads, each holding up to 32 rows of a
// chunk or a tile in registers
constexpr int kBlock = 1024;
constexpr int kPerThread = 32;
constexpr int kMaxRows = kBlock * kPerThread;  // rows of a chunk or a tile
constexpr int kMaxChunks = 4096;               // pass 1's run table
constexpr int kMaxTiles = 4097;                // the plan's counts, with the zero tile

// One column of a hop. `in` rows may be strided (a view sliced from a wider
// tensor, at any 4-byte offset); words inside a row are contiguous. `out`
// and `stage` are contiguous (planes, n, w).
struct Col {
  const uint32_t* in;
  uint32_t* out;
  uint32_t* stage;
  int64_t in_plane;  // words between planes of `in`
  int64_t in_row;    // words between rows of `in`
  int64_t w;         // words per row
};

struct Cols {
  Col c[kMaxCols];
  int n;
  int planes;
};

// Grid y: the (column, plane) pairs. The card dispatches blocks x-first, so
// the pairs are gathered one after the other and the scattered reads of one
// plane share the L2, instead of every plane of the hop competing for it.
__global__ void gather_direct_kernel(const __grid_constant__ Cols cols,
                                     const int64_t* __restrict__ index, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Col& col = cols.c[blockIdx.y / cols.planes];
  const int p = blockIdx.y % cols.planes;
  const int64_t s = index[r];
  const bool inside = s >= 0 && s < n;
  const uint32_t* src = col.in + p * col.in_plane + (inside ? s : 0) * col.in_row;
  uint32_t* dst = col.out + (p * n + r) * col.w;
  for (int64_t k = 0; k < col.w; ++k) dst[k] = inside ? src[k] : 0u;
}

// In-place exclusive scan of a[0, len) by the whole block (blockDim.x a
// multiple of 32); `warp_sums` holds 32 words of scratch. Returns the total.
__device__ int block_exclusive_scan(int32_t* a, int len, int32_t* warp_sums) {
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, len), hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[(blockDim.x >> 5) - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// One block per chunk. Dynamic shared memory: slots[chunk_rows],
// count[n_tiles], 32 words of scan scratch.
__global__ void __launch_bounds__(kBlock)
gather_plan_kernel(const int64_t* __restrict__ index, int64_t n, int chunk_rows, int tile_rows,
                   int n_tiles, int32_t* __restrict__ counts, int32_t* __restrict__ starts,
                   uint32_t* __restrict__ packed) {
  extern __shared__ uint32_t shm[];
  uint32_t* slots = shm;
  int32_t* count = reinterpret_cast<int32_t*>(slots + chunk_rows);
  int32_t* scratch = count + n_tiles;
  const int k = blockIdx.x;
  const int64_t r0 = (int64_t)k * chunk_rows;
  const int rows = (int)min((int64_t)chunk_rows, n - r0);
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) count[t] = 0;
  __syncthreads();
  int32_t src[kPerThread];  // the row's source, -1 outside [0, n)
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int q = threadIdx.x + i * kBlock;
    src[i] = -1;
    if (q < rows) {
      const int64_t s = index[r0 + q];
      src[i] = (s >= 0 && s < n) ? (int32_t)s : -1;
    }
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (threadIdx.x + i * kBlock < rows)
      atomicAdd(&count[src[i] >= 0 ? src[i] / tile_rows : n_tiles - 1], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) counts[(int64_t)k * n_tiles + t] = count[t];
  __syncthreads();
  block_exclusive_scan(count, n_tiles, scratch);
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) starts[(int64_t)k * n_tiles + t] = count[t];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int q = threadIdx.x + i * kBlock;
    if (q < rows) {
      const int t = src[i] >= 0 ? src[i] / tile_rows : n_tiles - 1;
      const uint32_t off = src[i] >= 0 ? (uint32_t)(src[i] - t * tile_rows) : 0u;
      slots[atomicAdd(&count[t], 1)] = (uint32_t)q | (off << 16);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int q = threadIdx.x + i * kBlock;
    if (q < rows) packed[r0 + q] = slots[q];
  }
}

// One block per tile (the last: the out-of-range rows). Dynamic shared
// memory: data[tile_rows], off[tile_rows] (16-bit), run_begin[n_chunks],
// run_start[n_chunks], 32 words of scan scratch.
__global__ void __launch_bounds__(kBlock)
gather_pass1_kernel(const __grid_constant__ Cols cols, const uint32_t* __restrict__ packed,
                    const int32_t* __restrict__ counts, const int32_t* __restrict__ starts, int64_t n,
                    int chunk_rows, int n_chunks, int tile_rows, int n_tiles) {
  extern __shared__ uint32_t shm[];
  uint32_t* data = shm;
  uint16_t* off = reinterpret_cast<uint16_t*>(data + tile_rows);
  int32_t* run_begin = reinterpret_cast<int32_t*>(data + tile_rows + (tile_rows + 1) / 2);
  int32_t* run_start = run_begin + n_chunks;
  int32_t* scratch = run_start + n_chunks;

  const int t = blockIdx.x;
  const bool zero_tile = t == n_tiles - 1;
  const int64_t tile_base = (int64_t)t * tile_rows;
  const int rows = zero_tile ? 0 : (int)min((int64_t)tile_rows, n - tile_base);
  for (int k = threadIdx.x; k < n_chunks; k += blockDim.x) {
    const int64_t bin = (int64_t)k * n_tiles + t;
    run_begin[k] = counts[bin];
    run_start[k] = k * chunk_rows + starts[bin];
  }
  __syncthreads();
  // the tile's entries in run order: run k holds [run_begin[k], run_begin[k + 1])
  const int total = block_exclusive_scan(run_begin, n_chunks, scratch);
  // a permutation gives a tile at most tile_rows entries: one batch
  for (int b0 = 0; b0 < total; b0 += tile_rows) {
    const int count = min(tile_rows, total - b0);
    // mark each entry of the batch with its run (in `data`, free until the
    // first plane), then give each of this thread's entries its slot
    for (int k = threadIdx.x; k < n_chunks; k += blockDim.x) {
      const int lo = max(run_begin[k] - b0, 0);
      const int hi = min((k + 1 < n_chunks ? run_begin[k + 1] : total) - b0, count);
      for (int e = lo; e < hi; ++e) data[e] = (uint32_t)k;
    }
    __syncthreads();
    int32_t slot[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kBlock;
      slot[i] = -1;
      if (e < count) {
        const int k = (int)data[e];
        slot[i] = run_start[k] + (b0 + e - run_begin[k]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (slot[i] >= 0) off[threadIdx.x + i * kBlock] = (uint16_t)(packed[slot[i]] >> 16);
    }
    __syncthreads();  // `data` and `off` are read below
    for (int c = 0; c < cols.n; ++c) {
      const Col& col = cols.c[c];
      for (int p = 0; p < cols.planes; ++p) {
        const uint32_t* in = col.in + p * col.in_plane + tile_base * col.in_row;
        uint32_t* stage = col.stage + p * n * col.w;
        for (int64_t w = 0; w < col.w; ++w) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) {
            const int q = threadIdx.x + i * kBlock;
            if (q < rows) data[q] = in[q * col.in_row + w];
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) {
            if (slot[i] >= 0)
              stage[(int64_t)slot[i] * col.w + w] = zero_tile ? 0u : data[off[threadIdx.x + i * kBlock]];
          }
          __syncthreads();
        }
      }
    }
  }
}

// One block per chunk. Dynamic shared memory: rows[chunk_rows].
__global__ void __launch_bounds__(kBlock)
gather_pass2_kernel(const __grid_constant__ Cols cols, const uint32_t* __restrict__ packed, int64_t n,
                    int chunk_rows) {
  extern __shared__ uint32_t buf[];
  const int64_t r0 = (int64_t)blockIdx.x * chunk_rows;
  const int rows = (int)min((int64_t)chunk_rows, n - r0);
  int32_t dst[kPerThread];  // the slot's row within the chunk
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int q = threadIdx.x + i * kBlock;
    dst[i] = q < rows ? (int32_t)(packed[r0 + q] & 0xffffu) : -1;
  }
  for (int c = 0; c < cols.n; ++c) {
    const Col& col = cols.c[c];
    for (int p = 0; p < cols.planes; ++p) {
      const uint32_t* stage = col.stage + (p * n + r0) * col.w;
      uint32_t* out = col.out + (p * n + r0) * col.w;
      for (int64_t w = 0; w < col.w; ++w) {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          if (dst[i] >= 0) buf[dst[i]] = stage[(int64_t)(threadIdx.x + i * kBlock) * col.w + w];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int q = threadIdx.x + i * kBlock;
          if (q < rows) out[q * col.w + w] = buf[q];
        }
        __syncthreads();
      }
    }
  }
}

// cols: `ncols` descriptors laid out as Col (three pointers, three int64s).
bool load_cols(Cols& out, const void* cols, int ncols, int planes) {
  if (ncols <= 0 || ncols > kMaxCols || planes <= 0) return false;
  const Col* src = static_cast<const Col*>(cols);
  for (int i = 0; i < ncols; ++i) out.c[i] = src[i];
  out.n = ncols;
  out.planes = planes;
  return true;
}

unsigned blocks_for(int64_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB a launch
// needs it); returns the error of the attribute call.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  static size_t granted = 48 * 1024;  // one kernel per instantiation
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

bool two_pass_shape(long long n, int chunk_rows, int tile_rows, int n_chunks, int n_tiles) {
  return n > 0 && chunk_rows > 0 && chunk_rows <= kMaxRows && tile_rows > 0 && tile_rows <= kMaxRows &&
         n_chunks == (n + chunk_rows - 1) / chunk_rows && n_chunks <= kMaxChunks &&
         n_tiles == (n + tile_rows - 1) / tile_rows + 1 && n_tiles <= kMaxTiles;
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.

extern "C" int gather_direct_launch(const void* cols, int ncols, int planes, const void* index,
                                    long long n, void* stream) {
  Cols c;
  if (!load_cols(c, cols, ncols, planes) || n <= 0 || ncols * planes > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n, kThreads), (unsigned)(ncols * planes));
  gather_direct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const int64_t*>(index), n);
  return (int)cudaGetLastError();
}

// counts, starts: (n_chunks, n_tiles) int32; packed: (n,) words.
extern "C" int gather_plan_launch(const void* index, long long n, int chunk_rows, int tile_rows,
                                  int n_chunks, int n_tiles, void* counts, void* starts, void* packed,
                                  void* stream) {
  if (!two_pass_shape(n, chunk_rows, tile_rows, n_chunks, n_tiles)) return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(uint32_t) * ((size_t)chunk_rows + n_tiles + 32);
  const cudaError_t err = allow_shared(gather_plan_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  gather_plan_kernel<<<(unsigned)n_chunks, kBlock, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(index), n, chunk_rows, tile_rows, n_tiles,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(starts), static_cast<uint32_t*>(packed));
  return (int)cudaGetLastError();
}

// counts, starts: the plan's (n_chunks, n_tiles) tables.
extern "C" int gather_pass1_launch(const void* cols, int ncols, int planes, const void* packed,
                                   const void* counts, const void* starts, long long n, int chunk_rows,
                                   int n_chunks, int tile_rows, int n_tiles, void* stream) {
  Cols c;
  if (!load_cols(c, cols, ncols, planes) || !two_pass_shape(n, chunk_rows, tile_rows, n_chunks, n_tiles))
    return (int)cudaErrorInvalidValue;
  const size_t shared =
      sizeof(uint32_t) * ((size_t)tile_rows + (tile_rows + 1) / 2 + 2 * (size_t)n_chunks + 32);
  const cudaError_t err = allow_shared(gather_pass1_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  gather_pass1_kernel<<<(unsigned)n_tiles, kBlock, shared, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(starts), n, chunk_rows, n_chunks, tile_rows, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int gather_pass2_launch(const void* cols, int ncols, int planes, const void* packed,
                                   long long n, int chunk_rows, void* stream) {
  Cols c;
  if (!load_cols(c, cols, ncols, planes) || n <= 0 || chunk_rows <= 0 || chunk_rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(uint32_t) * (size_t)chunk_rows;
  const cudaError_t err = allow_shared(gather_pass2_kernel, shared);
  if (err != cudaSuccess) return (int)err;
  gather_pass2_kernel<<<blocks_for(n, chunk_rows), kBlock, shared, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const uint32_t*>(packed), n, chunk_rows);
  return (int)cudaGetLastError();
}

// Grant each two-pass kernel, once, the most dynamic shared memory any of its
// launches can ask for (at most 229,504 bytes, under the H100's 227 KB), so
// that no later launch sets a function attribute: a launch inside a CUDA
// graph capture then only enqueues its kernel. Returns the first error.
extern "C" int gather_prepare() {
  cudaError_t err = allow_shared(gather_plan_kernel, sizeof(uint32_t) * ((size_t)kMaxRows + kMaxTiles + 32));
  if (err == cudaSuccess)
    err = allow_shared(gather_pass1_kernel,
                       sizeof(uint32_t) * ((size_t)kMaxRows + (kMaxRows + 1) / 2 + 2 * (size_t)kMaxChunks + 32));
  if (err == cudaSuccess) err = allow_shared(gather_pass2_kernel, sizeof(uint32_t) * (size_t)kMaxRows);
  return (int)err;
}
