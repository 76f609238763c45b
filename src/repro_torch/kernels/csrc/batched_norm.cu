// Batched per-tensor sum of squares over CHUNK-packed buffers (paper
// §III-B.2: all LARS norms in one pass instead of one small reduction per
// layer).
//
// Replaces the Pallas kernel repro/kernels/batched_norm.py::batched_sumsq.
// That kernel walks the chunks on a *sequential* TPU grid and carries each
// tensor's sum in its output row, zeroing the row when the segment id
// changes. Hopper's blocks run in parallel and in no order, so the sum is
// taken in two passes, with no atomics, in a fixed order (deterministic):
//
//   pass 1  one block per CHUNK (1024 elements, 256 threads x 4): each
//           thread loads 4 values in one vector load (16 B of f32 or 8 B of
//           bf16), squares and sums them in f32; warp shuffles and one
//           shared-memory step reduce the block in a fixed order into a
//           per-chunk partial.
//   pass 2  one block per (row, segment): thread 0 finds the segment's
//           chunk range [lo, hi) by binary search in the non-decreasing
//           seg_ids; the block sums that row's partials in a fixed order.
//           An empty segment gets 0; ids outside [0, n_tensors) are never
//           summed.
//
// The multi-buffer form takes R rows of B buffers each (the ZeRO path's p
// and g shards of every bucket: R = 2) and one segment map over a row's
// concatenated chunks, and returns (R, n_tensors) in one C call. The
// eager caller would otherwise pay a host round trip (checks, two
// launches, an add) for every buffer, 40-60 us each against ~2 us of
// bandwidth. Pass 1 finds a block's buffer by binary search in a table of
// buffer bases and first chunks, passed by value as a kernel parameter
// (__grid_constant__: read in place, nothing uploaded, no sync). The table
// holds kMaxBufs = 256 buffers (3,080 bytes, under the 4,096-byte parameter
// limit of every CUDA release; the larger limit needs 12.1 or later); a
// longer list takes one pass-1 launch per 256 buffers inside the same call. The single-buffer
// entries are the R = 1, B = 1 case of the same kernels.
//
// Bound: memory. The work is 2 flops per element against 4 (f32) or 2
// (bf16) bytes read, far below the card's ~20 flops/byte f32 balance. On
// the training path (ResNet-50, 25,021 chunks, f32) the input is 102.5 MB,
// so 30.6 us at the H100 SXM's 3.35 TB/s (15.3 us for bf16 input); the
// ZeRO step's p and g shards together are 205 MB, 61 us. The design stays
// simple: one small block per chunk, no TMA, no persistent blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = 256;   // kChunk / 4 values per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

__device__ __forceinline__ float sq4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return fa.x * fa.x + fa.y * fa.y + fb.x * fb.x + fb.y * fb.y;
}

// Sum of `v` over the block, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Buffer j's base and its first chunk, counted from the launch's first
// chunk; start[n] is the launch's chunk count.
template <int kCap>
struct Table {
  const void* ptr[kCap];
  int start[kCap + 1];
  int n;
};

template <typename T, int kCap>
__global__ void __launch_bounds__(kThreads)
chunk_sumsq(const __grid_constant__ Table<kCap> tab,
            float* __restrict__ partial) {
  const int g = blockIdx.x;
  int lo = 0, hi = tab.n - 1;     // the last buffer that starts at or before g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.start[mid] <= g) lo = mid; else hi = mid - 1;
  }
  const T* x = static_cast<const T*>(tab.ptr[lo]) +
               static_cast<size_t>(g - tab.start[lo]) * kChunk;
  const float s = block_sum(sq4(x + threadIdx.x * 4));
  if (threadIdx.x == 0) partial[g] = s;
}

// First index i in [0, n) with seg[i] >= t (n if none).
__device__ __forceinline__ int lower_bound(const int32_t* seg, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (seg[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block r * n_tensors + t sums segment t of row r's n_chunks partials.
__global__ void __launch_bounds__(kThreads)
segment_sum(const float* __restrict__ partial, const int32_t* __restrict__ seg,
            int n_chunks, int n_tensors, float* __restrict__ out) {
  __shared__ int range[2];
  const int r = blockIdx.x / n_tensors;
  const int t = blockIdx.x - r * n_tensors;
  if (threadIdx.x == 0) {
    range[0] = lower_bound(seg, n_chunks, t);
    range[1] = lower_bound(seg, n_chunks, t + 1);
  }
  __syncthreads();
  const float* row = partial + static_cast<size_t>(r) * n_chunks;
  float s = 0.f;
  for (int i = range[0] + threadIdx.x; i < range[1]; i += kThreads)
    s += row[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// n_bufs buffers in row-major (row, buffer) order; each row's counts sum
// to n_chunks, the length of seg.
template <typename T, int kCap>
int launch(const void* const* ptrs, const int* counts, int n_bufs,
           const void* seg, int n_chunks, int rows, void* partial, void* out,
           int n_tensors, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  long long done = 0;
  for (int i0 = 0; i0 < n_bufs; i0 += kCap) {
    Table<kCap> tab;
    tab.n = n_bufs - i0 < kCap ? n_bufs - i0 : kCap;
    int c = 0;
    for (int j = 0; j < tab.n; ++j) {
      tab.ptr[j] = ptrs[i0 + j];
      tab.start[j] = c;
      c += counts[i0 + j];
    }
    tab.start[tab.n] = c;
    if (c > 0) chunk_sumsq<T, kCap><<<c, kThreads, 0, s>>>(tab, part + done);
    done += c;
  }
  if (done != static_cast<long long>(rows) * n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && n_tensors > 0)
    segment_sum<<<rows * n_tensors, kThreads, 0, s>>>(
        part, static_cast<const int32_t*>(seg), n_chunks, n_tensors,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxBufs = 256;

}  // namespace

// x: (n_chunks * 1024,) f32 or bf16, 16-byte (f32) / 8-byte (bf16) aligned;
// seg: (n_chunks,) int32, non-decreasing; partial: (n_chunks,) f32 scratch;
// out: (n_tensors,) f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int batched_sumsq_f32(const void* x, const void* seg, void* partial,
                                 void* out, int n_chunks, int n_tensors,
                                 void* stream) {
  return launch<float, 1>(&x, &n_chunks, 1, seg, n_chunks, 1, partial, out,
                          n_tensors, stream);
}

extern "C" int batched_sumsq_bf16(const void* x, const void* seg,
                                  void* partial, void* out, int n_chunks,
                                  int n_tensors, void* stream) {
  return launch<__nv_bfloat16, 1>(&x, &n_chunks, 1, seg, n_chunks, 1,
                                  partial, out, n_tensors, stream);
}

// ptrs, counts: n_bufs = rows x B buffers in row-major order, buffer i of
// counts[i] * 1024 elements (aligned as above), buffer b the same length in
// every row; seg: (n_chunks,) int32, non-decreasing over a row's
// concatenated chunks, n_chunks = the sum of a row's counts; partial:
// (rows * n_chunks,) f32 scratch; out: (rows, n_tensors) f32. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue (nothing
// summed) when the counts do not add up to rows * n_chunks.
extern "C" int batched_sumsq_multi_f32(const void* const* ptrs,
                                       const int* counts, int n_bufs,
                                       const void* seg, int n_chunks, int rows,
                                       void* partial, void* out, int n_tensors,
                                       void* stream) {
  return launch<float, kMaxBufs>(ptrs, counts, n_bufs, seg, n_chunks, rows,
                             partial, out, n_tensors, stream);
}

extern "C" int batched_sumsq_multi_bf16(const void* const* ptrs,
                                        const int* counts, int n_bufs,
                                        const void* seg, int n_chunks,
                                        int rows, void* partial, void* out,
                                        int n_tensors, void* stream) {
  return launch<__nv_bfloat16, kMaxBufs>(ptrs, counts, n_bufs, seg, n_chunks,
                                     rows, partial, out, n_tensors, stream);
}
