// Fused LARS update over CHUNK-packed fp32 shards (the ZeRO-1 sharded
// update): weight decay, momentum and the trust-scaled step in one pass,
// one read of p, g, m and one write of p, m, instead of several
// elementwise passes per tensor.
//
//   g' = g + wd * p
//   m' = mu * m + (lr * trust[seg[chunk]]) * g'
//   p' = p - m'
//
// Replaces the Pallas kernel repro/kernels/lars_update.py::
// lars_packed_update. That kernel walks the chunks on a TPU grid and brings
// each chunk's trust row in through a scalar-prefetched segment map. Here a
// block loads its chunks' scale lr * trust[seg[chunk]] itself, once a chunk,
// into shared memory, and each thread moves one 16-byte vector of every
// operand a chunk, neighbouring threads on neighbouring addresses. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn: no fused
// multiply-add), so the result is the plain PyTorch version's, operation
// for operation, the same from call to call, and the same from either
// entry below.
//
// lr is read from a device f32 scalar: it changes every step, and passing
// it by value would cost a host sync to read it. A segment id outside
// [0, n_tensors) writes NaN rather than reading outside `trust`.
//
// Two entries:
//
//   lars_packed_update_f32        one buffer: one block per chunk, p_out /
//                                 m_out may alias p / m (each thread reads
//                                 its elements before it writes them, and
//                                 no thread touches another's, so the
//                                 pointers are not __restrict__).
//   lars_packed_update_multi_f32  the sharded step's call site: every
//                                 bucket's p, g, m shards in place, with the
//                                 rank's segment map over all the shards'
//                                 chunks concatenated, in one C call.
//
// Bound: memory. 6 flops per element against 20 bytes moved (p, g, m
// read; p, m written), far below the card's f32 balance. On the training
// path (ResNet-50's 16 buckets, 25,021 chunks) that is 512 MB a step,
// 153 us at the H100 SXM's 3.35 TB/s; a four-card rank's quarter, 128 MB,
// 38 us.
//
// What the multi entry does about it. Launched once a bucket, the step
// paid a host round trip and a launch for each of the 16 shards, and each
// launch's grid (1,560 chunks on one card, 390 on a four-card rank) is a
// wave and a half at most of the 1,056 blocks the card holds, so every
// launch paid its own tail. Here:
//   - one launch covers every shard. A block finds its bucket by binary
//     search in a table of the buckets' p, g, m bases and first chunks,
//     passed by value as a __grid_constant__ kernel parameter (read in
//     place: nothing uploaded, nothing waits). The table holds kMaxBufs =
//     128 buckets, 3,592 bytes: with the other arguments it stays under
//     the 4,096-byte parameter limit of every CUDA release (the larger
//     limit needs 12.1 or later). A longer list (the 0.25 MB plan's 211
//     buckets) takes one launch per 128 buckets inside the same C call;
//     the wrapper's launch counter counts C calls.
//   - a block takes kPerBlock = 2 chunks: each thread starts its six
//     16-byte loads (p, g, m of both chunks) before the one barrier, so
//     twice the bytes are in flight a thread and half as many blocks are
//     scheduled.
//   - g, trust, seg and lr go through the read-only path (__ldg); p and m
//     are read and then written in place, so they take plain loads.
// On an H100 80GB HBM3 (chip_smoke.py) the one launch takes the time of
// the single-buffer entry over the same shards concatenated, ~88% of the
// bound, which is about what the card streams: two chunks a block bought
// nothing measurable over one. What it saves is the launches, their tails
// and the host's cost a bucket.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = kChunk / 4;   // one float4 of a chunk a thread
constexpr int kPerBlock = 2;           // chunks a block (multi entry)
constexpr int kMaxBufs = 128;          // buckets a launch (multi entry)

__device__ __forceinline__ float scale_of(const float* __restrict__ trust,
                                          const int32_t* __restrict__ seg,
                                          const float* __restrict__ lr,
                                          int chunk, int n_tensors) {
  const int s = __ldg(seg + chunk);
  return (s >= 0 && s < n_tensors) ? __fmul_rn(__ldg(lr), __ldg(trust + s))
                                   : NAN;
}

// The update of one 4-element vector, each operation rounded on its own.
__device__ __forceinline__ void lars4(const float4& pv, const float4& gv,
                                      const float4& mv, float lt, float mu,
                                      float wd, float4& po, float4& mo) {
#define LARS_LANE(c)                                              \
  {                                                               \
    const float g2 = __fadd_rn(gv.c, __fmul_rn(wd, pv.c));        \
    mo.c = __fadd_rn(__fmul_rn(mu, mv.c), __fmul_rn(lt, g2));     \
    po.c = __fsub_rn(pv.c, mo.c);                                 \
  }
  LARS_LANE(x) LARS_LANE(y) LARS_LANE(z) LARS_LANE(w)
#undef LARS_LANE
}

__global__ void __launch_bounds__(kThreads)
lars_update_f32(const float* p, const float* g, const float* m, float* p_out,
                float* m_out, const float* __restrict__ trust,
                const int32_t* __restrict__ seg,
                const float* __restrict__ lr, float mu, float wd,
                int n_tensors) {
  __shared__ float scale;
  if (threadIdx.x == 0)
    scale = scale_of(trust, seg, lr, blockIdx.x, n_tensors);
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * kChunk + threadIdx.x * 4;
  const float4 pv = *reinterpret_cast<const float4*>(p + i);
  const float4 gv = *reinterpret_cast<const float4*>(g + i);
  const float4 mv = *reinterpret_cast<const float4*>(m + i);
  float4 po, mo;
  lars4(pv, gv, mv, scale, mu, wd, po, mo);
  *reinterpret_cast<float4*>(p_out + i) = po;
  *reinterpret_cast<float4*>(m_out + i) = mo;
}

// Bucket j's in-place p and m, its g, and its first chunk, counted from
// the launch's first chunk; start[n] is the launch's chunk count.
struct Table {
  float* p[kMaxBufs];
  const float* g[kMaxBufs];
  float* m[kMaxBufs];
  int start[kMaxBufs + 1];
  int n;
};

__global__ void __launch_bounds__(kThreads)
lars_update_multi_f32(const __grid_constant__ Table tab,
                      const float* __restrict__ trust,
                      const int32_t* __restrict__ seg,
                      const float* __restrict__ lr, float mu, float wd,
                      int n_tensors) {
  __shared__ float scale[kPerBlock];
  const int n_chunks = tab.start[tab.n];
  const int c0 = blockIdx.x * kPerBlock;
  float4 pv[kPerBlock], gv[kPerBlock], mv[kPerBlock];
  float* pp[kPerBlock];
  float* mp[kPerBlock];
#pragma unroll
  for (int j = 0; j < kPerBlock; ++j) {
    const int c = c0 + j;
    if (c >= n_chunks) break;
    int lo = 0, hi = tab.n - 1;   // the last bucket that starts at or before c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.start[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const size_t off =
        static_cast<size_t>(c - tab.start[lo]) * kChunk + threadIdx.x * 4;
    pp[j] = tab.p[lo] + off;
    mp[j] = tab.m[lo] + off;
    pv[j] = *reinterpret_cast<const float4*>(pp[j]);
    gv[j] = __ldg(reinterpret_cast<const float4*>(tab.g[lo] + off));
    mv[j] = *reinterpret_cast<const float4*>(mp[j]);
  }
  if (threadIdx.x < kPerBlock && c0 + threadIdx.x < n_chunks)
    scale[threadIdx.x] = scale_of(trust, seg, lr, c0 + threadIdx.x,
                                  n_tensors);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerBlock; ++j) {
    if (c0 + j >= n_chunks) break;
    float4 po, mo;
    lars4(pv[j], gv[j], mv[j], scale[j], mu, wd, po, mo);
    *reinterpret_cast<float4*>(pp[j]) = po;
    *reinterpret_cast<float4*>(mp[j]) = mo;
  }
}

}  // namespace

// p, g, m, p_out, m_out: (n_chunks * 1024,) f32, 16-byte aligned; p_out /
// m_out may equal p / m. trust: (n_tensors,) f32; seg: (n_chunks,) int32;
// lr: one f32 on the device. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int lars_packed_update_f32(const void* p, const void* g,
                                      const void* m, void* p_out, void* m_out,
                                      const void* trust, const void* seg,
                                      const void* lr, float mu, float wd,
                                      int n_chunks, int n_tensors,
                                      void* stream) {
  if (n_chunks > 0)
    lars_update_f32<<<n_chunks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(g),
        static_cast<const float*>(m), static_cast<float*>(p_out),
        static_cast<float*>(m_out), static_cast<const float*>(trust),
        static_cast<const int32_t*>(seg), static_cast<const float*>(lr), mu,
        wd, n_tensors);
  return static_cast<int>(cudaGetLastError());
}

// bufs: 3 * n_bufs pointers, bucket i's p at bufs[i], its g at
// bufs[n_bufs + i] and its m at bufs[2 * n_bufs + i], each of counts[i] *
// 1024 f32 elements, 16-byte aligned; p and m are updated in place. seg:
// (n_chunks,) int32 over the buckets' chunks concatenated, n_chunks = the
// sum of counts; trust: (n_tensors,) f32; lr: one f32 on the device.
// Launches on `stream`, one launch per kMaxBufs buckets; returns
// cudaGetLastError(), or cudaErrorInvalidValue (nothing launched) when the
// counts do not add up to n_chunks.
extern "C" int lars_packed_update_multi_f32(
    void* const* bufs, const int* counts, int n_bufs,
    const void* trust, const void* seg, const void* lr, float mu, float wd,
    int n_chunks, int n_tensors, void* stream) {
  long long total = 0;
  for (int i = 0; i < n_bufs; ++i) {
    if (counts[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    total += counts[i];
  }
  if (total != n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* seg_i = static_cast<const int32_t*>(seg);
  int done = 0;
  for (int i0 = 0; i0 < n_bufs; i0 += kMaxBufs) {
    Table tab;
    tab.n = n_bufs - i0 < kMaxBufs ? n_bufs - i0 : kMaxBufs;
    int c = 0;
    for (int j = 0; j < tab.n; ++j) {
      const int i = i0 + j;
      tab.p[j] = static_cast<float*>(bufs[i]);
      tab.g[j] = static_cast<const float*>(bufs[n_bufs + i]);
      tab.m[j] = static_cast<float*>(bufs[2 * n_bufs + i]);
      tab.start[j] = c;
      c += counts[i];
    }
    tab.start[tab.n] = c;
    if (c > 0)
      lars_update_multi_f32<<<(c + kPerBlock - 1) / kPerBlock, kThreads, 0,
                              s>>>(tab, static_cast<const float*>(trust),
                                   seg_i + done,
                                   static_cast<const float*>(lr), mu, wd,
                                   n_tensors);
    done += c;
  }
  return static_cast<int>(cudaGetLastError());
}
