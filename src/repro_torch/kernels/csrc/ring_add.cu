// The ring reduce-scatter's fold: out = recv + chunks[k], one streaming
// pass. At every step of a ring reduce-scatter a rank adds the partial sum
// it received from its neighbour to its own chunk k of the bucket.
//
// Replaces the Pallas kernel repro/comm/ring_kernel.py::ring_add_step.
// That kernel walks (8, 128) tiles of the chunk row on a TPU grid and
// scalar-prefetches k so that it drives the input's index map, which keeps
// the jnp gather of chunks[k] out of HBM. Here k is a host integer (the
// ring computes it from the rank's index), so the launcher points straight
// at row k and nothing is gathered or uploaded. A grid-stride loop over
// 16-byte vectors (4 f32 or 8 bf16 a thread) reads recv and the row once
// and writes out once. Each element is added in f32 and rounded once to
// the operands' dtype (__fadd_rn: no contraction, denormals kept), which
// is how PyTorch computes recv + chunks[k], so the result is its plain
// version's bit for bit.
//
// Alignment: the ring's buffers are fresh allocations and its rows are
// CHUNK-aligned, so all three pointers sit on 16-byte boundaries. Any view
// is taken all the same: where the three share their offset from a 16-byte
// boundary, a scalar head runs up to it, then the vector body and a scalar
// tail; where they do not, every element is a scalar. out may equal recv
// (the fold in place): each element is read before it is written, by the
// same thread, so no pointer is __restrict__.
//
// Host path: the ring folds n - 1 times a bucket against one chunks
// buffer, and eagerly every fold pays its host cost. So the ring binds
// once a bucket (comm/ring_kernel.kernel_step_fn) to a typed in-place
// entry, ring_add_f32 or ring_add_bf16, that takes row k's own pointer:
// a fold is one 4-argument C call and one launch.
//
// Bound: memory. One add per element against 3 x 2 bytes (bf16, the wire
// dtype) or 3 x 4 bytes moved. The largest row on the ResNet-50 path (a
// 2,097,152-element bucket on four ranks: 524,288 elements) moves 3.1 MB
// in bf16, 0.94 us at the H100 SXM's 3.35 TB/s: less than a launch costs,
// so the fold is launch-bound, not bandwidth-bound. This first version
// keeps the design simple: no persistent blocks, no fusion with the
// neighbour exchange.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void add_one(const T* a, const T* b, T* o) {
  from_f32(o, __fadd_rn(to_f32(*a), to_f32(*b)));
}

// 16 bytes of each operand: 4 f32 or 8 bf16 lanes.
__device__ __forceinline__ void add_vec(const float* a, const float* b,
                                        float* o) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  *reinterpret_cast<float4*>(o) =
      make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                  __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

__device__ __forceinline__ void add_vec(const __nv_bfloat16* a,
                                        const __nv_bfloat16* b,
                                        __nv_bfloat16* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  uint4 z;
  const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
  __nv_bfloat162* zh = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xh[i]);
    const float2 v = __bfloat1622float2(yh[i]);
    zh[i] = __floats2bfloat162_rn(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
  }
  *reinterpret_cast<uint4*>(o) = z;
}

// head: scalars before the first 16-byte boundary (-1: the three pointers
// do not share one, so every element is a scalar).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_add(const T* recv, const T* row, T* out, long long c, long long head) {
  constexpr int N = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (head < 0) {
    for (long long i = tid; i < c; i += stride)
      add_one(recv + i, row + i, out + i);
    return;
  }
  const long long n_vec = (c - head) / N;
  for (long long i = tid; i < head; i += stride)
    add_one(recv + i, row + i, out + i);
  for (long long v = tid; v < n_vec; v += stride) {
    const long long i = head + v * N;
    add_vec(recv + i, row + i, out + i);
  }
  for (long long i = head + n_vec * N + tid; i < c; i += stride)
    add_one(recv + i, row + i, out + i);
}

// The fold of one row: out = recv + row, c elements.
template <typename T>
int launch(const void* recv, const void* row, void* out, long long c,
           void* stream) {
  if (c <= 0) return 0;
  constexpr int N = 16 / sizeof(T);
  const T* r = static_cast<const T*>(recv);
  const T* w = static_cast<const T*>(row);
  T* o = static_cast<T*>(out);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(r) % 16;
  long long head = -1;
  if (reinterpret_cast<uintptr_t>(w) % 16 == mis &&
      reinterpret_cast<uintptr_t>(o) % 16 == mis) {
    head = mis ? static_cast<long long>((16 - mis) / sizeof(T)) : 0;
    if (head > c) head = c;
  }
  const long long work = head < 0 ? c : (c - head) / N + head + N;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ring_add<T><<<static_cast<int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(r, w, o, c, head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// recv, out: (c,); chunks: (n, c) row-major, all in one dtype: f32
// (dtype 0) or bf16 (dtype 1), element-aligned. k in [0, n) is checked by
// the caller. out may equal recv. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ring_add_step(const void* recv, const void* chunks, int k,
                             void* out, long long c, int dtype,
                             void* stream) {
  if (dtype == 0)
    return launch<float>(recv, static_cast<const float*>(chunks) + k * c, out,
                         c, stream);
  return launch<__nv_bfloat16>(
      recv, static_cast<const __nv_bfloat16*>(chunks) + k * c, out, c,
      stream);
}

// The ring's own entries, one a dtype, bound once a bucket by
// comm/ring_kernel.kernel_step_fn: the caller passes row k's own pointer,
// and the fold is in place (recv += row). c <= 0 launches nothing.
extern "C" int ring_add_f32(void* recv, const void* row, long long c,
                            void* stream) {
  return launch<float>(recv, row, recv, c, stream);
}

extern "C" int ring_add_bf16(void* recv, const void* row, long long c,
                             void* stream) {
  return launch<__nv_bfloat16>(recv, row, recv, c, stream);
}
