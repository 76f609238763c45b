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
// each chunk's trust row in through a scalar-prefetched segment map. Here
// one 256-thread block takes one 1,024-element chunk: thread 0 gathers the
// chunk's scale lr * trust[seg[chunk]] once into shared memory, and each
// thread moves one 16-byte vector of every operand. Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn: no fused multiply-add), so
// the result is the plain PyTorch version's, operation for operation, and
// the same from call to call.
//
// lr is read from a device f32 scalar: it changes every step, and passing
// it by value would cost a host sync to read it. p_out / m_out may alias
// p / m (in-place update): each thread reads its elements before it writes
// them, and no thread touches another's, so the pointers are not
// __restrict__. A segment id outside [0, n_tensors) writes NaN rather than
// reading outside `trust`.
//
// Bound: memory. 6 flops per element against 20 bytes moved (p, g, m
// read; p, m written), far below the card's f32 balance. On the training
// path (ResNet-50's 16 buckets, 25,021 chunks) that is 512 MB a step,
// 153 us at the H100 SXM's 3.35 TB/s. This first version keeps the design
// simple: one small block per chunk, no persistent blocks, no TMA.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = kChunk / 4;   // one float4 a thread

__global__ void __launch_bounds__(kThreads)
lars_update_f32(const float* p, const float* g, const float* m, float* p_out,
                float* m_out, const float* __restrict__ trust,
                const int32_t* __restrict__ seg,
                const float* __restrict__ lr, float mu, float wd,
                int n_tensors) {
  __shared__ float scale;
  if (threadIdx.x == 0) {
    const int s = seg[blockIdx.x];
    scale = (s >= 0 && s < n_tensors) ? __fmul_rn(lr[0], trust[s]) : NAN;
  }
  __syncthreads();
  const float lt = scale;
  const size_t i = static_cast<size_t>(blockIdx.x) * kChunk + threadIdx.x * 4;
  const float4 pv = *reinterpret_cast<const float4*>(p + i);
  const float4 gv = *reinterpret_cast<const float4*>(g + i);
  const float4 mv = *reinterpret_cast<const float4*>(m + i);
  float4 po, mo;
#define LARS_LANE(c)                                              \
  {                                                               \
    const float g2 = __fadd_rn(gv.c, __fmul_rn(wd, pv.c));        \
    mo.c = __fadd_rn(__fmul_rn(mu, mv.c), __fmul_rn(lt, g2));     \
    po.c = __fsub_rn(pv.c, mo.c);                                 \
  }
  LARS_LANE(x) LARS_LANE(y) LARS_LANE(z) LARS_LANE(w)
#undef LARS_LANE
  *reinterpret_cast<float4*>(p_out + i) = po;
  *reinterpret_cast<float4*>(m_out + i) = mo;
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
