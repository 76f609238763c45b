// Flash attention forward (causal / sliding-window GQA) with an f32 online
// softmax: QK^T, the softmax and PV fused, so no score-sized tensor is
// written to device memory.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention and computes what it computes: query and key positions
// both from 0; q scaled by Dk^-0.5 in f32; keys masked unless
// kpos <= qpos (causal) and kpos > qpos - window (window > 0); masked
// scores filled with -1e30 (finite, so a row that has seen only masked
// keys computes exp(0), never inf - inf, and the first visible key wipes
// that out with a correction of exp(-1e30) = 0); output
// acc / max(l, 1e-30) in q's dtype; query row-block bh reads kv head
// (bh / H) * K + (bh % H) / G.
//
// Design (simple first). The TPU kernel walks kv blocks on a sequential
// grid axis and carries (m, l, acc) in VMEM scratch between grid steps.
// Hopper's blocks run in no order, so here one 256-thread block owns one
// (b*h, 64-row query tile) and loops over the 64-key tiles itself. Each
// tile of K and V is staged in shared memory as f32 with 16-byte loads;
// tiles wholly outside the causal/window range are never loaded (the TPU
// kernel skips the same blocks). Four threads share a query row: each
// holds a quarter of the scaled q row and of the f32 accumulator in
// registers (a Dv = 128 accumulator in one thread would spill), reads its
// quarter of each key and value row as float4s (the 4 lanes of a row read
// 64 contiguous bytes, which the warp's 8 rows share by broadcast), and
// two xor shuffles finish each dot product. The softmax state is updated
// every 16 keys. Arithmetic is f32 on the CUDA cores, as the TPU kernel's
// body casts q, k, v to f32: bf16 tensor cores would need P rounded to
// bf16, and f32 inputs tf32, which would break agreement with the f32
// plain version. Any Sq and Sk: the tails are bounds-checked (out-of-range
// key rows are staged as zeros and masked; query rows past Sq are not
// stored).
//
// Bound: at the serving path's shape (8 x 2048 tokens, 16 heads of 64,
// bf16, causal) the visible half of QK^T and PV is 68.7 GFLOP, 69 us at
// the H100's bf16 tensor-core peak, against 40 us for its 134 MB of q, k,
// v and o. This kernel runs on the CUDA cores (67 TFLOP/s f32 peak), so it
// cannot come within 15x of that bound; mma/wgmma, TMA and a bf16 P path
// are the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // query rows a block
constexpr int kKeys = 64;                  // key rows a staged tile
constexpr int kLanes = 4;                  // threads a query row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kStep = 16;                  // keys a softmax update
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 16 bytes of T -> f32 into dst (4 floats for f32, 8 for bf16).
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  store4(dst, load4(src));
}

__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Stage rows [0, rows) of a contiguous (kKeys, D) tile of T into dst as
// f32 with 16-byte loads; rows [rows, kKeys) become zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = kKeys * D / kPer;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    float* d = dst + i * kPer;
    if ((i * kPer) / D < rows) {
      widen16(src + static_cast<size_t>(i) * kPer, d);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        store4(d + e, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int K, int causal, int window, float scale) {
  static_assert(DK % (4 * kLanes) == 0 && DV % (4 * kLanes) == 0,
                "head dims must be multiples of 16");
  constexpr int QC = DK / (4 * kLanes);   // float4s of q a thread
  constexpr int VC = DV / (4 * kLanes);   // float4s of acc a thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // (kKeys, DK)
  float* vs = ks + kKeys * DK;                   // (kKeys, DV)

  const int bh = blockIdx.x;
  // the longest causal rows first, so the short tiles fill the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qpos = q0 + row;
  const bool live = qpos < Sq;

  float4 qr[QC];
  const T* qrow = q + (static_cast<size_t>(bh) * Sq + (live ? qpos : 0)) * DK;
#pragma unroll
  for (int i = 0; i < QC; ++i) {
    const float4 x = live ? load4(qrow + 4 * (i * kLanes + lane))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  float4 acc[VC];
#pragma unroll
  for (int i = 0; i < VC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNeg, l = 0.f;

  // keys that some row of this tile can see
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys
                                 : 0;
  const T* kbase = k + static_cast<size_t>(kvh) * Sk * DK;
  const T* vbase = v + static_cast<size_t>(kvh) * Sk * DV;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    const int rows = min(kKeys, Sk - k0);
    __syncthreads();   // every thread is done with the previous tile
    stage<T, DK>(ks, kbase + static_cast<size_t>(k0) * DK, rows);
    stage<T, DV>(vs, vbase + static_cast<size_t>(k0) * DV, rows);
    __syncthreads();
    const int j_end = min(kKeys, k_end - k0);
#pragma unroll 1
    for (int j0 = 0; j0 < j_end; j0 += kStep) {
      float s[kStep];
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        const float* kr = ks + (j0 + jj) * DK;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < QC; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kr + 4 * (i * kLanes + lane));
          a = fmaf(qr[i].x, kk.x, a);
          a = fmaf(qr[i].y, kk.y, a);
          a = fmaf(qr[i].z, kk.z, a);
          a = fmaf(qr[i].w, kk.w, a);
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        const int kpos = k0 + j0 + jj;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[jj] = ok ? a : kNeg;
      }
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) m_new = fmaxf(m_new, s[jj]);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < VC; ++i) {
        acc[i].x *= corr;
        acc[i].y *= corr;
        acc[i].z *= corr;
        acc[i].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kStep; ++jj) {
        const float* vr = vs + (j0 + jj) * DV;
#pragma unroll
        for (int i = 0; i < VC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vr + 4 * (i * kLanes + lane));
          acc[i].x = fmaf(s[jj], vv.x, acc[i].x);
          acc[i].y = fmaf(s[jj], vv.y, acc[i].y);
          acc[i].z = fmaf(s[jj], vv.z, acc[i].z);
          acc[i].w = fmaf(s[jj], vv.w, acc[i].w);
        }
      }
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + (static_cast<size_t>(bh) * Sq + qpos) * DV;
#pragma unroll
  for (int i = 0; i < VC; ++i)
    store4(orow + 4 * (i * kLanes + lane),
           make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                       acc[i].w / den));
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kKeys * (DK + DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_fwd<T, DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, K, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, Sq, Dk); k: (BK, Sk, Dk); v: (BK, Sk, Dv); o: (BH, Sq, Dv); all
// contiguous, 16-byte aligned, of one dtype (bf16 != 0: bf16, else f32).
// BH = B * H, BK = B * K, H % K == 0. (Dk, Dv) must be one of the pairs
// instantiated below; another pair returns -1 without launching.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int BH,
                                   int Sq, int Sk, int H, int K, int Dk,
                                   int Dv, int causal, int window,
                                   float scale, void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DK, DV)                                                  \
  if (Dk == DK && Dv == DV)                                                 \
    return bf16 ? launch<__nv_bfloat16, DK, DV>(q, k, v, o, BH, Sq, Sk, H,  \
                                                K, causal, window, scale,   \
                                                st)                         \
                : launch<float, DK, DV>(q, k, v, o, BH, Sq, Sk, H, K,       \
                                        causal, window, scale, st);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return -1;
}
