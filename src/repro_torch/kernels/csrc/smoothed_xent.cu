// Label-smoothed cross entropy, one row at a time (the LM loss's per-row
// NLL), forward and backward:
//
//   forward   nll[t] = lse[t] - ((1-eps) * x[t, y_t] + eps * mean_v x[t, v])
//             lse[t] = log sum_v exp(x[t, v])     (kept for the backward)
//   backward  dx[t, v] = g[t] * (exp(x[t, v] - lse[t]) - (1-eps) * [v = y_t]
//                                - eps / V)
//
// Replaces the Pallas kernel repro/kernels/smoothed_xent.py::
// smoothed_xent_rows. That kernel walks vocab tiles on a sequential TPU
// grid axis and carries (max, sum-exp, target, sum) in VMEM scratch from
// tile to tile. Hopper's blocks run in no order, so here one 256-thread
// block owns one row and loops over it itself: each thread streams a
// strided share of the row with 16-byte loads (4 f32 or 8 bf16 logits),
// keeping its running max and sum-exp (rescaled online, once a vector),
// the plain sum and the target logit in f32 registers; warp shuffles and
// one shared-memory step merge the 256 partials in a fixed order
// (deterministic). The target is a column-equals-label test, as the Pallas
// kernel's `hit`: no gather by label, so a label outside [0, V) (IGNORE,
// -1) touches no memory and contributes no target. The reference has no
// backward kernel (JAX differentiates its jnp loss); the backward here
// streams the row once more and writes dx in the logits' dtype; a row whose
// g[t] is 0 (a masked row) is written as exact zeros without reading x.
//
// Any T and V: a row of V elements starts at an arbitrary element offset,
// so each row is split into a scalar head up to the first 16-byte boundary,
// a body of 16-byte vectors and a scalar tail, all bounds-checked. The
// backward takes the vector path only where x's and dx's rows share their
// alignment (a fresh dx and a fresh x always do), else scalars.
//
// Bound: memory. ~5 f32 operations and one exp per logit against 4 (f32)
// or 2 (bf16) bytes read, and the backward 4 or 2 more bytes written. At
// the LM training path's shape (T 8,192 x V 151,936, f32 logits) the
// forward reads 4.98 GB, 1.49 ms at the H100 SXM's 3.35 TB/s, and the
// backward moves 9.96 GB, 2.97 ms. This first version keeps the design
// simple: one block a row, two vectors in flight a thread, no TMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// The running max before any logit: finite, so exp(kNeg - m) is 0 and
// never inf - inf (the Pallas kernel's NEG).
constexpr float kNeg = -1e30f;

// 16 bytes of logits, as f32 values.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* o) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A row of V elements at `row`: `head` scalars up to the first 16-byte
// boundary, then `n_vec` vectors of Pack<T>::N, then the tail.
template <typename T>
__device__ __forceinline__ void split(const void* row, long long V,
                                      long long* head, long long* n_vec) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  long long h = mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0;
  if (h > V) h = V;
  *head = h;
  *n_vec = (V - h) / Pack<T>::N;
}

// Running statistics of a share of one row.
struct Stats {
  float m;   // max
  float l;   // sum of exp(x - m)
  float s;   // sum of x
  float t;   // the target logit (0 unless this share holds column y)
};

template <int N>
__device__ __forceinline__ void absorb(Stats& st, const float* x,
                                       long long col, int label) {
  float m = st.m;
#pragma unroll
  for (int i = 0; i < N; ++i) m = fmaxf(m, x[i]);
  float l = st.l * expf(st.m - m);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    l += expf(x[i] - m);
    st.s += x[i];
    st.t += (col + i == label) ? x[i] : 0.f;
  }
  st.m = m;
  st.l = l;
}

__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  a.l = a.l * expf(a.m - m) + b.l * expf(b.m - m);
  a.m = m;
  a.s += b.s;
  a.t += b.t;
}

__device__ __forceinline__ void warp_merge(Stats& st) {
  for (int o = 16; o > 0; o >>= 1) {
    const Stats other{__shfl_xor_sync(kFull, st.m, o),
                      __shfl_xor_sync(kFull, st.l, o),
                      __shfl_xor_sync(kFull, st.s, o),
                      __shfl_xor_sync(kFull, st.t, o)};
    merge(st, other);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smoothed_xent_fwd_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ labels,
                         float* __restrict__ nll, float* __restrict__ lse,
                         long long V, float keep, float eps) {
  constexpr int N = Pack<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  const int label = labels[row];
  long long head, n_vec;
  split<T>(xr, V, &head, &n_vec);
  Stats st{kNeg, 0.f, 0.f, 0.f};
  for (long long i = threadIdx.x; i < head; i += kThreads) {
    const float v = to_f32(xr[i]);
    absorb<1>(st, &v, i, label);
  }
  const T* body = xr + head;
  long long k = threadIdx.x;
  // two vectors in flight a thread
  for (; k + kThreads < n_vec; k += 2 * kThreads) {
    float a[N], b[N];
    Pack<T>::load(body + k * N, a);
    Pack<T>::load(body + (k + kThreads) * N, b);
    absorb<N>(st, a, head + k * N, label);
    absorb<N>(st, b, head + (k + kThreads) * N, label);
  }
  if (k < n_vec) {
    float a[N];
    Pack<T>::load(body + k * N, a);
    absorb<N>(st, a, head + k * N, label);
  }
  for (long long i = head + n_vec * N + threadIdx.x; i < V; i += kThreads) {
    const float v = to_f32(xr[i]);
    absorb<1>(st, &v, i, label);
  }

  __shared__ Stats warp_stats[kWarps];
  warp_merge(st);
  if ((threadIdx.x & 31) == 0) warp_stats[threadIdx.x >> 5] = st;
  __syncthreads();
  if (threadIdx.x < 32) {
    st = threadIdx.x < kWarps ? warp_stats[threadIdx.x]
                              : Stats{kNeg, 0.f, 0.f, 0.f};
    warp_merge(st);
    if (threadIdx.x == 0) {
      const float r = st.m + logf(st.l);
      lse[row] = r;
      nll[row] = r - (keep * st.t + eps * (st.s / static_cast<float>(V)));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smoothed_xent_bwd_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ labels,
                         const float* __restrict__ lse,
                         const float* __restrict__ g, T* __restrict__ dx,
                         long long V, float keep, float eps_over_v) {
  constexpr int N = Pack<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const float gr = g[row];
  long long head, n_vec;
  split<T>(dr, V, &head, &n_vec);
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) ^
                     reinterpret_cast<uintptr_t>(dr)) & 15) == 0;
  if (!vec) {
    head = V;
    n_vec = 0;
  }
  if (gr == 0.f) {   // a masked row: exact zeros, x not read
    const float z[N] = {};
    for (long long i = threadIdx.x; i < head; i += kThreads) put(dr + i, 0.f);
    for (long long k = threadIdx.x; k < n_vec; k += kThreads)
      Pack<T>::store(dr + head + k * N, z);
    for (long long i = head + n_vec * N + threadIdx.x; i < V; i += kThreads)
      put(dr + i, 0.f);
    return;
  }
  const float r = lse[row];
  const int label = labels[row];
  auto grad = [&](float v, long long col) {
    return gr * (expf(v - r) - (col == label ? keep : 0.f) - eps_over_v);
  };
  for (long long i = threadIdx.x; i < head; i += kThreads)
    put(dr + i, grad(to_f32(xr[i]), i));
  for (long long k = threadIdx.x; k < n_vec; k += kThreads) {
    const long long c = head + k * N;
    float v[N];
    Pack<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = grad(v[i], c + i);
    Pack<T>::store(dr + c, v);
  }
  for (long long i = head + n_vec * N + threadIdx.x; i < V; i += kThreads)
    put(dr + i, grad(to_f32(xr[i]), i));
}

template <typename T>
int fwd(const void* x, const void* labels, void* nll, void* lse, long long T_,
        long long V, float keep, float eps, cudaStream_t s) {
  smoothed_xent_fwd_kernel<T><<<static_cast<unsigned>(T_), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(labels),
      static_cast<float*>(nll), static_cast<float*>(lse), V, keep, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* labels, const void* lse, const void* g,
        void* dx, long long T_, long long V, float keep, float eps_over_v,
        cudaStream_t s) {
  smoothed_xent_bwd_kernel<T><<<static_cast<unsigned>(T_), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), V, keep, eps_over_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (T, V) contiguous, f32 (dtype 0) or bf16 (dtype 1), element-aligned;
// labels: (T,) int32 (any value; outside [0, V) hits no column); nll, lse:
// (T,) f32 outputs. keep = 1 - eps. Launches on `stream` (nothing when T
// is 0); returns cudaGetLastError().
extern "C" int smoothed_xent_fwd(const void* x, int dtype, const void* labels,
                                 void* nll, void* lse, long long T,
                                 long long V, float keep, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  return dtype == 1 ? fwd<__nv_bfloat16>(x, labels, nll, lse, T, V, keep, eps,
                                         s)
                    : fwd<float>(x, labels, nll, lse, T, V, keep, eps, s);
}

// x, dx: (T, V) contiguous in x's dtype; labels (T,) int32; lse, g: (T,)
// f32 (lse from smoothed_xent_fwd, g the gradient of the loss w.r.t. nll).
extern "C" int smoothed_xent_bwd(const void* x, int dtype, const void* labels,
                                 const void* lse, const void* g, void* dx,
                                 long long T, long long V, float keep,
                                 float eps_over_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  return dtype == 1
             ? bwd<__nv_bfloat16>(x, labels, lse, g, dx, T, V, keep,
                                  eps_over_v, s)
             : bwd<float>(x, labels, lse, g, dx, T, V, keep, eps_over_v, s);
}
