// Flash attention forward (causal / sliding-window GQA) with an f32 online
// softmax: QK^T, the softmax and PV fused, so no score-sized tensor is
// written to device memory.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention and computes what it computes: query and key positions
// both from 0; q.k scaled by Dk^-0.5 in f32; keys masked unless
// kpos <= qpos (causal) and kpos > qpos - window (window > 0); masked
// scores filled with -1e30 (finite, so a row that has seen only masked
// keys computes exp(0), never inf - inf, and the first visible key wipes
// that out with a correction of exp(-1e30) = 0); output
// acc / max(l, 1e-30) in q's dtype; query row-block bh reads kv head
// (bh / H) * K + (bh % H) / G.
//
// Two routes, chosen by dtype. Both: one block owns one (b*h, 64-row query
// tile) and walks the 64-key tiles itself (the TPU kernel carries (m, l,
// acc) in VMEM across a sequential grid axis; Hopper's blocks run in no
// order); tiles wholly outside the causal/window range are never loaded
// (the TPU kernel skips the same blocks); the longest causal rows go
// first, so the short tiles fill the tail; any Sq and Sk, tails masked;
// no atomics, so two calls give equal bits.
//
// bf16 (the serving path): the tensor cores. 4 warps, 16 query rows a
// warp. The Q tile is copied once into shared memory and read into
// m16n8k16 A fragments with ldmatrix (kept in registers up to Dk 128; at
// Dk 192 read again from shared memory at every k-step, so that the 16 x
// 128 f32 O accumulator, 64 registers a thread, does not spill). K and V
// tiles stay bf16 in shared memory (rows padded by 16 bytes, so ldmatrix's
// 8 rows hit 8 distinct bank quads) and are double-buffered with 16-byte
// cp.async copies, zero-filled past Sk: the next tile's copy runs under
// this tile's MMAs. S = Q K^T is mma.sync m16n8k16 bf16 -> f32 (bf16 x
// bf16 products are exact in f32, so S differs from the plain version only
// in the order of the sums), scaled by Dk^-0.5 * log2(e) after the dot and
// masked; the online softmax runs on the accumulator fragments in the
// exp2 domain, a row's max reduced over the quad of threads that holds it
// with two xor shuffles; l is summed from the f32 P.
//
// PV splits P into two bf16 halves, P_hi = bf16(P) and P_lo = bf16(P -
// P_hi), and accumulates P_hi V + P_lo V in f32. Both go straight from the
// S accumulator's register layout into the A fragments of the next MMA; V's
// B fragments come through ldmatrix.trans. The split is what keeps the
// kernel within the tolerance of the f32 plain version (rtol 1e-2, atol
// 1e-5 in bf16): P rounded once to bf16, the textbook tensor-core design,
// put 3-8% of the output elements outside it in a tile-by-tile emulation on
// the CPU (44,106 of 524,288 at H 4, S 2048, 64/64 causal; 22,163 of
// 262,144 at 192/128; 42,872 of 512,000 at 128/128, window 256; 8,798 of
// 524,288 with q x 8; 1,861 of 64,000 at 32/16, window 37, q x 4), and
// the split none (tests/test_torch_flash_tiles.py holds the emulation and
// its no-P_lo guard). V is bf16 already, so both products are exact bf16
// MMAs; the split costs one more PV MMA, 1.5x the tensor-core operations
// of a plain bf16 kernel. A design that drops P_lo has to meet the same
// tolerance.
//
// f32 (no path of the port): the CUDA cores, as the TPU kernel's body casts
// q, k, v to f32 (tf32 tensor cores would break agreement with the f32
// plain version): 256 threads, four a query row, each holding a quarter of
// the scaled q row and of the accumulator in registers; K and V tiles
// staged as f32 with 16-byte loads; two xor shuffles finish each dot
// product; the softmax state is updated every 16 keys.
//
// Bound: at the serving path's shape (8 x 2048 tokens, 16 heads of 64,
// bf16, causal) the visible half of QK^T and PV is 68.7 GFLOP, 69.5 us at
// the H100's bf16 tensor-core peak (989 TFLOP/s), against ~40 us for its
// 134 MB of q, k, v and o: operations bound. That is the work the function
// needs; the split's extra PV MMA (103 GFLOP of MMAs in all) is this
// kernel's own cost. mma.sync reaches only part of the peak that wgmma
// does; what is left for later: wgmma with TMA-fed K/V tiles, warp
// specialisation (a producer warp for the copies), and 128-row blocks that
// read each K/V fragment for two row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

// ------------------------------------------------------------ f32 route

namespace f32 {

constexpr int kRows = 64;                  // query rows a block
constexpr int kKeys = 64;                  // key rows a staged tile
constexpr int kLanes = 4;                  // threads a query row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kStep = 16;                  // keys a softmax update

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Stage rows [0, rows) of a contiguous (kKeys, D) tile into dst with
// 16-byte loads; rows [rows, kKeys) become zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int rows) {
  constexpr int kVecs = kKeys * D / 4;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    store4(dst + i * 4, (i * 4) / D < rows
                            ? load4(src + static_cast<size_t>(i) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq,
          int Sk, int H, int K, int causal, int window, float scale) {
  static_assert(DK % (4 * kLanes) == 0 && DV % (4 * kLanes) == 0,
                "head dims must be multiples of 16");
  constexpr int QC = DK / (4 * kLanes);   // float4s of q a thread
  constexpr int VC = DV / (4 * kLanes);   // float4s of acc a thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // (kKeys, DK)
  float* vs = ks + kKeys * DK;                   // (kKeys, DV)

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qpos = q0 + row;
  const bool live = qpos < Sq;

  float4 qr[QC];
  const float* qrow =
      q + (static_cast<size_t>(bh) * Sq + (live ? qpos : 0)) * DK;
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
  const float* kbase = k + static_cast<size_t>(kvh) * Sk * DK;
  const float* vbase = v + static_cast<size_t>(kvh) * Sk * DV;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    const int rows = min(kKeys, Sk - k0);
    __syncthreads();   // every thread is done with the previous tile
    stage<DK>(ks, kbase + static_cast<size_t>(k0) * DK, rows);
    stage<DV>(vs, vbase + static_cast<size_t>(k0) * DV, rows);
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
          const float4 kk = load4(kr + 4 * (i * kLanes + lane));
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
          const float4 vv = load4(vr + 4 * (i * kLanes + lane));
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
  float* orow = o + (static_cast<size_t>(bh) * Sq + qpos) * DV;
#pragma unroll
  for (int i = 0; i < VC; ++i)
    store4(orow + 4 * (i * kLanes + lane),
           make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                       acc[i].w / den));
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kKeys * (DK + DV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_fwd<DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, K,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ----------------------------------------------------- bf16 route (MMA)

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                  // query rows a block
constexpr int kKeys = 64;                  // keys a K/V tile
constexpr int kWarps = 4;                  // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;      // 128
constexpr int kPad = 8;                    // bf16 of padding a smem row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi); x in the low half
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Copy rows [0, rows) of a row-major (64, D) global tile into shared
// memory with row stride D + kPad, 16 bytes a thread; rows [rows, 64)
// become zeros. Asynchronous: the caller commits and waits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows) {
  constexpr int kVec = D / 8;              // 16-byte pieces a row
  constexpr int kN = kKeys * kVec;
  static_assert(kN % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < kN / kThreads; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kVec, col = (c % kVec) * 8;
    const bool full = r < rows;
    cp_async16(smem_addr(dst + r * (D + kPad) + col),
               src + static_cast<size_t>(full ? r : 0) * D + col, full);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
          int H, int K, int causal, int window, float scale_log2) {
  static_assert(DK % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  constexpr int SQK = DK + kPad;           // smem row stride of Q and K
  constexpr int SV = DV + kPad;            // of V
  constexpr int KS = DK / 16;              // k-steps of Q K^T
  constexpr int NV = DV / 8;               // 8-column blocks of O
  constexpr bool kQRegs = DK <= 128;       // Q's A fragments in registers
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (64, SQK)
  bf16* ks = qs + kRows * SQK;                    // 2 x (64, SQK)
  bf16* vs = ks + 2 * kKeys * SQK;                // 2 x (64, SV)

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;    // row and column of a fragment
  // this thread's two query rows: g and g + 8 of the warp's 16
  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;

  // keys that some row of this tile can see
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys
                                 : 0;
  const bf16* kbase = k + static_cast<size_t>(kvh) * Sk * DK;
  const bf16* vbase = v + static_cast<size_t>(kvh) * Sk * DV;

  load_tile<DK>(qs, q + (static_cast<size_t>(bh) * Sq + q0) * DK,
                q_last - q0 + 1);
  if (k_begin < k_end) {
    const int rows = min(kKeys, Sk - k_begin);
    load_tile<DK>(ks, kbase + static_cast<size_t>(k_begin) * DK, rows);
    load_tile<DV>(vs, vbase + static_cast<size_t>(k_begin) * DV, rows);
  }
  cp_async_commit();

  // ldmatrix lane roles: matrix mi of the x4, row r of it
  const int mi = lane / 8, r = lane % 8;
  // A fragments of Q: rows warp*16 + (lane % 16), columns + (lane / 16) * 8
  const bf16* qa = qs + (warp * 16 + lane % 16) * SQK + (lane / 16) * 8;

  float oacc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this thread's part
  uint32_t qf[KS][4];

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kKeys, buf ^= 1) {
    const int next = k0 + kKeys;
    if (next < k_end) {   // the next tile's copy runs under this tile
      const int rows = min(kKeys, Sk - next);
      load_tile<DK>(ks + (buf ^ 1) * kKeys * SQK,
                    kbase + static_cast<size_t>(next) * DK, rows);
      load_tile<DV>(vs + (buf ^ 1) * kKeys * SV,
                    vbase + static_cast<size_t>(next) * DV, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (k0 == k_begin) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], smem_addr(qa + kk * 16));
      }
    }
    const bf16* kt = ks + buf * kKeys * SQK;
    const bf16* vt = vs + buf * kKeys * SV;

    // S (16 x 64 a warp) = Q K^T: 8 blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, smem_addr(qa + kk * 16));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // two 8-key blocks an ldmatrix
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt + (np * 16 + r + (mi / 2) * 8) * SQK +
                             kk * 16 + (mi % 2) * 8));
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, then mask where some key of the tile is hidden from some row
    const bool full = k0 + kKeys <= Sk &&
                      (!causal || k0 + kKeys - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kRows - 1 - window);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (!full) {
          const int kpos = k0 + nb * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : kNeg;
        }
        s[nb][e] = x;
      }
    }

    // online softmax in the exp2 domain; a row lives on a quad's 4 threads
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m[e / 2]);
        rs[e / 2] += s[nb][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }

    // O += P_hi V + P_lo V, 16 keys a step: S's blocks 2kk and 2kk + 1 are
    // the A fragment of keys [16kk, 16kk + 16)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {   // two 8-column blocks of O
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(vt + (kk * 16 + r + (mi % 2) * 8) * SV +
                                   np * 16 + (mi / 2) * 8));
        mma(oacc[2 * np], hi, b[0], b[1]);
        mma(oacc[2 * np], lo, b[0], b[1]);
        mma(oacc[2 * np + 1], hi, b[2], b[3]);
        mma(oacc[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();   // no copy outlives the block (no tile: only Q's)

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-30f);
  }
  bf16* obase = o + static_cast<size_t>(bh) * Sq * DV + 2 * t;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (qpos0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          obase + static_cast<size_t>(qpos0) * DV + j * 8) =
          __floats2bfloat162_rn(oacc[j][0] / den[0], oacc[j][1] / den[0]);
    if (qpos1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          obase + static_cast<size_t>(qpos1) * DV + j * 8) =
          __floats2bfloat162_rn(oacc[j][2] / den[1], oacc[j][3] / den[1]);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(bf16)) *
                   (3 * kKeys * (DK + kPad) + 2 * kKeys * (DV + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (Sq + kRows - 1) / kRows);
  flash_fwd<DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, K,
      causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q: (BH, Sq, Dk); k: (BK, Sk, Dk); v: (BK, Sk, Dv); o: (BH, Sq, Dv); all
// contiguous, 16-byte aligned, of one dtype (bf16 != 0: bf16, on the tensor
// cores; else f32, on the CUDA cores). BH = B * H, BK = B * K, H % K == 0.
// (Dk, Dv) must be one of the pairs instantiated below; another pair
// returns -1 without launching. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int BH,
                                   int Sq, int Sk, int H, int K, int Dk,
                                   int Dv, int causal, int window,
                                   float scale, void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DK, DV)                                                  \
  if (Dk == DK && Dv == DV)                                                 \
    return bf16 ? tc::launch<DK, DV>(q, k, v, o, BH, Sq, Sk, H, K, causal,  \
                                     window, scale, st)                     \
                : f32::launch<DK, DV>(q, k, v, o, BH, Sq, Sk, H, K, causal, \
                                      window, scale, st);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return -1;
}
