// Blocked GQA flash attention (causal or not, optional logit soft cap) for
// Hopper (sm_90a), bound with ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel). It computes what that kernel computes:
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D) in q's
//   type; query head hq reads kv head hq / (Hq / Hkv); s = scale q.k, then
//   cap tanh(s / cap) when cap > 0, then the causal mask, with query row i
//   at absolute position i + (Skv - Sq); float32 math throughout.
// Unlike the Pallas kernel, which asserts that Sq and Skv divide its
// blocks, this one masks the ragged tail of both axes: training feeds
// T = seq - 1 positions.
//
// What bounds it on the card: operations. A call does 4 D flops per
// (query, visible key) pair -- two products, q.k and p.v -- on
// (2 Sq Hq + 2 Skv Hkv) D elements. At the training shape (2, 32/8, 1023,
// 128) that is 17.2 GFLOP on 42 MB: ~17 us at the bf16 tensor-core peak
// against ~13 us of bytes. This bring-up design runs float32 CUDA-core
// fmas (67 TFLOP/s peak, so >= 0.26 ms at that shape) from shared memory;
// tensor cores (wgmma) and TMA are later work.
//
// Design (simple and right first):
//  * one block of 256 threads per (64-row query tile, b * Hq + hq); the
//    query tiles with the most causal work are scheduled first;
//  * the Pallas grid's sequential k axis becomes a loop over 32-key
//    tiles, staged in shared memory as float32 (rows past Skv are zeros);
//    the loop stops at the last tile the tile's last query can see, so
//    tiles strictly above the offset diagonal are skipped;
//  * thread (tr, tc) = (tid / 16, tid % 16) owns query rows tr + 16 i
//    (i < 4), score columns tc + 16 j and output columns tc + 16 c: the 16
//    lanes of a half-warp share a row, so its running max and sum are
//    reduced with four shuffles and kept, replicated, in registers;
//  * masked entries get p = 0 explicitly, never exp(-1e30 - m): while a
//    row's max is still the -1e30 sentinel, exp(s - m) of a masked s
//    would be 1 (the key tail of every ragged row hits this);
//  * Q and K rows are padded to D + 4 floats and read as float4, the P
//    tile to 48 floats, so every shared-memory access is free of bank
//    conflicts; ~79 KB of dynamic shared memory at D = 128 (two blocks per
//    SM), above the 48 KB static limit, so each instantiation lifts its
//    cap once (cudaFuncAttributeMaxDynamicSharedMemorySize).
// D is a template parameter (compile-time trip counts, no guarded
// register loops), built for 16 (smoke), 112 (zamba2's shared block) and
// 128 (minitron-8b); another D fails at launch with cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256
#define BQ 64           // query rows per block
#define BK 32           // keys per tile
#define NJ (BK / 16)    // score columns per thread
#define PS (BK + 16)    // P tile row stride (floats)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <int D> struct Smem {
  static constexpr int QS = D + 4;  // Q and K row stride (floats)
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * D + (size_t)BQ * PS);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Hq, int G, int Sq, int Skv, float scale, float cap,
          int causal) {
  constexpr int QS = Smem<D>::QS;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;                      // b * Hq + hq
  const int bkv = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const int off = Skv - Sq;
  const int qrows = min(BQ, Sq - q0);
  const T* qp = q + ((size_t)bh * Sq + q0) * D;
  const T* kp = k + (size_t)bkv * Skv * D;
  const T* vp = v + (size_t)bkv * Skv * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    sQ[r * QS + c] = r < qrows ? to_f(qp[(size_t)r * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys past the last one this tile's last query sees are never loaded
  const int kend = causal ? min(Skv, off + q0 + qrows) : Skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    const int krows = min(BK, Skv - k0);
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = r < krows;
      const size_t g = (size_t)(k0 + r) * D + c;
      sK[r * QS + c] = in ? to_f(kp[g]) : 0.f;
      sV[r * D + c] = in ? to_f(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (tr + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tc + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = off + q0 + tr + 16 * i;
      bool ok[NJ];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        s[i][j] = x;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos);
        if (ok[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mnew = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        rs += p;
        sP[(tr + 16 * i) * PS + tc + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (tr + 16 * i) * PS + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = sV[(kk + t) * D + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = o + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= qrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) op[(size_t)r * D + tc + 16 * c] = from_f<T>(acc[i][c] / den);
  }
}

// Lift each instantiation's dynamic shared-memory cap once, then launch it.
template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                  int Hkv, int Sq, int Skv, float scale, float cap, int causal,
                  cudaStream_t s) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  fa_kernel<T, D><<<grid, THREADS, Smem<D>::bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hq / Hkv, Sq, Skv, scale, cap,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                    int Hq, int Hkv, int Sq, int Skv, float scale, float cap, int causal,
                    cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s);
    case 112: return launch<T, 112>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype code of q, k, v and out: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim, type or grid
// the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      float scale, float cap, int causal, int dtype,
                                      void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s);
  return (int)cudaErrorInvalidValue;
}
