// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces: src/repro/kernels/ssm_scan.py::ssd (Pallas body _ssd_kernel).
// That kernel asserts h0 is None, yet its serving caller (models/ssm.py,
// the chunked-prefill continuation) passes h0; this kernel computes what
// src/repro/kernels/ref.py::ssd computes -- the JAX package's semantic
// ground truth -- h0 included.
//
// Per (batch, head) and chunk of L steps, with cum the inclusive cumsum of
// dt * A over the chunk and h the (P, N) state entering it:
//   y[t]  = sum_{s<=t} (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] x[s]
//         + exp(cum[t]) (C[t] . h^T) + D x[t]
//   h    <- exp(cum[L-1]) h + sum_s exp(cum[L-1] - cum[s]) dt[s] x[s]^T B[s]
//
// What bounds it on the card: operations. At the serving shape (one
// 256-step chunk, H = 112 heads of P = 64, N = 64) a call needs
// L (L + 1) N float32 flops per chunk for the causal C.B triangle (B and
// C are shared by the heads) and L (L + 1) P + 4 L P N per head (the M.x
// triangle, the inter-chunk term, the state update): 0.95 GFLOP in all,
// on 11 MB of x, y and the two states. The float32 CUDA-core bound
// (67 TFLOP/s) is ~14 us against ~3.3 us of bytes. This design forms C.B
// again in every head's block, 1.41 GFLOP of work done.
//
// Design (simple and right first):
//  * one block of 256 threads per (batch, head) walks the chunks in order;
//    the state h stays in shared memory across them (the Pallas grid's
//    sequential chunk axis becomes this loop);
//  * each chunk's x and B are staged once as float32 with padded rows
//    (P + 1, N + 1 floats), so loops that run along a row and loops that
//    run down a column are both free of bank conflicts;
//  * the L x L decay-weighted C.B matrix is never held whole (256 KB at
//    L = 256): rows t are taken TT = 32 at a time, and only columns
//    s < the tile's end are formed; exp(cum[t] - cum[s]) is evaluated for
//    s <= t only, so masked entries never produce an overflow;
//  * every thread keeps a few outputs in registers (4 rows of the C.B
//    tile, TT P / 256 rows of y, P N / 256 rows of the state: 8 and 16 at
//    P = N = 64), so one shared load of a B, x or h element feeds several
//    fmas; P and N are template parameters, so these loops unroll with
//    no guard (the first version took them at run time: its guarded
//    loops compiled to a branch per register and ran 1.08 ms a call);
//  * padded steps (dt = 0) contribute nothing to h: their weight is 0 and
//    they add nothing to cum; their y is computed and the caller drops it.
// Known limits, left to later work: float32 CUDA-core fmas, no tensor
// cores; b * H blocks (112 at batch 1) on 132 SMs, one block per SM for
// its ~190 KB of shared memory; a 16-token piece still pays for the whole
// 256-step chunk it is padded to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256
#define TT 32        // rows t of the C.B tile

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x, y: (b, T, H, P) of T_; dt: (b, T, H) f32; A, D: (H,) f32; Bm, Cm:
// (b, T, N) of T_; h0 (may be null), hout: (b, H, P, N) f32. P and N are
// template parameters, so every register loop has a compile-time trip
// count and no guard. One block per SM (its shared memory allows no
// second), so the register budget is the whole 255 a thread may have.
template <typename T_, int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const T_* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T_* __restrict__ Bm,
           const T_* __restrict__ Cm, const float* __restrict__ Dv,
           const float* __restrict__ h0, T_* __restrict__ y, float* __restrict__ hout,
           int Tn, int H, int L) {
  constexpr int NP = N + 1, PP = P + 1;
  constexpr int RY = THREADS / P, KY = TT / RY;   // y: thread owns column p, KY rows
  constexpr int RH = THREADS / N, KH = P / RH;    // state: thread owns column n, KH rows
  static_assert(THREADS % P == 0 && THREADS % N == 0 && TT % RY == 0 && P % RH == 0,
                "P and N must divide the block");
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* sB = smem;                // L x NP
  float* sX = sB + L * NP;         // L x PP
  float* sH = sX + L * PP;         // P x NP, the state entering the chunk
  float* sC = sH + P * NP;         // TT x NP, C rows of the tile
  float* sM = sC + TT * NP;        // TT x L, decay-weighted C.B of the tile
  float* sCum = sM + TT * L;       // L
  float* sDt = sCum + L;           // L
  float* sW = sDt + L;             // L: exp(cum[L-1] - cum[s]) * dt[s]

  const float a_h = A[h], d_h = Dv[h];
  const size_t hbase = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    sH[(i / N) * NP + i % N] = h0 ? h0[hbase + i] : 0.f;
  const int py = tid % P, ry = tid / P;
  const int nh = tid % N, ph = tid / N;

  for (int c = 0; c < Tn / L; ++c) {
    const size_t row0 = (size_t)b * Tn + (size_t)c * L;   // (b, t) row of the chunk
    __syncthreads();               // the previous chunk is done with sX, sB, sH
    for (int i = tid; i < L * P; i += THREADS)
      sX[(i / P) * PP + i % P] = to_f(x[((row0 + i / P) * H + h) * P + i % P]);
    for (int i = tid; i < L * N; i += THREADS)
      sB[(i / N) * NP + i % N] = to_f(Bm[row0 * N + i]);
    for (int s = tid; s < L; s += THREADS) sDt[s] = dt[(row0 + s) * H + h];
    __syncthreads();
    if (tid < 32) {                // inclusive cumsum of dt * A: runs per lane, then a warp scan
      const int per = (L + 31) / 32, lo = min(tid * per, L), hi = min(lo + per, L);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += sDt[s] * a_h;
        sCum[s] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float off = incl - run;
      for (int s = lo; s < hi; ++s) sCum[s] += off;
    }
    __syncthreads();
    const float cl = sCum[L - 1];
    for (int s = tid; s < L; s += THREADS) sW[s] = expf(cl - sCum[s]) * sDt[s];

    for (int t0 = 0; t0 < L; t0 += TT) {
      const int rows = min(TT, L - t0), cols = t0 + rows;   // s < cols
      for (int i = tid; i < rows * N; i += THREADS)
        sC[(i / N) * NP + i % N] = to_f(Cm[(row0 + t0) * N + i]);
      __syncthreads();
      {  // M[r][s] = (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] for s <= t, else 0
        const int lane = tid & 31, g = tid >> 5;            // 8 row groups of 4
        for (int s = lane; s < cols; s += 32) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
          for (int n = 0; n < N; ++n) {
            const float bv = sB[s * NP + n];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] = fmaf(sC[(g + 8 * k) * NP + n], bv, acc[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = g + 8 * k, t = t0 + r;
            if (r < rows)
              sM[r * L + s] = s <= t ? acc[k] * expf(sCum[t] - sCum[s]) * sDt[s] : 0.f;
          }
        }
      }
      __syncthreads();
      {  // y rows of the tile: thread owns column py, rows ry + k * RY; rows
         // past the tile's end read stale sM and are not written
        float yi[KY], ye[KY];
#pragma unroll
        for (int k = 0; k < KY; ++k) yi[k] = ye[k] = 0.f;
#pragma unroll 4
        for (int s = 0; s < cols; ++s) {
          const float xv = sX[s * PP + py];
#pragma unroll
          for (int k = 0; k < KY; ++k) yi[k] = fmaf(sM[(ry + k * RY) * L + s], xv, yi[k]);
        }
#pragma unroll 16
        for (int n = 0; n < N; ++n) {
          const float hv = sH[py * NP + n];
#pragma unroll
          for (int k = 0; k < KY; ++k) ye[k] = fmaf(sC[(ry + k * RY) * NP + n], hv, ye[k]);
        }
#pragma unroll
        for (int k = 0; k < KY; ++k) {
          const int r = ry + k * RY;
          if (r < rows) {
            const int t = t0 + r;
            const float v = yi[k] + expf(sCum[t]) * ye[k] + d_h * sX[t * PP + py];
            y[((row0 + t) * H + h) * P + py] = from_f<T_>(v);
          }
        }
      }
      __syncthreads();             // sC and sM are rewritten by the next tile
    }

    {  // state: thread owns column nh, rows ph + k * RH
      float acc[KH];
#pragma unroll
      for (int k = 0; k < KH; ++k) acc[k] = 0.f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float wb = sW[s] * sB[s * NP + nh];
#pragma unroll
        for (int k = 0; k < KH; ++k) acc[k] = fmaf(sX[s * PP + ph + k * RH], wb, acc[k]);
      }
      const float decay = expf(cl);
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        float* hp = sH + (ph + k * RH) * NP + nh;
        *hp = fmaf(decay, *hp, acc[k]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) hout[hbase + i] = sH[(i / N) * NP + i % N];
}

// The (P, N) pairs the kernel is built for: the smoke configs' (16, 16)
// and zamba2-7b's (64, 64).
static bool supported(int P, int N) { return (P == 16 && N == 16) || (P == 64 && N == 64); }

// Dynamic shared memory the kernel needs, or 0 where it does not take the
// shape; a request past the block limit fails at launch.
static size_t smem_bytes(int P, int N, int L) {
  if (!supported(P, N) || L <= 0) return 0;
  return sizeof(float) * ((size_t)L * (N + 1) + (size_t)L * (P + 1) + (size_t)P * (N + 1) +
                          (size_t)TT * (N + 1) + (size_t)TT * L + 3 * (size_t)L);
}

// Lift each instantiation's dynamic shared-memory cap to the block limit
// once, then launch it.
template <typename T_, int P, int N>
static int launch(const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, const void* Dv, const void* h0, void* y, void* hout,
                  dim3 grid, size_t smem, cudaStream_t s, int Tn, int H, int L) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ssd_kernel<T_, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (allowed != cudaSuccess) return (int)allowed;
  ssd_kernel<T_, P, N><<<grid, THREADS, smem, s>>>(
      (const T_*)x, (const float*)dt, (const float*)A, (const T_*)Bm, (const T_*)Cm,
      (const float*)Dv, (const float*)h0, (T_*)y, (float*)hout, Tn, H, L);
  return (int)cudaGetLastError();
}

// dtype code of x, B, C and y: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the kernel does
// not take or a shared-memory request the device refuses).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* Dv, const void* h0, void* y,
                          void* hout, int batch, int Tn, int H, int P, int N, int L,
                          int dtype, void* stream) {
  const size_t smem = smem_bytes(P, N, L);
  if (smem == 0 || Tn % L != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H, batch);
#define ARGS x, dt, A, Bm, Cm, Dv, h0, y, hout, grid, smem, s, Tn, H, L
  if (P == 16)
    return dtype == 0 ? launch<float, 16, 16>(ARGS) : launch<__nv_bfloat16, 16, 16>(ARGS);
  return dtype == 0 ? launch<float, 64, 64>(ARGS) : launch<__nv_bfloat16, 64, 64>(ARGS);
#undef ARGS
}
