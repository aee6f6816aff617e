// Backward of blocked GQA flash attention (causal or not, optional logit
// soft cap) for Hopper (sm_90a), bound with ctypes: two bodies, chosen by
// dtype alone, like the forward (flash_attention.cu).
//
// Replaces: the gradient the JAX package takes of its attention by XLA's
// autodiff of the plain src/repro/kernels/ref.py::mha (its Pallas
// flash_attention has no custom_vjp, so it trains through that
// reference). It computes that gradient:
//   x = scale q.k, then cap tanh(x / cap) when cap > 0; causal with query
//   row i at i + (Skv - Sq); P = softmax(x) over the keys a row sees;
//   dV = P^T dO, dP = dO V^T, Delta_i = rowsum(dO_i o O_i) (for bf16, O
//   is the forward's out plus its rounding remainder olo: the float32
//   output to about 16 bits, as the plain version's autograd has it),
//   dS = P o (dP - Delta) o dx/ds, dQ = scale dS K, dK = scale dS^T Q,
//   dK and dV summed over the G = Hq / Hkv query heads of each kv head.
// P is recomputed from the forward's log-sum-exp (lse, float32, natural
// units): P = exp(x - lse), so no (Sq, Skv) tensor exists. A causal row
// that sees no key (i + Skv - Sq < 0) is what the plain version makes of
// an all-masked row: its softmax is uniform and the mask cuts the
// gradient to every one of its logits, so the row gives dQ = 0, nothing
// to dK, and dO_i / Skv to dV at every key. The kernels give it x = 0 on
// every key (the forward stored lse = log Skv for it, so P = 1 / Skv)
// and dS = 0 explicitly: exp(-1e30 - lse) of the plain version's
// sentinel logits could not be reproduced from an lse in float32.
//
// What bounds it on the card: operations. The gradient needs five
// products of the forward's size (Q K^T recomputed, dO V^T, and the three
// gradient products): 2.5 x 17.2 = 42.9 GFLOP at the training shape
// (2, 32/8, 1023, 128), 43 us at the bf16 tensor-core peak. The bf16 body
// does seven: S and dP once for each (key tile, query tile, query head),
// dV = P^T dO and dK = dS^T Q each over the bf16 halves hi and lo of P or
// dS (hi + lo keeps about 16 bits), dQ = dS K over dS rounded once. With
// P rounded once (five products, as SDPA rounds), dV comes to the bf16
// tolerance (atol 1e-2 + rtol 1.6e-2 against the float32 gradient) at the
// training shape, and dK near it; dQ has room (chip_smoke.py prints this
// model's figures, tests/test_torch_flash_bwd_plan.py holds the choice).
//
// Launches, in order on the caller's stream (two for bf16, three for
// float32):
//  * Delta: a row's 16-byte vectors of O and dO over a few lanes, float32
//    fmas, a shuffle sum; for bf16 it also zeroes the counters below;
//  * float32: the dK/dV kernel and the dQ kernel of the float32 body, each
//    recomputing S and dP; bf16: one kernel for all three gradients.
//
// Body 1, float32 (CUDA cores, exact float32: fmaf, expf, tanhf), in the
// structure of the forward's fa_kernel: 256 threads, thread (tr, tc) owns
// rows tr + 16 i and columns tc + 16 j of the score tile, rows padded to
// D + 4 floats and read as float4; P and dS go through shared memory to
// the products with dO, Q and K. The card-vs-CPU training of the small
// float32 model needs float32 gradients (TF32 keeps about three digits).
//  * dK/dV: one block per (b * Hkv + kv head, 64-key tile) walks the query
//    tiles that see its keys for all G query heads of the kv head;
//  * dQ: one block per (b * Hq + q head, 64-query tile), the heaviest
//    causal tiles first, walks the key tiles its rows see, as the forward.
//
// Body 2, bfloat16 (wgmma, one warpgroup of 128 threads a block; two at
// D = 192 and 256), with the forward's building blocks (wgmma.cuh): bf16
// tiles of 64 rows in the 128-byte swizzle, copied by cp.async into a
// two-stage ring (the next (Q, dO) tile in flight while this one is
// computed), D = 112 and 24, 16, 8 padded to 128 and 64 with zero columns
// (64 is one column block as it is). At D = 256 one warpgroup would hold
// dK and dV in 256 floats a thread: there each of two warpgroups owns 128
// columns of dK, dV and dQ (the registers of D = 128), and both form S^T
// and dP^T over all of D, the second repeating the first's two products;
// 202 KB of shared memory, one block an SM. D = 192 (MLA) runs that body
// padded to 256 with zero columns: S^T and dP^T take D's 12 k16 steps,
// the three gradient products the padded 256 columns (a quarter of their
// work on zeros), 202 KB as at 256. Grid: one thread block cluster
// of C blocks (C the largest divisor of G up to 8) per unit (b * Hkv + kv
// head, 64-key tile): B Hkv ceil(Skv / 64) C blocks, 1024 at the training
// shape; 108 KB of shared memory a block (D = 128), so two blocks an SM.
// Block r of a cluster walks query heads [r G / C, (r + 1) G / C) of the
// kv head over the query tiles that see the keys: for a causal call, the
// tiles holding rows that see no key, then the tiles from the last down
// to the diagonal, the heads inner; dK and dV for the 64 keys stay in
// registers. Each step:
//  * S^T = K Q^T and dP^T = V dO^T, m64n64k16 with both operands K-major;
//    P^T and dS^T are formed on the accumulator fragments in float32;
//  * dV += P^T dO and dK += dS^T Q with the halves as A operands from
//    registers (m64nDPk16, Q and dO read MN-major); dS^T goes to shared
//    memory as bf16 while dK's products run (keys its rows, queries along
//    the swizzled row: the MN-major A operand of dQ);
//  * dQ's share = dS K (m64nDPk16, dS^T and K both MN-major), which goes
//    to a float32 sum for the (q head, query tile) in a workspace, in key
//    tile order: the key tiles that walk a query tile are 0 .. n_last
//    (the causal ones a prefix), so key tile n writes its share (64 x DP
//    floats) into the step's Q and dO tiles, which it no longer needs,
//    waits until the tile's counter equals n (read at the step's start,
//    made an acquire by a fence; an acquire load while it is short), and
//    one thread hands the share to the TMA: a bulk store for tile 0, a
//    bulk reduce-add in L2 after it (FlashAttention-3's route), and
//    releases turn n + 1 once the bulk group is complete (a proxy fence,
//    a release store; releasing it later, after the next step's first
//    products, was slower on the card). Tile n_last reads the sum
//    and writes dq = scale x sum in bf16 straight from its registers: no
//    pass after the kernel. (A read and write of the sum at every step,
//    or float4 atomics from every thread, cost more on the card.) The sum
//    has one order on every run, so two calls give the same bits. Key
//    tile n - 1 walks the query tiles of key tile n at the same steps,
//    after one more (the descending walk), so the turn it hands on is a
//    step ahead: with an ascending walk the last tile's turn would come
//    at step 2 nq - 1, not nq.
// No deadlock: units are handed out by a ticket (an atomic counter that
// rank 0 of each cluster takes once, key tile major), not by blockIdx, so
// the unit a block waits for (the same kv head and query head, key tile
// n - 1) holds a smaller ticket, taken earlier by a cluster that is
// already running; by induction the smallest unfinished ticket always
// runs. ((b, kv head) major is slower: the tiles of a head then run
// together and the last waits out the whole chain.) The clusters then
// sum dK and dV over their heads through distributed shared memory in
// rank order.
// Registers: at D = 128, dK and dV hold 64 + 64 floats a thread, S^T and
// dP^T 32 + 32, the bf16 halves of P and dS 16 + 16 each, dQ's share 64
// once those are dead.
// Both bodies: D is a template parameter, built for the forward's widths:
// 8 (deepseek-67b's smoke), 16 (the other smoke configs), 24 (the MLA
// smoke's 16 + 8), 64 (whisper-medium), 112 (zamba2's shared block), 128
// (minitron-8b, the other dense configs and the vision cross attention),
// 192 (MLA's 128 + 64) and 256 (gemma-7b); another D fails at launch with
// cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

// The launch's arguments, one block: flash_attention.py packs it with
// the same layout (struct format "<13Q8i2fQ", 152 bytes).
struct BwdArgs {
  const void *q, *k, *v, *o, *olo;
  const float* lse;
  const void* dout;
  float* delta;
  void *dq, *dk, *dv;
  float* dq_acc;  // bf16: dQ's float32 partial sums, 64 x DP floats a (b, q head, query tile)
  int* sem;       // bf16: B * Hq * nq turn counters, then the ticket counter
  int B, Hq, Hkv, Sq, Skv, D, causal, dtype;
  float scale, cap;
  void* stream;
};
static_assert(sizeof(BwdArgs) == 152, "BwdArgs layout");

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ------------------------------------------------------------------ Delta
// Delta_i = dO_i . O_i in float32: L lanes a row, each reading one 16-byte
// vector of O and of dO (4 float32 or 8 bf16), 32 / L rows a warp; for
// bf16, O is out + olo, the forward's output and its rounding remainder
__device__ __forceinline__ void vec_f(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void vec_f(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ olo, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int* __restrict__ sem, int nsem) {
  constexpr int VEC = 16 / (int)sizeof(T), NCH = D / VEC;
  constexpr int L = NCH <= 2 ? 2 : NCH <= 4 ? 4 : NCH <= 8 ? 8 : NCH <= 16 ? 16 : 32;
  const int gi = blockIdx.x * 256 + threadIdx.x;  // the bf16 kernel's counters start at 0
  if (gi < nsem) sem[gi] = 0;
  const int lane = threadIdx.x & 31;
  const int row = (blockIdx.x * 8 + (threadIdx.x >> 5)) * (32 / L) + lane / L;
  float s = 0.f;
  // a lane's vectors c, c + L, ... (two where a row has 64: float32 at D = 256)
#pragma unroll
  for (int c = lane % L; c < NCH; c += L) {
    if (row >= rows) break;
    float a[VEC], b[VEC];
    vec_f(o + (size_t)row * D + c * VEC, a);
    if (olo != nullptr) {
      float r[VEC];
      vec_f(olo + (size_t)row * D + c * VEC, r);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] += r[e];
    }
    vec_f(dout + (size_t)row * D + c * VEC, b);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s = fmaf(a[e], b[e], s);
  }
#pragma unroll
  for (int w = L / 2; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (row < rows && lane % L == 0) delta[row] = s;
}

// the Delta pass, which also zeroes nsem counters at sem (fewer than its
// threads: each row has at least two)
template <typename T, int D>
static void launch_delta(const void* o, const void* olo, const void* dout, float* delta,
                         int rows, int* sem, int nsem, cudaStream_t s) {
  constexpr int NCH = D / (16 / (int)sizeof(T));
  constexpr int L = NCH <= 2 ? 2 : NCH <= 4 ? 4 : NCH <= 8 ? 8 : NCH <= 16 ? 16 : 32;
  const int per_block = 8 * (32 / L);
  delta_kernel<T, D><<<(rows + per_block - 1) / per_block, 256, 0, s>>>(
      (const T*)o, (const T*)olo, (const T*)dout, delta, rows, sem, nsem);
}

// p and dS of one (query, key) pair, float32: s = q.k, dp = dO.v; lse in
// natural units; vis: the row attends the key; none: the row sees no key
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, float scale,
                                     float cap, bool vis, bool none, float& p, float& ds) {
  float x = s * scale, capf = 1.f;
  if (cap > 0.f) {
    const float th = tanhf(x / cap);
    x = cap * th;
    capf = 1.f - th * th;
  }
  if (none) x = 0.f;
  p = vis ? expf(x - lse) : 0.f;
  ds = vis && !none ? p * (dp - delta) * capf : 0.f;
}

// ------------------------------------------------------ float32: CUDA cores
constexpr int THREADS = 256;
constexpr int PS = 48;  // P / dS tile row stride (floats): 32 columns + 16

template <int D> struct F32 {
  static constexpr int QS = D + 4;  // row stride of the staged Q, dO, K, V (floats)
  static constexpr int NC = (D + 15) / 16;  // a thread's output columns tc + 16 c < D
  static __device__ __forceinline__ bool col(int tc, int c) { return D % 16 == 0 || tc + 16 * c < D; }
  // dQ: Q and dO (64 rows), K and V (32 rows), dS (64 x 32)
  static constexpr size_t dq_bytes = sizeof(float) * (2 * 64 * QS + 2 * 32 * QS + 64 * PS);
  // dK/dV: K and V (64 rows), Q and dO (32 rows), P and dS (64 x 32), lse and Delta (32)
  static constexpr size_t dkv_bytes =
      sizeof(float) * (2 * 64 * QS + 2 * 32 * QS + 2 * 64 * PS + 2 * 32);
};

// copy rows [r0, r0 + n) of a (rows, D) float32 matrix into a tile of row
// stride QS; rows past nrows are zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int n, int nrows) {
  constexpr int QS = F32<D>::QS;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * QS + c] = r0 + r < nrows ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Hq, int G, int Sq, int Skv, float scale, float cap,
              int causal) {
  constexpr int QS = F32<D>::QS, NC = F32<D>::NC;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sG = sQ + 64 * QS;
  float* sK = sG + 64 * QS;
  float* sV = sK + 32 * QS;
  float* sS = sV + 32 * QS;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int bh = blockIdx.y;  // b * Hq + hq
  const int bkv = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const int off = Skv - Sq;
  const int qrows = min(64, Sq - q0);
  const float* kp = k + (size_t)bkv * Skv * D;
  const float* vp = v + (size_t)bkv * Skv * D;
  stage<D>(sQ, q + (size_t)bh * Sq * D, q0, 64, Sq);
  stage<D>(sG, dout + (size_t)bh * Sq * D, q0, 64, Sq);
  float rl[4], rd[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    rl[i] = r < qrows ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
    rd[i] = r < qrows ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // rows that see no key give dS = 0: only the keys the tile's rows see
  const int kend = causal ? min(Skv, max(0, off + q0 + qrows)) : Skv;
  for (int k0 = 0; k0 < kend; k0 += 32) {
    __syncthreads();  // the previous tile's K and dS are consumed
    stage<D>(sK, kp, k0, 32, Skv);
    stage<D>(sV, vp, k0, 32, Skv);
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], gv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sQ + (tr + 16 * i) * QS + d);
        gv[i] = *reinterpret_cast<const float4*>(sG + (tr + 16 * i) * QS + d);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(sK + (tc + 16 * j) * QS + d);
        vv[j] = *reinterpret_cast<const float4*>(sV + (tc + 16 * j) * QS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = s[i][j], b = dp[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          b = fmaf(gv[i].x, vv[j].x, b);
          b = fmaf(gv[i].y, vv[j].y, b);
          b = fmaf(gv[i].z, vv[j].z, b);
          b = fmaf(gv[i].w, vv[j].w, b);
          s[i][j] = a;
          dp[i][j] = b;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = off + q0 + tr + 16 * i;
      const bool none = causal && qpos < 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tc + 16 * j;
        const bool vis = kpos < Skv && (!causal || none || kpos <= qpos);
        float p, ds;
        p_ds(s[i][j], dp[i][j], rl[i], rd[i], scale, cap, vis, none, p, ds);
        sS[(tr + 16 * i) * PS + tc + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < 32; kk += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(sS + (tr + 16 * i) * PS + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) kr[c] = F32<D>::col(tc, c) ? sK[(kk + t) * QS + tc + 16 * c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = t == 0 ? sv[i].x : t == 1 ? sv[i].y : t == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(x, kr[c], acc[i][c]);
        }
      }
    }
  }

  float* op = dq + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= qrows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (F32<D>::col(tc, c)) op[(size_t)r * D + tc + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int Hq, int G, int Sq, int Skv,
                float scale, float cap, int causal) {
  constexpr int QS = F32<D>::QS, NC = F32<D>::NC;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + 64 * QS;
  float* sQ = sV + 64 * QS;
  float* sG = sQ + 32 * QS;
  float* sP = sG + 32 * QS;
  float* sS = sP + 64 * PS;
  float* sL = sS + 64 * PS;
  float* sD = sL + 32;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * 64;
  const int bkv = blockIdx.y;  // b * Hkv + h
  const int Hkv = Hq / G, b = bkv / Hkv, h = bkv % Hkv;
  const int off = Skv - Sq;
  const int krows = min(64, Skv - k0);
  stage<D>(sK, k + (size_t)bkv * Skv * D, k0, 64, Skv);
  stage<D>(sV, v + (size_t)bkv * Skv * D, k0, 64, Skv);
  float ak[4][NC], av[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * Hq + h * G + g;
    for (int q0 = 0; q0 < Sq; q0 += 32) {
      // no row of this query tile sees these keys (and none sees no key)
      if (causal && off + q0 >= 0 && off + min(q0 + 31, Sq - 1) < k0) continue;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      stage<D>(sQ, q + bh * Sq * D, q0, 32, Sq);
      stage<D>(sG, dout + bh * Sq * D, q0, 32, Sq);
      if (tid < 32) {
        sL[tid] = q0 + tid < Sq ? lse[bh * Sq + q0 + tid] : 0.f;
        sD[tid] = q0 + tid < Sq ? delta[bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 kv[4], vv[4], qv[2], gv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = *reinterpret_cast<const float4*>(sK + (tr + 16 * i) * QS + d);
          vv[i] = *reinterpret_cast<const float4*>(sV + (tr + 16 * i) * QS + d);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = *reinterpret_cast<const float4*>(sQ + (tc + 16 * j) * QS + d);
          gv[j] = *reinterpret_cast<const float4*>(sG + (tc + 16 * j) * QS + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float a = s[i][j], e = dp[i][j];
            a = fmaf(qv[j].x, kv[i].x, a);
            a = fmaf(qv[j].y, kv[i].y, a);
            a = fmaf(qv[j].z, kv[i].z, a);
            a = fmaf(qv[j].w, kv[i].w, a);
            e = fmaf(gv[j].x, vv[i].x, e);
            e = fmaf(gv[j].y, vv[i].y, e);
            e = fmaf(gv[j].z, vv[i].z, e);
            e = fmaf(gv[j].w, vv[i].w, e);
            s[i][j] = a;
            dp[i][j] = e;
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tc + 16 * j;
        const int qpos = off + q0 + c;
        const bool none = causal && qpos < 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + tr + 16 * i;
          const bool vis =
              q0 + c < Sq && kpos < Skv && (!causal || none || kpos <= qpos);
          float p, ds;
          p_ds(s[i][j], dp[i][j], sL[c], sD[c], scale, cap, vis, none, p, ds);
          sP[(tr + 16 * i) * PS + c] = p;
          sS[(tr + 16 * i) * PS + c] = ds;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < 32; qq += 4) {
        float4 pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = *reinterpret_cast<const float4*>(sP + (tr + 16 * i) * PS + qq);
          sv[i] = *reinterpret_cast<const float4*>(sS + (tr + 16 * i) * PS + qq);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float gr[NC], qr[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const bool in = F32<D>::col(tc, c);
            gr[c] = in ? sG[(qq + t) * QS + tc + 16 * c] : 0.f;
            qr[c] = in ? sQ[(qq + t) * QS + tc + 16 * c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
            const float y = t == 0 ? sv[i].x : t == 1 ? sv[i].y : t == 2 ? sv[i].z : sv[i].w;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              av[i][c] = fmaf(x, gr[c], av[i][c]);
              ak[i][c] = fmaf(y, qr[c], ak[i][c]);
            }
          }
        }
      }
    }
  }

  const size_t base = ((size_t)bkv * Skv + k0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= krows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!F32<D>::col(tc, c)) continue;
      dk[base + (size_t)r * D + tc + 16 * c] = ak[i][c] * scale;
      dv[base + (size_t)r * D + tc + 16 * c] = av[i][c];
    }
  }
}

// ------------------------------------------------------------ bf16: wgmma
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// the k16 A fragments of an m64n64 accumulator fragment as two bf16
// halves, f = hi + lo to about 16 bits: a gradient product over hi and lo
// keeps the float32 P and dS where one bf16 rounding (2^-9) does not hold
// the gradient to the bf16 tolerance of the plain version's
__device__ __forceinline__ void frag_split(const float* f, uint32_t (*hi)[4],
                                           uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = f[8 * kk + 2 * r], x1 = f[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = wg::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
}

// rows row0, row0 + 8 of an m64nW fragment of columns [col0, col0 + W)
template <int D, int W>
__device__ __forceinline__ void store_rows(bf16* dst, const float* acc, int row0, int nrows,
                                           float mul, int col0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const int c = col0 + 8 * n + 2 * tq;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D + c) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h] * mul, acc[4 * n + 2 * h + 1] * mul);
    }
  }
}

// x in base-2 units (log2 e times the capped logit) and dx/ds
__device__ __forceinline__ float logit2(float s, float scale, float sl2, float cap,
                                        float& capf) {
  if (cap > 0.f) {
    const float th = tanhf(s * scale / cap);
    capf = 1.f - th * th;
    return cap * th * wg::LOG2E;
  }
  capf = 1.f;
  return s * sl2;
}

// P^T and dS^T of an m64n64 tile of S^T and dP^T, in place: s[4 n + 2 h
// + e] is key k0 + row0 + 8 h, query q0 + 8 n + 2 tq + e; sL, sD the
// tile's lse and Delta. MASK: the causal, ragged and no-key masks apply
template <bool MASK>
__device__ __forceinline__ void p_ds_tile(float* s, float* dp, const float* sL, const float* sD,
                                          int q0, int k0, int row0, int tq, int off, int Sq,
                                          int Skv, int causal, float scale, float sl2,
                                          float cap) {
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * nn + 2 * tq + e;
      const int qpos = off + q0 + c;
      const bool none = MASK && causal && qpos < 0;
      const float lq = sL[c] * wg::LOG2E, dq_ = sD[c];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * nn + 2 * hh + e;
        const int kpos = k0 + row0 + 8 * hh;
        const bool vis =
            !MASK || (q0 + c < Sq && kpos < Skv && (!causal || none || kpos <= qpos));
        float capf = 1.f;
        const float x2 = none ? 0.f : logit2(s[i], scale, sl2, cap, capf);
        const float p = vis ? wg::ex2(x2 - lq) : 0.f;
        dp[i] = vis && !none ? p * (dp[i] - dq_) * capf : 0.f;
        s[i] = p;
      }
    }
}

template <int D> struct Bf16 {
  // D padded to whole 64-column blocks; D = 192 to 256, so that each of
  // two warpgroups owns 128 columns (a 96-column half would start inside
  // a 128-byte swizzle row): the last 64 columns are zeros, read by the
  // gradient products and never stored
  static constexpr int DP = D == 192 ? 256 : wg::Tile<D>::DP, TILE = 64 * DP * 2;
  // warpgroups a block: two at D = 192 and 256, each owning W = DP / NWG
  // columns of dK, dV and dQ (m64n128 accumulators, as at D = 128)
  static constexpr int NWG = DP > 128 ? 2 : 1, NT = 128 * NWG, W = DP / NWG;
  // K, V and two stages of (Q, dO); dS^T (64 x 64 bf16); two stages of
  // (lse, Delta) of 64 floats each; slack to align the tiles to 1 KB
  static constexpr size_t bytes = 6 * (size_t)TILE + 8192 + 2 * 512 + 1024;
};

// dS^T into shared memory as bf16, rounded once (the hi half): keys are
// its rows, 64 queries a 128-byte row in the swizzle, the MN-major A
// operand of dQ = dS K. sh[kk][r] holds columns 8 (2 kk + r / 2) + 2 tq,
// + 1 of key row row0 + 8 (r % 2)
__device__ __forceinline__ void store_ds(uint8_t* pDS, uint32_t (*sh)[4], int row0,
                                         int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1), nn = 2 * kk + (r >> 1);
      *reinterpret_cast<uint32_t*>(pDS + row * 128 + ((nn ^ (row & 7)) << 4) + 4 * tq) =
          sh[kk][r];
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// hold the bf16 A-operand registers of an in-flight wgmma live up to here
__device__ __forceinline__ void keep(uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile("" ::"r"(a[kk][0]), "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// One kernel for dK, dV and dQ. A unit of work is a (b * Hkv + kv head,
// 64-key tile): a cluster of C blocks takes it, block r walking query heads
// [r G / C, (r + 1) G / C) of the kv head over the query tiles that see the
// keys; the dK / dV sum over the cluster is as before. Units are handed
// out in ticket order (an atomic counter), so any unit a block waits for
// was handed to a block that is already running.
template <int D>
__global__ void __launch_bounds__(Bf16<D>::NT)
bwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ dq_acc, int* __restrict__ sem, int Hq, int G, int Sq,
                 int Skv, float scale, float cap, int causal, int n_bkv) {
  using namespace wg;
  constexpr int DP = Bf16<D>::DP, TILE = Bf16<D>::TILE;
  constexpr int NT = Bf16<D>::NT, W = Bf16<D>::W;
  constexpr int NKS = (D + 15) / 16;  // k16 steps of S^T and dP^T (over all of D)
  constexpr int NO = W / 2;           // floats a thread of an m64nW fragment
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_unit;
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + TILE;
  // stage st: Q at sK + (2 + 2 st) TILE, dO one tile on; then dS^T, then
  // lse and Delta
  const uint32_t sDS = sK + 6 * TILE;
  const uint32_t sLD = sDS + 8192;
  const float* fLD = reinterpret_cast<const float*>(smem_raw + (sLD - smem_u32(smem_raw)));
  uint8_t* pDS = smem_raw + (sDS - smem_u32(smem_raw));

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, tq = lane & 3;
  // this warpgroup's columns [col0, col0 + W) of dK, dV and dQ: 8 KB column
  // blocks from cb of the tiles
  const int col0 = (tid >> 7) * W;
  const uint32_t cb = (uint32_t)col0 / 64 * (64 * 128);
  const int C = gridDim.z;
  const int nq = (Sq + BR - 1) / BR, nkv = (Skv + BN - 1) / BN;
  const int ticket = n_bkv / (Hq / G) * Hq * nq;  // index of the ticket counter in sem
  cg::cluster_group cluster = cg::this_cluster();
  if (tid == 0 && (C == 1 || cluster.block_rank() == 0)) s_unit = atomicAdd(sem + ticket, 1);
  int unit;
  if (C > 1) {
    cluster.sync();
    unit = *cluster.map_shared_rank(&s_unit, 0);
  } else {
    __syncthreads();
    unit = s_unit;
  }
  const int n = unit / n_bkv, bkv = unit % n_bkv;  // key tile major: heavy causal tiles first
  const int k0 = n * BN;
  const int Hkv = Hq / G, b = bkv / Hkv, h = bkv % Hkv;
  const int off = Skv - Sq;
  const int krows = min(BN, Skv - k0);
  const bool do_kv = dk != nullptr, do_q = dq != nullptr;
  // query tiles that see these keys: [0, n_none) holds the rows that see
  // no key (causal, off < 0), [t_first, nq) the rows at or past key k0
  const int n_none = causal && off < 0 ? (min(-off, Sq) + BR - 1) / BR : 0;
  auto t_first = [&](int kt) {
    const int kk = kt * BN;
    return !causal ? 0 : kk - off <= 0 ? 0 : min(nq, (kk - off) / BR);
  };
  const int lo = max(t_first(n), n_none);
  const int m = n_none + (nq - lo);  // tiles a query head walks
  // this block's query heads: the C blocks of a cluster share them
  const int gpb = G / C, g0 = (C > 1 ? (int)cluster.block_rank() : 0) * gpb;
  const int total = gpb * m;

  // the it-th step's query tile and head: the tiles of rows that see no
  // key first, then the others from the last down to the diagonal, the
  // block's heads inner. Key tile n - 1 walks the same tiles at the same
  // steps plus one more first, so the turn it hands on is a step ahead
  auto tile_of = [&](int it) {
    const int u = it / gpb;
    return u < n_none ? u : nq - 1 - (u - n_none);
  };
  auto load_q = [&](int it, int st) {  // the it-th (head, query tile) into stage st
    const int g = g0 + it % gpb;
    const int qt0 = tile_of(it) * BR;
    const size_t bh = (size_t)b * Hq + h * G + g;
    const uint32_t dst = sK + TILE * (2 + 2 * st);
    load_tile<D, DP, NT>(dst, q + bh * Sq * D, qt0, Sq);
    load_tile<D, DP, NT>(dst + TILE, dout + bh * Sq * D, qt0, Sq);
    if (tid < 128) {
      const int t = tid & 63;
      const float* src = (tid < 64 ? lse : delta) + bh * Sq + qt0 + t;
      cp_async4(sLD + st * 512 + tid * 4, qt0 + t < Sq ? src : lse, qt0 + t < Sq);
    }
  };

  load_tile<D, DP, NT>(sK, k + (size_t)bkv * Skv * D, k0, Skv);
  load_tile<D, DP, NT>(sV, v + (size_t)bkv * Skv * D, k0, Skv);
  if (total > 0) load_q(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int row0 = warp * 16 + (lane >> 2);  // keys row0, row0 + 8 of the tile
  float ak[NO], av[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) ak[i] = av[i] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    const int g = g0 + it % gpb;
    const int mt = tile_of(it);
    const int q0 = mt * BR;
    // this step's dQ turn, read now (relaxed) so its round trip is over by
    // the dQ section; seen == n there is made an acquire by a fence
    int* turn = sem + ((size_t)b * Hq + h * G + g) * nq + mt;
    const int seen = do_q && n > 0 && tid == 0 ? ld_relaxed(turn) : 0;
    const uint32_t sQ = sK + TILE * (2 + 2 * st), sG = sQ + TILE;
    const float* sL = fLD + st * 128;
    const float* sD = sL + 64;
    if (it + 1 < total) load_q(it + 1, st ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries; each
    // warpgroup forms both over all of D (at D = 256 the second one repeats
    // the first's: exchanging half-D sums would cost a barrier a product)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin<32>(s);
    pin<32>(dp);
    fence();
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      const uint32_t o8 = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, desc(sK + o8, 16, 1024), desc(sQ + o8, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      const uint32_t o8 = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_m64n64k16_ss(dp, desc(sV + o8, 16, 1024), desc(sG + o8, 16, 1024), kk > 0);
    }
    commit();
    wait0();
    pin<32>(s);
    pin<32>(dp);

    // P^T and dS^T in place of S^T and dP^T; a tile whose every key is
    // visible to every row skips the masks
    if (q0 + BR <= Sq && k0 + BN <= Skv &&
        (!causal || (off + q0 >= 0 && k0 + BN - 1 <= off + q0)))
      p_ds_tile<false>(s, dp, sL, sD, q0, k0, row0, tq, off, Sq, Skv, causal, scale, sl2, cap);
    else
      p_ds_tile<true>(s, dp, sL, sD, q0, k0, row0, tq, off, Sq, Skv, causal, scale, sl2, cap);

    // dV += P^T dO, then dK += dS^T Q, the A operands (hi and lo halves)
    // from registers; dS^T goes to shared memory while dK's products run.
    // Each group is issued and waited in one block, and nothing defines a
    // register of the next group while one is in flight: ptxas serializes
    // or waits otherwise (C7513, C7517)
    uint32_t sh[4][4], sl[4][4];
    if (do_kv) {
      uint32_t ph[4][4], pl[4][4];
      frag_split(s, ph, pl);
      pin<NO>(av);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pv<W>(av, ph[kk], desc(sG + cb + kk * 2048, 64 * 128, 1024));
        pv<W>(av, pl[kk], desc(sG + cb + kk * 2048, 64 * 128, 1024));
      }
      commit();
      wait0();
      keep(ph);
      keep(pl);
      pin<NO>(av);
      frag_split(dp, sh, sl);
      pin<NO>(ak);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pv<W>(ak, sh[kk], desc(sQ + cb + kk * 2048, 64 * 128, 1024));
        pv<W>(ak, sl[kk], desc(sQ + cb + kk * 2048, 64 * 128, 1024));
      }
      commit();
      if (do_q && col0 == 0) store_ds(pDS, sh, row0, tq);  // the same in every warpgroup
      wait0();
      keep(sh);
      keep(sl);
      pin<NO>(ak);
    } else {
      frag_split(dp, sh, sl);
      if (col0 == 0) store_ds(pDS, sh, row0, tq);
    }
    if (do_q) {
      __syncthreads();  // every warp's dS^T is in shared memory
      // dQ's share of this key tile: dS K, dS^T and K both MN-major
      float acc[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.f;
      pin<NO>(acc);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mm_tt<W>(acc, desc(sDS + kk * 2048, 64 * 128, 1024),
                 desc(sK + cb + kk * 2048, 64 * 128, 1024), kk > 0);
      commit();
      wait0();
      pin<NO>(acc);

      // added to the (head, query tile)'s float32 sum in key tile order:
      // the tiles that walk query tile mt are 0 .. n_last, key tile n
      // waits for its turn (the counter equal to n); tile 0 stores, the
      // others add (bulk, by the TMA), and tile n_last reads the sum and
      // writes dq = scale x sum in bf16
      int n_last = nkv - 1;
      if (mt >= n_none)
        while (n_last > 0 && t_first(n_last) > mt) --n_last;
      const size_t bh = (size_t)b * Hq + h * G + g;
      if (n != n_last) {
        // the share goes to this stage's Q and dO tiles, free now (64 x DP
        // floats, the workspace's order: float4 i of thread tid at i NT +
        // tid), for the TMA
        float4* stg = reinterpret_cast<float4*>(smem_raw + (sQ - smem_u32(smem_raw))) + tid;
#pragma unroll
        for (int i = 0; i < NO / 4; ++i)
          stg[i * NT] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      if (tid == 0 && n > 0) {
        if (seen == n)
          asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
        else
          while (ld_acquire(turn) != n) __nanosleep(32);
      }
      __syncthreads();  // the turn is ours, and the share is in shared memory
      if (n == n_last) {
        if (n > 0) {
          const float4* ws =
              reinterpret_cast<const float4*>(dq_acc + (bh * nq + mt) * (size_t)(64 * DP)) + tid;
#pragma unroll
          for (int i = 0; i < NO / 4; ++i) {
            const float4 w = __ldcg(ws + i * NT);
            acc[4 * i] += w.x;
            acc[4 * i + 1] += w.y;
            acc[4 * i + 2] += w.z;
            acc[4 * i + 3] += w.w;
          }
        }
        store_rows<D, W>(dq + (bh * Sq + q0) * D, acc, row0, min(BR, Sq - q0), scale, col0);
      } else {
        // one thread hands the share to the TMA: a bulk store for tile 0, a
        // bulk add (reduced in L2) after it
        if (tid == 0) {
          const uint32_t src = sQ;
          float* dst = dq_acc + (bh * nq + mt) * (size_t)(64 * DP);
          if (n == 0)
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                         "r"(src), "r"(64 * DP * 4)
                         : "memory");
          else
            asm volatile(
                "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                    dst),
                "r"(src), "r"(64 * DP * 4)
                : "memory");
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          // turn n + 1 once the add is done (and the stage read out)
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          st_release(turn, n + 1);
        }
      }
    }
    __syncthreads();  // stage st and dS^T are free for the tile after next
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!do_kv) {
    if (C > 1) cluster.sync();  // rank 0's ticket stays readable until all have read it
    return;
  }
  const size_t base = ((size_t)bkv * Skv + k0) * D;
  if (C == 1) {
    store_rows<D, W>(dk + base, ak, row0, krows, scale, col0);
    store_rows<D, W>(dv + base, av, row0, krows, 1.f, col0);
    return;
  }
  // the cluster's blocks sum their dK and dV over their heads through
  // distributed shared memory, in rank order: each stores its two float32
  // (64, DP) fragments where the tiles were, then block r writes elements
  // r * NT + tid, r * NT + tid + NT C, ... of the (krows, D) outputs
  __syncthreads();  // every wgmma and copy into the tiles is done
  float* red = reinterpret_cast<float*>(smem_raw + (sK - smem_u32(smem_raw)));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int nn = 0; nn < W / 8; ++nn) {
      const int idx = (row0 + 8 * hh) * DP + col0 + 8 * nn + 2 * tq;
      *reinterpret_cast<float2*>(red + idx) =
          make_float2(ak[4 * nn + 2 * hh], ak[4 * nn + 2 * hh + 1]);
      *reinterpret_cast<float2*>(red + 64 * DP + idx) =
          make_float2(av[4 * nn + 2 * hh], av[4 * nn + 2 * hh + 1]);
    }
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * NT + tid; i < krows * D; i += C * NT) {
    const int r = i / D, c = i - r * D;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < C; ++j) {
      const float* pr = cluster.map_shared_rank(red, j);
      sk += pr[r * DP + c];
      sv += pr[64 * DP + r * DP + c];
    }
    dk[base + i] = __float2bfloat16(sk * scale);
    dv[base + i] = __float2bfloat16(sv);
  }
  cluster.sync();  // every block's sums stay readable until all have read them
}

// Lift the kernel's dynamic shared-memory cap, then launch it, in
// clusters of (1, 1, cz) blocks when cz > 1.
template <typename... P, typename... A>
static int run(void (*kernel)(P...), size_t smem, dim3 grid, int threads, cudaStream_t s,
               int cz, A... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cfg.attrs = attr;
  cfg.numAttrs = cz > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int D>
static int launch_f32(const BwdArgs* a, cudaStream_t s) {
  const int G = a->Hq / a->Hkv;
  launch_delta<float, D>(a->o, nullptr, a->dout, a->delta, a->B * a->Hq * a->Sq, nullptr, 0,
                         s);
  int e = (int)cudaGetLastError();
  if (e == 0 && a->dk != nullptr)
    e = run(dkdv_f32_kernel<D>, F32<D>::dkv_bytes, dim3((a->Skv + 63) / 64, a->B * a->Hkv),
            THREADS, s, 1, (const float*)a->q, (const float*)a->k, (const float*)a->v,
            (const float*)a->dout, a->lse, (const float*)a->delta, (float*)a->dk,
            (float*)a->dv, a->Hq, G, a->Sq, a->Skv, a->scale, a->cap, a->causal);
  if (e == 0 && a->dq != nullptr)
    e = run(dq_f32_kernel<D>, F32<D>::dq_bytes, dim3((a->Sq + 63) / 64, a->B * a->Hq),
            THREADS, s, 1, (const float*)a->q, (const float*)a->k, (const float*)a->v,
            (const float*)a->dout, a->lse, (const float*)a->delta, (float*)a->dq, a->Hq, G,
            a->Sq, a->Skv, a->scale, a->cap, a->causal);
  return e;
}

template <int D>
static int launch_bf16(const BwdArgs* a, cudaStream_t s) {
  const int G = a->Hq / a->Hkv;
  const int nq = (a->Sq + wg::BR - 1) / wg::BR, nkv = (a->Skv + wg::BN - 1) / wg::BN;
  launch_delta<bf16, D>(a->o, a->olo, a->dout, a->delta, a->B * a->Hq * a->Sq, a->sem,
                        a->B * a->Hq * nq + 1, s);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  // a cluster of C blocks shares each kv head's G query heads: the
  // largest C <= 8 (the portable cluster size) that divides G
  int C = 1;
  for (int c = 2; c <= 8; ++c)
    if (G % c == 0) C = c;
  return run(bwd_wgmma_kernel<D>, Bf16<D>::bytes, dim3(a->B * a->Hkv, nkv, C), Bf16<D>::NT, s, C,
             (const bf16*)a->q, (const bf16*)a->k, (const bf16*)a->v, (const bf16*)a->dout,
             a->lse, (const float*)a->delta, (bf16*)a->dq, (bf16*)a->dk, (bf16*)a->dv,
             a->dq_acc, a->sem, a->Hq, G, a->Sq, a->Skv, a->scale, a->cap, a->causal,
             a->B * a->Hkv);
}

}  // namespace

// dtype code of q, k, v, out, dout and the gradients: 0 = float32 (CUDA
// cores), 1 = bfloat16 (wgmma). lse is the forward's (natural units);
// delta is a (B, Hq, Sq) float32 workspace. dq may be null (no query
// gradient wanted); dk and dv are both given or both null. The bf16 body
// also takes sem (B * Hq * ceil(Sq / 64) + 1 ints, zeroed here) and, with
// dq, dq_acc (B * Hq * ceil(Sq / 64) * 64 * DP floats, DP = Bf16<D>::DP). Returns the first
// launch error, or cudaErrorInvalidValue for a head dim, type, shape or
// grid the kernel does not take.
extern "C" int flash_attention_bwd_launch(const BwdArgs* a) {
  if (a->Hkv <= 0 || a->Hq % a->Hkv != 0 || a->B <= 0 || (long long)a->B * a->Hq > 65535 ||
      a->Sq <= 0 || a->Skv <= 0 || (a->dtype != 0 && a->dtype != 1) ||
      (a->dk == nullptr) != (a->dv == nullptr) || (a->dq == nullptr && a->dk == nullptr) ||
      (a->D != 8 && a->D != 16 && a->D != 24 && a->D != 64 && a->D != 112 && a->D != 128 &&
       a->D != 192 && a->D != 256) ||
      (a->dtype == 1 && (a->sem == nullptr || (a->dq != nullptr && a->dq_acc == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)a->stream;
  switch (a->D) {
    case 8: return a->dtype == 0 ? launch_f32<8>(a, s) : launch_bf16<8>(a, s);
    case 16: return a->dtype == 0 ? launch_f32<16>(a, s) : launch_bf16<16>(a, s);
    case 24: return a->dtype == 0 ? launch_f32<24>(a, s) : launch_bf16<24>(a, s);
    case 64: return a->dtype == 0 ? launch_f32<64>(a, s) : launch_bf16<64>(a, s);
    case 112: return a->dtype == 0 ? launch_f32<112>(a, s) : launch_bf16<112>(a, s);
    case 128: return a->dtype == 0 ? launch_f32<128>(a, s) : launch_bf16<128>(a, s);
    case 192: return a->dtype == 0 ? launch_f32<192>(a, s) : launch_bf16<192>(a, s);
    default: return a->dtype == 0 ? launch_f32<256>(a, s) : launch_bf16<256>(a, s);
  }
}
