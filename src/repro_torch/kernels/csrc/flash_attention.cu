// Blocked GQA flash attention (causal or not, optional logit soft cap) for
// Hopper (sm_90a), bound with ctypes: two bodies, chosen by dtype alone.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel). It computes what that kernel computes:
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D) in q's
//   type; query head hq reads kv head hq / (Hq / Hkv); s = scale q.k, then
//   cap tanh(s / cap) when cap > 0, then the causal mask, with query row i
//   at absolute position i + (Skv - Sq); out = acc / max(l, 1e-30).
// Unlike the Pallas kernel, which asserts that Sq and Skv divide its
// blocks, this one masks the ragged tail of both axes: training feeds
// T = seq - 1 positions. Causal calls may have Skv < Sq: a row that sees
// no key (i + Skv - Sq < 0) outputs the mean of V over all Skv keys, as
// the plain version and the JAX package's reference do (every logit of
// such a row is the mask value, so its softmax is uniform).
//
// What bounds it on the card: operations. A call does 4 D flops per
// (query, visible key) pair -- two products, q.k and p.v -- on
// (2 Sq Hq + 2 Skv Hkv) D elements. At the training shape (2, 32/8, 1023,
// 128) that is 17.2 GFLOP on 42 MB: ~17 us at the bf16 tensor-core peak
// against ~13 us of bytes.
//
// Body 1, float32 (fa_kernel): CUDA-core fmas, exact float32, since the
// card-vs-CPU training of the small float32 model needs float32 attention
// (TF32 keeps about three digits). 67 TFLOP/s peak, so >= 0.26 ms at the
// training shape:
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
//  * Q and K rows are padded to D + 4 floats and read as float4, the P
//    tile to 48 floats, so every shared-memory access is free of bank
//    conflicts; ~79 KB of dynamic shared memory at D = 128 (two blocks per
//    SM), 109.5 KB at D = 192 (two), 141.5 KB at D = 256 (one), above the
//    48 KB static limit, so each
//    instantiation lifts its cap once
//    (cudaFuncAttributeMaxDynamicSharedMemorySize); at D = 8 a thread's
//    output column tc + 16 c exists for tc < 8 only.
//
// Body 2, bfloat16 (fa_wgmma_kernel): both products on the tensor cores.
//  * one warpgroup (128 threads) per (64 query rows, b * Hq + hq): 64 rows
//    is one wgmma M. Grid (B * Hq, query tiles), the heaviest causal tiles
//    in the first wave (blockIdx.y = 0 is the last tile). At the prefill
//    shape (1, 32/8, 250) that is 128 blocks on 132 SMs; at the training
//    shape 1024 blocks, two resident a SM;
//  * Q (64 rows) and a ring of two stages of K and V tiles of 64 keys
//    live in shared memory as bf16 in the 128-byte swizzle (16-byte chunk
//    c of row r at chunk c ^ (r % 8) of its 128-byte row), as D / 64
//    column blocks of 64 values. D = 112 is padded to 128, D = 24, 16 and 8
//    to 64, with zero columns that are never stored (D = 8 takes one k16
//    step of Q K^T over 8 zero columns, D = 24 two steps, the second over
//    8 values and 8 zeros: wgmma's reduction is 16 deep). MLA's D = 192 is
//    three column blocks, no pad (a row is 24 chunks, which do not divide
//    the 128 threads: wgmma.cuh's load_tile then deals the tile's chunks
//    out in row-major order). cp.async copies 16 bytes a thread, its
//    zero-fill form covering rows past Sq or Skv and the pad; tile j + 1
//    is in flight while tile j is computed. 81 KB at D = 128; 121 KB at
//    D = 192 and 161 KB at D = 256, so one block an SM at both (two would
//    need 242 KB of the SM's 228);
//  * S = Q K^T is wgmma m64n64k16 with Q and K read from shared memory,
//    both K-major (D contiguous): descriptor SBO 1024 B between 8-row
//    groups, the k-step advancing 32 B within the swizzled row (12 k16
//    steps at D = 192);
//  * the online softmax runs on S's accumulator fragment in registers, in
//    float32 and base 2: a thread holds rows r and r + 8 of its warp's 16,
//    and the four lanes that share a row reduce its max with two shuffles
//    (the row sum is reduced once, at the end);
//  * O += P V is wgmma m64nDPk16 with P from registers (m64n192 at D =
//    192, 96 accumulator floats a thread; at D = 256 two m64n128 products
//    over V's column halves, 128 floats, beside S's 32): the m64n64 f32
//    accumulator fragment of S maps onto four k16 A fragments (keys
//    16 kk .. 16 kk + 15 are S's n8 blocks 2 kk and 2 kk + 1), so P is
//    rounded to bf16 and packed in place. V is the B operand with the
//    reduction over keys, MN-major (D contiguous, transpose flag set):
//    LBO is the stride between 64-wide column blocks, SBO 1024 B between
//    8-key groups. The JAX kernel and the plain version keep P in float32:
//    rounding it to bf16 (relative error <= 2^-9 a term, the row sum l
//    taken over the unrounded p) stays well inside the bf16 tolerance of
//    atol 1e-2 + rtol 1.6e-2;
//  * tiles where no key can be masked skip the mask arithmetic (one FFMA
//    and one ex2 a score), and O is rescaled only when a row max moved:
//    the CUDA-core softmax, not the tensor cores, bounded a first version.
// Both bodies:
//  * when asked (autograd records the call), write the float32
//    log-sum-exp of each row's logits, in natural units (ln), for the
//    backward kernel (flash_attention_bwd.cu): m + log l, the wgmma body's
//    base-2 (m, l) converted; a row that sees no key gets log(Skv). The
//    bf16 body then also writes out's rounding remainder (olo, bf16);
//  * masked entries get p = 0 explicitly, never exp(-1e30 - m): while a
//    row's max is still the -1e30 sentinel, exp(s - m) of a masked s
//    would be 1 (the key tail of every ragged row hits this);
//  * tiles above the offset diagonal are skipped (but for a tile with a
//    row that sees no key, which reads all Skv keys).
// D is a template parameter (compile-time trip counts, no guarded
// register loops), built for 8 (deepseek-67b's smoke), 16 (the other
// smoke configs), 24 (deepseek-v2-lite's smoke MLA), 112 (zamba2's shared
// block), 128 (minitron-8b, granite-20b, deepseek-67b, grok-1), 192
// (deepseek-v2-lite's MLA: qk_nope 128 + qk_rope 64, V zero-padded to it)
// and 256 (gemma-7b); another D fails at launch with
// cudaErrorInvalidValue. The backward (flash_attention_bwd.cu) is not
// built for 24 or 192: the wrapper refuses a gradient there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

#define THREADS 256
#define BQ 64           // query rows per block
#define BK 32           // keys per tile
#define NJ (BK / 16)    // score columns per thread
#define PS (BK + 16)    // P tile row stride (floats)

// the CUDA-core body is instantiated for float only (bf16 takes the wgmma body)
template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <int D> struct Smem {
  static constexpr int QS = D + 4;  // Q and K row stride (floats)
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * D + (size_t)BQ * PS);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int Hq, int G, int Sq, int Skv,
          float scale, float cap, int causal) {
  constexpr int QS = Smem<D>::QS;
  constexpr int NC = (D + 15) / 16;  // output columns per thread (tc + 16 c < D)
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

  // keys past the last one this tile's last query sees are never loaded;
  // a tile with a row that sees no key (off + q0 < 0) reads all of them
  const int kend = causal && off + q0 >= 0 ? min(Skv, off + q0 + qrows) : Skv;
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
      const bool none = causal && qpos < 0;  // sees no key: V's mean over all keys
      bool ok[NJ];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        s[i][j] = none ? 0.f : x;
        ok[j] = kpos < Skv && (!causal || none || kpos <= qpos);
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
        for (int c = 0; c < NC; ++c)
          vv[c] = D % 16 == 0 || tc + 16 * c < D ? sV[(kk + t) * D + tc + 16 * c] : 0.f;
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
    for (int c = 0; c < NC; ++c)
      if (D % 16 == 0 || tc + 16 * c < D)
        op[(size_t)r * D + tc + 16 * c] = from_f<T>(acc[i][c] / den);
    if (lse != nullptr && tc == 0) lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(l[i]);
  }
}

// Lift each instantiation's dynamic shared-memory cap once, then launch it.
template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int Hq, int Hkv, int Sq, int Skv, float scale, float cap, int causal,
                  cudaStream_t s) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  fa_kernel<T, D><<<grid, THREADS, Smem<D>::bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Hq, Hq / Hkv, Sq, Skv, scale,
      cap, causal);
  return (int)cudaGetLastError();
}

namespace wg {

template <int D> struct Geo {
  static constexpr int DP = Tile<D>::DP;         // padded width in shared memory
  static constexpr int TILE = Tile<D>::BYTES;    // bytes of a 64-row tile
  static constexpr size_t bytes = 5 * (size_t)TILE + 1024;  // Q, 2 x (K, V), alignment
};

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(128)
fa_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, __nv_bfloat16* __restrict__ olo, int Hq, int G, int Sq,
                int Skv, float scale, float cap, int causal) {
  using namespace wg;
  constexpr int DP = Geo<D>::DP, TILE = Geo<D>::TILE;
  constexpr int NKS = (D + 15) / 16;  // k-steps of Q K^T (the pad past them is skipped)
  constexpr int NO = DP / 2;    // O fragment floats a thread (m64nDP)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int bh = blockIdx.x;  // b * Hq + hq
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int bkv = (bh / Hq) * (Hq / G) + (bh % Hq) / G;
  const int off = Skv - Sq;
  const int qrows = min(BR, Sq - q0);
  const __nv_bfloat16* kp = k + (size_t)bkv * Skv * D;
  const __nv_bfloat16* vp = v + (size_t)bkv * Skv * D;
  const int kend = causal && off + q0 >= 0 ? min(Skv, off + q0 + qrows) : Skv;
  const int nt = (kend + BN - 1) / BN;

  load_tile<D, DP>(sQ, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<D, DP>(sQ + TILE, kp, 0, Skv);
  load_tile<D, DP>(sQ + 2 * TILE, vp, 0, Skv);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // rows of this thread in the tile: warp * 16 + lane / 4 (+ 8)
  const int row0 = warp * 16 + (lane >> 2);
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BN;
    const uint32_t sK = sQ + TILE * (1 + 2 * (j & 1)), sV = sK + TILE;
    if (j + 1 < nt) {  // the next tile into the other stage, freed at the end of j - 1
      const uint32_t nK = sQ + TILE * (1 + 2 * ((j + 1) & 1));
      load_tile<D, DP>(nK, kp, k0 + BN, Skv);
      load_tile<D, DP>(nK + TILE, vp, k0 + BN, Skv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");          // tile j has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin<32>(s);
    fence();
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      const uint32_t o8 = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, desc(sQ + o8, 16, 1024), desc(sK + o8, 16, 1024), kk > 0);
    }
    commit();
    wait0();
    pin<32>(s);

    // online softmax in base 2 on the fragment: s[4 n + 2 h + e] is row
    // row0 + 8 h, key k0 + 8 n + 2 tq + e
    const bool edge = k0 + BN > Skv || (causal && k0 + BN - 1 > off + q0);
    // every key visible, no cap: p = 2^(s sl2 - m), one FFMA and one ex2
    const bool fast = !edge && cap <= 0.f && sl2 > 0.f;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -1e30f;
      if (fast) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
        mx *= sl2;
      } else {
        const int qpos = off + q0 + row0 + 8 * h;
        const bool none = causal && qpos < 0;  // sees no key: V's mean over all keys
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * h + e;
            const int kpos = k0 + 8 * n + 2 * tq + e;
            float x = cap > 0.f ? cap * tanhf(s[i] * scale / cap) * LOG2E : s[i] * sl2;
            if (none) x = 0.f;
            // masked entries: the sentinel here, p = 0 explicitly below
            if (!(kpos < Skv && (!causal || none || kpos <= qpos))) x = -INFINITY;
            s[i] = x;
            mx = fmaxf(mx, x);
          }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[h], mx);
      alpha[h] = ex2(m[h] - mnew);
      float rs = 0.f;
      if (fast) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * h + e;
            s[i] = ex2(fmaf(s[i], sl2, -mnew));
            rs += s[i];
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * h + e;
            s[i] = s[i] == -INFINITY ? 0.f : ex2(s[i] - mnew);
            rs += s[i];
          }
      }
      l[h] = l[h] * alpha[h] + rs;  // this lane's share of the row sum
      m[h] = mnew;
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row max moved: rescale O
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    }

    // O += P V: P's k16 fragments straight from S's accumulator fragment
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    pin<NO>(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv<DP>(acc, a[kk], desc(sV + kk * 2048, 64 * 128, 1024));
    commit();
    wait0();
    pin<NO>(acc);
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  const size_t obase = ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = l[h];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    const int r = row0 + 8 * h;
    if (r >= qrows) continue;
    if (lse != nullptr && tq == 0)  // m is in base 2: lse = (m + log2 l) ln 2
      lse[(size_t)bh * Sq + q0 + r] = (m[h] + log2f(ls)) * 0.6931471805599453f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = 8 * n + 2 * tq;
      if (c >= D) continue;
      const float x0 = acc[4 * n + 2 * h] * inv, x1 = acc[4 * n + 2 * h + 1] * inv;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const size_t at = obase + (size_t)r * D + c;
      *reinterpret_cast<__nv_bfloat162*>(o + at) = hi;
      if (olo != nullptr)  // what rounding to bf16 took off
        *reinterpret_cast<__nv_bfloat162*>(olo + at) =
            __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
    }
  }
}

template <int D>
static int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                       void* olo, int B, int Hq, int Hkv, int Sq, int Skv, float scale,
                       float cap, int causal, cudaStream_t s) {
  constexpr size_t bytes = wg::Geo<D>::bytes;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid(B * Hq, (Sq + wg::BR - 1) / wg::BR);
  fa_wgmma_kernel<D><<<grid, 128, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, (__nv_bfloat16*)olo, Hq, Hq / Hkv, Sq, Skv, scale, cap, causal);
  return (int)cudaGetLastError();
}

// dtype code of q, k, v and out: 0 = float32 (CUDA-core body), 1 =
// bfloat16 (wgmma body). lse, when not null, receives the (B, Hq, Sq)
// float32 log-sum-exp of each row's logits in natural units (ln), for
// the backward kernel; a row that sees no key gets log(Skv), the
// log-sum-exp of the zero logits it is given. olo, when not null (bf16
// only), receives out's rounding remainder: the float32 output is out +
// olo to about 16 bits, which the backward's Delta = rowsum(dO o O)
// needs (from the rounded out alone, the gradient missed the bf16
// tolerance). Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// head dim, type or grid the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, void* olo, int B, int Hq, int Hkv, int Sq,
                                      int Skv, int D, float scale, float cap, int causal,
                                      int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535 || Sq <= 0 || Skv <= 0 ||
      (dtype != 0 && dtype != 1) || (dtype == 0 && olo != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s
#define ARGS_BF16 q, k, v, o, lse, olo, B, Hq, Hkv, Sq, Skv, scale, cap, causal, s
  switch (D) {
    case 8: return dtype == 0 ? launch<float, 8>(ARGS) : launch_bf16<8>(ARGS_BF16);
    case 16: return dtype == 0 ? launch<float, 16>(ARGS) : launch_bf16<16>(ARGS_BF16);
    case 24: return dtype == 0 ? launch<float, 24>(ARGS) : launch_bf16<24>(ARGS_BF16);
    case 112: return dtype == 0 ? launch<float, 112>(ARGS) : launch_bf16<112>(ARGS_BF16);
    case 128: return dtype == 0 ? launch<float, 128>(ARGS) : launch_bf16<128>(ARGS_BF16);
    case 192: return dtype == 0 ? launch<float, 192>(ARGS) : launch_bf16<192>(ARGS_BF16);
    case 256: return dtype == 0 ? launch<float, 256>(ARGS) : launch_bf16<256>(ARGS_BF16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS_BF16
#undef ARGS
}
