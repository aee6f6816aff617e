// Single-token decode attention for Hopper (sm_90a), bound with ctypes.
// One source, templated on the element type of q/out (float, bf16) and on
// the element type of the K/V pages (the same, or int8 / fp8 e4m3 codes
// with a float32 scale per (page, kv head, position)); K/V is addressed
// through a block table into a shared page pool. (The contiguous-cache
// decode kernel is decode_attention.cu.)
//
// Replaces:
//   src/repro/kernels/paged_attention.py::paged_attention
//     (Pallas bodies _paged_kernel and, for int8/fp8 pools,
//     _paged_kernel_quant)
//
// What bounds it on the card: bytes. A decode step does 4*D flops per live
// key per query head and reads 2*D elements of K/V per key per kv head:
// with G = Hq/Hkv = 4 query heads per kv head that is about 2 flop/byte in
// bf16, far below the H100's ridge of ~295 flop/byte. The least time is
// (live K/V bytes + q bytes + out bytes) / 3.35 TB/s.
//
// Design, aimed at reading each live K/V byte from device memory once:
//  * one block per (slot, kv head) handles the slot's whole G-head query
//    group, so a K/V tile loaded once serves all G heads;
//  * the block walks only the slot's live keys, in tiles of one page;
//    pages past kv_len - pos_offset, among
//    them the trash page 0 that pads an active slot's table row, are never
//    read (a parked slot, kv_len 1 on an all-zero row, reads one tile of
//    page 0, as the Pallas kernel does; the caller discards its output);
//  * each tile is staged in shared memory as fp32 with a padded row
//    (D + 1 floats), so the score and PV loops read it without bank
//    conflicts; scores, the online softmax (m, l) and the fp32 accumulator
//    stay on chip; the output is acc / max(l, 1e-30), as the Pallas kernel
//    writes it;
//  * quantized pools are dequantized while the tile is staged:
//    float(code) * scale[pid, h, pos], the same single product as the plain
//    version, so the pool is never widened in device memory and the staged
//    tile (and so the shared-memory layout) is the same fp32 tile as for an
//    unquantized pool. Scales are read only for live positions t < nvalid,
//    so a dead page's scales are never touched either.
// Known limits, left to later work: B*Hkv blocks (64 at the serving
// batch of 8) leave most of the 132 SMs idle -- the split over SMs of
// decode_attention.cu would fill them; loads are scalar, not 16-byte
// vectors, cp.async or TMA.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NEG_INF (-1e30f)
#define THREADS 128

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }
template <> __device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (B, Hq, 1, D); k, v are pools (P, Hkv, tile, D) and
// block_tables is (B, n_tiles_max); for KT other than T, ks and vs are the
// (P, Hkv, tile) float32 scales of the codes in k and v (null otherwise).
// s_cap is the number of addressable key positions per slot.
template <typename T, typename KT>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ block_tables, const int* __restrict__ kv_len,
    const int* __restrict__ pos_offset, T* __restrict__ out, int Hq, int Hkv, int D,
    int tile, int n_tiles_max, int s_cap, float scale, float soft_cap) {
  constexpr bool QUANT = !std::is_same<KT, T>::value;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int ld = D + 1;
  float* q_s = smem;              // G * D
  float* k_s = q_s + G * D;       // tile * ld
  float* v_s = k_s + tile * ld;   // tile * ld
  float* p_s = v_s + tile * ld;   // G * tile: scores, then probabilities
  float* acc = p_s + G * tile;    // G * D
  float* m_s = acc + G * D;       // G running max
  float* l_s = m_s + G;           // G running denominator
  float* a_s = l_s + G;           // G rescale factor of the current tile

  int len = kv_len[b] - pos_offset[b];
  len = min(len, s_cap);
  const int n_tiles = len > 0 ? (len + tile - 1) / tile : 0;

  const size_t qo = ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f(q[qo + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * tile;
    const int nvalid = min(tile, len - t0);
    const int pid = block_tables[(size_t)b * n_tiles_max + it];
    const size_t sbase = ((size_t)pid * Hkv + h) * (size_t)tile;
    const size_t base = sbase * D;
    for (int i = tid; i < tile * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      float kk = 0.f, vv = 0.f;
      if (t < nvalid) {
        kk = to_f(k[base + i]);
        vv = to_f(v[base + i]);
        if (QUANT) {
          kk *= ks[sbase + t];
          vv *= vs[sbase + t];
        }
      }
      k_s[t * ld + d] = kk;
      v_s[t * ld + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * tile; i += THREADS) {
      const int g = i / tile, t = i - g * tile;
      float s = NEG_INF;
      if (t < nvalid) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * ld;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, p_s[g * tile + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = expf(p_s[g * tile + t] - m_new);
        p_s[g * tile + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      const float* pr = p_s + g * tile;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < nvalid; ++t) a = fmaf(pr[t], v_s[t * ld + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    out[qo + i] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

static size_t smem_bytes(int G, int D, int tile) {
  return sizeof(float) * (size_t)(2 * G * D + 2 * tile * (D + 1) + G * tile + 3 * G);
}

template <typename T, typename KT>
static void launch_typed(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* bt, const void* kv_len,
                         const void* pos_offset, void* out, int B, int Hq, int Hkv, int D,
                         int tile, int n_tiles_max, int s_cap, float scale,
                         float soft_cap, cudaStream_t s) {
  const size_t smem = smem_bytes(Hq / Hkv, D, tile);
  decode_attn_kernel<T, KT><<<B * Hkv, THREADS, smem, s>>>(
      (const T*)q, (const KT*)k, (const KT*)v, (const float*)ks, (const float*)vs,
      (const int*)bt, (const int*)kv_len, (const int*)pos_offset, (T*)out, Hq, Hkv, D,
      tile, n_tiles_max, s_cap, scale, soft_cap);
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, out and unquantized pages);
// kv codes: 0 = pages in q's dtype, 2 = int8, 3 = float8 e4m3.
static int launch(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* bt, const void* kv_len,
                  const void* pos_offset, void* out, int B, int Hq, int Hkv, int D,
                  int tile, int n_tiles_max, int s_cap, float scale, float soft_cap,
                  int dtype, int kv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS q, k, v, ks, vs, bt, kv_len, pos_offset, out, B, Hq, Hkv, D, tile, \
             n_tiles_max, s_cap, scale, soft_cap, s
  if (dtype == 0 && kv == 0)
    launch_typed<float, float>(ARGS);
  else if (dtype == 1 && kv == 0)
    launch_typed<__nv_bfloat16, __nv_bfloat16>(ARGS);
  else if (dtype == 0 && kv == 2)
    launch_typed<float, int8_t>(ARGS);
  else if (dtype == 1 && kv == 2)
    launch_typed<__nv_bfloat16, int8_t>(ARGS);
  else if (dtype == 0 && kv == 3)
    launch_typed<float, __nv_fp8_e4m3>(ARGS);
  else if (dtype == 1 && kv == 3)
    launch_typed<__nv_bfloat16, __nv_fp8_e4m3>(ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef ARGS
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError().
// k_pages, v_pages hold elements of q's dtype (kv = 0; k_scales and v_scales
// null), or int8 (kv = 2) or float8 e4m3 (kv = 3) codes whose (P, Hkv, page)
// float32 scales are k_scales, v_scales.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scales,
                                      const void* v_scales, const void* block_tables,
                                      const void* kv_len, const void* pos_offset,
                                      void* out, int B, int Hq, int Hkv, int D, int page,
                                      int n_pages, float scale, float soft_cap, int dtype,
                                      int kv, void* stream) {
  if ((kv != 0) != (k_scales != nullptr) || (kv != 0) != (v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(q, k_pages, v_pages, k_scales, v_scales, block_tables, kv_len, pos_offset,
                out, B, Hq, Hkv, D, page, n_pages, n_pages * page, scale, soft_cap, dtype, kv,
                stream);
}

extern "C" size_t attention_smem_bytes(int G, int D, int tile) {
  return smem_bytes(G, D, tile);
}
