// Single-token decode attention for Hopper (sm_90a), bound with ctypes.
// One source, templated on the element type (float, bf16) and on how K/V
// is addressed: through a block table into a shared page pool (paged) or
// by stride into a per-slot contiguous cache.
//
// Replaces:
//   src/repro/kernels/paged_attention.py::paged_attention
//     (Pallas body _paged_kernel; the int8/fp8 body _paged_kernel_quant is
//     not ported yet)
//   src/repro/kernels/decode_attention.py::decode_attention
//     (Pallas body _dec_kernel)
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
//  * the block walks only the slot's live keys, in tiles of one page (paged)
//    or 16 positions (contiguous); pages past kv_len - pos_offset, among
//    them the trash page 0 that pads an active slot's table row, are never
//    read (a parked slot, kv_len 1 on an all-zero row, reads one tile of
//    page 0, as the Pallas kernel does; the caller discards its output);
//  * each tile is staged in shared memory as fp32 with a padded row
//    (D + 1 floats), so the score and PV loops read it without bank
//    conflicts; scores, the online softmax (m, l) and the fp32 accumulator
//    stay on chip; the output is acc / max(l, 1e-30), as the Pallas kernel
//    writes it.
// Known limits, left to later work: B*Hkv blocks (64 at the serving
// batch of 8) leave most of the 132 SMs idle -- a split-K over SMs would
// fill them; loads are scalar, not 16-byte vectors, cp.async or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)
#define THREADS 128

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (B, Hq, 1, D). Paged: k, v are pools (P, Hkv, tile, D) and
// block_tables is (B, n_tiles_max). Contiguous: k, v are (B, Hkv, S, D).
// s_cap is the number of addressable key positions per slot.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ block_tables, const int* __restrict__ kv_len,
    const int* __restrict__ pos_offset, T* __restrict__ out, int Hq, int Hkv, int D,
    int tile, int n_tiles_max, int S, int s_cap, float scale, float soft_cap) {
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

  int len = kv_len[b];
  if (PAGED) len -= pos_offset[b];
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
    size_t base;
    if (PAGED) {
      const int pid = block_tables[(size_t)b * n_tiles_max + it];
      base = ((size_t)pid * Hkv + h) * (size_t)tile * D;
    } else {
      base = (((size_t)b * Hkv + h) * S + t0) * (size_t)D;
    }
    for (int i = tid; i < tile * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      float kk = 0.f, vv = 0.f;
      if (t < nvalid) {
        kk = to_f(k[base + i]);
        vv = to_f(v[base + i]);
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

template <bool PAGED>
static int launch(const void* q, const void* k, const void* v, const void* bt,
                  const void* kv_len, const void* pos_offset, void* out, int B, int Hq,
                  int Hkv, int D, int tile, int n_tiles_max, int S, int s_cap,
                  float scale, float soft_cap, int dtype, void* stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D, tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    decode_attn_kernel<float, PAGED><<<B * Hkv, THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)bt,
        (const int*)kv_len, (const int*)pos_offset, (float*)out, Hq, Hkv, D, tile,
        n_tiles_max, S, s_cap, scale, soft_cap);
  else if (dtype == 1)
    decode_attn_kernel<__nv_bfloat16, PAGED><<<B * Hkv, THREADS, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const int*)bt, (const int*)kv_len, (const int*)pos_offset,
        (__nv_bfloat16*)out, Hq, Hkv, D, tile, n_tiles_max, S, s_cap, scale, soft_cap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* block_tables,
                                      const void* kv_len, const void* pos_offset,
                                      void* out, int B, int Hq, int Hkv, int D, int page,
                                      int n_pages, float scale, float soft_cap, int dtype,
                                      void* stream) {
  return launch<true>(q, k_pages, v_pages, block_tables, kv_len, pos_offset, out, B, Hq,
                      Hkv, D, page, n_pages, 0, n_pages * page, scale, soft_cap, dtype,
                      stream);
}

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* out, int B, int Hq,
                                       int Hkv, int S, int D, float scale, float soft_cap,
                                       int dtype, void* stream) {
  const int tile = 16;
  return launch<false>(q, k, v, nullptr, kv_len, nullptr, out, B, Hq, Hkv, D, tile,
                       (S + tile - 1) / tile, S, S, scale, soft_cap, dtype, stream);
}

extern "C" size_t attention_smem_bytes(int G, int D, int tile) {
  return smem_bytes(G, D, tile);
}
