// Single-token decode attention over a shared KV page pool, split over the
// card's SMs, for Hopper (sm_90a): the kernel, templated on the element
// type of q/out (float, bf16) and of the K/V pages (the same, or int8 /
// fp8 e4m3 codes with a float32 scale per (page, kv head, position)); K/V
// is addressed through a block table. Two translation units instantiate
// it, each bound with ctypes and built in parallel: attention.cu for
// pages in q's type, attention_quant.cu for codes. (The contiguous-cache
// decode kernel is decode_attention.cu, whose design this one follows.)
//
// Replaces:
//   src/repro/kernels/paged_attention.py::paged_attention
//     (Pallas bodies _paged_kernel and, for int8/fp8 pools,
//     _paged_kernel_quant)
// It computes what they compute: q (B, Hq, 1, D); pools (P, Hkv, page, D);
// block_tables (B, n_pages); query head hq reads kv head hq / G (G = Hq /
// Hkv); slot b's live keys are the slot-space positions [0, kv_len[b] -
// pos_offset[b]) of its block-table row; s = scale q.k, then cap
// tanh(s / cap) when cap > 0; out = acc / max(l, 1e-30), float32 math.
//
// What bounds it on the card: bytes. A decode step does 4 D flops per live
// key per query head and reads 2 D elements of K/V (plus two scales, for
// codes) per live key per kv head: about G flop per byte in bf16, far below
// the H100's ridge of ~295. The least time is (live K/V bytes + q + out +
// table and length bytes) / 3.35 TB/s: 0.9 us at the serving batch of 8,
// 32/8 heads of 128, ragged lengths up to 256. At that size a launch costs
// more than the bytes, so, as in decode_attention.cu, the design puts every
// SM to work on the first wave and keeps many loads in flight:
//  * the keys of each (slot, kv head) are split into n_split <= 8 ranges
//    of whole pages (chunk = pages a split times page); the wrapper's plan
//    (paged_attention.py::splits) is made from the pool's addressable
//    length n_pages x page, never from kv_len, which stays on the device.
//    A block whose range starts at or past its slot's live length skips
//    the keys at once, so only live pages are read: pages past the live
//    tail (among them the trash page 0 that pads a table row) never are.
//    A parked slot (kv_len 1 on an all-zero row) reads one position of
//    page 0, whose output the caller discards;
//  * a block takes GB <= 8 query heads of one kv head (all G where G <= 8;
//    G = 48 is six blocks of 8, which read the same K/V, from L2 after the
//    first); grid (n_split, B * Hkv * G / GB);
//  * threads map to (key, D-slice): L <= 32 lanes (a power of two) share
//    a key row, each loading one 16-byte vector -- 4 float32, 8 bf16 or 16
//    int8/fp8 codes -- of K and of V straight into registers (two vectors
//    where a row has more than 32: float32 at D = 256; 8 bytes where it
//    has fewer than 16 codes: D = 8); a lane group
//    takes KB = 4 keys at a time (8 loads in flight a thread), each key's
//    page id read from the block table by the lanes that load it. The
//    codes stay packed until used; each K/V element becomes float once per
//    key and serves all GB heads. No shared memory on the key loop;
//  * quantized pools are dequantized in registers with the same single
//    product float(code) * scale[pid, h, pos] as the plain version; scales
//    are read only for live positions;
//  * lane groups merge with shuffles, warps through shared memory, and the
//    splits of one (slot, kv head, head group) -- one thread block cluster
//    -- through distributed shared memory, in split order (the same sum on
//    every run), each split weighed by exp(m_s - M); a split that computed
//    nothing (l = 0) weighs zero;
//  * masked keys get p = 0 explicitly, never exp(-1e30 - m).
// Float32 inputs keep exact float32 math (fmaf, expf, tanhf): the card's
// greedy streams must equal the CPU's token for token; bf16 inputs take
// the fast exponential (__expf, two ulp), far inside their tolerance.
// D (8, 16, 112, 128, 256) and GB are template parameters: GB in 1, 2, 4, 6, 8 for
// pages in q's type, 1, 2, 4 for codes (16 codes a lane and GB heads keep
// 2 x 16 x GB floats in registers); another fails the launch with
// cudaErrorInvalidValue.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define NEG_INF (-1e30f)
#define THREADS 128
#define NWARPS (THREADS / 32)
#define KB 4  // keys a lane group takes at a time

// the 4 / sizeof(KT) values of one 32-bit word, as float
template <typename KT> __device__ __forceinline__ void cvtw(uint32_t u, float* f);
template <> __device__ __forceinline__ void cvtw<float>(uint32_t u, float* f) {
  f[0] = __uint_as_float(u);
}
template <> __device__ __forceinline__ void cvtw<__nv_bfloat16>(uint32_t u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
template <> __device__ __forceinline__ void cvtw<int8_t>(uint32_t u, float* f) {
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = (float)(int8_t)((u >> (8 * b)) & 0xffu);
}
template <> __device__ __forceinline__ void cvtw<__nv_fp8_e4m3>(uint32_t u, float* f) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    __nv_fp8_e4m3 x;
    x.__x = (__nv_fp8_storage_t)((u >> (8 * b)) & 0xffu);
    f[b] = static_cast<float>(x);
  }
}
// the NW words at p (16-byte aligned where NW is a multiple of 4, else 8),
// in 16-byte loads, or one 8-byte load for two words
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
    }
  } else {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  }
}
// NW words as NW * 4 / sizeof(KT) floats
template <typename KT, int NW>
__device__ __forceinline__ void cvt(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < NW; ++i) cvtw<KT>(w[i], f + i * (4 / (int)sizeof(KT)));
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float exp_(float x) { return expf(x); }
template <> __device__ __forceinline__ float exp_<__nv_bfloat16>(float x) { return __expf(x); }

template <typename T, typename KT, int D> struct Geo {
  static constexpr int E = 16 / (int)sizeof(KT);    // K/V elements per 16-byte vector
  // K/V elements a lane takes: one vector; two where a row has more than
  // 32 (float32 at D = 256); half of one where the row is shorter (codes at D = 8)
  static constexpr int VEC = D / 32 > E ? D / 32 : D < E ? D : E;
  static constexpr int KW = VEC * (int)sizeof(KT) / 4;  // 32-bit words of them
  static constexpr int QW = VEC * (int)sizeof(T) / 4;   // words of q's VEC values
  static constexpr int NCH = D / VEC;               // lane slices per row, <= 32
  static constexpr int L = NCH <= 1 ? 1 : NCH <= 2 ? 2 : NCH <= 4 ? 4 : NCH <= 8 ? 8
                           : NCH <= 16 ? 16 : 32;   // lanes per key row
  static constexpr int LG = 32 / L;                 // lane groups per warp
};

// Merge state (m2, l2, a2) into (m, l, a); a state with l = 0 weighs zero.
template <typename T, int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2, float l2,
                                      const float* a2) {
  const float mx = fmaxf(m, m2);
  const float w1 = l > 0.f ? exp_<T>(m - mx) : 0.f;
  const float w2 = l2 > 0.f ? exp_<T>(m2 - mx) : 0.f;
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * w1 + a2[e] * w2;
  m = mx;
}

// q, out: (B, Hq, 1, D); k, v: pools (P, Hkv, page, D) of KT; ks, vs their
// (P, Hkv, page) float32 scales when KT is a code type (null otherwise);
// block_tables (B, n_pages). Launched with grid (n_split, B * Hkv * NG) in
// clusters of (n_split, 1, 1); NG = G / GB head groups a kv head.
template <typename T, typename KT, int D, int GB>
__global__ void __launch_bounds__(THREADS) paged_split_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ block_tables, const int* __restrict__ kv_len,
    const int* __restrict__ pos_offset, T* __restrict__ out, int Hq, int Hkv, int NG,
    int page, int n_pages, int chunk, float scale, float cap) {
  constexpr bool QUANT = !std::is_same<KT, T>::value;
  using Gm = Geo<T, KT, D>;
  constexpr int VEC = Gm::VEC, KW = Gm::KW, QW = Gm::QW, NCH = Gm::NCH, L = Gm::L,
                LG = Gm::LG;
  __shared__ float sm[NWARPS][GB][D + 2];  // per warp: acc[D], m, l
  __shared__ float part[GB][D + 2];        // the block's partial: acc[D], m, l

  const int split = blockIdx.x, n_split = gridDim.x;
  const int gi = blockIdx.y % NG, bh = blockIdx.y / NG;  // bh = b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int len = min(kv_len[b] - pos_offset[b], n_pages * page);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qrow = (size_t)b * Hq + (size_t)(h * NG + gi) * GB;  // first query head's row
  const int c = lane % L;  // this lane's D-slice (vector index)
  const bool has = c < NCH;
  float qf[GB][VEC];  // loaded while kv_len is in flight
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (has) {
      uint32_t w[QW];
      load_words<QW>(q + (qrow + g) * D + c * VEC, w);
      cvt<T, QW>(w, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[g][e] = 0.f;
    }
  }

  if (start >= len && n_split > 1) {  // nothing live here: an empty partial
    for (int i = tid; i < GB * (D + 2); i += THREADS)
      (&part[0][0])[i] = i % (D + 2) == D ? NEG_INF : 0.f;
  } else {
    float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }

    const int* bt = block_tables + (size_t)b * n_pages;
    // warp-uniform trip count: the shuffles below take every lane of the warp
    for (int tw = start + warp * LG * KB; tw < end; tw += NWARPS * LG * KB) {
      const int t0 = tw + (lane / L) * KB;
      uint32_t kw[KB][KW], vw[KB][KW];
      float ksc[KB], vsc[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int t = t0 + j;
#pragma unroll
        for (int i = 0; i < KW; ++i) kw[j][i] = vw[j][i] = 0u;
        ksc[j] = vsc[j] = 0.f;
        if (t < end) {
          const size_t pos = ((size_t)bt[t / page] * Hkv + h) * page + t % page;
          if (has) {
            load_words<KW>(k + pos * D + c * VEC, kw[j]);
            load_words<KW>(v + pos * D + c * VEC, vw[j]);
          }
          if (QUANT) {
            ksc[j] = __ldg(ks + pos);
            vsc[j] = __ldg(vs + pos);
          }
        }
      }
      float s[GB][KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float kf[VEC];
        cvt<KT, KW>(kw[j], kf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] *= ksc[j];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
          s[g][j] = d;
        }
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < KB; ++j) s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], o);
      float p[GB][KB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          float x = s[g][j] * scale;
          if (cap > 0.f) x = cap * tanhf(x / cap);
          s[g][j] = x;
          if (t0 + j < end) mx = fmaxf(mx, x);
        }
        const float alpha = exp_<T>(m[g] - mx);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          p[g][j] = t0 + j < end ? exp_<T>(s[g][j] - mx) : 0.f;
          ps += p[g][j];
        }
        l[g] = l[g] * alpha + ps;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float vf[VEC];
        cvt<KT, KW>(vw[j], vf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vf[e] *= vsc[j];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p[g][j], vf[e], acc[g][e]);
      }
    }

    // merge the warp's lane groups (lanes c, c + L, c + 2L, ...)
#pragma unroll
    for (int o = L; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
        float a2[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        merge<T, VEC>(m[g], l[g], acc[g], m2, l2, a2);
      }
    if (lane < L && has) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm[warp][g][c * VEC + e] = acc[g][e];
        if (c == 0) {
          sm[warp][g][D] = m[g];
          sm[warp][g][D + 1] = l[g];
        }
      }
    }
    __syncthreads();

    // merge the warps: thread i owns (g, d) = (i / D, i % D)
    for (int i = tid; i < GB * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      float mm = NEG_INF, ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w)
        merge<T, 1>(mm, ll, &aa, sm[w][g][D], sm[w][g][D + 1], &sm[w][g][d]);
      if (n_split == 1) {
        out[(qrow + g) * D + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
      } else {
        part[g][d] = aa;
        if (d == 0) {
          part[g][D] = mm;
          part[g][D + 1] = ll;
        }
      }
    }
  }
  if (n_split == 1) return;

  // merge the cluster's partials through distributed shared memory: block
  // r takes outputs r * THREADS + tid, r * THREADS + tid + n_split * THREADS, ...
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = split * THREADS + tid; i < GB * D; i += n_split * THREADS) {
    const int g = i / D, d = i - g * D;
    float M = NEG_INF, den = 0.f, a = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float* pr = &cluster.map_shared_rank(&part[0][0], r)[g * (D + 2)];
      merge<T, 1>(M, den, &a, pr[D], pr[D + 1], &pr[d]);
    }
    out[(qrow + g) * D + d] = from_f<T>(a / fmaxf(den, 1e-30f));
  }
  cluster.sync();  // every block's partial stays readable until all have merged
}

// The launch's arguments, one block: a ctypes call costs per argument,
// and a decode step makes one call a layer. paged_attention.py packs it
// with the same layout (struct format "<9Q11i2f4xQ", 136 bytes).
struct PagedArgs {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *block_tables, *kv_len, *pos_offset;
  void* out;
  int B, Hq, Hkv, D, page, n_pages, n_split, chunk, gb, dtype, kv;
  float scale, soft_cap;
  void* stream;
};
static_assert(sizeof(PagedArgs) == 136, "PagedArgs layout");

template <typename T, typename KT, int D, int GB>
static int launch(const PagedArgs* a) {
  const int NG = a->Hq / a->Hkv / GB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->n_split, a->B * a->Hkv * NG);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)a->stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_split_kernel<T, KT, D, GB>, (const T*)a->q, (const KT*)a->k,
      (const KT*)a->v, a->ks, a->vs, a->block_tables, a->kv_len, a->pos_offset, (T*)a->out,
      a->Hq, a->Hkv, NG, a->page, a->n_pages, a->chunk, a->scale, a->soft_cap);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename KT, int D>
static int launch_gb(const PagedArgs* a) {
  constexpr bool QUANT = !std::is_same<KT, T>::value;
  switch (a->gb) {
    case 1: return launch<T, KT, D, 1>(a);
    case 2: return launch<T, KT, D, 2>(a);
    case 4: return launch<T, KT, D, 4>(a);
    case 6: return QUANT ? (int)cudaErrorInvalidValue : launch<T, KT, D, QUANT ? 1 : 6>(a);
    case 8: return QUANT ? (int)cudaErrorInvalidValue : launch<T, KT, D, QUANT ? 1 : 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename KT>
static int launch_d(const PagedArgs* a) {
  switch (a->D) {
    case 8: return launch_gb<T, KT, 8>(a);
    case 16: return launch_gb<T, KT, 16>(a);
    case 112: return launch_gb<T, KT, 112>(a);
    case 128: return launch_gb<T, KT, 128>(a);
    case 256: return launch_gb<T, KT, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the plan and shapes both entry points check before a launch
static bool bad_plan(const PagedArgs* a) {
  const long long S = (long long)a->n_pages * a->page;
  return a->Hkv <= 0 || a->Hq % a->Hkv != 0 || a->B <= 0 || a->page <= 0 ||
         a->n_pages <= 0 || a->n_split <= 0 || a->n_split > 8 || a->chunk <= 0 ||
         a->chunk % a->page != 0 || (long long)a->n_split * a->chunk < S || a->gb <= 0 ||
         (a->Hq / a->Hkv) % a->gb != 0 || (long long)a->B * (a->Hq / a->gb) > 65535 ||
         (a->kv != 0) != (a->ks != nullptr) || (a->kv != 0) != (a->vs != nullptr);
}
