// Single-token decode attention over a contiguous per-slot cache, split
// over the card's SMs (flash-decoding), for Hopper (sm_90a), bound with
// ctypes.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention
// (Pallas body _dec_kernel). It computes what that kernel computes:
//   q (B, Hq, 1, D); k, v (B, Hkv, S, D) in q's type; out (B, Hq, 1, D);
//   query head hq reads kv head hq / G (G = Hq / Hkv); s = scale q.k, then
//   cap tanh(s / cap) when cap > 0; keys t >= kv_len[b] are masked; the
//   output is acc / max(l, 1e-30), float32 math throughout.
//
// What bounds it on the card: bytes. A call reads 2 D elements of K/V per
// live key per kv head and does 4 D flops per live key per query head:
// G flop per byte in bf16 at most, far below the H100's ridge of ~295.
// The least time is (live K/V + q + out bytes) / 3.35 TB/s: 0.3 us at B=1,
// 32/8 heads of 128, S=256; 3.3 us at zamba2's B=8, 32/32 heads of 112.
// At those sizes a launch is a few microseconds, so the design aims to
// put every SM to work on the first wave and keep many loads in flight:
//  * the keys of each (slot, kv head, head group) are split into n_split
//    <= 8 ranges of `chunk` positions; the wrapper's plan
//    (decode_attention.py::splits) aims at two blocks per SM, with at least
//    16 keys a range. A block whose range starts at or past its
//    slot's live length skips the keys at once: kv_len is never read on
//    the host;
//  * a block takes GB query heads of its kv head (decode_attention.py::
//    heads_per_block: all G up to 8; G = 48, granite-20b's MQA, is six
//    blocks of 8, which read the same K/V, from L2 after the first): a
//    lane keeps GB x VEC accumulators, and 48 x 8 would not fit in
//    registers. Grid (n_split, B * Hkv, G / GB);
//  * inside a block, threads map to (key, D-slice): L <= 32 lanes (a power
//    of two) share a key row, each reading VEC values of K and of V -- one
//    16-byte vector (8 bf16 or 4 float32), two where a row has more than
//    32 (float32 at D = 192 and 256) -- neighbouring lanes on neighbouring
//    addresses; one K row serves all GB query heads of the block, so G = 1
//    keeps every lane busy. A row need not fill its L lanes: MLA's D = 192
//    is 24 vectors in bf16 (and 24 pairs in float32) over 32 lanes, of
//    which 8 load nothing and add zeros to the shuffled dots (the row is
//    whole vectors, so no lane reads past it); the smoke configs' D = 24 is
//    3 bf16 vectors (6 float32) over 4 (8) lanes, with no padding. A lane group takes KB = 4 keys at a time (8
//    vector loads in flight a thread), reduces the GB x KB partial dots
//    over its L lanes with shuffles, and updates its running (m, l, acc)
//    once per batch. No shared memory on the key loop: each K/V byte is
//    read once, straight into registers;
//  * the lane groups' states are merged with shuffles (within a warp) and
//    through shared memory (across the 4 warps), into the block's float32
//    partial (m, l, acc[D]) per query head, kept in shared memory;
//  * the splits of one (slot, kv head) are one thread block cluster (at
//    most 8 blocks, the portable cluster size; the plan keeps n_split <= 8)
//    and merge their partials through distributed shared memory: after a
//    cluster barrier, block r reads every block's partial for its share of
//    the G x D outputs and writes them; a second barrier keeps each
//    block's shared memory alive until the others have read it. Measured
//    on the H100 at B=1, 32/8 heads of 128, S=256 with a cold L2, merging
//    through device memory instead (partials in a workspace, the last
//    block behind a __threadfence and an atomic counter) took 5 us of the
//    kernel's 15; a second merge kernel costs a launch (>= 5 us) more.
//    The partials never leave the chip. Each output is merged over the
//    splits in split order (the same sum on every run), each split
//    weighed by exp(m_s - M), M the max over the non-empty splits; a split
//    with l = 0 (its range starts at or past the live length: it computed
//    nothing) weighs zero, so the merge never takes exp(sentinel -
//    sentinel);
//  * masked keys get p = 0 explicitly, never exp(-1e30 - m).
// Float32 inputs keep exact float32 math (fmaf, expf, tanhf): the card's
// greedy streams must equal the CPU's token for token; bf16 inputs take
// the fast exponential (__expf, two ulp), far inside their tolerance.
// D (8, 16, 24, 64, 112, 128, 192, 256) and GB (1, 2, 4, 8) are template
// parameters (whisper-medium's D = 64: a row is 8 bf16 vectors over 8
// lanes, or 16 float32 vectors over 16);
// another fails the launch with cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NEG_INF (-1e30f)
#define THREADS 128
#define NWARPS (THREADS / 32)
#define KB 4  // keys a lane group takes at a time

// one 16-byte vector as float: 4 float32 or 8 bf16 values
template <typename T> __device__ __forceinline__ void load16(const T* p, float* f);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// a lane's VEC values, VEC / (16 / sizeof(T)) vectors
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
  for (int u = 0; u < VEC / E; ++u) load16<T>(p + u * E, f + u * E);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float exp_(float x) { return expf(x); }
template <> __device__ __forceinline__ float exp_<__nv_bfloat16>(float x) { return __expf(x); }

template <typename T, int D> struct Geo {
  static constexpr int E = 16 / (int)sizeof(T);    // elements per 16-byte vector
  // elements a lane takes: one vector, or the fewest whole vectors that
  // keep a row within 32 lanes (float32 at D = 192: two vectors of 4)
  static constexpr int VEC = D / 32 > E ? (D / 32 + E - 1) / E * E : E;
  static constexpr int NCH = D / VEC;              // lane slices per row, <= 32
  static constexpr int L = NCH <= 1 ? 1 : NCH <= 2 ? 2 : NCH <= 4 ? 4 : NCH <= 8 ? 8
                           : NCH <= 16 ? 16 : 32;  // lanes per key row
  static constexpr int LG = 32 / L;                // lane groups per warp
  static_assert(D % VEC == 0 && NCH <= 32, "a row must be whole vectors over <= 32 lanes");
};

// Merge state (m2, l2, a2) into (m, l, a); a state with l = 0 weighs zero.
template <typename T, int VEC>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2, float l2,
                                      const float* a2) {
  const float mx = fmaxf(m, m2);
  const float w1 = l > 0.f ? exp_<T>(m - mx) : 0.f;
  const float w2 = l2 > 0.f ? exp_<T>(m2 - mx) : 0.f;
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] = a[e] * w1 + a2[e] * w2;
  m = mx;
}

// q, out: (B, Hq, 1, D); k, v: (B, Hkv, S, D); kv_len (B,) int32. Launched
// with grid (n_split, B * Hkv, G / GB) in clusters of (n_split, 1, 1).
template <typename T, int D, int GB>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ out, int Hkv, int S, int chunk,
    float scale, float cap) {
  using Gm = Geo<T, D>;
  constexpr int VEC = Gm::VEC, NCH = Gm::NCH, L = Gm::L, LG = Gm::LG;
  __shared__ float sm[NWARPS][GB][D + 2];  // per warp: acc[D], m, l
  __shared__ float part[GB][D + 2];        // the block's partial: acc[D], m, l

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bh = blockIdx.y;  // b * Hkv + h
  const int b = bh / Hkv;
  const int len = min(kv_len[b], S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qrow = (size_t)((bh * gridDim.z + blockIdx.z) * GB);  // first query head's row
  const int c = lane % L;              // this lane's D-slice (vector index)
  const bool has = c < NCH;
  float qf[GB][VEC];  // loaded while kv_len is in flight
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (has) {
      load_vec<T, VEC>(q + (qrow + g) * D + c * VEC, qf[g]);
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

    const T* kp = k + (size_t)bh * S * D + c * VEC;
    const T* vp = v + (size_t)bh * S * D + c * VEC;
    // warp-uniform trip count: the shuffles below take every lane of the warp
    for (int tw = start + warp * LG * KB; tw < end; tw += NWARPS * LG * KB) {
      const int t0 = tw + (lane / L) * KB;
      float kv[KB][VEC], vv[KB][VEC];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (has && t0 + j < end) {
          load_vec<T, VEC>(kp + (size_t)(t0 + j) * D, kv[j]);
          load_vec<T, VEC>(vp + (size_t)(t0 + j) * D, vv[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[j][e] = vv[j][e] = 0.f;
        }
      }
      float s[GB][KB];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kv[j][e], d);
          s[g][j] = d;
        }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int j = 0; j < KB; ++j) s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], o);
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
        float p[KB];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          p[j] = t0 + j < end ? exp_<T>(s[g][j] - mx) : 0.f;
          ps += p[j];
        }
        l[g] = l[g] * alpha + ps;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int j = 0; j < KB; ++j) a = fmaf(p[j], vv[j][e], a);
          acc[g][e] = a;
        }
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

template <typename T, int D, int GB>
static int launch(const void* q, const void* k, const void* v, const void* kv_len,
                  void* out, int B, int Hkv, int NG, int S, int n_split, int chunk,
                  float scale, float cap, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * Hkv, NG);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_split_kernel<T, D, GB>, (const T*)q,
                                     (const T*)k, (const T*)v, (const int*)kv_len, (T*)out,
                                     Hkv, S, chunk, scale, cap);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int D>
static int launch_g(int GB, int NG, const void* q, const void* k, const void* v,
                    const void* kv_len, void* out, int B, int Hkv, int S, int n_split,
                    int chunk, float scale, float cap, cudaStream_t s) {
#define ARGS q, k, v, kv_len, out, B, Hkv, NG, S, n_split, chunk, scale, cap, s
  switch (GB) {
    case 1: return launch<T, D, 1>(ARGS);
    case 2: return launch<T, D, 2>(ARGS);
    case 4: return launch<T, D, 4>(ARGS);
    case 8: return launch<T, D, 8>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

template <typename T>
static int launch_d(int D, int GB, int NG, const void* q, const void* k, const void* v,
                    const void* kv_len, void* out, int B, int Hkv, int S, int n_split,
                    int chunk, float scale, float cap, cudaStream_t s) {
#define ARGS GB, NG, q, k, v, kv_len, out, B, Hkv, S, n_split, chunk, scale, cap, s
  switch (D) {
    case 8: return launch_g<T, 8>(ARGS);
    case 16: return launch_g<T, 16>(ARGS);
    case 24: return launch_g<T, 24>(ARGS);
    case 64: return launch_g<T, 64>(ARGS);
    case 112: return launch_g<T, 112>(ARGS);
    case 128: return launch_g<T, 128>(ARGS);
    case 192: return launch_g<T, 192>(ARGS);
    case 256: return launch_g<T, 256>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The launch's arguments, one block: a ctypes call costs per argument,
// and a decode step makes one call a layer. decode_attention.py packs it
// with the same layout (struct format "<5Q8i2fi4xQ", 96 bytes).
struct DecodeArgs {
  const void *q, *k, *v, *kv_len;
  void* out;
  int B, Hq, Hkv, S, D, n_split, chunk, gb;
  float scale, soft_cap;
  int dtype;
  void* stream;
};
static_assert(sizeof(DecodeArgs) == 96, "DecodeArgs layout");

// dtype code of q, k, v and out: 0 = float32, 1 = bfloat16. The keys of
// each (slot, kv head) are split into n_split <= 8 ranges of `chunk`
// positions, n_split * chunk >= S; gb query heads a block, gb dividing
// Hq / Hkv. Returns the launch's error, or cudaErrorInvalidValue for a
// head dim, head group, type or plan the kernel does not take.
extern "C" int decode_attention_launch(const DecodeArgs* a) {
  const int B = a->B, Hq = a->Hq, Hkv = a->Hkv, S = a->S, n_split = a->n_split,
            chunk = a->chunk, gb = a->gb;
  if (Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || S <= 0 || n_split <= 0 || n_split > 8 ||
      chunk <= 0 || (long long)n_split * chunk < S || gb <= 0 || (Hq / Hkv) % gb != 0 ||
      (long long)B * Hkv > 65535 || Hq / Hkv / gb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)a->stream;
  const int NG = Hq / Hkv / gb;
#define ARGS a->D, gb, NG, a->q, a->k, a->v, a->kv_len, a->out, B, Hkv, S, n_split, chunk, \
             a->scale, a->soft_cap, s
  if (a->dtype == 0) return launch_d<float>(ARGS);
  if (a->dtype == 1) return launch_d<__nv_bfloat16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
