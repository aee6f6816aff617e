// W4A16 grouped-dequant matmul (AWQ layout) for Hopper (sm_90a), bound with
// ctypes:  out (M, N) = x (M, K) @ ((q - z) * s), accumulated in fp32 and
// cast once to x's dtype.
//
//   x       (M, K) float32 or bf16, row-major, 16-byte aligned
//   qw      (K/8, N) int32: word (r, n) holds the 4-bit codes of rows
//           k = 8r .. 8r+7 of column n, nibble j (bits 4j..4j+3) = row 8r+j
//   scales, zeros  (K/g, N) float32: one row per group of g rows of K
//
// Replaces: src/repro/kernels/awq_matmul.py::awq_matmul (Pallas body
// _awq_kernel), which keeps the codes packed in HBM and dequantizes
// tile by tile in VMEM for the MXU.
//
// What bounds it on the card: bytes at decode. With M <= 16 rows the
// product does 2 M flops per weight and reads half a byte of codes per
// weight (plus 8 / g bytes of scale and zero): about 2 M * 2 flop/byte, far
// below the H100's ridge. The least time is the packed codes, scales,
// zeros and activations over 3.35 TB/s (0.0126 ms at (8, 4096, 16384)).
//
// Both bodies factor the dequantization out of the product, per group:
//     out += s * (sum_k x q - z * sum_k x)
// so no weight is ever rounded, and the inner loop multiplies raw codes.
//
// bf16 body (awq_mma_kernel), on tensor cores:
//  * a code q in 0..15 is exact in bf16, and so is x, so
//    mma.sync.m16n8k16 (bf16 in, f32 out) gives sum x q over a group with
//    exact products. x fills the A operand (16 rows; rows past M are zero;
//    with M <= 8 a tile stages 8 rows, rows 8..15 of A are zero registers
//    and their outputs are never folded); the codes fill B. sum x comes
//    from the same instruction, with a B of ones, so it lands in the
//    registers of the rows it scales;
//  * a word is unpacked to bf16 pairs in registers: lop3 puts nibbles j
//    and j + 4 under the bf16 exponent of 128 (0x4300 | q is 128 + q) and
//    one bf16x2 fma subtracts 128, so pairs come out as (0, 4), (1, 5),
//    (2, 6), (3, 7). Lane (g, t) of a warp holds word i of its 16-byte load
//    for column 4 g + i of the warp's 32 (n8 tile i, B column g) and rows
//    8 t .. 8 t + 7 of a 32-row block of K, so its k16 steps take the pairs
//    as (b0, b1) = (p0, p1) and (p2, p3). The A fragments take x in the
//    same order: the slot order of a 64-row slab is
//    awq_matmul.py::k_order, a permutation within each group, built from
//    16 contiguous bytes of x per row with two byte permutes per register;
//  * each block owns BN = 128 (or 64) columns of one 16-row tile and a
//    range of whole groups. Its four warps take 32 columns each (BN = 128)
//    or 32 columns and one of a slab's two 32-row blocks (BN = 64, two
//    warps along K). A slab of 64 K rows (codes, the group's scales and
//    zeros, x) comes through a ring of STAGES stages in shared memory by
//    16-byte cp.async, three stages in flight ahead of the one in use
//    (more measured slower on the H100: PERF.md); the copies run along
//    rows and land XOR-swizzled, so the lanes' reads are conflict-free;
//  * split-K is one launch: the K ranges of one column tile are one thread
//    block cluster (n_split <= 8 blocks) whose float32 partials merge
//    through distributed shared memory in rank order (deterministic: two
//    calls give the same bits). No workspace, no second kernel.
// float32 body (awq_f32_kernel), on CUDA cores in exact float32 (only the
// small float32 models run it): one column a thread, x staged in shared
// memory as [k][row] (16-byte loads), the same per-group factoring and
// the same cluster merge.
//
// The plan (BN, row tile MT, n_split, groups per split) is plain Python:
// awq_matmul.py::splits. Groups are multiples of 64 rows up to 512.
// Columns may be ragged: when N % 4 != 0 (or a weight pointer is not 16-byte
// aligned) the copies go 4 bytes at a time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 128
#define SLAB 64       // K rows a pipeline stage holds
#define STAGES 4
#define MAX_GROUP 512
#define F32_XS_BYTES (32 * 1024)

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 (or 4) bytes global -> shared, zero-filled where !ok (src is then
// never read, but kept a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// words c .. c + 3 of a row of N 32-bit words (columns past N: zeros)
template <bool V16>
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* row, int c, int N) {
  if (V16) {  // N % 4 == 0: the chunk is all in or all out
    cp16(dst, row + (c < N ? c : 0), c < N);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) cp4(dst + w, row + (c + w < N ? c + w : 0), c + w < N);
  }
}

// nibbles (j, j + 4) of q >> 4 j as a bf16 pair of exact codes
__device__ __forceinline__ uint32_t code_pair(uint32_t q) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(q), "r"(0x000F000Fu), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

// d (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cluster's float32 partials part[WK][MT][BN] (one per block, in its
// shared memory) summed in rank order, then over WK, and stored. Block r
// takes outputs r * THREADS + tid, r * THREADS + tid + n_split * THREADS, ...
template <typename T, int MT, int BN, int WK>
__device__ __forceinline__ void merge_out(float* part, T* __restrict__ out, int M, int N,
                                          int row0, int col0) {
  const int split = blockIdx.x, n_split = gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (n_split > 1) cluster.sync(); else __syncthreads();
  for (int i = split * THREADS + threadIdx.x; i < MT * BN; i += n_split * THREADS) {
    const int m = i / BN, c = i - m * BN;
    float v[8][WK];  // every rank's loads in flight before the first add
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float* p = n_split > 1 ? cluster.map_shared_rank(part, r < n_split ? r : 0) : part;
#pragma unroll
      for (int w = 0; w < WK; ++w) v[r][w] = r < n_split ? p[(w * MT + m) * BN + c] : 0.f;
    }
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int w = 0; w < WK; ++w)
        if (r < n_split) a += v[r][w];
    if (row0 + m < M && col0 + c < N) out[(size_t)(row0 + m) * N + col0 + c] = from_f<T>(a);
  }
  if (n_split > 1) cluster.sync();  // every partial stays readable until all have merged
}

template <int MT, int WK> struct MmaGeo {
  static constexpr int WN = 4 / WK;                  // warps along N
  static constexpr int BN = 32 * WN;                 // columns of a block
  static constexpr int CODE_B = 8 * BN * 4;          // 8 packed rows x BN words
  static constexpr int SZ_B = 2 * BN * 4;            // scales[BN], zeros[BN]
  static constexpr int X_B = MT * SLAB * 2;          // MT rows x 64 bf16
  static constexpr int STAGE_B = CODE_B + SZ_B + X_B;
  static constexpr int SMEM = STAGES * STAGE_B;
  static_assert(WK * MT * BN * 4 <= SMEM, "partials fit the ring");
};

// A stage holds the slab's codes as 8 packed rows of BN words and x as MT
// rows of 64 values, both in 16-byte chunks, row-major, with the chunk index
// XOR-swizzled by the row: the copies go along rows (a warp's addresses are
// contiguous in device memory), and lane (g, t)'s reads of chunk (4 b + t,
// 8 wn + g) of the codes and (g, 4 b + t) of x fall in 8 distinct bank
// groups in every phase of 8 lanes, as the copies' writes do.
template <int BN>
__device__ __forceinline__ int code_chunk(int r, int cc) {
  return r * (BN / 4) + (cc ^ ((r & 3) << 1));
}
__device__ __forceinline__ int x_chunk(int m, int kc) { return m * 8 + (kc ^ ((m & 1) << 2)); }

// Grid (n_split, ceil(N / BN), ceil(M / MT)), clusters of (n_split, 1, 1).
template <int MT, int WK, bool V16>
__global__ void __launch_bounds__(THREADS) awq_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    __nv_bfloat16* __restrict__ out, int M, int K, int N, int group, int gps) {
  using G = MmaGeo<MT, WK>;
  constexpr int WN = G::WN, BN = G::BN, H = MT / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int col0 = blockIdx.y * BN, row0 = blockIdx.z * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int gq = lane >> 2, tq = lane & 3;
  const int g_begin = blockIdx.x * gps, g_end = min(K / group, g_begin + gps);
  const int spg = group / SLAB;
  const int n_slabs = max(0, g_end - g_begin) * spg;
  const int k_begin = g_begin * group;

  // This thread's copies, the same chunks of every slab: their sources
  // advance by a slab (8 packed rows, 64 values of x) a copy, the scales'
  // and zeros' by a row a group.
  constexpr int CODE_PER = 8 * BN / 4 / THREADS;  // code chunks a thread: 2 or 1
  const uint32_t* code_src[CODE_PER];
  int code_dst[CODE_PER], code_col[CODE_PER];
#pragma unroll
  for (int p = 0; p < CODE_PER; ++p) {
    const int c = tid + p * THREADS, r = c / (BN / 4), cc = c % (BN / 4);
    code_src[p] = qw + (size_t)(k_begin / 8 + r) * N;
    code_col[p] = col0 + 4 * cc;
    code_dst[p] = code_chunk<BN>(r, cc) * 16;
  }
  const bool sz_copy = tid < BN / 2;  // chunk tid of scales[BN] then zeros[BN]
  const int sz_col = col0 + 4 * (tid % (BN / 4));
  const float* sz_src = (tid < BN / 4 ? scales : zeros) + (size_t)g_begin * N;
  const bool x_copy = tid < MT * 8;   // chunk (m, kc) = (tid / 8, tid % 8) of x
  const bool x_ok = row0 + tid / 8 < M;
  const __nv_bfloat16* x_src = x + (size_t)(x_ok ? row0 + tid / 8 : 0) * K + k_begin +
                               8 * (tid % 8);
  const int x_dst = G::CODE_B + G::SZ_B + x_chunk(tid / 8, tid % 8) * 16;
  int issued = 0, issued_in_group = 0;
  unsigned char* const ring = smem;
  auto issue = [&]() {  // the next slab, into its slot
    if (issued < n_slabs) {
      unsigned char* st = ring + (issued % STAGES) * G::STAGE_B;
#pragma unroll
      for (int p = 0; p < CODE_PER; ++p) {
        copy_words<V16>(reinterpret_cast<uint32_t*>(st + code_dst[p]), code_src[p],
                        code_col[p], N);
        code_src[p] += (size_t)8 * N;
      }
      if (sz_copy)
        copy_words<V16>(reinterpret_cast<uint32_t*>(st + G::CODE_B) + 4 * tid,
                        reinterpret_cast<const uint32_t*>(sz_src), sz_col, N);
      if (x_copy) cp16(st + x_dst, x_src, x_ok);
      x_src += SLAB;
      if (++issued_in_group == spg) {
        issued_in_group = 0;
        sz_src += N;
      }
      ++issued;
    }
    cp_commit();  // an empty group past the end keeps the wait count uniform
  };

  float acc[4][4], gacc[4][4], sx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sx[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = gacc[i][e] = 0.f;
  }
  const uint32_t ONES = 0x3F803F80u;  // bf16 (1, 1)

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();
  for (int j = 0, in_group = 0; j < n_slabs; ++j) {
    cp_wait<STAGES - 2>();  // this thread's copies of slab j have landed
    __syncthreads();        // everyone's have, and slot (j - 1) % STAGES is free
    issue();                // slab j + STAGES - 1
    const unsigned char* st = smem + (j % STAGES) * G::STAGE_B;
    const uint4* cs = reinterpret_cast<const uint4*>(st);
    const uint4* xs = reinterpret_cast<const uint4*>(st + G::CODE_B + G::SZ_B);
#pragma unroll
    for (int bb = 0; bb < 2 / WK; ++bb) {
      const int b = WK == 1 ? bb : wk;
      const uint4 c = cs[code_chunk<BN>(4 * b + tq, 8 * wn + gq)];
      const uint4 xa = xs[x_chunk(gq, 4 * b + tq)];
      const uint4 xb = H == 2 ? xs[x_chunk(gq + 8, 4 * b + tq)] : make_uint4(0, 0, 0, 0);
      // A fragments of the two k16 steps: slots (2t, 2t+1) = K rows (8t, 8t+4)
      // then (8t+2, 8t+6); slots (2t+8, 2t+9) = (8t+1, 8t+5) then (8t+3, 8t+7)
      uint32_t a[2][4];
      a[0][0] = __byte_perm(xa.x, xa.z, 0x5410);
      a[0][2] = __byte_perm(xa.x, xa.z, 0x7632);
      a[0][1] = __byte_perm(xb.x, xb.z, 0x5410);
      a[0][3] = __byte_perm(xb.x, xb.z, 0x7632);
      a[1][0] = __byte_perm(xa.y, xa.w, 0x5410);
      a[1][2] = __byte_perm(xa.y, xa.w, 0x7632);
      a[1][1] = __byte_perm(xb.y, xb.w, 0x5410);
      a[1][3] = __byte_perm(xb.y, xb.w, 0x7632);
      const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma(gacc[i], a[0], code_pair(w[i]), code_pair(w[i] >> 4));
        mma(gacc[i], a[1], code_pair(w[i] >> 8), code_pair(w[i] >> 12));
      }
      mma(sx, a[0], ONES, ONES);
      mma(sx, a[1], ONES, ONES);
    }
    if (++in_group == spg) {  // the group's last slab: fold it into acc
      in_group = 0;
      const float* sp = reinterpret_cast<const float*>(st + G::CODE_B) + 32 * wn + 8 * tq;
      const float4 s0 = *reinterpret_cast<const float4*>(sp);
      const float4 s1 = *reinterpret_cast<const float4*>(sp + 4);
      const float4 z0 = *reinterpret_cast<const float4*>(sp + BN);
      const float4 z1 = *reinterpret_cast<const float4*>(sp + BN + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      // fragment (i, e): row g + 8 (e / 2), column 32 wn + 8 t + 4 (e % 2) + i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 2 * H; ++e) {
          const int cc = 4 * (e & 1) + i;
          acc[i][e] = fmaf(sv[cc], fmaf(-zv[cc], sx[e], gacc[i][e]), acc[i][e]);
          gacc[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[e] = 0.f;
    }
  }

  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the partials now
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2 * H; ++e)
      part[(wk * MT + gq + 8 * (e >> 1)) * BN + 32 * wn + 8 * tq + 4 * (e & 1) + i] = acc[i][e];
  merge_out<__nv_bfloat16, MT, BN, WK>(part, out, M, N, row0, col0);
}

// float32 body. Thread (kh, c) owns column col0 + c (c < BN = THREADS / WK)
// and every WK-th group of the block's range from its kh-th.
template <int MT, int WK>
__global__ void __launch_bounds__(THREADS) awq_f32_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    float* __restrict__ out, int M, int K, int N, int group, int gps) {
  constexpr int BN = THREADS / WK;
  constexpr int CHUNK = F32_XS_BYTES / 4 / MT;  // K rows of x staged at a time
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);              // [k][MT]
  float* sxs = xs + CHUNK * MT;                             // [group of chunk][MT]
  const int col0 = blockIdx.y * BN, row0 = blockIdx.z * MT;
  const int tid = threadIdx.x, kh = tid / BN, n = col0 + tid % BN;
  const int mt = min(MT, M - row0);
  const int g_begin = blockIdx.x * gps, g_end = min(K / group, g_begin + gps);
  const int chunk_groups = CHUNK / group;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = g_begin; c0 < g_end; c0 += chunk_groups) {
    const int c1 = min(g_end, c0 + chunk_groups);
    const int nk = (c1 - c0) * group, kbase = c0 * group;
    __syncthreads();  // the previous chunk's reads of xs and sxs are done
    // 16-byte loads, 4 in flight a thread, stored transposed
    for (int i0 = tid; i0 < MT * nk / 4; i0 += 4 * THREADS) {
      float4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * THREADS, m = i / (nk / 4), k4 = i - m * (nk / 4);
        v[e] = (i < MT * nk / 4 && m < mt)
                   ? __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + m) * K + kbase) + k4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * THREADS, m = i / (nk / 4), k4 = i - m * (nk / 4);
        if (i < MT * nk / 4) {
          xs[(4 * k4 + 0) * MT + m] = v[e].x;
          xs[(4 * k4 + 1) * MT + m] = v[e].y;
          xs[(4 * k4 + 2) * MT + m] = v[e].z;
          xs[(4 * k4 + 3) * MT + m] = v[e].w;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < (c1 - c0) * MT; i += THREADS) {  // sum x per (group, row)
      const int gi = i / MT, m = i - gi * MT;
      float s = 0.f;
      for (int kk = 0; kk < group; ++kk) s += xs[(gi * group + kk) * MT + m];
      sxs[i] = s;
    }
    __syncthreads();
    if (n >= N) continue;
    for (int gi = c0 + kh; gi < c1; gi += WK) {
      float ga[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) ga[m] = 0.f;
      for (int r0 = 0; r0 < group / 8; r0 += 8) {
        const uint32_t* wrow = qw + (size_t)(gi * group / 8 + r0) * N + n;
        uint32_t u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = __ldg(wrow + (size_t)i * N);
        const float4* xr = reinterpret_cast<const float4*>(
            xs + (size_t)((gi - c0) * group + r0 * 8) * MT);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float q = (float)((u[i] >> (4 * j)) & 15u);
#pragma unroll
            for (int v = 0; v < MT / 4; ++v) {
              const float4 a = xr[(i * 8 + j) * (MT / 4) + v];
              ga[4 * v + 0] = fmaf(a.x, q, ga[4 * v + 0]);
              ga[4 * v + 1] = fmaf(a.y, q, ga[4 * v + 1]);
              ga[4 * v + 2] = fmaf(a.z, q, ga[4 * v + 2]);
              ga[4 * v + 3] = fmaf(a.w, q, ga[4 * v + 3]);
            }
          }
        }
      }
      const float s = __ldg(scales + (size_t)gi * N + n), z = __ldg(zeros + (size_t)gi * N + n);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m] = fmaf(s, fmaf(-z, sxs[(gi - c0) * MT + m], ga[m]), acc[m]);
    }
  }
  __syncthreads();  // xs is free: it holds the partials now
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MT; ++m) part[(kh * MT + m) * BN + tid % BN] = acc[m];
  merge_out<float, MT, BN, WK>(part, out, M, N, row0, col0);
}

template <typename... KArgs, typename... Args>
static int launch(void (*kernel)(KArgs...), dim3 grid, int smem, cudaStream_t s,
                  Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;  // the K splits of one tile: one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The launch's arguments, one block: a ctypes call costs per argument, and
// a quantized decode step makes four calls a layer. awq_matmul.py packs it
// with the same layout (struct format "<5Q9i4xQ", 88 bytes).
struct AwqArgs {
  const void *x, *qw, *scales, *zeros;
  void* out;
  int M, K, N, group, mt, bn, n_split, gps, dtype;
  void* stream;
};
static_assert(sizeof(AwqArgs) == 88, "AwqArgs layout");

template <int MT, int WK>
static int launch_bf16(const AwqArgs* a, bool v16, dim3 grid, cudaStream_t s) {
  constexpr int smem = MmaGeo<MT, WK>::SMEM;
#define ARGS (const __nv_bfloat16*)a->x, (const uint32_t*)a->qw, (const float*)a->scales, \
             (const float*)a->zeros, (__nv_bfloat16*)a->out, a->M, a->K, a->N, a->group, a->gps
  return v16 ? launch(awq_mma_kernel<MT, WK, true>, grid, smem, s, ARGS)
             : launch(awq_mma_kernel<MT, WK, false>, grid, smem, s, ARGS);
#undef ARGS
}

template <int MT, int WK>
static int launch_f32(const AwqArgs* a, dim3 grid, cudaStream_t s) {
  constexpr int smem = F32_XS_BYTES + (F32_XS_BYTES / 4 / MT / SLAB) * MT * 4;
  return launch(awq_f32_kernel<MT, WK>, grid, smem, s, (const float*)a->x,
                (const uint32_t*)a->qw, (const float*)a->scales, (const float*)a->zeros,
                (float*)a->out, a->M, a->K, a->N, a->group, a->gps);
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// dtype code of x and out: 0 = float32, 1 = bfloat16. The plan (mt in {8,
// 16} rows a tile, bn in {64, 128} columns a block, n_split <= 8 ranges of
// gps groups, every range non-empty) comes from awq_matmul.py::splits.
// Returns the launch's error, or cudaErrorInvalidValue for a group, plan,
// type or alignment the kernel does not take.
extern "C" int awq_matmul_launch(const AwqArgs* a) {
  const int M = a->M, K = a->K, N = a->N, group = a->group, mt = a->mt, bn = a->bn,
            n_split = a->n_split, gps = a->gps;
  if (M <= 0 || N <= 0 || group <= 0 || group % SLAB || group > MAX_GROUP || K <= 0 ||
      K % group || (mt != 8 && mt != 16) || (bn != 64 && bn != 128) || n_split < 1 ||
      n_split > 8 || gps < 1 || (long long)(n_split - 1) * gps >= K / group ||
      (long long)n_split * gps < K / group || (N + bn - 1) / bn > 65535 ||
      (M + mt - 1) / mt > 65535 || !aligned16(a->x))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_split, (N + bn - 1) / bn, (M + mt - 1) / mt);
  cudaStream_t s = (cudaStream_t)a->stream;
  if (a->dtype == 1) {
    const bool v16 = N % 4 == 0 && aligned16(a->qw) && aligned16(a->scales) &&
                     aligned16(a->zeros);
    if (mt == 8) return bn == 128 ? launch_bf16<8, 1>(a, v16, grid, s)
                                  : launch_bf16<8, 2>(a, v16, grid, s);
    return bn == 128 ? launch_bf16<16, 1>(a, v16, grid, s) : launch_bf16<16, 2>(a, v16, grid, s);
  }
  if (a->dtype == 0) {
    if (mt == 8) return bn == 128 ? launch_f32<8, 1>(a, grid, s) : launch_f32<8, 2>(a, grid, s);
    return bn == 128 ? launch_f32<16, 1>(a, grid, s) : launch_f32<16, 2>(a, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}
