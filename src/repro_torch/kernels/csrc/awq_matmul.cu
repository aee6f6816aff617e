// W4A16 grouped-dequant matmul (AWQ layout) for Hopper (sm_90a), bound with
// ctypes:  out (M, N) = x (M, K) @ ((q - z) * s), accumulated in fp32 and
// cast once to x's dtype.
//
//   x       (M, K) float32 or bf16, row-major
//   qw      (K/8, N) int32: word (r, n) holds the 4-bit codes of rows
//           k = 8r .. 8r+7 of column n, nibble j (bits 4j..4j+3) = row 8r+j
//   scales, zeros  (K/g, N) float32: one row per group of g rows of K
//
// Replaces: src/repro/kernels/awq_matmul.py::awq_matmul (Pallas body
// _awq_kernel), which keeps the codes packed in HBM and dequantizes
// tile by tile in VMEM for the MXU.
//
// What bounds it on the card: bytes at decode. With M <= 16 rows the
// kernel does 2*M flops per weight and reads half a byte of codes per
// weight (plus 8/g bytes of scale and zero), about 2*M*2 flop/byte, far
// below the H100's ridge; the least time is the packed weight bytes plus
// scales, zeros and activations over 3.35 TB/s. Reading int4 codes instead
// of bf16 weights is the whole gain: 4x fewer weight bytes.
//
// Design (simple first; no tensor cores, no TMA):
//  * a block of 128 threads owns 128 adjacent output columns, one per
//    thread, so the threads of a warp read 32 adjacent int32 words of a
//    qw row: every weight read is a coalesced 128-byte line. A thread
//    issues the 8 words of 64 rows of K before it uses any, so 8 loads
//    are in flight per thread;
//  * x is staged in shared memory as fp32, transposed to [k][row], a
//    chunk of whole groups at a time (32 KB, 8 loads in flight per
//    thread), so the rows of one k are one 16-byte broadcast read
//    (conflict-free: every thread reads the same address);
//  * each word unpacks to 8 consecutive k; w = (code - z) * s in fp32 (the
//    plain version's formula, the group's scale and zero read once per
//    64 rows), and MT row accumulators live in registers (MT in {4, 8,
//    16}: the smallest that covers M, so a decode step of 8 rows does no
//    work for rows it does not have);
//  * the grid is (N/128, splits, ceil(M/MT)). At N = 4096 only 32 column
//    blocks exist for 132 SMs, so K is split over `splits` ranges of whole
//    groups (about four blocks per SM); each split writes fp32 partial
//    sums (splits, M, N) and a second kernel adds them in split order
//    (deterministic) and casts. With one split the first kernel writes
//    the output directly.
// Groups are multiples of 64 rows up to the chunk (512 rows at MT = 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#define THREADS 128
#define BLOCKS_PER_SM 4  // the K split aims at this many blocks per SM

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

constexpr int SMEM_BYTES = 32 * 1024;

template <int MT>
__host__ __device__ constexpr int chunk_rows() { return SMEM_BYTES / 4 / MT; }

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS) awq_kernel(
    const T* __restrict__ x, const int* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    float* __restrict__ partial, T* __restrict__ out, int M, int K, int N, int group,
    int groups_per_split) {
  extern __shared__ float4 xs4[];  // chunk_rows<MT>() x MT floats: [k][row]
  float* xs = reinterpret_cast<float*>(xs4);
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int mt = min(MT, M - m0);
  const int g_begin = split * groups_per_split;
  const int g_end = min(K / group, g_begin + groups_per_split);
  const int chunk_groups = chunk_rows<MT>() / group;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int c0 = g_begin; c0 < g_end; c0 += chunk_groups) {
    const int c1 = min(g_end, c0 + chunk_groups);
    const int nk = (c1 - c0) * group, kbase = c0 * group;
    __syncthreads();  // the previous chunk's reads of xs are done
    // 8 loads in flight per thread before any is stored
    for (int i0 = threadIdx.x; i0 < MT * nk; i0 += 8 * THREADS) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * THREADS, m = i / nk, kk = i - m * nk;
        v[e] = (i < MT * nk && m < mt) ? to_f(x[(size_t)(m0 + m) * K + kbase + kk]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = i0 + e * THREADS, m = i / nk, kk = i - m * nk;
        if (i < MT * nk) xs[kk * MT + m] = v[e];
      }
    }
    __syncthreads();
    if (n >= N) continue;
    for (int gi = c0; gi < c1; ++gi) {
      const float s = scales[(size_t)gi * N + n];
      const float z = zeros[(size_t)gi * N + n];
      for (int r0 = 0; r0 < group / 8; r0 += 8) {
        const int* wrow = qw + (size_t)(gi * group / 8 + r0) * N + n;
        unsigned u[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) u[i] = (unsigned)__ldg(wrow + (size_t)i * N);
        const float4* xr = reinterpret_cast<const float4*>(
            xs + (size_t)((gi - c0) * group + r0 * 8) * MT);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float w = ((float)((u[i] >> (4 * j)) & 15u) - z) * s;
#pragma unroll
            for (int q = 0; q < MT / 4; ++q) {
              const float4 a = xr[(i * 8 + j) * (MT / 4) + q];
              acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
            }
          }
        }
      }
    }
  }
  if (n >= N) return;
  if (partial != nullptr) {
    for (int m = 0; m < mt; ++m) partial[((size_t)split * M + m0 + m) * N + n] = acc[m];
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < mt) out[(size_t)(m0 + m) * N + n] = from_f<T>(acc[m]);
  }
}

// out[i] = sum over splits (in order) of partial[split, i], cast to T.
template <typename T>
__global__ void __launch_bounds__(256) awq_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ out, int splits, size_t MN) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= MN) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += partial[(size_t)s * MN + i];
  out[i] = from_f<T>(a);
}

static int row_tile(int M) {
  int mt = 4;
  while (mt < M && mt < 16) mt *= 2;
  return mt;
}

template <typename T, int MT>
static void launch_mt(const void* x, const void* qw, const void* scales, const void* zeros,
                      void* partial, void* out, int M, int K, int N, int group,
                      int splits, cudaStream_t s) {
  const int n_groups = K / group;
  const int gps = (n_groups + splits - 1) / splits;
  dim3 grid((N + THREADS - 1) / THREADS, splits, (M + MT - 1) / MT);
  awq_kernel<T, MT><<<grid, THREADS, SMEM_BYTES, s>>>(
      (const T*)x, (const int*)qw, (const float*)scales, (const float*)zeros,
      splits > 1 ? (float*)partial : nullptr, (T*)out, M, K, N, group, gps);
  if (splits > 1) {
    const size_t MN = (size_t)M * N;
    awq_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
        (const float*)partial, (T*)out, splits, MN);
  }
}

template <typename T>
static void launch_t(const void* x, const void* qw, const void* scales, const void* zeros,
                     void* partial, void* out, int M, int K, int N, int group, int splits,
                     cudaStream_t s) {
  switch (row_tile(M)) {
    case 4: launch_mt<T, 4>(x, qw, scales, zeros, partial, out, M, K, N, group, splits, s); break;
    case 8: launch_mt<T, 8>(x, qw, scales, zeros, partial, out, M, K, N, group, splits, s); break;
    default: launch_mt<T, 16>(x, qw, scales, zeros, partial, out, M, K, N, group, splits, s);
  }
}

static bool takes(int K, int group) {
  return group > 0 && group % 64 == 0 && K % group == 0 && group <= chunk_rows<16>();
}

// How many ranges of whole groups K is split over, so that the grid holds
// about BLOCKS_PER_SM blocks on `sms` SMs (at least one group per range);
// 0 when the kernel does not take (K, group): K % group == 0, group % 64
// == 0 and a group that fits one chunk (512 rows at M > 8).
extern "C" int awq_matmul_splits(int M, int K, int N, int group, int sms) {
  if (!takes(K, group) || K == 0) return 0;
  const int mt = row_tile(M);
  const int blocks = ((N + THREADS - 1) / THREADS) * ((M + mt - 1) / mt);
  const int groups = K / group;
  const int want = std::min(std::max((BLOCKS_PER_SM * sms + blocks - 1) / blocks, 1), groups);
  const int per = (groups + want - 1) / want;
  return (groups + per - 1) / per;
}

// dtype codes: 0 = float32, 1 = bfloat16 (x and out). `partial` is a
// float32 workspace of splits * M * N values (unused when splits == 1),
// splits from awq_matmul_splits. Returns cudaGetLastError().
extern "C" int awq_matmul_launch(const void* x, const void* qw, const void* scales,
                                 const void* zeros, void* partial, void* out, int M, int K,
                                 int N, int group, int splits, int dtype, void* stream) {
  if (!takes(K, group) || splits < 1 || splits > K / group) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch_t<float>(x, qw, scales, zeros, partial, out, M, K, N, group, splits, s);
  else if (dtype == 1)
    launch_t<__nv_bfloat16>(x, qw, scales, zeros, partial, out, M, K, N, group, splits, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
