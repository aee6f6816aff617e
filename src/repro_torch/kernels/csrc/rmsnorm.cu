// Fused RMSNorm for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body _rms_kernel).
//   y = x * rsqrt(mean(x^2) + eps) * w   (or * (1 + w), the Gemma form),
//   computed in float32 and cast to x's type; x and w each float32 or bf16.
//
// What bounds it on the card: bytes. It reads x and w once and writes y
// once, rows*D*(2 * elt) + D*elt_w bytes, and does about four flops per
// element -- two orders of magnitude below the H100's ridge of ~295
// flop/byte -- so the least time is those bytes over 3.35 TB/s: 0.010 ms
// at training's 2048 x 4096 bf16. A decode step's 8 rows are a launch's
// latency and nothing else.
//
// Design:
//  * vector body (rms_vec_kernel), where a row is a whole number of
//    16-byte vectors and x, w and y are 16-byte aligned: a team of TPR
//    threads owns a row (TPR = 32, a warp, for rows of up to 128 vectors,
//    four rows a block; TPR = 128, a block, up to 2048 vectors). Each
//    thread loads its NC vectors of the row with 16-byte loads, all in
//    flight at once, and keeps them in registers: device memory and L1
//    see x once. Squares are summed (in double for float32 rows, in
//    float32 for bf16), reduced with shuffles (and one shared-memory step
//    across a block's warps); w is then read
//    in vectors of the same elements and y written in 16-byte stores;
//  * scalar body (rms_row_kernel) for every other row: one block a row, a
//    strided pass for the sum and a second pass (from L1/L2) for y.
// The launch takes its arguments as one packed struct (RmsArgs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The sum of squares: double for float32 rows, so the mean is the
// correctly rounded one whatever the order of the sum (the card's
// float32 training must track the CPU's), float for bf16 rows.
template <typename TX>
using Acc = std::conditional_t<sizeof(TX) == 4, double, float>;

// 1 / sqrt(mean + eps), each step rounded as the plain version's float32
// torch.rsqrt rounds it (rsqrtf is two ulps off)
__device__ __forceinline__ float inv_rms(float mean, float eps) {
  return 1.f / sqrtf(mean + eps);
}

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

// 16 bytes of T <-> 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
// VEC consecutive elements of w (16-byte aligned) as floats
template <int VEC> __device__ __forceinline__ void load_w(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i)
    unpack(__ldg(reinterpret_cast<const uint4*>(p) + i), f + 4 * i, 0.f);
}
template <int VEC> __device__ __forceinline__ void load_w(const __nv_bfloat16* p, float* f) {
  if constexpr (VEC == 8) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f, __nv_bfloat16());
  } else {  // 4 bf16: 8 bytes
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// A team of TPR threads a row, 128 / TPR rows a block, NC vectors a thread.
template <typename TX, typename TW, int NC, int TPR>
__global__ void __launch_bounds__(128) rms_vec_kernel(const TX* __restrict__ x,
                                                      const TW* __restrict__ w,
                                                      TX* __restrict__ y, int rows, int D,
                                                      float eps, int gemma) {
  constexpr int VEC = 16 / (int)sizeof(TX);
  const int lt = threadIdx.x % TPR;
  const int row = blockIdx.x * (128 / TPR) + threadIdx.x / TPR;
  const int nv = D / VEC;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(live ? row : 0) * D);
  uint4 v[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lt + i * TPR;
    v[i] = live && c < nv ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
  }
  Acc<TX> ss = 0;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float f[VEC];
    unpack(v[i], f, TX());
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += (Acc<TX>)f[e] * f[e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (TPR > 32) {
    __shared__ Acc<TX> part[TPR / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) ss += part[i];
  }
  if (!live) return;
  const float r = inv_rms((float)(ss / D), eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lt + i * TPR;
    if (c < nv) {
      float f[VEC], s[VEC];
      unpack(v[i], f, TX());
      load_w<VEC>(w + c * VEC, s);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * (gemma ? s[e] + 1.f : s[e]);
      yr[c] = pack(f, TX());
    }
  }
}

// One block a row, any D and alignment.
template <typename TX, typename TW>
__global__ void rms_row_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                               TX* __restrict__ y, int D, float eps, int gemma) {
  const TX* xr = x + (size_t)blockIdx.x * D;
  TX* yr = y + (size_t)blockIdx.x * D;
  Acc<TX> ss = 0;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += (Acc<TX>)v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ Acc<TX> part[32];
  __shared__ float inv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    Acc<TX> t = lane < nw ? part[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) inv = inv_rms((float)(t / D), eps);
  }
  __syncthreads();
  const float r = inv;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float s = to_f(w[i]);
    if (gemma) s += 1.f;
    yr[i] = from_f<TX>(to_f(xr[i]) * r * s);
  }
}

template <typename TX, typename TW, int NC, int TPR>
static void vec(const TX* x, const TW* w, TX* y, int rows, int D, float eps, int gemma,
                cudaStream_t s) {
  constexpr int RPB = 128 / TPR;
  rms_vec_kernel<TX, TW, NC, TPR><<<(rows + RPB - 1) / RPB, 128, 0, s>>>(x, w, y, rows, D,
                                                                         eps, gemma);
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename TX, typename TW>
static int launch_t(const void* xp, const void* wp, void* yp, int rows, int D, float eps,
                    int gemma, cudaStream_t s) {
  const TX* x = (const TX*)xp;
  const TW* w = (const TW*)wp;
  TX* y = (TX*)yp;
  constexpr int VEC = 16 / (int)sizeof(TX);
  const int nv = D / VEC;
  if (D % VEC == 0 && aligned16(x) && aligned16(w) && aligned16(y) && nv <= 2048) {
    if (nv <= 32) vec<TX, TW, 1, 32>(x, w, y, rows, D, eps, gemma, s);
    else if (nv <= 64) vec<TX, TW, 2, 32>(x, w, y, rows, D, eps, gemma, s);
    else if (nv <= 128) vec<TX, TW, 4, 32>(x, w, y, rows, D, eps, gemma, s);
    else if (nv <= 256) vec<TX, TW, 2, 128>(x, w, y, rows, D, eps, gemma, s);
    else if (nv <= 512) vec<TX, TW, 4, 128>(x, w, y, rows, D, eps, gemma, s);
    else if (nv <= 1024) vec<TX, TW, 8, 128>(x, w, y, rows, D, eps, gemma, s);
    else vec<TX, TW, 16, 128>(x, w, y, rows, D, eps, gemma, s);
  } else {
    const int threads = D >= 256 ? 256 : ((D + 31) / 32) * 32;
    rms_row_kernel<TX, TW><<<rows, threads, 0, s>>>(x, w, y, D, eps, gemma);
  }
  return (int)cudaGetLastError();
}

// The launch's arguments, one block: a ctypes call costs per argument, and
// every layer of every path calls it twice. rmsnorm.py packs it with the
// same layout (struct format "<3Q2if3iQ", 56 bytes).
struct RmsArgs {
  const void *x, *w;
  void* y;
  int rows, D;
  float eps;
  int gemma, x_dtype, w_dtype;
  void* stream;
};
static_assert(sizeof(RmsArgs) == 56, "RmsArgs layout");

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a type or size the kernel does not take.
extern "C" int rmsnorm_launch(const RmsArgs* a) {
  if (a->rows <= 0 || a->D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)a->stream;
#define ARGS a->x, a->w, a->y, a->rows, a->D, a->eps, a->gemma, s
  if (a->x_dtype == 0 && a->w_dtype == 0) return launch_t<float, float>(ARGS);
  if (a->x_dtype == 0 && a->w_dtype == 1) return launch_t<float, __nv_bfloat16>(ARGS);
  if (a->x_dtype == 1 && a->w_dtype == 0) return launch_t<__nv_bfloat16, float>(ARGS);
  if (a->x_dtype == 1 && a->w_dtype == 1) return launch_t<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
