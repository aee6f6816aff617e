// Fused RMSNorm for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body _rms_kernel).
//
// What bounds it on the card: bytes. It reads x and w once and writes y
// once, rows*D*(2 * elt) + D*elt_w bytes, and does about four flops per
// element -- two orders of magnitude below the H100's ridge of ~295
// flop/byte -- so the least time is those bytes over 3.35 TB/s.
//
// Design: one block per row. Each thread sums the squares of a strided
// slice of the row in fp32; warp shuffles and one shared-memory step give
// the row's sum, and the block writes y = x * rsqrt(mean + eps) * w (or
// * (1 + w) for the Gemma convention) in x's type. The second pass re-reads
// the row from L1/L2 (a 4096-wide bf16 row is 8 KB), so device memory sees
// each byte once. Loads are scalar, not 16-byte vectors: making it fast is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename TX, typename TW>
__global__ void rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                               TX* __restrict__ y, int D, float eps, int gemma) {
  const TX* xr = x + (size_t)blockIdx.x * D;
  TX* yr = y + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float part[32];
  __shared__ float inv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float t = lane < nw ? part[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) inv = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float r = inv;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float s = to_f(w[i]);
    if (gemma) s += 1.f;
    yr[i] = from_f<TX>(to_f(xr[i]) * r * s);
  }
}

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int D,
                              float eps, int gemma, int x_dtype, int w_dtype,
                              void* stream) {
  const int threads = D >= 256 ? 256 : ((D + 31) / 32) * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && w_dtype == 0)
    rmsnorm_kernel<float, float><<<rows, threads, 0, s>>>(
        (const float*)x, (const float*)w, (float*)y, D, eps, gemma);
  else if (x_dtype == 0 && w_dtype == 1)
    rmsnorm_kernel<float, __nv_bfloat16><<<rows, threads, 0, s>>>(
        (const float*)x, (const __nv_bfloat16*)w, (float*)y, D, eps, gemma);
  else if (x_dtype == 1 && w_dtype == 0)
    rmsnorm_kernel<__nv_bfloat16, float><<<rows, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, (__nv_bfloat16*)y, D, eps, gemma);
  else if (x_dtype == 1 && w_dtype == 1)
    rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16><<<rows, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, D, eps,
        gemma);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
