// Paged decode attention over int8 / fp8 e4m3 codes with float32 scales
// per (page, kv head, position), dequantized in registers, for Hopper
// (sm_90a), bound with ctypes. The kernel and its design are in
// paged_attention.cuh; attention.cu instantiates it over pages in q's
// type, so that the two build in parallel.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (Pallas
// body _paged_kernel_quant).

#include "paged_attention.cuh"

template <typename T>
static int launch_kv(const PagedArgs* a) {
  switch (a->kv) {
    case 2: return launch_d<T, int8_t>(a);
    case 3: return launch_d<T, __nv_fp8_e4m3>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16 (q and out); kv codes: 2 = int8,
// 3 = float8 e4m3 codes whose (P, Hkv, page) float32 scales are ks, vs.
// The plan as in attention.cu. Returns the launch's error, or
// cudaErrorInvalidValue for a head dim, head group, type or plan the
// kernel does not take.
extern "C" int paged_attention_quant_launch(const PagedArgs* a) {
  if (bad_plan(a)) return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return launch_kv<float>(a);
  if (a->dtype == 1) return launch_kv<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
