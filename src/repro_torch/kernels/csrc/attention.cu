// Paged decode attention over pages in q's type (float32 or bf16), for
// Hopper (sm_90a), bound with ctypes. The kernel and its design are in
// paged_attention.cuh; attention_quant.cu instantiates it over int8/fp8
// codes, so that the two build in parallel.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (Pallas
// body _paged_kernel).

#include "paged_attention.cuh"

// dtype codes: 0 = float32, 1 = bfloat16 (q, out and the pages); kv must
// be 0 (ks and vs null). The keys of each (slot, kv head) are split into
// n_split <= 8 ranges of `chunk` positions, a whole number of pages each,
// n_split * chunk >= n_pages * page; gb query heads a block, gb dividing
// Hq / Hkv. Returns the launch's error, or cudaErrorInvalidValue for a
// head dim, head group, type or plan the kernel does not take.
extern "C" int paged_attention_launch(const PagedArgs* a) {
  if (bad_plan(a) || a->kv != 0) return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return launch_d<float, float>(a);
  if (a->dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
