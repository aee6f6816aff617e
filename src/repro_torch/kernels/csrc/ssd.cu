// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces: src/repro/kernels/ssm_scan.py::ssd (Pallas body _ssd_kernel).
// That kernel asserts h0 is None, yet its serving caller (models/ssm.py,
// the chunked-prefill continuation) passes h0; this kernel computes what
// src/repro/kernels/ref.py::ssd computes -- the JAX package's semantic
// ground truth -- h0 included.
//
// Per (batch, head) and chunk of L steps, with cum the inclusive cumsum of
// dt * A over the chunk and h the (P, N) state entering it:
//   y[t]  = sum_{s<=t} (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] x[s]
//         + exp(cum[t]) (C[t] . h^T) + D x[t]
//   h    <- exp(cum[L-1]) h + sum_s exp(cum[L-1] - cum[s]) dt[s] x[s]^T B[s]
//
// Two bodies, chosen by dtype alone.
//
// Body 1, float32 (CUDA cores, exact float32; the card-vs-CPU runs of the
// small float32 models need it), as first written:
//  * one block of 256 threads per (batch, head) walks the chunks in order;
//    the state h stays in shared memory across them (the Pallas grid's
//    sequential chunk axis becomes this loop);
//  * each chunk's x and B are staged once as float32 with padded rows
//    (P + 1, N + 1 floats), so loops that run along a row and loops that
//    run down a column are both free of bank conflicts;
//  * the L x L decay-weighted C.B matrix is never held whole (256 KB at
//    L = 256): rows t are taken TT = 32 at a time, and only columns
//    s < the tile's end are formed; exp(cum[t] - cum[s]) is evaluated for
//    s <= t only, so masked entries never produce an overflow;
//  * every thread keeps a few outputs in registers, so one shared load of
//    a B, x or h element feeds several fmas; P and N are template
//    parameters, so these loops unroll with no guard;
//  * b * H blocks (112 at batch 1) on 132 SMs, one block per SM for its
//    ~190 KB of shared memory; C.B formed again in every head's block.
//
// Body 2, bfloat16 (the serving path: zamba2-7b's prefill piece, one
// 256-step chunk, H = 112 heads of P = 64, N = 64). What bounds it: the
// float32 math of the scan is 0.95 GFLOP a 256-step chunk at this shape,
// ~14 us on CUDA cores (67 TFLOP/s), against ~3.3 us for its 11 MB of x,
// y and the two states. Every product of the scan has one operand that is
// exact in bf16 (C.B: both; M x: x; C h^T: C; (x o w)^T B: B), so this
// body runs them on the tensor cores (mma.sync m16n8k16, float32
// accumulation) with the float32 operand cut into bf16 pieces, each the
// rounding of what the earlier left: three for x o w (24 bits: the
// float32 state is held to 1e-5 of its largest value), two for M and h
// (16 bits: y is bf16); tests/test_torch_ssd_plan.py holds these pieces
// to those checks. On tensor cores the bytes bound it.
// The SSD algorithm one level finer: a chunk of L steps is CL = L / Q
// sub-chunks of Q = 64 steps (16 where L is not a multiple of 64; CL <= 8),
// with cum now the cumsum from the sub-chunk's start and h_j the state
// entering sub-chunk j:
//   y[t]    = sum_{s in j, s<=t} M[t][s] x[s] + exp(cum[t]) C[t] . h_j + D x[t]
//   h_{j+1} = exp(cum[Q-1]) h_j + S_j,  S_j = sum_{s in j} exp(cum[Q-1] - cum[s]) dt[s] x[s]^T B[s]
// with M[t][s] = C.B[t][s] exp(cum[t] - cum[s]) dt[s]: the same function as
// the chunk of L, up to rounding. Two launches:
//  * ssd_cb_kernel: C.B of each (batch, sub-chunk), its lower triangle's
//    16 x 16 tiles, once for all heads (B and C are shared by them),
//    float32 into a workspace (10 KB a sub-chunk of 64): T / Q blocks a
//    batch row, 18 KB of shared memory;
//  * ssd_sub_kernel: one block of 128 threads per (sub-chunk j, head,
//    batch), the CL sub-chunks of a chunk one thread block cluster: grid
//    (CL, H, b), 448 blocks at the serving shape on 132 SMs; 56 KB of
//    shared memory a block (x, B and C rows in bf16, S_j written over x
//    and B once they are read, C.B's tiles and the state in float32) and
//    at most 128 registers, so four blocks an SM: one wave. The loads of a
//    chunk (cp.async for x and C, then for a live block B and C.B) are
//    in flight at once; x and B stay in their own layout, ldmatrix .trans
//    reading their fragments. Each block forms M x and S_j for its
//    sub-chunk, the cluster syncs, and the carry runs over slices of the
//    state: block r takes a CL-th of its elements, writes the state
//    entering each sub-chunk i into block i's shared memory and carries
//    it over sub-chunk i (S_i read from block i through distributed
//    shared memory), in rank order: the same sums in every block and on
//    every run. The cluster syncs again, each block adds exp(cum[t]) C h_j,
//    and the cluster walks the chunks in order, the slice leaving a chunk
//    kept in h_final's place (the final state after the last). (Block j
//    reading all of S_0 .. S_{j-1} itself made the last block the slowest
//    by far; so did two blocks an SM, or fragments built from 16-bit
//    loads.)
// A sub-chunk whose dt are all 0 (a short prefill piece padded to the
// chunk) has S_j = 0, decay 1 and no intra term: its block skips both
// products and its rows get the inter-chunk and D x terms only.
//
// Both bodies: padded steps (dt = 0) contribute nothing to h: their weight
// is 0 and they add nothing to cum; their y is computed and the caller
// drops it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define TT 32        // rows t of the C.B tile

// The float32 body. x, y: (b, T, H, P); dt: (b, T, H); A, D: (H,); Bm, Cm:
// (b, T, N); h0 (may be null), hout: (b, H, P, N). P and N are
// template parameters, so every register loop has a compile-time trip
// count and no guard. One block per SM (its shared memory allows no
// second), so the register budget is the whole 255 a thread may have.
template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dv,
           const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hout,
           int Tn, int H, int L) {
  constexpr int NP = N + 1, PP = P + 1;
  constexpr int RY = THREADS / P, KY = TT / RY;   // y: thread owns column p, KY rows
  constexpr int RH = THREADS / N, KH = P / RH;    // state: thread owns column n, KH rows
  static_assert(THREADS % P == 0 && THREADS % N == 0 && TT % RY == 0 && P % RH == 0,
                "P and N must divide the block");
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* sB = smem;                // L x NP
  float* sX = sB + L * NP;         // L x PP
  float* sH = sX + L * PP;         // P x NP, the state entering the chunk
  float* sC = sH + P * NP;         // TT x NP, C rows of the tile
  float* sM = sC + TT * NP;        // TT x L, decay-weighted C.B of the tile
  float* sCum = sM + TT * L;       // L
  float* sDt = sCum + L;           // L
  float* sW = sDt + L;             // L: exp(cum[L-1] - cum[s]) * dt[s]

  const float a_h = A[h], d_h = Dv[h];
  const size_t hbase = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    sH[(i / N) * NP + i % N] = h0 ? h0[hbase + i] : 0.f;
  const int py = tid % P, ry = tid / P;
  const int nh = tid % N, ph = tid / N;

  for (int c = 0; c < Tn / L; ++c) {
    const size_t row0 = (size_t)b * Tn + (size_t)c * L;   // (b, t) row of the chunk
    __syncthreads();               // the previous chunk is done with sX, sB, sH
    for (int i = tid; i < L * P; i += THREADS)
      sX[(i / P) * PP + i % P] = x[((row0 + i / P) * H + h) * P + i % P];
    for (int i = tid; i < L * N; i += THREADS)
      sB[(i / N) * NP + i % N] = Bm[row0 * N + i];
    for (int s = tid; s < L; s += THREADS) sDt[s] = dt[(row0 + s) * H + h];
    __syncthreads();
    if (tid < 32) {                // inclusive cumsum of dt * A: runs per lane, then a warp scan
      const int per = (L + 31) / 32, lo = min(tid * per, L), hi = min(lo + per, L);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += sDt[s] * a_h;
        sCum[s] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float off = incl - run;
      for (int s = lo; s < hi; ++s) sCum[s] += off;
    }
    __syncthreads();
    const float cl = sCum[L - 1];
    for (int s = tid; s < L; s += THREADS) sW[s] = expf(cl - sCum[s]) * sDt[s];

    for (int t0 = 0; t0 < L; t0 += TT) {
      const int rows = min(TT, L - t0), cols = t0 + rows;   // s < cols
      for (int i = tid; i < rows * N; i += THREADS)
        sC[(i / N) * NP + i % N] = Cm[(row0 + t0) * N + i];
      __syncthreads();
      {  // M[r][s] = (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] for s <= t, else 0
        const int lane = tid & 31, g = tid >> 5;            // 8 row groups of 4
        for (int s = lane; s < cols; s += 32) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
          for (int n = 0; n < N; ++n) {
            const float bv = sB[s * NP + n];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] = fmaf(sC[(g + 8 * k) * NP + n], bv, acc[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = g + 8 * k, t = t0 + r;
            if (r < rows)
              sM[r * L + s] = s <= t ? acc[k] * expf(sCum[t] - sCum[s]) * sDt[s] : 0.f;
          }
        }
      }
      __syncthreads();
      {  // y rows of the tile: thread owns column py, rows ry + k * RY; rows
         // past the tile's end read stale sM and are not written
        float yi[KY], ye[KY];
#pragma unroll
        for (int k = 0; k < KY; ++k) yi[k] = ye[k] = 0.f;
#pragma unroll 4
        for (int s = 0; s < cols; ++s) {
          const float xv = sX[s * PP + py];
#pragma unroll
          for (int k = 0; k < KY; ++k) yi[k] = fmaf(sM[(ry + k * RY) * L + s], xv, yi[k]);
        }
#pragma unroll 16
        for (int n = 0; n < N; ++n) {
          const float hv = sH[py * NP + n];
#pragma unroll
          for (int k = 0; k < KY; ++k) ye[k] = fmaf(sC[(ry + k * RY) * NP + n], hv, ye[k]);
        }
#pragma unroll
        for (int k = 0; k < KY; ++k) {
          const int r = ry + k * RY;
          if (r < rows) {
            const int t = t0 + r;
            const float v = yi[k] + expf(sCum[t]) * ye[k] + d_h * sX[t * PP + py];
            y[((row0 + t) * H + h) * P + py] = v;
          }
        }
      }
      __syncthreads();             // sC and sM are rewritten by the next tile
    }

    {  // state: thread owns column nh, rows ph + k * RH
      float acc[KH];
#pragma unroll
      for (int k = 0; k < KH; ++k) acc[k] = 0.f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float wb = sW[s] * sB[s * NP + nh];
#pragma unroll
        for (int k = 0; k < KH; ++k) acc[k] = fmaf(sX[s * PP + ph + k * RH], wb, acc[k]);
      }
      const float decay = expf(cl);
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        float* hp = sH + (ph + k * RH) * NP + nh;
        *hp = fmaf(decay, *hp, acc[k]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) hout[hbase + i] = sH[(i / N) * NP + i % N];
}

// ---------------------------------------------------- bfloat16: tensor cores
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// (x0, x1) as NP bf16 pieces, each the rounding of what the earlier left:
// two keep about 16 bits of a float32, three its 24
template <int NP>
__device__ __forceinline__ void split(float x0, float x1, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    w[i] = pack2(x0, x1);
    x0 -= lo_f(w[i]);
    x1 -= hi_f(w[i]);
  }
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major fragment) b (16 x 8 bf16):
// lane (g, t) = (lane / 4, lane % 4) holds a rows g, g + 8 and columns
// 2t, 2t + 1, 2t + 8, 2t + 9; b rows 2t, 2t + 1, 2t + 8, 2t + 9 of
// column g; d rows g, g + 8 and columns 2t, 2t + 1
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp tiling of an (M, N) output in 16 x 8 tiles over W warps: warp w
// takes m-tile w / WN and n-tiles (w % WN) NPW .. + NPW
template <int M, int N, int W> struct Tiling {
  static constexpr int MT = M / 16, NT = N / 8;
  static constexpr int WN = NT < W / MT ? NT : W / MT, NPW = NT / WN, WARPS = MT * WN;
};

// CB[t][s] = C[t] . B[s] for t, s in one sub-chunk of Q steps: one block
// per (sub-chunk, batch), the product once for all heads. Only the lower
// triangle's 16 x 16 tiles (mt, kt <= mt) are kept, packed in that order,
// each row-major: CBT(Q) floats a sub-chunk
template <int Q> struct CbTiles {
  static constexpr int MT = Q / 16, N = MT * (MT + 1) / 2, FLOATS = N * 256;
};
__host__ __device__ constexpr int cb_tile(int mt, int kt) { return mt * (mt + 1) / 2 + kt; }

template <int N, int Q>
__global__ void __launch_bounds__(256)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb,
              int Tn) {
  constexpr int NS = N + 8;  // bf16 row stride: fragment loads free of bank conflicts
  __shared__ __align__(16) bf16 sB[Q * NS], sC[Q * NS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const size_t row0 = (size_t)blockIdx.y * Tn + (size_t)blockIdx.x * Q;
  for (int i = tid; i < Q * N / 8; i += 256) {
    const int r = i / (N / 8), c = 8 * (i % (N / 8));
    *reinterpret_cast<uint4*>(sB + r * NS + c) =
        *reinterpret_cast<const uint4*>(Bm + (row0 + r) * N + c);
    *reinterpret_cast<uint4*>(sC + r * NS + c) =
        *reinterpret_cast<const uint4*>(Cm + (row0 + r) * N + c);
  }
  __syncthreads();
  float* out = cb + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * CbTiles<Q>::FLOATS;
  for (int ti = warp; ti < (Q / 16) * (Q / 8); ti += 8) {  // 8 warps
    const int mt = ti / (Q / 8), nt = ti % (Q / 8);
    if (nt / 2 > mt) continue;  // above the diagonal
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      const bf16* ca = sC + (16 * mt + g) * NS + 16 * kt + 2 * t4;
      const uint32_t a[4] = {ld32(ca), ld32(ca + 8 * NS), ld32(ca + 8), ld32(ca + 8 * NS + 8)};
      const bf16* bb = sB + (8 * nt + g) * NS + 16 * kt + 2 * t4;
      mma16816(d, a, ld32(bb), ld32(bb + 8));
    }
    float* o = out + cb_tile(mt, nt / 2) * 256 + g * 16 + 8 * (nt & 1) + 2 * t4;
    *reinterpret_cast<float2*>(o) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(o + 8 * 16) = make_float2(d[2], d[3]);
  }
}

// The scan of one (sub-chunk j, head, batch): block j of a cluster of CL
// = L / Q blocks, which walks the chunks of its (batch, head) in order.
// 128 threads; shared memory: x, B and C rows of the sub-chunk in bf16
// (natural layout, rows padded by 16 bytes: fragment loads free of bank
// conflicts), S_j over x and B once they are read, the state in float32.
constexpr int SUB_THREADS = 128;
template <int P, int N, int Q> struct Sub {
  static constexpr int XS = P + 8, BS = N + 8, HS = N + 8;  // row strides (elements)
  static constexpr size_t XB = sizeof(bf16) * (size_t)Q * (XS + BS);  // x and B
  static constexpr size_t SB = sizeof(float) * (size_t)P * N;         // S_j
  static constexpr size_t U = XB > SB ? XB : SB;                       // S_j over x and B
  static constexpr size_t bytes = U + sizeof(bf16) * (size_t)Q * BS +
                                  sizeof(float) * (CbTiles<Q>::FLOATS + (size_t)P * HS + 3 * Q + 2);
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// ldmatrix .trans from a row-major tile of 16-byte rows: lane l gives the
// row of matrix l / 8; each thread gets rows 2 t, 2 t + 1 of column g of
// every 8 x 8 matrix, the mma fragment of an operand stored K-major
__device__ __forceinline__ void ldsm_t4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_t2(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

template <int P, int N, int Q>
__global__ void __launch_bounds__(SUB_THREADS, 4)
ssd_sub_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ h0, const float* __restrict__ cb,
               bf16* __restrict__ y, float* __restrict__ hout, int Tn, int H, int L) {
  using S_ = Sub<P, N, Q>;
  constexpr int XS = S_::XS, BS = S_::BS, HS = S_::HS, W = SUB_THREADS / 32;
  using TY = Tiling<Q, P, W>;   // y (steps x P)
  using TS = Tiling<P, N, W>;   // the sub-chunk's state (P x N)
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  bf16* sX = reinterpret_cast<bf16*>(base);                 // Q x XS
  bf16* sB = sX + Q * XS;                                   // Q x BS
  float* sS = reinterpret_cast<float*>(base);               // P x N, once x and B are read
  bf16* sC = reinterpret_cast<bf16*>(base + S_::U);         // Q x BS
  float* sCB = reinterpret_cast<float*>(sC + Q * BS);       // C.B's lower-triangle tiles
  float* sH = sCB + CbTiles<Q>::FLOATS;                      // P x HS: h_j, from the ranks' carry
  float* sCum = sH + P * HS;  // Q: inclusive cumsum of dt A from the sub-chunk's start
  float* sDt = sCum + Q;      // Q
  float* sW = sDt + Q;        // Q: exp(cum[Q-1] - cum[s]) dt[s]
  float* sA = sW + Q;         // [0]: exp(cum[Q-1]); [1]: 1 if any dt != 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, CL = gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int F4 = P * N / 4;  // the state's float4s, row f / (N / 4)
  const float a_h = A[h], d_h = Dv[h];
  const size_t hbase = ((size_t)b * H + h) * P * N;
  // rank j owns float4s [j F4 / CL, (j + 1) F4 / CL) of the state
  const int f_lo = j * F4 / CL, f_hi = (j + 1) * F4 / CL;
  const int nc = Tn / L;
  for (int c = 0; c < nc; ++c) {
    const size_t r0 = (size_t)b * Tn + (size_t)c * L + (size_t)j * Q;  // its first (b, t) row
    // stage x, C and dt with cp.async, all in flight together
    for (int i = tid; i < Q * P / 8; i += SUB_THREADS) {
      const int st = i / (P / 8), p = 8 * (i % (P / 8));
      cp16(sX + st * XS + p, x + ((r0 + st) * H + h) * P + p, true);
    }
    for (int i = tid; i < Q * N / 8; i += SUB_THREADS) {
      const int st = i / (N / 8), n = 8 * (i % (N / 8));
      cp16(sC + st * BS + n, Cm + (r0 + st) * N + n, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float dtv = tid < Q ? dt[(r0 + tid) * H + h] : 0.f;
    if (tid < Q) sDt[tid] = dtv;
    // a sub-chunk whose dt are all 0 has no intra term, S_j = 0 and decay
    // 1: its block skips B, C.B and both products
    const bool live = __syncthreads_or(dtv != 0.f);
    // B and C.B's tiles, in flight while the cumsum runs
    if (live) {
      for (int i = tid; i < Q * N / 8; i += SUB_THREADS) {
        const int st = i / (N / 8), n = 8 * (i % (N / 8));
        cp16(sB + st * BS + n, Bm + (r0 + st) * N + n, true);
      }
      const float* cbp = cb + ((size_t)b * (Tn / Q) + (size_t)c * CL + j) * CbTiles<Q>::FLOATS;
      for (int i = tid; i < CbTiles<Q>::FLOATS / 4; i += SUB_THREADS)
        cp16(sCB + 4 * i, cbp + 4 * i, true);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int mt = warp / TY::WN, nt0 = (warp % TY::WN) * TY::NPW;
    const bool ywarp = warp < TY::WARPS;
    if (warp == 0) {  // inclusive cumsum of dt A: runs per lane, then a warp scan
      constexpr int PER = (Q + 31) / 32;
      const int lo = min(lane * PER, Q), hi = min(lo + PER, Q);
      float run = 0.f;
      for (int s = lo; s < hi; ++s) {
        run += sDt[s] * a_h;
        sCum[s] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float off = incl - run;
      for (int s = lo; s < hi; ++s) sCum[s] += off;
      if (lane == 31) {
        sA[0] = expf(incl);  // incl of lane 31 is cum[Q-1]
        sA[1] = live ? 1.f : 0.f;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (tid < Q) sW[tid] = expf(sCum[Q - 1] - sCum[tid]) * sDt[tid];
    __syncthreads();

    // y's intra-sub-chunk term: M x with M[t][s] = CB[t][s] exp(cum[t] -
    // cum[s]) dt[s] for s <= t, M in two bf16 pieces; k-tiles past the
    // diagonal are zero and skipped. A sub-chunk whose dt are all 0 has no
    // intra term, S_j = 0 and decay 1: both products are skipped
    float yi[TY::NPW][4];
#pragma unroll
    for (int u = 0; u < TY::NPW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[u][e] = 0.f;
    if (live && ywarp) {
#pragma unroll
      for (int kt = 0; kt < Q / 16; ++kt) {
        if (kt > mt) break;
        uint32_t a[2][4];
        const float* tile = sCB + cb_tile(mt, kt) * 256;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 16 * mt + g + 8 * (r & 1), s = 16 * kt + 2 * t4 + 8 * (r >> 1);
          const float2 v = *reinterpret_cast<const float2*>(tile + (t & 15) * 16 + (s & 15));
          // y is bf16: the fast exponential (a few ulps) serves M
          const float m0 = s <= t ? v.x * __expf(sCum[t] - sCum[s]) * sDt[s] : 0.f;
          const float m1 = s + 1 <= t ? v.y * __expf(sCum[t] - sCum[s + 1]) * sDt[s + 1] : 0.f;
          uint32_t w[2];
          split<2>(m0, m1, w);
          a[0][r] = w[0];
          a[1][r] = w[1];
        }
#pragma unroll
        for (int u = 0; u < TY::NPW; ++u) {  // x rows 16 kt .. + 15, columns of n-tile nt0 + u
          uint32_t bx[2];
          ldsm_t2(bx, sX + (16 * kt + 8 * ((lane >> 3) & 1) + (lane & 7)) * XS + 8 * (nt0 + u));
          mma16816(yi[u], a[0], bx[0], bx[1]);
          mma16816(yi[u], a[1], bx[0], bx[1]);
        }
      }
    }
    // the sub-chunk's own state S_j = (x o w)^T B (P x N, over its Q
    // steps), x o w in three bf16 pieces: float32 accuracy for the state;
    // it goes to shared memory over x and B once every warp has read them
    {
      const int ms = warp / TS::WN, ns0 = (warp % TS::WN) * TS::NPW;
      float acc[TS::NPW][4];
#pragma unroll
      for (int u = 0; u < TS::NPW; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      const bool sw = live && warp < TS::WARPS;
      if (sw) {
#pragma unroll
        for (int kt = 0; kt < Q / 16; ++kt) {
          // x^T's fragment: matrix m holds x rows 16 kt + 8 (m / 2) .. + 7,
          // columns 16 ms + 8 (m % 2) .. + 7
          uint32_t xf[4], a[3][4];
          ldsm_t4(xf, sX + (16 * kt + 8 * (lane >> 4) + (lane & 7)) * XS + 16 * ms +
                          8 * ((lane >> 3) & 1));
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // register r: row p + 8 (r & 1), column s + 8 (r >> 1)
            const int sc = 16 * kt + 2 * t4 + 8 * (r >> 1);
            uint32_t w[3];
            split<3>(lo_f(xf[r]) * sW[sc], hi_f(xf[r]) * sW[sc + 1], w);
            a[0][r] = w[0];
            a[1][r] = w[1];
            a[2][r] = w[2];
          }
#pragma unroll
          for (int u = 0; u < TS::NPW; ++u) {
            uint32_t bf[2];
            ldsm_t2(bf, sB + (16 * kt + 8 * ((lane >> 3) & 1) + (lane & 7)) * BS + 8 * (ns0 + u));
#pragma unroll
            for (int k = 0; k < 3; ++k) mma16816(acc[u], a[k], bf[0], bf[1]);
          }
        }
      }
      __syncthreads();  // x and B are read
      if (sw) {
#pragma unroll
        for (int u = 0; u < TS::NPW; ++u) {
          float* o = sS + (16 * ms + g) * N + 8 * (ns0 + u) + 2 * t4;
          *reinterpret_cast<float2*>(o) = make_float2(acc[u][0], acc[u][1]);
          *reinterpret_cast<float2*>(o + 8 * N) = make_float2(acc[u][2], acc[u][3]);
        }
      }
    }
    if (CL > 1) cluster.sync();  // every S_j and decay of the chunk is written
    else __syncthreads();

    // the carry, each rank over its slice of the state: the slice entering
    // the chunk (h0's, or the last chunk's left in hout), written to rank
    // i's sH as the state entering sub-chunk i, then carried over it (decay
    // a_i, plus S_i read from rank i), in rank order: the same sums in
    // every block and on every run. The slice leaving the chunk goes to
    // hout (the final state after the last chunk)
    float4* hout4 = reinterpret_cast<float4*>(hout + hbase);
    for (int f = f_lo + tid; f < f_hi; f += SUB_THREADS) {
      float4 hv = c > 0 ? hout4[f]
                        : h0 ? reinterpret_cast<const float4*>(h0 + hbase)[f]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const int at = (f / (N / 4)) * HS + 4 * (f % (N / 4));
      for (int i = 0; i < CL; ++i) {
        float* rh = CL > 1 ? cluster.map_shared_rank(sH, i) : sH;
        *reinterpret_cast<float4*>(rh + at) = hv;
        const float* ra = CL > 1 ? cluster.map_shared_rank(sA, i) : sA;
        const float a = ra[0];
        if (ra[1] != 0.f) {
          const float4 sv =
              reinterpret_cast<const float4*>(CL > 1 ? cluster.map_shared_rank(sS, i) : sS)[f];
          hv = make_float4(a * hv.x + sv.x, a * hv.y + sv.y, a * hv.z + sv.z, a * hv.w + sv.w);
        } else {
          hv = make_float4(a * hv.x, a * hv.y, a * hv.z, a * hv.w);
        }
      }
      hout4[f] = hv;
    }
    // every h_j is in place; after this no block reads another's shared
    // memory in this chunk, so none rewrites or exits early
    if (CL > 1) cluster.sync();
    else __syncthreads();

    // y's inter-sub-chunk term: exp(cum[t]) C[t] . h_j, h_j in two bf16
    // pieces; then y = intra + inter + D x (x read again from L2)
    if (ywarp) {
      float yo[TY::NPW][4];
#pragma unroll
      for (int u = 0; u < TY::NPW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[u][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < N / 16; ++kt) {
        const bf16* ca = sC + (16 * mt + g) * BS + 16 * kt + 2 * t4;
        const uint32_t a[4] = {ld32(ca), ld32(ca + 8 * BS), ld32(ca + 8), ld32(ca + 8 * BS + 8)};
#pragma unroll
        for (int u = 0; u < TY::NPW; ++u) {
          const float* hp = sH + (8 * (nt0 + u) + g) * HS + 16 * kt + 2 * t4;
          const float2 v0 = *reinterpret_cast<const float2*>(hp);
          const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
          uint32_t w0[2], w1[2];
          split<2>(v0.x, v0.y, w0);
          split<2>(v1.x, v1.y, w1);
          mma16816(yo[u], a, w0[0], w1[0]);
          mma16816(yo[u], a, w0[1], w1[1]);
        }
      }
#pragma unroll
      for (int u = 0; u < TY::NPW; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 16 * mt + g + 8 * hf, p = 8 * (nt0 + u) + 2 * t4;
          const size_t at = ((r0 + t) * H + h) * P + p;
          const uint32_t xv = __ldg(reinterpret_cast<const unsigned int*>(x + at));
          const float et = __expf(sCum[t]);
          const float v0 = yi[u][2 * hf] + et * yo[u][2 * hf] + d_h * lo_f(xv);
          const float v1 = yi[u][2 * hf + 1] + et * yo[u][2 * hf + 1] + d_h * hi_f(xv);
          *reinterpret_cast<uint32_t*>(y + at) = pack2(v0, v1);
        }
    }
    __syncthreads();  // sH (h_j) is read before the next chunk's carry writes it
  }
}

// The (P, N) pairs the kernels are built for: the smoke configs' (16, 16)
// and zamba2-7b's (64, 64).
static bool supported(int P, int N) { return (P == 16 && N == 16) || (P == 64 && N == 64); }

// The bf16 body's sub-chunk: 64 steps where the chunk is a multiple of 64,
// else 16; a chunk is at most 8 sub-chunks (one thread block cluster).
static int sub_chunk(int L) { return L % 64 == 0 ? 64 : L % 16 == 0 ? 16 : 0; }

// Dynamic shared memory the float32 kernel needs, or 0 where it does not
// take the shape; a request past the block limit fails at launch.
static size_t smem_bytes(int P, int N, int L) {
  if (!supported(P, N) || L <= 0) return 0;
  return sizeof(float) * ((size_t)L * (N + 1) + (size_t)L * (P + 1) + (size_t)P * (N + 1) +
                          (size_t)TT * (N + 1) + (size_t)TT * L + 3 * (size_t)L);
}

// Lift each instantiation's dynamic shared-memory cap to the block limit
// once, then launch it.
template <int P, int N>
static int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* Dv, const void* h0, void* y, void* hout,
                      int batch, cudaStream_t s, int Tn, int H, int L) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ssd_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (allowed != cudaSuccess) return (int)allowed;
  ssd_kernel<P, N><<<dim3(H, batch), THREADS, smem_bytes(P, N, L), s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)Dv, (const float*)h0, (float*)y, (float*)hout, Tn, H, L);
  return (int)cudaGetLastError();
}

// The bf16 body: the C.B pass, then the sub-chunk scan in clusters of CL
template <int P, int N, int Q>
static int launch_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* Dv, const void* h0, float* cb, void* y,
                       void* hout, int batch, cudaStream_t s, int Tn, int H, int L) {
  constexpr size_t bytes = Sub<P, N, Q>::bytes;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ssd_sub_kernel<P, N, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (allowed != cudaSuccess) return (int)allowed;
  ssd_cb_kernel<N, Q><<<dim3(Tn / Q, batch), 256, 0, s>>>((const bf16*)Bm, (const bf16*)Cm,
                                                          cb, Tn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int CL = L / Q;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H, batch);
  cfg.blockDim = dim3(SUB_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, ssd_sub_kernel<P, N, Q>, (const bf16*)x, (const float*)dt,
                         (const float*)A, (const bf16*)Bm, (const bf16*)Cm, (const float*)Dv,
                         (const float*)h0, (const float*)cb, (bf16*)y, (float*)hout, Tn, H, L);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dtype code of x, B, C and y: 0 = float32 (one launch), 1 = bfloat16 (two
// launches; cb is a float32 workspace of batch * Tn * sub_chunk(L)
// floats). Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// the kernels do not take or a shared-memory request the device refuses).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* Dv, const void* h0, void* y,
                          void* hout, float* cb, int batch, int Tn, int H, int P, int N, int L,
                          int dtype, void* stream) {
  if (!supported(P, N) || L <= 0 || Tn % L != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (smem_bytes(P, N, L) == 0) return (int)cudaErrorInvalidValue;
    return P == 16 ? launch_f32<16, 16>(x, dt, A, Bm, Cm, Dv, h0, y, hout, batch, s, Tn, H, L)
                   : launch_f32<64, 64>(x, dt, A, Bm, Cm, Dv, h0, y, hout, batch, s, Tn, H, L);
  }
  const int Q = sub_chunk(L);
  if (Q == 0 || L / Q > 8 || cb == nullptr) return (int)cudaErrorInvalidValue;
#define ARGS x, dt, A, Bm, Cm, Dv, h0, cb, y, hout, batch, s, Tn, H, L
  if (P == 16)
    return Q == 64 ? launch_bf16<16, 16, 64>(ARGS) : launch_bf16<16, 16, 16>(ARGS);
  return Q == 64 ? launch_bf16<64, 64, 64>(ARGS) : launch_bf16<64, 64, 16>(ARGS);
#undef ARGS
}
