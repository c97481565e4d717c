// Fused Swin window attention: forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels in boxinstseg_tpu/ops/swin_attention.py:
//   K5  _fwd_kernel_factory  (driven by _flash_fwd)
//   K6  _bwd_kernel_factory  (driven by _flash_bwd, the custom VJP of
//       window_attention)
// Math, per window bw and head h, with q, k, v (BW, N, C), C = H*D, head h in
// columns [h*D, (h+1)*D), bias (H, N, N) and regions (nW, N) int32 (window
// bw uses region row bw % nW: windows are image-major):
//   s[i,j] = (q_i . k_j) * scale + bias[h,i,j] + (reg[i] != reg[j] ? -100 : 0)
//   P = softmax_j(s),  out_i = sum_j P[i,j] v_j
// Backward with g = d(out):
//   dV = P^T g,  dP = g V^T,  dS = P o (dP - rowsum(dP o P)),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dbias[h] = sum_bw dS.
// The mask constant is -100 (not -inf), as in the JAX package and mmdet.
//
// What bounds them on an H100. At Swin-L's window 12 (N = 144, D = 32) the
// forward does 4*N^2*D = 2.65 MFLOP of products per (window, head) against
// 74 KB of q, k, v and out; the backward five such products. Counted at the
// fp32 rate (67 TFLOP/s) the operations bound both kernels; with the
// products on the tensor cores in 3xTF32 (three TF32 products each, 495
// TFLOP/s) the forward is bound by its bytes (3.35 TB/s) and the backward
// by its operations. Measured at Swin-L's stage 0 / stage 2 shapes (NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py): the forward reaches 30% / 22% of
// its fp32 bound and 16% / 12% of its 3xTF32 bound, the backward 19% / 15%
// and 8% / 6%; both run under torch's scaled_dot_product_attention.
//
// Design.
// - Products on the tensor cores, at fp32 accuracy: every operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding), and a
//   product sums lo*hi + hi*lo + hi*hi in fp32 accumulators (mma.sync
//   m16n8k8 TF32); the dropped lo*lo term is 2^-22 of the product. A single
//   TF32 product would leave about 2^-11, which the fp32 tolerances of the
//   checks do not admit (tests/test_torch_swin_tf32.py emulates both).
// - One warp owns a strip of 16 rows and holds the strip's scores against
//   all keys in registers (KT tiles of 16 x 8, KT = 18 at N = 144): softmax
//   reduces over the quad's 4 lanes and the tiles; P never leaves the
//   registers. A product with P (or dS) as its left operand takes the
//   accumulator tile as the A fragment directly: the accumulator holds
//   columns 2t, 2t+1 where the A fragment wants t, t+4, so the right
//   operand's rows are read in the same permuted order (rows 8*tile + 2t and
//   8*tile + 2t + 1), and no shuffle is needed.
// - The tile loops have no branches: D is padded with zeros to whole chunks
//   of 32 columns, and each of the three split products sweeps several
//   tiles, so consecutive mma instructions write different accumulators.
//   The scores start at bias + shift mask (-inf for padded keys) and add
//   the products of q * scale: the bias loads start ahead of the products.
// - A block is persistent over one head and a group of windows bw = grp,
//   grp + G, ...; the wrapper picks G so that the blocks fill the card and
//   no group walks more than ceil(BW / G) windows. q, k, v (and g) slices
//   are staged with cp.async (16 bytes where aligned) one window at a time:
//   a second buffer, to copy the next window during this one's math, was
//   measured and bought nothing at Swin-L's shapes. Rows are padded to D32 +
//   4 floats, so fragment loads are free of bank conflicts and rows stay
//   16-byte aligned. Padded rows and columns are zero; padded queries are
//   never stored.
// - The forward keeps the head's bias in shared memory for all its windows
//   when it fits (N <= 144 at D = 32), read as float2.
// - The backward has no N x N buffer per window: a query-major pass per warp
//   recomputes S and P, forms dP = g V^T, D_i = sum_j dP o P and dS, writes
//   dQ, adds dS into the block's dbias accumulator in shared memory (a warp
//   owns its strip's rows: no atomics) and leaves the row max, 1/sum and D in
//   shared memory; a key-major pass recomputes S^T and P^T for its 16 keys
//   from those, then dV = P^T g, dP^T = V g^T, dS^T and dK = dS^T Q. The
//   accumulator leaves the chip once per block into a (G, H, N, N) partial,
//   summed by a second kernel in a fixed order: dqkv and dbias are the same
//   bits from run to run. The accumulator, four staged operands and the
//   statistics fill the shared memory at N = 144, so the backward reads the
//   bias from L2 there.
// - Past N = 144 at D = 32 the whole-block accumulator (NR x (NR + 8)
//   floats) no longer fits beside the staged operands. Such a block adds dS
//   straight into its own (group, head) slice of the partial instead: the
//   slice is the block's alone, and within it each element belongs to one
//   thread (the warp's strip row, the lane's columns) in every window, so
//   the read-add-write needs no atomics and the sums keep their order.
//   Where even then the four staged operands do not fit (N > 144 at D = 64,
//   N > 64 at D = 128), g is read from a zero-padded (BW, NR, H, D32) copy
//   in L2 that the wrapper makes, and only q, k and v are staged: the
//   backward then takes every shape the forward takes.
// The plan (which of these apply) is chosen by the wrapper,
// ops/swin_attention.py, which repeats the sizes below.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -100.f;
constexpr int MAX_N = 256;
constexpr int MAX_D = 128;

// <plan>: the shapes' arithmetic, in plain C++ (tests/
// test_torch_kernel_plans.py compiles this block with a host compiler and
// holds it to ops/swin_attention.py).

// The plan's flags (the forward reads only the first).
constexpr int PLAN_BIAS_SMEM = 1;     // the head's bias in shared memory
constexpr int PLAN_DBIAS_GLOBAL = 2;  // dS added into the partial slice
constexpr int PLAN_G_GLOBAL = 4;      // g read from the padded copy in L2

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Columns of a staged row: D padded to whole 32-column chunks (the
// products' fixed width); rows are staged 4 floats wider, so that fragment
// loads are free of bank conflicts and rows stay 16-byte aligned.
__host__ __device__ inline int padded_width(int D) { return round_up(D, 32); }

// Key tiles of 8 that a strip holds: the kernels' template argument.
inline int key_tiles(int N) {
  return N <= 16 ? 2 : N <= 32 ? 4 : N <= 64 ? 8 : N <= 144 ? 18 : 32;
}

// Shared-memory floats (ops/swin_attention.py repeats these): [bias NR x
// BS if in shared memory][backward: dbias NR x BS unless it goes to the
// partial, row max, 1 / sum and D, NR each][q, k, v (, g unless read from
// L2) tiles NR x DS, regions NR].
inline size_t plan_floats(int NR, int D, bool backward, int plan) {
  const size_t bias = (size_t)NR * (NR + 8);
  const int tiles = backward && !(plan & PLAN_G_GLOBAL) ? 4 : 3;
  return ((plan & PLAN_BIAS_SMEM) ? bias : 0) +
         (backward ? ((plan & PLAN_DBIAS_GLOBAL) ? 0 : bias) + 3 * (size_t)NR
                   : 0) +
         (size_t)tiles * NR * (padded_width(D) + 4) + NR;
}
// </plan>

// ------------------------------------------------------------ primitives

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero: keep 10
// mantissa bits) as integer operations on the bits. The PTX instruction
// compiles to the same add and mask plus a test for infinity, which the
// finite operands here do not need.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c[m] += a b[m] in 3xTF32 for M tiles, the small terms first; each term
// sweeps the M tiles, so that consecutive mma instructions write different
// accumulators.
template <int M>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA& a,
                                     const FragB* b) {
#pragma unroll
  for (int m = 0; m < M; ++m) mma_tf32(c[m], a.lo, b[m].hi);
#pragma unroll
  for (int m = 0; m < M; ++m) mma_tf32(c[m], a.hi, b[m].lo);
#pragma unroll
  for (int m = 0; m < M; ++m) mma_tf32(c[m], a.hi, b[m].hi);
}

// A (16 x 8) times mult: rows r0 + g, r0 + g + 8, columns k0 + t, k0 + t + 4
// of a row-major tile with row stride ds.
__device__ __forceinline__ FragA load_a(const float* s, int r0, int k0,
                                        int ds, float mult, int g, int t) {
  FragA f;
  const float* p = s + (r0 + g) * ds + k0 + t;
  split(p[0] * mult, f.hi[0], f.lo[0]);
  split(p[8 * ds] * mult, f.hi[1], f.lo[1]);
  split(p[4] * mult, f.hi[2], f.lo[2]);
  split(p[8 * ds + 4] * mult, f.hi[3], f.lo[3]);
  return f;
}

// A from an accumulator tile (c0, c1: row g, columns 2t, 2t+1; c2, c3: row
// g + 8), with k = t standing for column 2t and k = t + 4 for 2t + 1.
__device__ __forceinline__ FragA acc_a(const float c[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = M[n0 + n][k0 + k]: the right operand of a product with a
// transposed matrix (k in q k^T).
__device__ __forceinline__ FragB load_bt(const float* s, int n0, int k0,
                                         int ds, int g, int t) {
  FragB f;
  const float* p = s + (n0 + g) * ds + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = M[j0 + row(k)][n0 + n] with row(t) = 2t, row(t + 4) = 2t + 1:
// the right operand after acc_a (v in P v).
__device__ __forceinline__ FragB load_bp(const float* s, int j0, int n0,
                                         int ds, int g, int t) {
  FragB f;
  const float* p = s + (j0 + 2 * t) * ds + n0 + g;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[ds], f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;");
}

// Copies the (N, D) slice of rows with stride ld into rows of ds floats.
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src,
                                           int ld, int N, int D, int ds,
                                           bool vec) {
  if (vec) {
    const int c4 = D >> 2;
    for (int idx = threadIdx.x; idx < N * c4; idx += blockDim.x) {
      const int r = idx / c4, c = (idx - r * c4) << 2;
      cp_async16(dst + r * ds + c, src + (size_t)r * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - r * D;
      cp_async4(dst + r * ds + c, src + (size_t)r * ld + c);
    }
  }
}

__device__ __forceinline__ void stage_ints(int* dst,
                                           const int* __restrict__ src,
                                           int N) {
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// ------------------------------------------------------------- the pieces

template <int KT>
__device__ __forceinline__ void zero(float acc[KT][4]) {
#pragma unroll
  for (int jt = 0; jt < KT; ++jt)
    acc[jt][0] = acc[jt][1] = acc[jt][2] = acc[jt][3] = 0.f;
}

// acc[jt] += (mult A[r0 .. r0+16)) B[8 jt .. 8 jt + 8)^T over the dw
// columns: a strip of one staged matrix (row stride dsa) against all rows
// of another (row stride dsb).
template <int KT>
__device__ __forceinline__ void strip_products(float acc[KT][4],
                                               const float* sa, int dsa,
                                               const float* sb, int dsb,
                                               int r0, int dw, float mult,
                                               int g, int t) {
  for (int k0 = 0; k0 < dw; k0 += 8) {
    const FragA a = load_a(sa, r0, k0, dsa, mult, g, t);
#pragma unroll
    for (int jt = 0; jt < KT; jt += 2) {
      const FragB b[2] = {load_bt(sb, 8 * jt, k0, dsb, g, t),
                          load_bt(sb, 8 * jt + 8, k0, dsb, g, t)};
      mma3<2>(acc + jt, a, b);
    }
  }
}

// out rows r0 + g (+ 8) = mult * (acc as A) M, M staged with rows in the
// permuted order of acc_a, 32 columns at a time (dw is a multiple of 32);
// stores rows < N and columns < D at dst + row * ld.
template <int KT>
__device__ __forceinline__ void strip_times(const float acc[KT][4],
                                            const float* sm, float* dst,
                                            int ld, int r0, int N, int D,
                                            int dw, int ds, float mult, int g,
                                            int t) {
  for (int d0 = 0; d0 < dw; d0 += 32) {
    float o[4][4] = {};
#pragma unroll
    for (int jt = 0; jt < KT; ++jt) {
      const FragA a = acc_a(acc[jt]);
      FragB b[4];
#pragma unroll
      for (int dt = 0; dt < 4; ++dt)
        b[dt] = load_bp(sm, 8 * jt, d0 + 8 * dt, ds, g, t);
      mma3<4>(o, a, b);
    }
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8;
        const int c = d0 + 8 * dt + 2 * t + (e & 1);
        if (r < N && c < D) dst[(size_t)r * ld + c] = o[dt][e] * mult;
      }
    }
  }
}

// bias[i][j], bias[i][j + 1] of the head: from the shared copy (stride bs,
// zero beyond N) or from global memory.
__device__ __forceinline__ float2 bias_pair(const float* sb,
                                            const float* __restrict__ bh,
                                            bool in_smem, int i, int j, int N,
                                            int bs) {
  if (in_smem) return *reinterpret_cast<const float2*>(sb + i * bs + j);
  float2 r = make_float2(0.f, 0.f);
  if (i < N) {
    if (j < N) r.x = __ldg(bh + (size_t)i * N + j);
    if (j + 1 < N) r.y = __ldg(bh + (size_t)i * N + j + 1);
  }
  return r;
}

// The scores of rows i0 + g (+ 8) before the products are added: bias +
// shift mask, -inf for padded keys. Starting the accumulators there puts
// the bias loads ahead of the products, which hide their latency.
template <int KT>
__device__ __forceinline__ void init_rows(float s[KT][4], const int* sreg,
                                          const float* sb,
                                          const float* __restrict__ bh,
                                          bool bias_smem, int N, int i0,
                                          int g, int t) {
  constexpr int BS = 8 * KT + 8;
  const int ia = i0 + g, ib = ia + 8;
  const int ra = sreg[ia], rb = sreg[ib];
#pragma unroll
  for (int jt = 0; jt < KT; ++jt) {
    const int j = 8 * jt + 2 * t;
    const float2 ba = bias_pair(sb, bh, bias_smem, ia, j, N, BS);
    const float2 bb = bias_pair(sb, bh, bias_smem, ib, j, N, BS);
    const int r0 = sreg[j], r1 = sreg[j + 1];
    s[jt][0] = j < N ? ba.x + (r0 != ra ? NEG : 0.f) : -INFINITY;
    s[jt][1] = j + 1 < N ? ba.y + (r1 != ra ? NEG : 0.f) : -INFINITY;
    s[jt][2] = j < N ? bb.x + (r0 != rb ? NEG : 0.f) : -INFINITY;
    s[jt][3] = j + 1 < N ? bb.y + (r1 != rb ? NEG : 0.f) : -INFINITY;
  }
}

// The same for S^T: keys j0 + g (+ 8) against every query i, -inf where
// either is padding.
template <int KT>
__device__ __forceinline__ void init_cols(float s[KT][4], const int* sreg,
                                          const float* sb,
                                          const float* __restrict__ bh,
                                          bool bias_smem, int N, int j0,
                                          int g, int t) {
  constexpr int BS = 8 * KT + 8;
  const int ja = j0 + g, jb = ja + 8;
  const int ra = sreg[ja], rb = sreg[jb];
#pragma unroll
  for (int qt = 0; qt < KT; ++qt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * qt + 2 * t + (e & 1), j = e < 2 ? ja : jb;
      float x = -INFINITY;
      if (i < N && j < N)
        x = (bias_smem ? sb[i * BS + j] : __ldg(bh + (size_t)i * N + j)) +
            (sreg[i] != (e < 2 ? ra : rb) ? NEG : 0.f);
      s[qt][e] = x;
    }
  }
}

// Scores of rows g, g + 8 into probabilities, in place; stats gets the row
// max and 1 / sum of both rows.
template <int KT>
__device__ __forceinline__ void softmax_rows(float s[KT][4], float stats[4]) {
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int jt = 0; jt < KT; ++jt) {
    ma = fmaxf(ma, fmaxf(s[jt][0], s[jt][1]));
    mb = fmaxf(mb, fmaxf(s[jt][2], s[jt][3]));
  }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int jt = 0; jt < KT; ++jt) {
    s[jt][0] = expf(s[jt][0] - ma);
    s[jt][1] = expf(s[jt][1] - ma);
    s[jt][2] = expf(s[jt][2] - mb);
    s[jt][3] = expf(s[jt][3] - mb);
    la += s[jt][0] + s[jt][1];
    lb += s[jt][2] + s[jt][3];
  }
  const float inva = 1.f / quad_sum(la), invb = 1.f / quad_sum(lb);
#pragma unroll
  for (int jt = 0; jt < KT; ++jt) {
    s[jt][0] *= inva;
    s[jt][1] *= inva;
    s[jt][2] *= invb;
    s[jt][3] *= invb;
  }
  stats[0] = ma;
  stats[1] = inva;
  stats[2] = mb;
  stats[3] = invb;
}

// ------------------------------------------------------------------ K5

template <int KT>
__global__ void __launch_bounds__(KT * 16, 1)
swin_attention_forward_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, int ld,
                              const float* __restrict__ bias,
                              const int* __restrict__ regions,
                              float* __restrict__ out, int BW, int N, int H,
                              int D, int nW, float scale, int G,
                              int bias_smem, int vec, int smem_floats) {
  constexpr int NR = 8 * KT, BS = NR + 8;
  extern __shared__ __align__(16) float smem[];
  const int dw = padded_width(D), ds = dw + 4;
  const int grp = blockIdx.x / H, h = blockIdx.x - grp * H;
  const int C = H * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = (threadIdx.x >> 5) * 16;
  float* sb = smem;
  const float* bh = bias + (size_t)h * N * N;

  for (int i = threadIdx.x; i < smem_floats; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  if (bias_smem)
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const int i = idx / N;
      sb[i * BS + idx - i * N] = __ldg(bh + idx);
    }
  float* sq = smem + (bias_smem ? NR * BS : 0);   // this window's tiles
  float* sk = sq + NR * ds;
  float* sv = sk + NR * ds;
  int* sreg = reinterpret_cast<int*>(sv + NR * ds);
  auto load = [&](int bw) {
    const size_t base = (size_t)bw * N * ld + (size_t)h * D;
    stage_tile(sq, q + base, ld, N, D, ds, vec);
    stage_tile(sk, k + base, ld, N, D, ds, vec);
    stage_tile(sv, v + base, ld, N, D, ds, vec);
    stage_ints(sreg, regions + (size_t)(bw % nW) * N, N);
    cp_async_commit();
  };

  load(grp);
  for (int bw = grp; bw < BW; bw += G) {
    cp_async_wait();
    __syncthreads();
    float s[KT][4], stats[4];
    init_rows<KT>(s, sreg, sb, bh, bias_smem, N, i0, g, t);
    strip_products<KT>(s, sq, ds, sk, ds, i0, dw, scale, g, t);
    softmax_rows<KT>(s, stats);
    strip_times<KT>(s, sv, out + (size_t)bw * N * C + (size_t)h * D, C, i0,
                    N, D, dw, ds, 1.f, g, t);
    __syncthreads();            // the next copies overwrite this window
    if (bw + G < BW) load(bw + G);
  }
}

// ------------------------------------------------------------------ K6

// DG: dS is added straight into the block's partial slice instead of a
// shared-memory accumulator (PLAN_DBIAS_GLOBAL). GG: g is read from its
// zero-padded copy (BW, NR, H, D32) in L2 instead of being staged
// (PLAN_G_GLOBAL). <KT, false, false> is the plan of N <= 144 at D <= 32.
template <int KT, bool DG, bool GG>
__global__ void __launch_bounds__(KT * 16, 1)
swin_attention_backward_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v, int ld,
                               const float* __restrict__ bias,
                               const int* __restrict__ regions,
                               const float* __restrict__ gout,
                               float* __restrict__ dqkv,
                               float* __restrict__ partial, int BW, int N,
                               int H, int D, int nW, float scale, int G,
                               int bias_smem, int vec, int smem_floats) {
  constexpr int NR = 8 * KT, BS = NR + 8;
  extern __shared__ __align__(16) float smem[];
  const int dw = padded_width(D), ds = dw + 4;
  const int grp = blockIdx.x / H, h = blockIdx.x - grp * H;
  const int C = H * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;     // query strip, then key strip
  float* sb = smem;
  float* sdb = sb + (bias_smem ? NR * BS : 0);  // dbias of the block's windows
  float* smax = sdb + (DG ? 0 : NR * BS);
  float* sinv = smax + NR;
  float* sdd = sinv + NR;
  const float* bh = bias + (size_t)h * N * N;

  for (int i = threadIdx.x; i < smem_floats; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  if (bias_smem)
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const int i = idx / N;
      sb[i * BS + idx - i * N] = __ldg(bh + idx);
    }
  float* sq = sdd + NR;                        // this window's tiles
  float* sk = sq + NR * ds;
  float* sv = sk + NR * ds;
  float* sg = sv + NR * ds;                    // unless GG
  int* sreg = reinterpret_cast<int*>(sg + (GG ? 0 : NR * ds));
  const int dsg = GG ? H * dw : ds;            // g's row stride
  auto load = [&](int bw) {
    const size_t base = (size_t)bw * N * ld + (size_t)h * D;
    stage_tile(sq, q + base, ld, N, D, ds, vec);
    stage_tile(sk, k + base, ld, N, D, ds, vec);
    stage_tile(sv, v + base, ld, N, D, ds, vec);
    if constexpr (!GG)
      stage_tile(sg, gout + (size_t)bw * N * C + (size_t)h * D, C, N, D, ds,
                 vec);
    stage_ints(sreg, regions + (size_t)(bw % nW) * N, N);
    cp_async_commit();
  };

  load(grp);
  for (int bw = grp; bw < BW; bw += G) {
    cp_async_wait();
    __syncthreads();
    float* drow = dqkv + (size_t)bw * N * 3 * C + (size_t)h * D;
    const float* gw =
        GG ? gout + (size_t)bw * NR * H * dw + (size_t)h * dw : sg;

    // query-major pass: rows i of the strip r0
    {
      float p[KT][4], dp[KT][4], stats[4];
      init_rows<KT>(p, sreg, sb, bh, bias_smem, N, r0, g, t);
      strip_products<KT>(p, sq, ds, sk, ds, r0, dw, scale, g, t);
      softmax_rows<KT>(p, stats);
      zero<KT>(dp);
      strip_products<KT>(dp, gw, dsg, sv, ds, r0, dw, 1.f, g, t);  // g V^T
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int jt = 0; jt < KT; ++jt) {
        da += dp[jt][0] * p[jt][0] + dp[jt][1] * p[jt][1];
        db += dp[jt][2] * p[jt][2] + dp[jt][3] * p[jt][3];
      }
      da = quad_sum(da);
      db = quad_sum(db);
      const int ia = r0 + g, ib = ia + 8;
      if (t == 0) {
        smax[ia] = stats[0];
        sinv[ia] = stats[1];
        sdd[ia] = da;
        smax[ib] = stats[2];
        sinv[ib] = stats[3];
        sdd[ib] = db;
      }
#pragma unroll
      for (int jt = 0; jt < KT; ++jt) {
        p[jt][0] *= dp[jt][0] - da;                        // dS
        p[jt][1] *= dp[jt][1] - da;
        p[jt][2] *= dp[jt][2] - db;
        p[jt][3] *= dp[jt][3] - db;
        if constexpr (!DG) {
          float2* xa =
              reinterpret_cast<float2*>(sdb + ia * BS + 8 * jt + 2 * t);
          float2* xb =
              reinterpret_cast<float2*>(sdb + ib * BS + 8 * jt + 2 * t);
          float2 ya = *xa, yb = *xb;
          ya.x += p[jt][0];
          ya.y += p[jt][1];
          yb.x += p[jt][2];
          yb.y += p[jt][3];
          *xa = ya;
          *xb = yb;
        }
      }
      if constexpr (DG) {
        // this thread's elements of the block's own slice, in every
        // window: the first window stores, the later ones add in order
        float* part = partial + ((size_t)grp * H + h) * N * N;
        const bool first = bw == grp;
#pragma unroll
        for (int jt = 0; jt < KT; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, j = 8 * jt + 2 * t + (e & 1);
            if (i < N && j < N) {
              float* x = part + (size_t)i * N + j;
              *x = first ? p[jt][e] : *x + p[jt][e];
            }
          }
        }
      }
      strip_times<KT>(p, sk, drow, 3 * C, r0, N, D, dw, ds, scale, g, t);
    }
    __syncthreads();            // row statistics of every strip

    // key-major pass: keys j of the strip r0
    {
      float p[KT][4], dp[KT][4];
      init_cols<KT>(p, sreg, sb, bh, bias_smem, N, r0, g, t);
      strip_products<KT>(p, sk, ds, sq, ds, r0, dw, scale, g, t);  // S^T
#pragma unroll
      for (int qt = 0; qt < KT; ++qt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * qt + 2 * t + (e & 1);
          p[qt][e] = expf(p[qt][e] - smax[i]) * sinv[i];     // P^T
        }
      }
      strip_times<KT>(p, gw, drow + 2 * C, 3 * C, r0, N, D, dw, dsg, 1.f,
                      g, t);                               // dV = P^T g
      zero<KT>(dp);
      strip_products<KT>(dp, sv, ds, gw, dsg, r0, dw, 1.f, g, t);  // dP^T
#pragma unroll
      for (int qt = 0; qt < KT; ++qt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[qt][e] *= dp[qt][e] - sdd[8 * qt + 2 * t + (e & 1)];  // dS^T
      }
      strip_times<KT>(p, sq, drow + C, 3 * C, r0, N, D, dw, ds, scale, g,
                      t);                                  // dK = dS^T Q
    }
    __syncthreads();            // the next copies overwrite this window
    if (bw + G < BW) load(bw + G);
  }

  // the block's windows, summed in a fixed order, into its own slice
  if constexpr (!DG) {
    float* part = partial + ((size_t)grp * H + h) * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const int i = idx / N;
      part[idx] = sdb[i * BS + idx - i * N];
    }
  }
}

// dbias[e] = sum_{grp < G} partial[grp][e], in the order of grp.
__global__ void __launch_bounds__(256)
swin_dbias_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ dbias, int G, int HNN) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= HNN) return;
  float s = 0.f;
  for (int grp = 0; grp < G; ++grp) s += partial[(size_t)grp * HNN + e];
  dbias[e] = s;
}

// ------------------------------------------------------------------ host

bool shape_ok(int BW, int N, int H, int D, int nW, int ld, int G) {
  return BW > 0 && N > 0 && N <= MAX_N && H > 0 && D > 0 && D <= MAX_D &&
         nW > 0 && BW % nW == 0 && ld >= H * D && G >= 1 && G <= BW;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int KT>
cudaError_t forward(const float* q, const float* k, const float* v, int ld,
                    const float* bias, const int* regions, float* out,
                    int BW, int N, int H, int D, int nW, float scale, int G,
                    int bias_smem, int vec, cudaStream_t stream) {
  const size_t floats = plan_floats(8 * KT, D, false, bias_smem);
  cudaError_t err =
      prepare(swin_attention_forward_kernel<KT>, floats * sizeof(float));
  if (err != cudaSuccess) return err;
  swin_attention_forward_kernel<KT>
      <<<G * H, (N + 15) / 16 * 32, floats * sizeof(float), stream>>>(
          q, k, v, ld, bias, regions, out, BW, N, H, D, nW, scale, G,
          bias_smem, vec, (int)floats);
  return cudaGetLastError();
}

template <int KT, bool DG, bool GG>
cudaError_t backward(const float* q, const float* k, const float* v, int ld,
                     const float* bias, const int* regions, const float* g,
                     float* dqkv, float* partial, int BW, int N, int H, int D,
                     int nW, float scale, int G, int bias_smem, int vec,
                     cudaStream_t stream) {
  const int plan = bias_smem * PLAN_BIAS_SMEM + DG * PLAN_DBIAS_GLOBAL +
                   GG * PLAN_G_GLOBAL;
  const size_t floats = plan_floats(8 * KT, D, true, plan);
  cudaError_t err = prepare(swin_attention_backward_kernel<KT, DG, GG>,
                            floats * sizeof(float));
  if (err != cudaSuccess) return err;
  swin_attention_backward_kernel<KT, DG, GG>
      <<<G * H, (N + 15) / 16 * 32, floats * sizeof(float), stream>>>(
          q, k, v, ld, bias, regions, g, dqkv, partial, BW, N, H, D, nW,
          scale, G, bias_smem, vec, (int)floats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). q, k, v: (BW, N, C) rows of stride
// ld (unit column stride); out (BW, N, C) contiguous. G window groups and
// whether the bias is kept in shared memory: the wrapper's plan.
int swin_attention_forward(const float* q, const float* k, const float* v,
                           int ld, const float* bias, const int* regions,
                           float* out, int BW, int N, int H, int D, int nW,
                           float scale, int G, int bias_smem, void* stream) {
  if (!shape_ok(BW, N, H, D, nW, ld, G))
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && ld % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  cudaStream_t s = (cudaStream_t)stream;
  switch (key_tiles(N)) {
#define SWIN_FWD(KT)                                                        \
  case KT:                                                                  \
    return (int)forward<KT>(q, k, v, ld, bias, regions, out, BW, N, H, D,   \
                            nW, scale, G, bias_smem, vec, s);
    SWIN_FWD(2) SWIN_FWD(4) SWIN_FWD(8) SWIN_FWD(18) SWIN_FWD(32)
#undef SWIN_FWD
  }
  return (int)cudaErrorInvalidValue;
}

// g: (BW, N, C) contiguous, or under PLAN_G_GLOBAL its zero-padded copy
// (BW, NR, H, D32), NR = 8 * key_tiles(N), D32 = D rounded up to 32;
// dqkv: (BW, N, 3C) contiguous (dq | dk | dv); partial: (G, H, N, N)
// scratch; dbias: (H, N, N). plan: the PLAN_* flags of the wrapper's plan
// (PLAN_G_GLOBAL only where N > 64).
int swin_attention_backward(const float* q, const float* k, const float* v,
                            int ld, const float* bias, const int* regions,
                            const float* g, float* dqkv, float* partial,
                            float* dbias, int BW, int N, int H, int D,
                            int nW, float scale, int G, int plan,
                            void* stream) {
  if (!shape_ok(BW, N, H, D, nW, ld, G))
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && ld % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(g);
  const int bias_smem = (plan & PLAN_BIAS_SMEM) != 0;
  const int dg = (plan & PLAN_DBIAS_GLOBAL) != 0;
  const int gg = (plan & PLAN_G_GLOBAL) != 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  // the (key tiles, DG, GG) that a plan of ops/swin_attention.py takes
  switch (key_tiles(N) * 4 + dg * 2 + gg) {
#define SWIN_BWD(KT, DG, GG)                                                 \
  case KT * 4 + DG * 2 + GG:                                                 \
    err = backward<KT, DG, GG>(q, k, v, ld, bias, regions, g, dqkv, partial, \
                               BW, N, H, D, nW, scale, G, bias_smem, vec,    \
                               s);                                           \
    break;
    SWIN_BWD(2, false, false) SWIN_BWD(4, false, false)
    SWIN_BWD(8, false, false) SWIN_BWD(18, false, false)
    SWIN_BWD(18, true, false) SWIN_BWD(18, true, true)
    SWIN_BWD(32, true, false) SWIN_BWD(32, true, true)
#undef SWIN_BWD
  }
  if (err != cudaSuccess) return (int)err;
  const int hnn = H * N * N;
  swin_dbias_reduce_kernel<<<(hnn + 255) / 256, 256, 0, s>>>(partial, dbias,
                                                            G, hnn);
  return (int)cudaGetLastError();
}

}  // extern "C"
