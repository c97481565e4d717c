// BoxInst pairwise affinity loss: forward sums (K1) and analytic gradient
// (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels in boxinstseg_tpu/ops/pallas_kernels.py:
//   K1  _pairwise_block_kernel  (called by pairwise_loss_forward_pallas)
//   K2  _pairwise_grad_kernel   (called by pairwise_grad_pallas)
//
// Math (boxinstseg_tpu/ops/pairwise.py _pairwise_num_den / _pairwise_bwd):
// for every pixel p of instance (b, k) and every dilated neighbour offset o
// of the (2*half+1)^2 - 1 stencil, in row-major order (neighbor_offsets),
//   w_o(p)    = [sim[b, o, p] >= thresh] * bitmask[b, k, p] * valid[b, k]
//   term(p,q) = -logaddexp(lf(p) + lf(q), lb(p) + lb(q)),  q = p + o
// with lf = log_sigmoid(x), lb = log_sigmoid(-x), both ZERO outside the
// image (an out-of-image neighbour contributes 0 to the log-probs).
//   num = sum w * term,  den = sum w,  loss = num / max(den, 1).
// The opposite of offset o is offset G-1-o (row-major order is symmetric).
//
// What the main path asks of these kernels (B=2, K=64 sampled instances,
// 200x336, kernel 3, dilation 2): the bitmasks are the sampled GT boxes'
// rectangles, so most (instance, 32x8 tile) items hold no weight; the
// colour gates belong to the image and are shared by its 64 instances.
// The first kernels ran one block an (instance, tile), staged log-probs
// for every tile, and read up to 8 (K1) or 16 (K2) gate floats from L2
// for every weighted pixel. The design here:
//
// 1. A block serves one tile of one image for a chunk of that image's
//    instances (grid: tiles x chunks x B).
// 2. It first votes, for all instances of the chunk at once (16-byte
//    loads, four in flight a thread, where the rows allow), on whether
//    any box weight lies in the window the formula needs (K1: the tile and
//    R rows below and R columns each side; K2: the tile and its halo of
//    R). ops/pairwise.py live_tiles is the same vote in PyTorch. A chunk
//    with nothing live reads nothing else: K1 adds 0, K2 writes zeros with
//    16-byte stores. K1 votes on K2's window too and hands K2 a map of
//    its live (instance, tile) items, so that the backward of a forward
//    reads no bitmask to find its work.
// 3. Main path (kernel 3, dilation 2, compile-time radius 2): the tile's
//    8 gate planes, with the halo, are read once per chunk with coalesced
//    loads and packed as one bit an offset (bit o = gate o) into a word a
//    pixel in shared memory. Other stencils take the generic path: the
//    radius at run time and the gates read as floats where a weight needs
//    them, as the first kernels did.
// 4. Each live instance stages its log-probs and weights over the window
//    (K1) or tile and halo (K2), from registers that were loaded while
//    the previous live instance was computed, then:
//    K1: one evaluation an unordered pair. term(p, q) is symmetric in its
//        two ends, so pixel p takes only the G/2 "forward" offsets f (the
//        second half of the row-major order, pointing down or right),
//        weighted by w_f(p) + w_{G-1-f}(p + o_f). A pair whose earlier end
//        lies outside the image (so has no pixel to own it) is taken at its
//        later end, in tiles on the image's top, left or right border.
//        den is counted apart: bitmask(p) x the gates that pass at p.
//    K2: the pair probability pA = exp(a - logaddexp(a, b)), a = lf(p) +
//        lf(q), b = lb(p) + lb(q), is symmetric too: the fast path computes
//        the G/2 forward ones of every pair that touches the tile into
//        shared memory, then each pixel gathers its G, as the first K2's
//        gather form did:  grad(p) = sum_d (w_d(p) + w_{G-1-d}(p + o_d))
//                                   * (s(p) - pA_d(p)),   s = sigmoid(x).
//        The arithmetic of each pA and each sum is the first K2's, in its
//        order.
// 5. K1 writes one (num, den) partial a block; a second one-block pass
//    sums all partials in double, in index order. No float atomics: two
//    calls give the same bits.
//
// What bounds them: bytes. The live bound is the bitmask read whole, the
// gates, and the logits near a weight (K2: and the gradient written
// whole); at the main path that is a few tens of microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = 256;   // a warp a tile row: 32 x 8
constexpr int MAX_RADIUS = 16;
// instances a block, the fastest for each kernel at the main path's inputs
// on an H100 (tools/diagnose_pairwise_kernels.py); at most 32, the bits of
// the vote's word
constexpr int CHUNK_FORWARD = 16;
constexpr int CHUNK_BACKWARD = 8;
static_assert(CHUNK_FORWARD <= 32 && CHUNK_BACKWARD <= 32, "a vote word");
static_assert(TILE_H % 8 == 0, "a warp a tile row");

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// The stencil's half width and dilation: compile-time on the fast path,
// run-time (template arguments 0) on the generic one.
template <int HALF, int DIL>
struct Stencil {
  int half_rt, dil_rt;
  __device__ __forceinline__ int half() const { return HALF ? HALF : half_rt; }
  __device__ __forceinline__ int dil() const { return DIL ? DIL : dil_rt; }
  __device__ __forceinline__ int R() const { return half() * dil(); }
  __device__ __forceinline__ int G() const {
    return (2 * half() + 1) * (2 * half() + 1) - 1;
  }
  // offset o of neighbor_offsets: row-major over the (2 half + 1)^2 grid
  // without its centre, which is grid index G / 2
  __device__ __forceinline__ void offset(int o, int* dy, int* dx) const {
    const int n = 2 * half() + 1;
    const int i = o < G() / 2 ? o : o + 1;
    *dy = (i / n - half()) * dil();
    *dx = (i % n - half()) * dil();
  }
};

// The vote, two words a thread: bit j of k2 is set when instance j < nk of
// the chunk has a non-zero bitmask pixel in K2's window, rows [r0, r1) =
// [y0 - R, y0 + TILE_H + R) and columns [c0, c1) = [x0 - R, x0 + TILE_W + R),
// clipped to the map (``bm`` is the chunk's first plane); bit j of k1 when
// it has one in K1's, the same window from row y0 (no rows above the
// tile). vote_block ORs them over the block and drops invalid instances.
struct Votes {
  unsigned k1, k2;
};

// Main path: K2's window is WR rows and WQ float4 columns from column
// 4 q0 (W % 4 == 0, so a float4 lies wholly in or out of the map); a
// thread issues its loads 4 at a time before it tests any.
template <int WR, int WQ>
__device__ __forceinline__ Votes vote_fast(const float* __restrict__ bm,
                                           size_t plane, int nk, int H,
                                           int W, int r0, int y0, int q0,
                                           int c0, int c1) {
  constexpr int per = WR * WQ;
  const int total = nk * per;
  Votes mine{0, 0};
  for (int base = threadIdx.x; base < total; base += 4 * THREADS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS, j = i / per, rem = i % per;
      const int yy = r0 + rem / WQ, c = 4 * (q0 + rem % WQ);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && yy >= 0 && yy < H && c >= 0 && c < W)
        v[u] = __ldg(reinterpret_cast<const float4*>(
            bm + j * plane + (size_t)yy * W + c));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS, rem = i % per;
      const int c = 4 * (q0 + rem % WQ);
      if ((v[u].x != 0.f && c >= c0 && c < c1) ||
          (v[u].y != 0.f && c + 1 >= c0 && c + 1 < c1) ||
          (v[u].z != 0.f && c + 2 >= c0 && c + 2 < c1) ||
          (v[u].w != 0.f && c + 3 >= c0 && c + 3 < c1)) {
        const unsigned bit = 1u << (i / per);
        mine.k2 |= bit;
        if (r0 + rem / WQ >= y0) mine.k1 |= bit;
      }
    }
  }
  return mine;
}

// Other stencils and rows that are not 16-byte aligned: one pixel a load.
__device__ __forceinline__ Votes vote_generic(const float* __restrict__ bm,
                                              size_t plane, int nk, int H,
                                              int W, int r0, int r1, int y0,
                                              int c0, int c1) {
  r0 = max(r0, 0);
  r1 = min(r1, H);
  c0 = max(c0, 0);
  c1 = min(c1, W);
  Votes mine{0, 0};
  if (r1 <= r0 || c1 <= c0) return mine;
  const int cols = c1 - c0, per = (r1 - r0) * cols;
  for (int i = threadIdx.x; i < nk * per; i += THREADS) {
    const int j = i / per, rem = i - j * per, yy = r0 + rem / cols;
    if (bm[j * plane + (size_t)yy * W + c0 + rem % cols] != 0.f) {
      mine.k2 |= 1u << j;
      if (yy >= y0) mine.k1 |= 1u << j;
    }
  }
  return mine;
}

// The block's live instances: every thread's votes ORed (one barrier), and
// bit j cleared where valid[j] is false (each warp reads the chunk's
// flags itself, while its vote loads are in flight).
__device__ __forceinline__ Votes vote_block(Votes mine,
                                            const bool* __restrict__ valid,
                                            int nk,
                                            unsigned (*s_warp)[THREADS / 32]) {
  const int lane = threadIdx.x & 31;
  const unsigned vb = __ballot_sync(0xffffffffu, lane < nk && valid[lane]);
  mine.k1 = __reduce_or_sync(0xffffffffu, mine.k1 & vb);
  mine.k2 = __reduce_or_sync(0xffffffffu, mine.k2 & vb);
  if (lane == 0) {
    s_warp[0][threadIdx.x >> 5] = mine.k1;
    s_warp[1][threadIdx.x >> 5] = mine.k2;
  }
  __syncthreads();
  Votes live{0, 0};
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    live.k1 |= s_warp[0][i];
    live.k2 |= s_warp[1][i];
  }
  return live;
}

// Both windows' votes of this block's chunk (K2's window, K1's within it).
template <int HALF, int DIL, bool FAST, class S>
__device__ __forceinline__ Votes vote_chunk(const float* __restrict__ bm,
                                            const bool* __restrict__ valid,
                                            S st, size_t plane, int nk,
                                            int H, int W, int y0, int x0,
                                            bool vec,
                                            unsigned (*s_warp)[THREADS / 32]) {
  constexpr int RC = FAST ? HALF * DIL : MAX_RADIUS;
  const int R = st.R();
  return vote_block(
      FAST && vec
          ? vote_fast<TILE_H + 2 * RC, 8 + 2 * ((RC + 3) / 4)>(
                bm, plane, nk, H, W, y0 - R, y0, x0 / 4 - (RC + 3) / 4,
                x0 - R, x0 + TILE_W + R)
          : vote_generic(bm, plane, nk, H, W, y0 - R, y0 + TILE_H + R, y0,
                         x0 - R, x0 + TILE_W + R),
      valid, nk, s_warp);
}

// Zeros of the tile [y0, y0 + TILE_H) x [x0, x0 + TILE_W) of the chunk's
// instances whose bit in ``dead`` is set (K2's output where no weight
// reaches).
__device__ __forceinline__ void zero_tiles(float* __restrict__ grad,
                                           size_t plane, int nk,
                                           unsigned dead, int H, int W,
                                           int y0, int x0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int per = TILE_H * (TILE_W / 4);
    for (int i = tid; i < nk * per; i += THREADS) {
      const int j = i / per, rem = i % per;
      const int yy = y0 + rem / (TILE_W / 4);
      const int xx = x0 + 4 * (rem % (TILE_W / 4));
      if ((dead >> j & 1u) && yy < H && xx < W)
        *reinterpret_cast<float4*>(grad + j * plane + (size_t)yy * W + xx) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    constexpr int per = TILE_H * TILE_W;
    for (int i = tid; i < nk * per; i += THREADS) {
      const int j = i / per, rem = i % per;
      const int yy = y0 + rem / TILE_W, xx = x0 + rem % TILE_W;
      if ((dead >> j & 1u) && yy < H && xx < W)
        grad[j * plane + (size_t)yy * W + xx] = 0.f;
    }
  }
}

// Region layout in shared memory: rows [y0 - R, y0 + TILE_H + R) x columns
// [x0 - R, x0 + TILE_W + R), row-major with width SW = TILE_W + 2R. Rows
// [ry0, ry1) of it (global row indices) are filled.

// One word a pixel, bit o = [sim[b, o, p] >= thresh]; 0 outside the image.
template <class S>
__device__ __forceinline__ void stage_gate_bits(
    const float* __restrict__ simb, size_t plane, S st, float thresh, int H,
    int W, int y0, int x0, int ry0, int ry1, uint32_t* s_bits) {
  const int R = st.R(), SW = TILE_W + 2 * R, G = st.G();
  for (int i = threadIdx.x; i < (ry1 - ry0) * SW; i += THREADS) {
    const int yy = ry0 + i / SW, rc = i % SW, xx = x0 - R + rc;
    uint32_t bits = 0;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* g = simb + (size_t)yy * W + xx;
#pragma unroll
      for (int o = 0; o < G; ++o)
        bits |= (uint32_t)(g[o * plane] >= thresh) << o;
    }
    s_bits[(yy - y0 + R) * SW + rc] = bits;
  }
}

__host__ __device__ constexpr int per_thread(int pixels) {
  return (pixels + THREADS - 1) / THREADS;
}

// One instance's logits and bitmask over rows [ry0, ry1) of the region,
// N values a thread in registers: the next live instance's loads are
// issued before this one is computed, so they are in flight meanwhile.
template <int N>
struct Prefetch {
  float x[N], w[N];

  template <class S>
  __device__ __forceinline__ void load(const float* __restrict__ xs,
                                       const float* __restrict__ bm, S st,
                                       int H, int W, int x0, int ry0,
                                       int ry1) {
    const int R = st.R(), SW = TILE_W + 2 * R, n = (ry1 - ry0) * SW;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int i = threadIdx.x + t * THREADS;
      const int yy = ry0 + i / SW, xx = x0 - R + i % SW;
      x[t] = 0.f;
      w[t] = 0.f;
      if (i < n && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const size_t p = (size_t)yy * W + xx;
        x[t] = xs[p];
        w[t] = bm[p];
      }
    }
  }

  // Zero-padded log-probs and the box weights into shared memory.
  template <class S>
  __device__ __forceinline__ void store(S st, int H, int W, int y0, int x0,
                                        int ry0, int ry1, float* s_lf,
                                        float* s_lb, float* s_w) const {
    const int R = st.R(), SW = TILE_W + 2 * R, n = (ry1 - ry0) * SW;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int i = threadIdx.x + t * THREADS;
      if (i >= n) break;
      const int yy = ry0 + i / SW, rc = i % SW, xx = x0 - R + rc;
      float lf = 0.f, lb = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        // log_sigmoid(v) and log_sigmoid(-v) share log1p(exp(-|v|))
        const float v = x[t], l = log1pf(expf(-fabsf(v)));
        lf = fminf(v, 0.f) - l;
        lb = fminf(-v, 0.f) - l;
      }
      const int c = (yy - y0 + R) * SW + rc;
      s_lf[c] = lf;
      s_lb[c] = lb;
      s_w[c] = w[t];
    }
  }
};

// K1's partial of this block into part[block]. ``worked``: whether the
// block had a live instance (else its sums are 0).
__device__ __forceinline__ void finish_forward(float num, float den,
                                               bool worked,
                                               float2* __restrict__ part) {
  __shared__ float s_red[2][THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (worked) {
    for (int s = 16; s > 0; s >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, s);
      den += __shfl_xor_sync(0xffffffffu, den, s);
    }
    if (lane == 0) {
      s_red[0][warp] = num;
      s_red[1][warp] = den;
    }
    __syncthreads();
  }
  if (tid == 0) {
    float n = 0.f, d = 0.f;
    for (int i = 0; worked && i < THREADS / 32; ++i) {
      n += s_red[0][i];
      d += s_red[1][i];
    }
    part[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)] =
        make_float2(n, d);
  }
}

// K1's second pass, one block: every partial summed in index order, in
// double, into out[0] (num) and out[1] (den).
__global__ void __launch_bounds__(THREADS) pairwise_sum_kernel(
    const float2* __restrict__ part, int n_part, float* __restrict__ out) {
  __shared__ double s_sum[2][THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double n = 0.0, d = 0.0;
  for (int i = tid; i < n_part; i += THREADS) {
    const float2 v = part[i];
    n += v.x;
    d += v.y;
  }
  for (int s = 16; s > 0; s >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, s);
    d += __shfl_xor_sync(0xffffffffu, d, s);
  }
  if (lane == 0) {
    s_sum[0][warp] = n;
    s_sum[1][warp] = d;
  }
  __syncthreads();
  if (tid == 0) {
    n = 0.0;
    d = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) {
      n += s_sum[0][i];
      d += s_sum[1][i];
    }
    out[0] = (float)n;
    out[1] = (float)d;
  }
}

// K1: grid (tiles, chunks, B), 256 threads; tiles of TILE_H x 32 pixels.
// FAST: half and dilation compile-time, gates as bits in shared memory.
template <int HALF, int DIL, bool FAST>
__global__ void __launch_bounds__(THREADS) pairwise_fwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ sim,
    const float* __restrict__ bitmask, const bool* __restrict__ valid,
    float2* __restrict__ part, uint8_t* __restrict__ live_map, int K, int H,
    int W, int half, int dil, float thresh, int tiles_x, bool vec) {
  constexpr int CHUNK = CHUNK_FORWARD;
  extern __shared__ float smem[];
  __shared__ unsigned s_warp[2][THREADS / 32];
  const Stencil<HALF, DIL> st{half, dil};
  const int R = st.R(), G = st.G(), SW = TILE_W + 2 * R;
  const int SH = TILE_H + 2 * R;
  float* s_lf = smem;
  float* s_lb = s_lf + SH * SW;
  float* s_w = s_lb + SH * SW;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_w + SH * SW);

  const int b = blockIdx.z, k0 = blockIdx.y * CHUNK;
  const int nk = min(CHUNK, K - k0);
  const size_t plane = (size_t)H * W;
  const size_t inst0 = (size_t)b * K + k0;
  const int y0 = (blockIdx.x / tiles_x) * TILE_H;
  const int x0 = (blockIdx.x % tiles_x) * TILE_W;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float* simb = sim + (size_t)b * G * plane;

  constexpr int RC = FAST ? HALF * DIL : MAX_RADIUS;
  const Votes votes = vote_chunk<HALF, DIL, FAST>(
      bitmask + inst0 * plane, valid + inst0, st, plane, nk, H, W, y0, x0,
      vec, s_warp);
  // K2's votes for K2, which then reads no bitmask to find its work
  if (live_map && tid < nk)
    live_map[(inst0 + tid) * gridDim.x + blockIdx.x] = votes.k2 >> tid & 1u;
  unsigned live = votes.k1;
  const bool worked = live != 0;

  float num = 0.f, den = 0.f;
  // rows [y0, y0 + TILE_H + R): forward offsets never point up
  const int ry0 = y0, ry1 = y0 + TILE_H + R;
  Prefetch<per_thread((TILE_H + RC) * (TILE_W + 2 * RC))> pre;
  if (live) {
    const size_t first = (inst0 + __ffs(live) - 1) * plane;
    pre.load(logits + first, bitmask + first, st, H, W, x0, ry0, ry1);
  }
  if constexpr (FAST) {
    if (live)
      stage_gate_bits(simb, plane, st, thresh, H, W, y0, x0, ry0, ry1,
                      s_bits);
  }
  // a pair whose earlier end is outside the image is taken at its later end
  const bool border = y0 < R || x0 < R || x0 + TILE_W + R > W;
  while (live) {
    live &= live - 1;
    pre.store(st, H, W, y0, x0, ry0, ry1, s_lf, s_lb, s_w);
    if (live) {
      const size_t next = (inst0 + __ffs(live) - 1) * plane;
      pre.load(logits + next, bitmask + next, st, H, W, x0, ry0, ry1);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TILE_H / 8; ++r) {
      const int y = y0 + ty + 8 * r, x = x0 + tx;
      if (y >= H || x >= W) continue;
      const int c = (ty + 8 * r + R) * SW + tx + R;
      const float wp = s_w[c], lfp = s_lf[c], lbp = s_lb[c];
      uint32_t bp = 0;
      if constexpr (FAST) {
        bp = s_bits[c];
        if (wp != 0.f) den += wp * (float)__popc(bp);
      } else if (wp != 0.f) {
        for (int o = 0; o < G; ++o)
          if (simb[o * plane + (size_t)y * W + x] >= thresh) den += wp;
      }
#pragma unroll
      for (int f = G / 2; f < G; ++f) {
        int dy, dx;
        st.offset(f, &dy, &dx);
        const int q = c + dy * SW + dx;
        float w;
        const float wq = s_w[q];
        if constexpr (FAST) {
          w = (bp >> f & 1u) ? wp : 0.f;
          if (wq != 0.f && (s_bits[q] >> (G - 1 - f) & 1u)) w += wq;
        } else {
          w = (wp != 0.f && simb[f * plane + (size_t)y * W + x] >= thresh)
                  ? wp : 0.f;
          if (wq != 0.f &&
              simb[(G - 1 - f) * plane + (size_t)(y + dy) * W + x + dx] >=
                  thresh)
            w += wq;
        }
        if (w != 0.f) num -= w * logaddexp(lfp + s_lf[q], lbp + s_lb[q]);
      }
      if (border && wp != 0.f) {
#pragma unroll
        for (int f = G / 2; f < G; ++f) {
          int dy, dx;
          st.offset(f, &dy, &dx);
          if (y - dy >= 0 && x - dx >= 0 && x - dx < W) continue;
          bool pass;
          if constexpr (FAST) {
            pass = bp >> (G - 1 - f) & 1u;
          } else {
            pass = simb[(G - 1 - f) * plane + (size_t)y * W + x] >= thresh;
          }
          if (pass) num -= wp * logaddexp(lfp + 0.f, lbp + 0.f);
        }
      }
    }
    __syncthreads();
  }
  finish_forward(num, den, worked, part);
}

// K2: grid (tiles, chunks, B), 256 threads. grad = d(num)/dx * scale[0].
// FAST: gates as bits and the forward pair probabilities in shared memory.
template <int HALF, int DIL, bool FAST>
__global__ void __launch_bounds__(THREADS) pairwise_bwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ sim,
    const float* __restrict__ bitmask, const bool* __restrict__ valid,
    const float* __restrict__ scale, float* __restrict__ grad,
    const uint8_t* __restrict__ live_map, int K, int H, int W, int half,
    int dil, float thresh, int tiles_x, bool vec) {
  constexpr int CHUNK = CHUNK_BACKWARD;
  extern __shared__ float smem[];
  __shared__ unsigned s_warp[2][THREADS / 32];
  const Stencil<HALF, DIL> st{half, dil};
  const int R = st.R(), G = st.G(), SW = TILE_W + 2 * R;
  const int SH = TILE_H + 2 * R;
  const int AREG = (TILE_H + R) * SW;  // anchors of forward pairs: rows above
  float* s_lf = smem;
  float* s_lb = s_lf + SH * SW;
  float* s_w = s_lb + SH * SW;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_w + SH * SW);
  float* s_pa = reinterpret_cast<float*>(s_bits + SH * SW);

  const int b = blockIdx.z, k0 = blockIdx.y * CHUNK;
  const int nk = min(CHUNK, K - k0);
  const size_t plane = (size_t)H * W;
  const size_t inst0 = (size_t)b * K + k0;
  const int y0 = (blockIdx.x / tiles_x) * TILE_H;
  const int x0 = (blockIdx.x % tiles_x) * TILE_W;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const float* simb = sim + (size_t)b * G * plane;
  float* grad0 = grad + inst0 * plane;

  constexpr int RC = FAST ? HALF * DIL : MAX_RADIUS;
  unsigned live;
  if (live_map) {  // K1's votes for this window: every warp reads them
    const int lane = tid & 31;
    live = __ballot_sync(0xffffffffu,
                         lane < nk && live_map[(inst0 + lane) * gridDim.x +
                                               blockIdx.x]);
  } else {
    live = vote_chunk<HALF, DIL, FAST>(bitmask + inst0 * plane,
                                          valid + inst0, st, plane, nk, H, W,
                                          y0, x0, vec, s_warp)
               .k2;
  }
  const unsigned all = nk == 32 ? 0xffffffffu : (1u << nk) - 1;
  zero_tiles(grad0, plane, nk, all & ~live, H, W, y0, x0, vec);
  if (!live) return;

  const int ry0 = y0 - R, ry1 = y0 + TILE_H + R;
  Prefetch<per_thread((TILE_H + 2 * RC) * (TILE_W + 2 * RC))> pre;
  {
    const size_t first = (inst0 + __ffs(live) - 1) * plane;
    pre.load(logits + first, bitmask + first, st, H, W, x0, ry0, ry1);
  }
  if constexpr (FAST)
    stage_gate_bits(simb, plane, st, thresh, H, W, y0, x0, ry0, ry1, s_bits);
  const float sc = scale[0];
  while (live) {
    const int j = __ffs(live) - 1;
    live &= live - 1;
    const float* xin = logits + (inst0 + j) * plane;
    pre.store(st, H, W, y0, x0, ry0, ry1, s_lf, s_lb, s_w);
    if (live) {
      const size_t next = (inst0 + __ffs(live) - 1) * plane;
      pre.load(logits + next, bitmask + next, st, H, W, x0, ry0, ry1);
    }
    __syncthreads();
    if constexpr (FAST) {
      // pA of each forward pair (u, u + o_f) with an end in the tile
      constexpr int GH = ((2 * HALF + 1) * (2 * HALF + 1) - 1) / 2;
      for (int i = tid; i < GH * AREG; i += THREADS) {
        const int fo = i / AREG, u = i % AREG;
        int dy, dx;
        st.offset(GH + fo, &dy, &dx);
        const int ar = u / SW, ac = u % SW;
        const bool in_u = ar >= R && ac >= R && ac < R + TILE_W;
        const bool in_v = ar + dy >= R && ar + dy < R + TILE_H &&
                          ac + dx >= R && ac + dx < R + TILE_W;
        if (!in_u && !in_v) continue;
        const int v = u + dy * SW + dx;
        const float wu = s_w[u], wv = s_w[v];
        float w = (wu != 0.f && (s_bits[u] >> (GH + fo) & 1u)) ? wu : 0.f;
        if (wv != 0.f && (s_bits[v] >> (GH - 1 - fo) & 1u)) w += wv;
        if (w == 0.f) continue;
        const float a = s_lf[u] + s_lf[v];
        const float m = logaddexp(a, s_lb[u] + s_lb[v]);
        s_pa[fo * AREG + u] = expf(a - m);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TILE_H / 8; ++r) {
      const int y = y0 + ty + 8 * r, x = x0 + tx;
      if (y >= H || x >= W) continue;
      const size_t p = (size_t)y * W + x;
      const int c = (ty + 8 * r + R) * SW + tx + R;
      const float s = 1.f / (1.f + expf(-xin[p]));
      const float wp = s_w[c], lfp = s_lf[c], lbp = s_lb[c];
      uint32_t bp = 0;
      if constexpr (FAST) bp = s_bits[c];
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < G; ++d) {
        int dy, dx;
        st.offset(d, &dy, &dx);
        const int q = c + dy * SW + dx;
        const float wq = s_w[q];
        float w;
        if constexpr (FAST) {
          w = (wp != 0.f && (bp >> d & 1u)) ? wp : 0.f;
          if (wq != 0.f && (s_bits[q] >> (G - 1 - d) & 1u)) w += wq;
        } else {
          w = (wp != 0.f && simb[d * plane + p] >= thresh) ? wp : 0.f;
          if (wq != 0.f &&
              simb[(G - 1 - d) * plane + (size_t)(y + dy) * W + x + dx] >=
                  thresh)
            w += wq;
        }
        if (w != 0.f) {
          float pa;
          if constexpr (FAST) {
            // d forward: the pair anchored here; else at the neighbour
            pa = d >= G / 2 ? s_pa[(d - G / 2) * AREG + c]
                            : s_pa[(G / 2 - 1 - d) * AREG + q];
          } else {
            const float a = lfp + s_lf[q];
            pa = expf(a - logaddexp(a, lbp + s_lb[q]));
          }
          acc += w * (s - pa);
        }
      }
      grad0[j * plane + p] = acc * sc;
    }
    __syncthreads();
  }
}

int smem_bytes(bool backward, bool fast, int R, int G) {
  const int region = (TILE_H + 2 * R) * (TILE_W + 2 * R);
  int words = 3 * region + (fast ? region : 0);
  if (backward && fast) words += G / 2 * (TILE_H + R) * (TILE_W + 2 * R);
  return words * 4;
}

struct Call {
  const void *logits, *sim, *bitmask, *valid;
  int B, K, H, W, G, half, dil;
  float thresh;
  int vec;
  cudaStream_t stream;
};

int check_call(const Call& c) {
  if (c.half < 1 || c.dil < 1 || c.half * c.dil > MAX_RADIUS ||
      c.G != (2 * c.half + 1) * (2 * c.half + 1) - 1 || c.B < 1 ||
      c.K < 1 || c.H < 1 || c.W < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int tiles_of(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

dim3 grid_of(const Call& c, int chunk) {
  return dim3(tiles_of(c.H, c.W), (c.K + chunk - 1) / chunk, c.B);
}

template <int HALF, int DIL, bool FAST>
int launch_forward(const Call& c, void* part, void* out, void* live_map) {
  const int R = c.half * c.dil;
  const dim3 grid = grid_of(c, CHUNK_FORWARD);
  pairwise_fwd_kernel<HALF, DIL, FAST>
      <<<grid, THREADS, smem_bytes(false, FAST, R, c.G), c.stream>>>(
          (const float*)c.logits, (const float*)c.sim,
          (const float*)c.bitmask, (const bool*)c.valid, (float2*)part,
          (uint8_t*)live_map, c.K, c.H, c.W, c.half, c.dil, c.thresh,
          (c.W + TILE_W - 1) / TILE_W, c.vec != 0);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  pairwise_sum_kernel<<<1, THREADS, 0, c.stream>>>(
      (const float2*)part, (int)(grid.x * grid.y * grid.z), (float*)out);
  return (int)cudaGetLastError();
}

template <int HALF, int DIL, bool FAST>
int launch_backward(const Call& c, const void* scale, void* grad,
                    const void* live_map) {
  const int R = c.half * c.dil;
  pairwise_bwd_kernel<HALF, DIL, FAST>
      <<<grid_of(c, CHUNK_BACKWARD), THREADS, smem_bytes(true, FAST, R, c.G),
         c.stream>>>((const float*)c.logits, (const float*)c.sim,
                     (const float*)c.bitmask, (const bool*)c.valid,
                     (const float*)scale, (float*)grad,
                     (const uint8_t*)live_map, c.K, c.H, c.W, c.half, c.dil,
                     c.thresh, (c.W + TILE_W - 1) / TILE_W, c.vec != 0);
  return (int)cudaGetLastError();
}

// The main path's stencil (kernel 3, dilation 2) takes the fast kernels.
bool fast_path(const Call& c) { return c.half == 1 && c.dil == 2; }

}  // namespace

extern "C" {

// Number of (num, den) float2 partials K1 writes: one a block.
int pairwise_forward_blocks(int B, int K, int H, int W) {
  return tiles_of(H, W) * ((K + CHUNK_FORWARD - 1) / CHUNK_FORWARD) * B;
}

// Number of (instance, tile) items of a call: the bytes of a live map.
int pairwise_live_items(int B, int K, int H, int W) {
  return tiles_of(H, W) * B * K;
}

// K1 (two launches: the blocks' partials, then their sum). out: 2 floats
// (num, den); part: pairwise_forward_blocks float2s. vec: W % 4 == 0 and
// the bitmask 16-byte aligned. live_map (may be null):
// pairwise_live_items bytes, (b, k, tile) set to whether K2 has work there
// (its window holds a weight of a valid instance).
int pairwise_forward(const void* logits, const void* sim, const void* bitmask,
                     const void* valid, void* part, void* out,
                     void* live_map, int B, int K, int H, int W, int G,
                     int half, int dil, float thresh, int vec, void* stream) {
  const Call c{logits, sim, bitmask, valid, B, K, H, W, G, half, dil,
               thresh, vec, (cudaStream_t)stream};
  if (const int err = check_call(c)) return err;
  return fast_path(c) ? launch_forward<1, 2, true>(c, part, out, live_map)
                      : launch_forward<0, 0, false>(c, part, out, live_map);
}

// K2. grad: (B, K, H, W) = d(num)/d(logits) * scale[0]. vec as for K1,
// with grad 16-byte aligned too. live_map: K1's of the same inputs, or
// null (K2 then votes on the bitmask itself).
int pairwise_backward(const void* logits, const void* sim,
                      const void* bitmask, const void* valid,
                      const void* scale, void* grad, const void* live_map,
                      int B, int K, int H, int W, int G, int half, int dil,
                      float thresh, int vec, void* stream) {
  const Call c{logits, sim, bitmask, valid, B, K, H, W, G, half, dil,
               thresh, vec, (cudaStream_t)stream};
  if (const int err = check_call(c)) return err;
  return fast_path(c)
             ? launch_backward<1, 2, true>(c, scale, grad, live_map)
             : launch_backward<0, 0, false>(c, scale, grad, live_map);
}

}  // extern "C"
