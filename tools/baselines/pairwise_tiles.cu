// The first K1 / K2 design (one block a 32x8 tile of one instance, the
// colour gates read as floats from L2 for every weighted pixel), kept for
// chip_smoke.py, which times the redesign in boxinstseg_tpu_torch/csrc/
// pairwise.cu against it in turns. Only the C symbols are renamed
// (baseline_pairwise_*); the kernels are as they were.
//
// BoxInst pairwise affinity loss: forward partial sums (K1) and analytic
// gradient (K2), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels in boxinstseg_tpu/ops/pallas_kernels.py:
//   K1  _pairwise_block_kernel  (called by pairwise_loss_forward_pallas)
//   K2  _pairwise_grad_kernel   (called by pairwise_grad_pallas)
//
// Math (boxinstseg_tpu/ops/pairwise.py _pairwise_num_den / _pairwise_bwd):
// for every pixel p of instance (b, k) and every dilated neighbour offset o
// of the (2*half+1)^2 - 1 stencil, in row-major order,
//   w_o(p)   = [sim[b, o, p] >= thresh] * bitmask[b, k, p] * valid[b, k]
//   term_o(p) = -logaddexp(lf(p) + lf(p+o), lb(p) + lb(p+o))
// with lf = log_sigmoid(x), lb = log_sigmoid(-x), both ZERO outside the
// image (zero-padded log-probs: an out-of-image neighbour contributes 0).
//   num = sum w * term,  den = sum w,  loss = num / max(den, 1).
//
// What bounds these kernels on an H100: bytes. At the main-path shape
// (B=2, K=64, 200x336) each direction streams 34 MB of logits and 34 MB of
// bitmasks (plus 34 MB of gradient out for K2) against ~20 flops a byte,
// far below the ~295 flops/byte at which the card becomes compute bound.
// The design therefore reads each logit and bitmask from device memory once
// per block: a 32x8 output tile stages its log-probs (and for K2 its
// weights) with a halo of half*dilation pixels in shared memory, so the 8
// neighbour reads hit shared memory, not device memory. The colour gates
// are per image (B x 8 planes, 4.3 MB at the main shape) and are re-read by
// every instance from L2. Pixels whose box weight is zero skip their gate
// reads. K1 writes one (num, den) pair per block into a buffer that the
// caller sums with torch.sum, so the result does not depend on the order
// in which blocks run (no float atomics).
//
// K2 is a pure gather. The reference backward adds, for each offset o, a
// centre term w_o(p) * (s(p) - pA_o(p)) and a neighbour term
// w_o(p-o) * (s(p) - pA_o(p-o)) that it shifts back by -o. The pair
// (p-o, p) is the pair (p, p+o') seen through the opposite offset o' = -o,
// and the pair probability pA is symmetric in its two ends, so for each
// offset d the gradient at p is
//   (w_d(p) + w_opp(d)(p + o_d)) * (s(p) - pA_d(p)),
//   pA_d(p) = exp(lf(p) + lf(p+o_d) - logaddexp(lf(p) + lf(p+o_d),
//                                               lb(p) + lb(p+o_d))),
// one pair probability per offset, no scatter and no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;

__device__ __forceinline__ float log_sigmoid(float x) {
  // -softplus(-x) = min(x, 0) - log1p(exp(-|x|)), as jax.nn.log_sigmoid
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Stage zero-padded log-probs of one (TILE_H + 2R) x (TILE_W + 2R) window.
__device__ __forceinline__ void stage_log_probs(
    const float* __restrict__ x, int H, int W, int y0, int x0, int R, int SW,
    int SH, float* s_lf, float* s_lb) {
  for (int i = threadIdx.y * TILE_W + threadIdx.x; i < SH * SW;
       i += THREADS) {
    const int yy = y0 - R + i / SW;
    const int xx = x0 - R + i % SW;
    float lf = 0.f, lb = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float v = x[(size_t)yy * W + xx];
      lf = log_sigmoid(v);
      lb = log_sigmoid(-v);
    }
    s_lf[i] = lf;
    s_lb[i] = lb;
  }
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int lane = (threadIdx.y * TILE_W + threadIdx.x) & 31;
  const int warp = (threadIdx.y * TILE_W + threadIdx.x) >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (warp == 0 && lane == 0)
    for (int i = 0; i < THREADS / 32; ++i) total += scratch[i];
  __syncthreads();
  return total;  // valid in thread (0, 0) only
}

// K1: grid (tiles, K, B), block (32, 8). Writes one partial per block.
__global__ void __launch_bounds__(THREADS) pairwise_fwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ sim,
    const float* __restrict__ bitmask, const bool* __restrict__ valid,
    float* __restrict__ num_part, float* __restrict__ den_part, int H, int W,
    int G, int half, int dil, float thresh, int tiles_x) {
  extern __shared__ float smem[];
  __shared__ float scratch[THREADS / 32];
  const int R = half * dil;
  const int SW = TILE_W + 2 * R;
  const int SH = TILE_H + 2 * R;
  float* s_lf = smem;
  float* s_lb = smem + SW * SH;

  const int b = blockIdx.z, K = gridDim.y;
  const size_t inst = (size_t)b * K + blockIdx.y;
  const size_t plane = (size_t)H * W;
  const int y0 = (blockIdx.x / tiles_x) * TILE_H;
  const int x0 = (blockIdx.x % tiles_x) * TILE_W;

  stage_log_probs(logits + inst * plane, H, W, y0, x0, R, SW, SH, s_lf, s_lb);
  __syncthreads();

  float num = 0.f, den = 0.f;
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (valid[inst] && y < H && x < W) {
    const float wb = bitmask[inst * plane + (size_t)y * W + x];
    if (wb != 0.f) {
      const int c = (threadIdx.y + R) * SW + threadIdx.x + R;
      const float lfp = s_lf[c], lbp = s_lb[c];
      const float* g = sim + (size_t)b * G * plane + (size_t)y * W + x;
      int o = 0;
      for (int ky = -half; ky <= half; ++ky) {
        for (int kx = -half; kx <= half; ++kx) {
          if (ky == 0 && kx == 0) continue;
          if (g[o * plane] >= thresh) {
            const int q = c + ky * dil * SW + kx * dil;
            num -= wb * logaddexp(lfp + s_lf[q], lbp + s_lb[q]);
            den += wb;
          }
          ++o;
        }
      }
    }
  }
  num = block_sum(num, scratch);
  den = block_sum(den, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const size_t slot = inst * gridDim.x + blockIdx.x;
    num_part[slot] = num;
    den_part[slot] = den;
  }
}

// K2: grid (tiles, K, B), block (32, 8). grad = d(num)/dx * scale[0].
__global__ void __launch_bounds__(THREADS) pairwise_bwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ sim,
    const float* __restrict__ bitmask, const bool* __restrict__ valid,
    const float* __restrict__ scale, float* __restrict__ grad, int H, int W,
    int G, int half, int dil, float thresh, int tiles_x) {
  extern __shared__ float smem[];
  const int R = half * dil;
  const int SW = TILE_W + 2 * R;
  const int SH = TILE_H + 2 * R;
  float* s_lf = smem;
  float* s_lb = smem + SW * SH;
  float* s_w = smem + 2 * SW * SH;

  const int b = blockIdx.z, K = gridDim.y;
  const size_t inst = (size_t)b * K + blockIdx.y;
  const size_t plane = (size_t)H * W;
  const int y0 = (blockIdx.x / tiles_x) * TILE_H;
  const int x0 = (blockIdx.x % tiles_x) * TILE_W;
  const float* xin = logits + inst * plane;
  const float* bm = bitmask + inst * plane;
  const bool v = valid[inst];

  stage_log_probs(xin, H, W, y0, x0, R, SW, SH, s_lf, s_lb);
  for (int i = threadIdx.y * TILE_W + threadIdx.x; i < SH * SW;
       i += THREADS) {
    const int yy = y0 - R + i / SW;
    const int xx = x0 - R + i % SW;
    s_w[i] = (v && yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? bm[(size_t)yy * W + xx] : 0.f;
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  if (y >= H || x >= W) return;
  const size_t p = (size_t)y * W + x;
  const int c = (threadIdx.y + R) * SW + threadIdx.x + R;
  const float xp = xin[p];
  const float s = 1.f / (1.f + expf(-xp));
  const float lfp = s_lf[c], lbp = s_lb[c], wp = s_w[c];
  const float* g = sim + (size_t)b * G * plane;

  float acc = 0.f;
  int o = 0;
  for (int ky = -half; ky <= half; ++ky) {
    for (int kx = -half; kx <= half; ++kx) {
      if (ky == 0 && kx == 0) continue;
      const int q = c + ky * dil * SW + kx * dil;
      // centre side: pair (p, p+o) weighted at p by offset o
      float w = (wp != 0.f && g[o * plane + p] >= thresh) ? wp : 0.f;
      // neighbour side: the same pair weighted at p+o by the opposite
      // offset, whose gate plane is G-1-o (row-major order is symmetric)
      const float wq = s_w[q];
      if (wq != 0.f) {
        const size_t pq = (size_t)(y + ky * dil) * W + (x + kx * dil);
        if (g[(size_t)(G - 1 - o) * plane + pq] >= thresh) w += wq;
      }
      if (w != 0.f) {
        const float a = lfp + s_lf[q];
        const float m = logaddexp(a, lbp + s_lb[q]);
        acc += w * (s - expf(a - m));
      }
      ++o;
    }
  }
  grad[inst * plane + p] = acc * scale[0];
}

// Largest half * dilation the shared-memory tiles take: K2's 3 arrays of
// (8 + 32) x (32 + 32) floats stay under the 48 KB of dynamic shared
// memory a launch may use without opting in.
constexpr int MAX_RADIUS = 16;

int smem_bytes(int arrays, int half, int dil) {
  const int R = half * dil;
  return arrays * (TILE_W + 2 * R) * (TILE_H + 2 * R) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// Number of per-block partials K1 writes for each (b, k) instance.
int baseline_pairwise_tiles(int H, int W) {
  return ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

int baseline_pairwise_forward(const void* logits, const void* sim,
                              const void* bitmask, const void* valid,
                              void* num_part, void* den_part, int B, int K,
                              int H, int W, int G, int half, int dil,
                              float thresh, void* stream) {
  if (half < 1 || dil < 1 || half * dil > MAX_RADIUS)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const dim3 grid(baseline_pairwise_tiles(H, W), K, B);
  const dim3 block(TILE_W, TILE_H);
  pairwise_fwd_kernel<<<grid, block, smem_bytes(2, half, dil),
                        (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)sim, (const float*)bitmask,
      (const bool*)valid, (float*)num_part, (float*)den_part, H, W, G, half,
      dil, thresh, tiles_x);
  return (int)cudaGetLastError();
}

int baseline_pairwise_backward(const void* logits, const void* sim,
                               const void* bitmask, const void* valid,
                               const void* scale, void* grad, int B, int K,
                               int H, int W, int G, int half, int dil,
                               float thresh, void* stream) {
  if (half < 1 || dil < 1 || half * dil > MAX_RADIUS)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const dim3 grid(baseline_pairwise_tiles(H, W), K, B);
  const dim3 block(TILE_W, TILE_H);
  pairwise_bwd_kernel<<<grid, block, smem_bytes(3, half, dil),
                        (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)sim, (const float*)bitmask,
      (const bool*)valid, (const float*)scale, (float*)grad, H, W, G, half,
      dil, thresh, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
