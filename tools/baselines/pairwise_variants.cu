// Timing-only variants of the one-block-a-tile pairwise kernels (K1 / K2
// in tools/baselines/pairwise_tiles.cu), for
// tools/diagnose_pairwise_kernels.py.
// Mode 0 of each is the baseline as it is; the others each take one cost
// away, and some give wrong results:
//   0  as shipped;
//   1  the colour gates a constant (every gate passes, no sim reads);
//   2  empty tiles skipped: a block whose tile (K1) or tile and halo (K2)
//      holds no box weight writes zeros and stops (right results);
//   3  the transcendentals replaced by cheap arithmetic (wrong values);
//   4  the copy floor: read the logits and the bitmask, write one partial
//      a block (K1) or one plane (K2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;

template <int MODE>
__device__ __forceinline__ float log_sigmoid(float x) {
  if (MODE == 3) return fminf(x, 0.f) - 0.25f * x * x;
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <int MODE>
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (MODE == 3) return m + 0.5f * fabsf(a - b);
  return m + log1pf(expf(-fabsf(a - b)));
}

template <int MODE>
__device__ __forceinline__ float exp_(float x) {
  return MODE == 3 ? 1.f + x : expf(x);
}

template <int MODE>
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
      lf = log_sigmoid<MODE>(v);
      lb = log_sigmoid<MODE>(-v);
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
  return total;
}

// Whether any pixel of rows [y0 - r, y0 + TILE_H + r) and columns
// [x0 - r, x0 + TILE_W + r), clipped to the map, has a box weight.
__device__ __forceinline__ bool any_weight(const float* __restrict__ bm,
                                           bool v, int H, int W, int y0,
                                           int x0, int r) {
  bool any = false;
  if (v) {
    const int sw = TILE_W + 2 * r, sh = TILE_H + 2 * r;
    for (int i = threadIdx.y * TILE_W + threadIdx.x; i < sh * sw;
         i += THREADS) {
      const int yy = y0 - r + i / sw, xx = x0 - r + i % sw;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W &&
          bm[(size_t)yy * W + xx] != 0.f)
        any = true;
    }
  }
  return __syncthreads_or(any) != 0;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) fwd_kernel(
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
  const size_t slot = inst * gridDim.x + blockIdx.x;
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;

  if (MODE == 4) {
    float v = 0.f;
    if (y < H && x < W) {
      const size_t p = inst * plane + (size_t)y * W + x;
      v = logits[p] * bitmask[p];
    }
    v = block_sum(v, scratch);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      num_part[slot] = v;
      den_part[slot] = 0.f;
    }
    return;
  }
  if (MODE == 2 && !any_weight(bitmask + inst * plane, valid[inst], H, W,
                               y0, x0, 0)) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      num_part[slot] = 0.f;
      den_part[slot] = 0.f;
    }
    return;
  }

  stage_log_probs<MODE>(logits + inst * plane, H, W, y0, x0, R, SW, SH,
                        s_lf, s_lb);
  __syncthreads();

  float num = 0.f, den = 0.f;
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
          if (MODE == 1 || g[o * plane] >= thresh) {
            const int q = c + ky * dil * SW + kx * dil;
            num -= wb * logaddexp<MODE>(lfp + s_lf[q], lbp + s_lb[q]);
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
    num_part[slot] = num;
    den_part[slot] = den;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) bwd_kernel(
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
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;

  if (MODE == 4) {
    if (y < H && x < W) {
      const size_t p = (size_t)y * W + x;
      grad[inst * plane + p] = xin[p] * bm[p];
    }
    return;
  }
  if (MODE == 2 && !any_weight(bm, v, H, W, y0, x0, R)) {
    if (y < H && x < W) grad[inst * plane + (size_t)y * W + x] = 0.f;
    return;
  }

  stage_log_probs<MODE>(xin, H, W, y0, x0, R, SW, SH, s_lf, s_lb);
  for (int i = threadIdx.y * TILE_W + threadIdx.x; i < SH * SW;
       i += THREADS) {
    const int yy = y0 - R + i / SW;
    const int xx = x0 - R + i % SW;
    s_w[i] = (v && yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? bm[(size_t)yy * W + xx] : 0.f;
  }
  __syncthreads();

  if (y >= H || x >= W) return;
  const size_t p = (size_t)y * W + x;
  const int c = (threadIdx.y + R) * SW + threadIdx.x + R;
  const float xp = xin[p];
  const float s = 1.f / (1.f + exp_<MODE>(-xp));
  const float lfp = s_lf[c], lbp = s_lb[c], wp = s_w[c];
  const float* g = sim + (size_t)b * G * plane;

  float acc = 0.f;
  int o = 0;
  for (int ky = -half; ky <= half; ++ky) {
    for (int kx = -half; kx <= half; ++kx) {
      if (ky == 0 && kx == 0) continue;
      const int q = c + ky * dil * SW + kx * dil;
      float w = (wp != 0.f && (MODE == 1 || g[o * plane + p] >= thresh))
                    ? wp : 0.f;
      const float wq = s_w[q];
      if (wq != 0.f) {
        const size_t pq = (size_t)(y + ky * dil) * W + (x + kx * dil);
        if (MODE == 1 || g[(size_t)(G - 1 - o) * plane + pq] >= thresh)
          w += wq;
      }
      if (w != 0.f) {
        const float a = lfp + s_lf[q];
        const float m = logaddexp<MODE>(a, lbp + s_lb[q]);
        acc += w * (s - exp_<MODE>(a - m));
      }
      ++o;
    }
  }
  grad[inst * plane + p] = acc * scale[0];
}

int smem_bytes(int arrays, int half, int dil) {
  const int R = half * dil;
  return arrays * (TILE_W + 2 * R) * (TILE_H + 2 * R) * (int)sizeof(float);
}

template <int MODE>
int fwd_go(const void* logits, const void* sim, const void* bitmask,
           const void* valid, void* num_part, void* den_part, int B, int K,
           int H, int W, int G, int half, int dil, float thresh,
           cudaStream_t stream) {
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + TILE_H - 1) / TILE_H) * tiles_x;
  fwd_kernel<MODE><<<dim3(tiles, K, B), dim3(TILE_W, TILE_H),
                     smem_bytes(2, half, dil), stream>>>(
      (const float*)logits, (const float*)sim, (const float*)bitmask,
      (const bool*)valid, (float*)num_part, (float*)den_part, H, W, G, half,
      dil, thresh, tiles_x);
  return (int)cudaGetLastError();
}

template <int MODE>
int bwd_go(const void* logits, const void* sim, const void* bitmask,
           const void* valid, const void* scale, void* grad, int B, int K,
           int H, int W, int G, int half, int dil, float thresh,
           cudaStream_t stream) {
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles = ((H + TILE_H - 1) / TILE_H) * tiles_x;
  bwd_kernel<MODE><<<dim3(tiles, K, B), dim3(TILE_W, TILE_H),
                     smem_bytes(3, half, dil), stream>>>(
      (const float*)logits, (const float*)sim, (const float*)bitmask,
      (const bool*)valid, (const float*)scale, (float*)grad, H, W, G, half,
      dil, thresh, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// num_part / den_part hold B * K * tiles floats each (tiles of 32 x 8).
int pairwise_fwd_variant(int mode, const void* logits, const void* sim,
                         const void* bitmask, const void* valid,
                         void* num_part, void* den_part, int B, int K, int H,
                         int W, int G, int half, int dil, float thresh,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return fwd_go<0>(logits, sim, bitmask, valid, num_part,
                             den_part, B, K, H, W, G, half, dil, thresh, s);
    case 1: return fwd_go<1>(logits, sim, bitmask, valid, num_part,
                             den_part, B, K, H, W, G, half, dil, thresh, s);
    case 2: return fwd_go<2>(logits, sim, bitmask, valid, num_part,
                             den_part, B, K, H, W, G, half, dil, thresh, s);
    case 3: return fwd_go<3>(logits, sim, bitmask, valid, num_part,
                             den_part, B, K, H, W, G, half, dil, thresh, s);
    case 4: return fwd_go<4>(logits, sim, bitmask, valid, num_part,
                             den_part, B, K, H, W, G, half, dil, thresh, s);
  }
  return (int)cudaErrorInvalidValue;
}

int pairwise_bwd_variant(int mode, const void* logits, const void* sim,
                         const void* bitmask, const void* valid,
                         const void* scale, void* grad, int B, int K, int H,
                         int W, int G, int half, int dil, float thresh,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return bwd_go<0>(logits, sim, bitmask, valid, scale, grad, B,
                             K, H, W, G, half, dil, thresh, s);
    case 1: return bwd_go<1>(logits, sim, bitmask, valid, scale, grad, B,
                             K, H, W, G, half, dil, thresh, s);
    case 2: return bwd_go<2>(logits, sim, bitmask, valid, scale, grad, B,
                             K, H, W, G, half, dil, thresh, s);
    case 3: return bwd_go<3>(logits, sim, bitmask, valid, scale, grad, B,
                             K, H, W, G, half, dil, thresh, s);
    case 4: return bwd_go<4>(logits, sim, bitmask, valid, scale, grad, B,
                             K, H, W, G, half, dil, thresh, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
