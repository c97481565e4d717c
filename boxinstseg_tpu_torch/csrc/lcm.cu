// Local Consistency Module refinement: forward and adjoint, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel boxinstseg_tpu/ops/pallas_kernels.py
//   K3  _lcm_block_kernel  (called by lcm_refine_pallas; transpose=False is
//       the forward, transpose=True the adjoint)
//
// Math (boxinstseg_tpu/models/losses/levelset_loss.py apply_a / apply_at):
// num_iter rounds over one (H, W) plane of channel c of image b,
//   forward  st'[p] = sum_k aff[b, k, p] * st[clip(p + off_k)]
//   adjoint  st'[q] = sum_k sum_{p : clip(p + off_k) = q} aff[b, k, p] * st[p]
// with the K offsets given by the caller (8 at dilation 2) and replicate
// (clamped) edges. The adjoint is written as a gather, so it is
// deterministic: an interior q receives from q - off_k only, while an edge
// row or column also receives every p that clamps onto it, a run of up to
// |off_k| + 1 rows (and columns) per offset.
//
// What bounds them on an H100: at the Box2Mask shape (B = 2, 80 channels
// of 96x96, aff 2 x 8 x 96x96) a call moves 5.9 MB in and 5.9 MB out, about
// 4 us of device memory time; the 10 rounds cost ~16 flops per pixel each.
// The design keeps the TPU kernel's idea (the state never leaves fast
// memory between rounds): one block per (b, c) plane holds two 36 KB
// copies of the plane in shared memory (current and next round) for all
// rounds. aff is shared by the image's channels and is read from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_OFFSETS = 16;

struct Offsets {
  int n;
  int dy[MAX_OFFSETS];
  int dx[MAX_OFFSETS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Source run [lo, hi] along one axis of size n whose clamped shift by d
// lands on q (empty when lo > hi).
__device__ __forceinline__ void source_run(int q, int d, int n, int* lo,
                                           int* hi) {
  if (d == 0) {
    *lo = q;
    *hi = q;
  } else if (d > 0) {
    if (q == n - 1) {
      *lo = max(n - 1 - d, 0);
      *hi = n - 1;
    } else if (q < d) {
      *lo = 0;            // every source would lie above the map
      *hi = -1;
    } else {
      *lo = q - d;
      *hi = q - d;
    }
  } else {
    if (q == 0) {
      *lo = 0;
      *hi = min(-d, n - 1);
    } else if (q - d > n - 1) {
      *lo = 0;            // every source would lie below the map
      *hi = -1;
    } else {
      *lo = q - d;
      *hi = q - d;
    }
  }
}

template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
lcm_kernel(const float* __restrict__ aff, const float* __restrict__ phi,
           float* __restrict__ out, int C, int H, int W, Offsets off,
           int num_iter) {
  extern __shared__ float smem[];
  const int hw = H * W;
  float* cur = smem;
  float* nxt = smem + hw;
  const size_t plane = blockIdx.x;                 // b * C + c
  const int b = (int)(plane / C);
  const float* a = aff + (size_t)b * off.n * hw;
  const float* src = phi + plane * hw;
  for (int p = threadIdx.x; p < hw; p += THREADS) cur[p] = src[p];
  __syncthreads();
  for (int it = 0; it < num_iter; ++it) {
    for (int p = threadIdx.x; p < hw; p += THREADS) {
      const int y = p / W;
      const int x = p - y * W;
      float s = 0.f;
      for (int k = 0; k < off.n; ++k) {
        const float* ak = a + (size_t)k * hw;
        if (!TRANSPOSE) {
          const int yy = clampi(y + off.dy[k], 0, H - 1);
          const int xx = clampi(x + off.dx[k], 0, W - 1);
          s += __ldg(ak + p) * cur[yy * W + xx];
        } else {
          int ylo, yhi, xlo, xhi;
          source_run(y, off.dy[k], H, &ylo, &yhi);
          source_run(x, off.dx[k], W, &xlo, &xhi);
          for (int py = ylo; py <= yhi; ++py)
            for (int px = xlo; px <= xhi; ++px)
              s += __ldg(ak + py * W + px) * cur[py * W + px];
        }
      }
      nxt[p] = s;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  float* dst = out + plane * hw;
  for (int p = threadIdx.x; p < hw; p += THREADS) dst[p] = cur[p];
}

int launch(bool transpose, const float* aff, const float* phi, float* out,
           int B, int C, int H, int W, int K, const int* dy, const int* dx,
           int num_iter, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || K <= 0 || K > MAX_OFFSETS ||
      num_iter < 0)
    return (int)cudaErrorInvalidValue;
  Offsets off;
  off.n = K;
  for (int k = 0; k < K; ++k) {
    off.dy[k] = dy[k];
    off.dx[k] = dx[k];
  }
  const size_t smem = 2 * (size_t)H * W * sizeof(float);
  cudaError_t err;
  if (transpose) {
    err = cudaFuncSetAttribute(lcm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    lcm_kernel<true><<<B * C, THREADS, smem, (cudaStream_t)stream>>>(
        aff, phi, out, C, H, W, off, num_iter);
  } else {
    err = cudaFuncSetAttribute(lcm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    lcm_kernel<false><<<B * C, THREADS, smem, (cudaStream_t)stream>>>(
        aff, phi, out, C, H, W, off, num_iter);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success). aff (B, K, H, W), phi and out
// (B, C, H, W), fp32, contiguous; dy/dx are K host ints.
int lcm_forward(const float* aff, const float* phi, float* out, int B, int C,
                int H, int W, int K, const int* dy, const int* dx,
                int num_iter, void* stream) {
  return launch(false, aff, phi, out, B, C, H, W, K, dy, dx, num_iter,
                stream);
}

int lcm_adjoint(const float* aff, const float* phi, float* out, int B, int C,
                int H, int W, int K, const int* dy, const int* dx,
                int num_iter, void* stream) {
  return launch(true, aff, phi, out, B, C, H, W, K, dy, dx, num_iter,
                stream);
}

}  // extern "C"
