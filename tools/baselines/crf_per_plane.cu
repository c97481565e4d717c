// Timing baseline, not part of the package: the one-block-a-plane
// CRF fixed-point kernel (K7) as it was before the redesign in
// boxinstseg_tpu_torch/csrc/, kept so that chip_smoke.py and
// tools/diagnose_stencil_kernels.py can time the redesign against them in
// the same run. Built with the package's nvcc flags; same C interface.
//
// Binary mean-field CRF fixed point of the DiscoBox pseudo-labels,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel boxinstseg_tpu/ops/pallas_kernels.py
//   K7  _crf_block_kernel  (called by crf_mean_field_pallas)
//
// Math (boxinstseg_tpu/models/dense_heads/discobox_head.py MeanFieldCRF,
// the branch without inter-image priors): num_iter rounds over one (H, W)
// plane of instance k of image b,
//   s[p]   = sum_o st[p + o] * kern[b, o, p]     (3x3 offsets, zero padding)
//   st'[p] = targets[p] > 0  and  s[p] > thresh[b, p]
// starting from bin0. The offsets run row-major from (-1, -1) and s starts
// from 0.0f, the JAX order; st is 0 or 1, so every product is exact and a
// product of 0 adds nothing, so the kernel gives the plain version's bits
// (a skipped term would have added +0 or -0, which leaves s's value alone).
//
// What bounds it on an H100: at the DiscoBox shape (B = 2, K = 128 planes
// of 200x336) a call reads kern 4.8 MB, thresh 0.5 MB, bin0 and targets
// 68.8 MB each and writes 68.8 MB, 63 us of device memory time; the 10
// rounds do 9 multiply-adds a pixel each, 46 us at the fp32 rate. So bytes
// bound it. The design keeps the TPU kernel's idea (the state never leaves
// fast memory between rounds): one block per (b, k) plane holds the plane's
// state in shared memory as one byte a pixel (bit 0 the state, bit 1 the
// target), in two ping-pong buffers (2 x 67,200 bytes at 200x336), with one
// barrier a round and one write of the final plane. kern and thresh are
// shared by the image's planes and are read from L2 (2.7 MB an image), and
// only at pixels inside the target: elsewhere the state is 0 whatever s is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int OFFSETS = 9;

__global__ void __launch_bounds__(THREADS)
crf_mean_field_kernel(const float* __restrict__ kern,
                      const float* __restrict__ thresh,
                      const float* __restrict__ bin0,
                      const float* __restrict__ targets,
                      float* __restrict__ out, int K, int H, int W,
                      int num_iter) {
  extern __shared__ uint8_t smem[];
  const int hw = H * W;
  uint8_t* cur = smem;
  uint8_t* nxt = smem + hw;
  const size_t plane = blockIdx.x;                 // b * K + k
  const size_t b = plane / K;
  const float* kb = kern + b * OFFSETS * hw;
  const float* tb = thresh + b * hw;
  const float* src = bin0 + plane * hw;
  const float* tgt = targets + plane * hw;
  for (int p = threadIdx.x; p < hw; p += THREADS)
    cur[p] = (src[p] != 0.f ? 1 : 0) | (tgt[p] > 0.f ? 2 : 0);
  __syncthreads();
  for (int it = 0; it < num_iter; ++it) {
    for (int p = threadIdx.x; p < hw; p += THREADS) {
      uint8_t v = cur[p] & 2;
      if (v) {
        const int y = p / W;
        const int x = p - y * W;
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < OFFSETS; ++o) {
          const int yy = y + o / 3 - 1;
          const int xx = x + o % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W &&
              (cur[yy * W + xx] & 1))
            s += __ldg(kb + (size_t)o * hw + p);
        }
        if (s > __ldg(tb + p)) v |= 1;
      }
      nxt[p] = v;
    }
    __syncthreads();
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  float* dst = out + plane * hw;
  for (int p = threadIdx.x; p < hw; p += THREADS)
    dst[p] = (cur[p] & 1) ? 1.f : 0.f;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). kern (B, 9, H, W), thresh (B, H, W),
// bin0, targets and out (B, K, H, W), fp32, contiguous.
int crf_mean_field(const float* kern, const float* thresh, const float* bin0,
                   const float* targets, float* out, int B, int K, int H,
                   int W, int num_iter, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || W <= 0 || num_iter < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)H * W;
  cudaError_t err = cudaFuncSetAttribute(
      crf_mean_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crf_mean_field_kernel<<<B * K, THREADS, smem, (cudaStream_t)stream>>>(
      kern, thresh, bin0, targets, out, K, H, W, num_iter);
  return (int)cudaGetLastError();
}

}  // extern "C"
