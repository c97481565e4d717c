// Timing-only variants of the one-block-a-plane LCM (K3) and CRF (K7)
// kernels (tools/baselines/lcm_per_plane.cu, crf_per_plane.cu), for
// tools/diagnose_stencil_kernels.py. Mode 0 of each is the baseline as it
// is; the others each take one cost away, and some give wrong results.

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
      *lo = 0;
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
      *lo = 0;
      *hi = -1;
    } else {
      *lo = q - d;
      *hi = q - d;
    }
  }
}

// MODE 0: the baseline; 1: the 8 offsets compile-time and unrolled; 2: as
// 1 with aff a constant (no L2 reads); 3 (adjoint): one source q - off_k a
// pixel, as in the map's interior (wrong at the edges).
template <bool TRANSPOSE, int MODE>
__global__ void __launch_bounds__(THREADS)
lcm_kernel(const float* __restrict__ aff, const float* __restrict__ phi,
           float* __restrict__ out, int C, int H, int W, Offsets off,
           int num_iter) {
  extern __shared__ float smem[];
  const int hw = H * W;
  float* cur = smem;
  float* nxt = smem + hw;
  const size_t plane = blockIdx.x;
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
      if (MODE == 0) {
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
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float* ak = a + (size_t)k * hw;
          if (!TRANSPOSE || MODE == 3) {
            const int sg = TRANSPOSE ? -1 : 1;
            const int yy = clampi(y + sg * off.dy[k], 0, H - 1);
            const int xx = clampi(x + sg * off.dx[k], 0, W - 1);
            const float wk =
                MODE == 2 ? 0.125f
                          : __ldg(ak + (TRANSPOSE ? yy * W + xx : p));
            s += wk * cur[yy * W + xx];
          } else {
            int ylo, yhi, xlo, xhi;
            source_run(y, off.dy[k], H, &ylo, &yhi);
            source_run(x, off.dx[k], W, &xlo, &xhi);
            for (int py = ylo; py <= yhi; ++py)
              for (int px = xlo; px <= xhi; ++px)
                s += (MODE == 2 ? 0.125f : __ldg(ak + py * W + px)) *
                     cur[py * W + px];
          }
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

template <bool T, int M>
int lcm_go(const float* aff, const float* phi, float* out, int B, int C,
           int H, int W, const int* dy, const int* dx, int num_iter,
           void* stream) {
  Offsets off;
  off.n = 8;
  for (int k = 0; k < 8; ++k) {
    off.dy[k] = dy[k];
    off.dx[k] = dx[k];
  }
  const size_t smem = 2 * (size_t)H * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lcm_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lcm_kernel<T, M><<<B * C, THREADS, smem, (cudaStream_t)stream>>>(
      aff, phi, out, C, H, W, off, num_iter);
  return (int)cudaGetLastError();
}

constexpr int CRF_THREADS = 1024;

// MODE 0: the baseline; 1: kern and thresh constants; 2: only the plane's
// target box is visited (box: 4 ints a plane, y0 y1 x0 x1, half-open)
template <int MODE>
__global__ void __launch_bounds__(CRF_THREADS)
crf_kernel(const float* __restrict__ kern, const float* __restrict__ thresh,
           const float* __restrict__ bin0, const float* __restrict__ targets,
           const int* __restrict__ box, float* __restrict__ out, int K,
           int H, int W, int num_iter) {
  extern __shared__ uint8_t smem8[];
  const int hw = H * W;
  uint8_t* cur = smem8;
  uint8_t* nxt = smem8 + hw;
  const size_t plane = blockIdx.x;
  const size_t b = plane / K;
  const float* kb = kern + b * 9 * hw;
  const float* tb = thresh + b * hw;
  const float* src = bin0 + plane * hw;
  const float* tgt = targets + plane * hw;
  for (int p = threadIdx.x; p < hw; p += CRF_THREADS)
    cur[p] = (src[p] != 0.f ? 1 : 0) | (tgt[p] > 0.f ? 2 : 0);
  int y0 = 0, y1 = H, x0 = 0, x1 = W;
  if (MODE == 2) {
    y0 = box[4 * plane];
    y1 = box[4 * plane + 1];
    x0 = box[4 * plane + 2];
    x1 = box[4 * plane + 3];
  }
  const int bw = max(x1 - x0, 0), bn = max(y1 - y0, 0) * bw;
  __syncthreads();
  for (int it = 0; it < num_iter; ++it) {
    for (int i = threadIdx.x; i < (MODE == 2 ? bn : hw); i += CRF_THREADS) {
      int p, y, x;
      if (MODE == 2) {
        y = y0 + i / bw;
        x = x0 + (i - (i / bw) * bw);
        p = y * W + x;
      } else {
        p = i;
        y = p / W;
        x = p - y * W;
      }
      uint8_t v = cur[p] & 2;
      if (v) {
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < 9; ++o) {
          const int yy = y + o / 3 - 1;
          const int xx = x + o % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W &&
              (cur[yy * W + xx] & 1))
            s += MODE == 1 ? 0.1f : __ldg(kb + (size_t)o * hw + p);
        }
        if (s > (MODE == 1 ? 0.45f : __ldg(tb + p))) v |= 1;
      }
      nxt[p] = v;
    }
    __syncthreads();
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  float* dst = out + plane * hw;
  for (int p = threadIdx.x; p < hw; p += CRF_THREADS)
    dst[p] = (cur[p] & 1) ? 1.f : 0.f;
}

template <int M>
int crf_go(const float* kern, const float* thresh, const float* bin0,
           const float* targets, const int* box, float* out, int B, int K,
           int H, int W, int num_iter, void* stream) {
  const size_t smem = 2 * (size_t)H * W;
  cudaError_t err = cudaFuncSetAttribute(
      crf_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crf_kernel<M><<<B * K, CRF_THREADS, smem, (cudaStream_t)stream>>>(
      kern, thresh, bin0, targets, box, out, K, H, W, num_iter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 8 offsets (dy, dx host ints); returns a cudaError_t, -1 for no such mode
int lcm_variant(int transpose, int mode, const float* aff, const float* phi,
                float* out, int B, int C, int H, int W, const int* dy,
                const int* dx, int num_iter, void* stream) {
#define GO(T, M)                                                          \
  if (transpose == T && mode == M)                                        \
    return lcm_go<T, M>(aff, phi, out, B, C, H, W, dy, dx, num_iter,      \
                        stream);
  GO(0, 0) GO(0, 1) GO(0, 2) GO(1, 0) GO(1, 1) GO(1, 2) GO(1, 3)
#undef GO
  return -1;
}

int crf_variant(int mode, const float* kern, const float* thresh,
                const float* bin0, const float* targets, const int* box,
                float* out, int B, int K, int H, int W, int num_iter,
                void* stream) {
  if (mode == 0)
    return crf_go<0>(kern, thresh, bin0, targets, box, out, B, K, H, W,
                     num_iter, stream);
  if (mode == 1)
    return crf_go<1>(kern, thresh, bin0, targets, box, out, B, K, H, W,
                     num_iter, stream);
  if (mode == 2)
    return crf_go<2>(kern, thresh, bin0, targets, box, out, B, K, H, W,
                     num_iter, stream);
  return -1;
}

}  // extern "C"
