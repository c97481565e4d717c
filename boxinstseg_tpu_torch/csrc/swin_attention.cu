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
// What bounds them on an H100: fp32 operations. At Swin-L's window 12
// (N = 144, D = 32) the forward does 4*N^2*D = 2.65 MFLOP per (window, head)
// against 4*N*D*4 = 74 KB of q, k, v and out, about 36 flops a byte; the
// backward about 2.5 times the operations. The design keeps the TPU kernel's
// idea (the N x N logits never reach device memory): one block per (window,
// head) stages the head's q, k, v slices in shared memory, read with a row
// stride so that they are the column slices of the fused qkv output, and
// each warp takes rows (logits with bias and region compare, max, exponent
// sum, output row). Rows of q, k, v in shared memory are padded to D + 1
// floats, so that the 32 lanes of a warp, each on its own key row j, read
// 32 different banks. The backward recomputes P into shared memory (N x N
// fp32 beside q, k, v and g: 159 KB at N = 144) and writes over it with dS.
// dq, dk and dv go into one (BW, N, 3C) buffer, the gradient of the qkv
// output. dbias sums dS over every window without atomics: a backward block
// owns one (group, head) pair and walks the windows bw = group, group + G,
// ..., adding each dS into its own slice of a (G, H, N, N) partial; a second
// kernel sums the G slices in a fixed order. The result is the same bits
// from run to run. The products run on the CUDA cores (no tensor cores, no
// TMA yet): a first kernel that is right.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_N = 256;          // key columns a lane keeps in registers
constexpr int MAX_D = 128;
constexpr int COLS = MAX_N / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copies the (N, D) slice at column h*D of rows with stride ld into shared
// memory rows of D + 1 floats.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      size_t base, int ld, int N, int D) {
  const int Dp = D + 1;
  for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    dst[r * Dp + c] = __ldg(src + base + (size_t)r * ld + c);
  }
}

// Softmax row i of the window into p[0..N): the logits, their max and the
// exponent sum, all in one warp. With normalize, p holds P[i, :]; without,
// p holds exp(s - max) and the function returns 1 / sum.
__device__ __forceinline__ float softmax_row(
    float* p, const float* sq, const float* sk, const float* __restrict__ bh,
    const int* sreg, int i, int N, int D, float scale, bool normalize) {
  const int lane = threadIdx.x & 31;
  const int Dp = D + 1;
  const float* qi = sq + i * Dp;
  const int ri = sreg[i];
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    const float* kj = sk + j * Dp;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
    s = s * scale + __ldg(bh + (size_t)i * N + j) +
        (sreg[j] != ri ? -100.f : 0.f);
    p[j] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  const float inv = 1.f / warp_sum(sum);
  if (normalize)
    for (int j = lane; j < N; j += 32) p[j] *= inv;
  __syncwarp();
  return inv;
}

__global__ void __launch_bounds__(THREADS)
swin_attention_forward_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, int ld,
                              const float* __restrict__ bias,
                              const int* __restrict__ regions,
                              float* __restrict__ out, int N, int H, int D,
                              int nW, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sq = smem;
  float* sk = sq + N * Dp;
  float* sv = sk + N * Dp;
  float* rows = sv + N * Dp;                      // WARPS x N
  int* sreg = reinterpret_cast<int*>(rows + WARPS * N);
  const int bw = blockIdx.x / H;
  const int h = blockIdx.x - bw * H;
  const int C = H * D;
  const size_t base = (size_t)bw * N * ld + (size_t)h * D;
  stage(sq, q, base, ld, N, D);
  stage(sk, k, base, ld, N, D);
  stage(sv, v, base, ld, N, D);
  const int* reg = regions + (size_t)(bw % nW) * N;
  for (int i = threadIdx.x; i < N; i += THREADS) sreg[i] = __ldg(reg + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = rows + warp * N;
  const float* bh = bias + (size_t)h * N * N;
  for (int i = warp; i < N; i += WARPS) {
    const float inv = softmax_row(p, sq, sk, bh, sreg, i, N, D, scale, false);
    float* orow = out + ((size_t)bw * N + i) * C + (size_t)h * D;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], sv[j * Dp + d], acc);
      orow[d] = acc * inv;
    }
    __syncwarp();               // the next row overwrites p
  }
}

__global__ void __launch_bounds__(THREADS)
swin_attention_backward_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v, int ld,
                               const float* __restrict__ bias,
                               const int* __restrict__ regions,
                               const float* __restrict__ g,
                               float* __restrict__ dqkv,
                               float* __restrict__ partial, int BW, int N,
                               int H, int D, int nW, int G, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* sq = smem;
  float* sk = sq + N * Dp;
  float* sv = sk + N * Dp;
  float* sg = sv + N * Dp;
  float* P = sg + N * Dp;                         // N x N: P, then dS
  int* sreg = reinterpret_cast<int*>(P + N * N);
  const int grp = blockIdx.x / H;
  const int h = blockIdx.x - grp * H;
  const int C = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bh = bias + (size_t)h * N * N;
  float* part = partial + ((size_t)grp * H + h) * N * N;

  for (int bw = grp; bw < BW; bw += G) {
    const size_t base = (size_t)bw * N * ld + (size_t)h * D;
    stage(sq, q, base, ld, N, D);
    stage(sk, k, base, ld, N, D);
    stage(sv, v, base, ld, N, D);
    stage(sg, g, (size_t)bw * N * C + (size_t)h * D, C, N, D);
    const int* reg = regions + (size_t)(bw % nW) * N;
    for (int i = threadIdx.x; i < N; i += THREADS) sreg[i] = __ldg(reg + i);
    __syncthreads();

    for (int i = warp; i < N; i += WARPS)
      softmax_row(P + i * N, sq, sk, bh, sreg, i, N, D, scale, true);
    __syncthreads();

    float* drow = dqkv + (size_t)bw * N * 3 * C + (size_t)h * D;
    // dV[j] = sum_i P[i, j] g[i]
    for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
      const int j = idx / D, d = idx - j * D;
      float acc = 0.f;
      for (int i = 0; i < N; ++i) acc = fmaf(P[i * N + j], sg[i * Dp + d], acc);
      drow[(size_t)j * 3 * C + 2 * C + d] = acc;
    }
    __syncthreads();            // dS overwrites P

    // dS[i, j] = P[i, j] (dP[i, j] - sum_j' dP[i, j'] P[i, j'])
    for (int i = warp; i < N; i += WARPS) {
      const float* gi = sg + i * Dp;
      float* pi = P + i * N;
      float dp[COLS];
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const int j = lane + 32 * t;
        dp[t] = 0.f;
        if (j < N) {
          const float* vj = sv + j * Dp;
          float s = 0.f;
          for (int d = 0; d < D; ++d) s = fmaf(gi[d], vj[d], s);
          dp[t] = s;
          dot = fmaf(s, pi[j], dot);
        }
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const int j = lane + 32 * t;
        if (j < N) pi[j] = pi[j] * (dp[t] - dot);
      }
    }
    __syncthreads();

    // dQ[i] = scale * sum_j dS[i, j] k[j];  dK[j] = scale * sum_i dS[i, j] q[i]
    for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < N; ++j) {
        aq = fmaf(P[r * N + j], sk[j * Dp + d], aq);
        ak = fmaf(P[j * N + r], sq[j * Dp + d], ak);
      }
      drow[(size_t)r * 3 * C + d] = aq * scale;
      drow[(size_t)r * 3 * C + C + d] = ak * scale;
    }
    // this block's windows, in a fixed order, into its own partial slice
    const bool first = bw == grp;
    for (int idx = threadIdx.x; idx < N * N; idx += THREADS)
      part[idx] = first ? P[idx] : part[idx] + P[idx];
    __syncthreads();            // the next window overwrites shared memory
  }
}

// dbias[e] = sum_{grp < G} partial[grp][e], in the order of grp.
__global__ void __launch_bounds__(THREADS)
swin_dbias_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ dbias, int G, int HNN) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= HNN) return;
  float s = 0.f;
  for (int grp = 0; grp < G; ++grp) s += partial[(size_t)grp * HNN + e];
  dbias[e] = s;
}

// (forward_smem and backward_smem in ops/swin_attention.py repeat these.)
size_t forward_smem(int N, int D) {
  return (3 * (size_t)N * (D + 1) + (size_t)WARPS * N) * sizeof(float) +
         (size_t)N * sizeof(int);
}

size_t backward_smem(int N, int D) {
  return (4 * (size_t)N * (D + 1) + (size_t)N * N) * sizeof(float) +
         (size_t)N * sizeof(int);
}

bool shape_ok(int BW, int N, int H, int D, int nW) {
  return BW > 0 && N > 0 && N <= MAX_N && H > 0 && D > 0 && D <= MAX_D &&
         nW > 0 && BW % nW == 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). q, k, v: (BW, N, C) rows of stride
// ld (unit column stride); out (BW, N, C) contiguous.
int swin_attention_forward(const float* q, const float* k, const float* v,
                           int ld, const float* bias, const int* regions,
                           float* out, int BW, int N, int H, int D, int nW,
                           float scale, void* stream) {
  if (!shape_ok(BW, N, H, D, nW) || ld < H * D)
    return (int)cudaErrorInvalidValue;
  const size_t smem = forward_smem(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      swin_attention_forward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  swin_attention_forward_kernel<<<BW * H, THREADS, smem,
                                  (cudaStream_t)stream>>>(
      q, k, v, ld, bias, regions, out, N, H, D, nW, scale);
  return (int)cudaGetLastError();
}

// g: (BW, N, C) contiguous; dqkv: (BW, N, 3C) contiguous (dq | dk | dv);
// partial: (G, H, N, N) scratch; dbias: (H, N, N). G <= BW.
int swin_attention_backward(const float* q, const float* k, const float* v,
                            int ld, const float* bias, const int* regions,
                            const float* g, float* dqkv, float* partial,
                            float* dbias, int BW, int N, int H, int D,
                            int nW, int G, float scale, void* stream) {
  if (!shape_ok(BW, N, H, D, nW) || ld < H * D || G < 1 || G > BW)
    return (int)cudaErrorInvalidValue;
  const size_t smem = backward_smem(N, D);
  cudaError_t err = cudaFuncSetAttribute(
      swin_attention_backward_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  swin_attention_backward_kernel<<<G * H, THREADS, smem,
                                   (cudaStream_t)stream>>>(
      q, k, v, ld, bias, regions, g, dqkv, partial, BW, N, H, D, nW, G,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hnn = H * N * N;
  swin_dbias_reduce_kernel<<<(hnn + THREADS - 1) / THREADS, THREADS, 0,
                             (cudaStream_t)stream>>>(partial, dbias, G, hnn);
  return (int)cudaGetLastError();
}

}  // extern "C"
