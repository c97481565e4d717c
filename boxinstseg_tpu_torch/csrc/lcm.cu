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
// with the K offsets given by the caller and replicate (clamped) edges. The
// adjoint is written as a gather, so it is deterministic.
//
// What bounds them on an H100: at the Box2Mask shape (B = 2, 80 channels
// of 96x96, aff 2 x 8 x 96x96) a call moves 5.9 MB in and 5.9 MB out, about
// 4 us of device memory time; the 10 rounds cost ~16 flops per pixel each.
// The state never leaves shared memory between rounds (the TPU kernel's
// idea), and neither do the weights:
//
// lcm_ring_kernel takes the 3x3 ring at dilation d (8 offsets in row-major
// order, the module's), the main path's case. A cluster of blocks holds one
// image's plane group: each block one band of rows of G channels (two
// buffers a channel, the band plus d halo rows on either side), and each
// thread a fixed set of the band's pixels with their 8 weights in registers,
// loaded once for all rounds and all G channels (the per-plane design read
// them from L2 every round, 472 MB a call). A round is one gather pass (all
// 8 loads issued before the multiply-adds, the source indices precomputed:
// no division in the round loop) and one cluster barrier; a pixel of the
// band's first or last d rows is also stored, as it is computed, into the
// neighbouring band's halo rows through distributed shared memory. The
// adjoint has the forward's shape: a pixel off the map's border rows and
// columns receives from q - off_k only, so its weight aff[k, q - off_k] is
// fixed (0 where q - off_k is off the map); the border pixels, where the
// clamp piles whole runs onto one pixel, are a second small pass that
// reads aff from the band's shared copy.
// Limits (the wrapper checks them, ops/lcm.py ring_plan): a band is at most
// RING_THREADS * RING_PPT pixels and at least d rows, at most RING_MAX_BANDS
// bands a cluster, and G channels plus (adjoint) aff fit shared memory.
//
// lcm_generic_kernel takes any other offset set (at most 16): one block a
// plane, two copies of the plane in shared memory, aff from L2 (so 2 H W 4
// bytes of shared memory: H W <= 29,056).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int MAX_OFFSETS = 16;
constexpr int RING_THREADS = 512;
constexpr int RING_PPT = 5;          // main-pass pixels a thread
constexpr int RING_MAX_BANDS = 8;    // the portable cluster size

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
lcm_generic_kernel(const float* __restrict__ aff,
                   const float* __restrict__ phi, float* __restrict__ out,
                   int C, int H, int W, Offsets off, int num_iter) {
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

// ring offset k (row-major 3x3 without the centre) -> row / column step
// index in {0, 1, 2}, the step being (index - 1) * d
__device__ __forceinline__ constexpr int ring_ky(int k) {
  return (k < 4 ? k : k + 1) / 3;
}
__device__ __forceinline__ constexpr int ring_kx(int k) {
  return (k < 4 ? k : k + 1) % 3;
}

struct Ring {
  int C, H, W;
  int d;           // dilation
  int G;           // channels a block
  int band_rows;   // rows of every band but the last
  int num_iter;
};

// grid (bands, channel groups, images), one cluster = the bands of a group
template <bool TRANSPOSE>
__global__ void __launch_bounds__(RING_THREADS, 1)
lcm_ring_kernel(const float* __restrict__ aff, const float* __restrict__ phi,
                float* __restrict__ out, Ring r) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int H = r.H, W = r.W, d = r.d;
  const int band = blockIdx.x;                  // its rank in the cluster
  const int nb = gridDim.x;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * r.G;
  const int gc = min(r.G, r.C - c0);
  const int r0 = band * r.band_rows;
  const int r1 = min(H, r0 + r.band_rows);
  const int rows = r1 - r0;
  // a buffer holds global rows r0 - d .. r0 + band_rows + d - 1
  const int plane = (r.band_rows + 2 * d) * W;
  float* state = smem;                          // [2][G][plane]
  float* aff_s = smem + 2 * r.G * plane;        // adjoint: [8][plane]
  const size_t hw = (size_t)H * W;
  const float* a = aff + (size_t)b * 8 * hw;
  const int tid = threadIdx.x;

  // the band and its halo rows, from device memory
  const int g_lo = max(r0 - d, 0), g_hi = min(r1 + d, H);
  const int n_load = (g_hi - g_lo) * W;
  const int l_off = (g_lo - r0 + d) * W;
  for (int g = 0; g < gc; ++g) {
    const float* src = phi + ((size_t)b * r.C + c0 + g) * hw +
                       (size_t)g_lo * W;
    float* dst = state + g * plane + l_off;
    for (int i = tid; i < n_load; i += RING_THREADS) dst[i] = __ldg(src + i);
  }
  if (TRANSPOSE) {
    for (int k = 0; k < 8; ++k) {
      const float* src = a + k * hw + (size_t)g_lo * W;
      float* dst = aff_s + k * plane + l_off;
      for (int i = tid; i < n_load; i += RING_THREADS)
        dst[i] = __ldg(src + i);
    }
    __syncthreads();
  }

  // main pass: the forward's every pixel; the adjoint's pixels off the
  // map's border rows and columns. Each thread's pixels, their source
  // rows (as buffer offsets) and columns, and their weights, for all rounds.
  const int my0 = TRANSPOSE ? max(r0, 1) : r0;
  const int my1 = TRANSPOSE ? min(r1, H - 1) : r1;
  const int mx0 = TRANSPOSE ? 1 : 0;
  const int mw = TRANSPOSE ? max(W - 2, 0) : W;
  const int n_main = max(my1 - my0, 0) * mw;
  // a pixel in the band's first d rows is also a halo row of the band
  // above (its buffer row + band_rows), one in the last d rows of the band
  // below (its buffer row - rows)
  const bool has_up = band > 0, has_dn = band + 1 < nb;
  int own[RING_PPT];
  int rb[RING_PPT][3], cx[RING_PPT][3];
  float wgt[RING_PPT][8];
  uint32_t to_up = 0, to_dn = 0;              // bit i: pixel i's halo role
#pragma unroll
  for (int i = 0; i < RING_PPT; ++i) {
    const int j = i * RING_THREADS + tid;
    const bool valid = j < n_main;
    const int jy = valid ? j / mw : 0;
    const int gy = valid ? my0 + jy : r0;
    const int gx = valid ? mx0 + j - jy * mw : 0;
    own[i] = valid ? (gy - r0 + d) * W + gx : -1;
    if (valid && has_up && gy - r0 < d) to_up |= 1u << i;
    if (valid && has_dn && gy - r0 >= rows - d) to_dn |= 1u << i;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int step = (t - 1) * d;
      rb[i][t] = (clampi(TRANSPOSE ? gy - step : gy + step, 0, H - 1) - r0 +
                  d) * W;
      cx[i][t] = clampi(TRANSPOSE ? gx - step : gx + step, 0, W - 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!TRANSPOSE) {
        wgt[i][k] = valid ? __ldg(a + k * hw + (size_t)gy * W + gx) : 0.f;
      } else {
        const int sy = gy - (ring_ky(k) - 1) * d;
        const int sx = gx - (ring_kx(k) - 1) * d;
        const bool in = valid && sy >= 0 && sy < H && sx >= 0 && sx < W;
        wgt[i][k] = in ? aff_s[k * plane + (sy - r0 + d) * W + sx] : 0.f;
      }
    }
  }

  // the adjoint's border pass: map columns 0 and W - 1 of the band's rows,
  // then the interior of map rows 0 and H - 1 where the band holds them
  const int n_cols = W > 1 ? 2 : 1;
  const int n_side = rows * n_cols;
  const int n_top = r0 == 0 ? max(W - 2, 0) : 0;
  const int n_bottom = (r1 == H && H > 1) ? max(W - 2, 0) : 0;
  const int n_edge = TRANSPOSE ? n_side + n_top + n_bottom : 0;

  cluster.sync();            // every block of the cluster has started
  float* up_state = has_up ? cluster.map_shared_rank(state, band - 1)
                           : nullptr;
  float* dn_state = has_dn ? cluster.map_shared_rank(state, band + 1)
                           : nullptr;
  const int up_shift = r.band_rows * W, dn_shift = -rows * W;
  for (int it = 0; it < r.num_iter; ++it) {
    const float* cur = state + (it & 1) * r.G * plane;
    const int nxt_off = ((it & 1) ^ 1) * r.G * plane;
    float* nxt = state + nxt_off;
    for (int g = 0; g < gc; ++g) {
      const float* cb = cur + g * plane;
      float* nbuf = nxt + g * plane;
#pragma unroll
      for (int i = 0; i < RING_PPT; ++i) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = cb[rb[i][ring_ky(k)] + cx[i][ring_kx(k)]];
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s = fmaf(wgt[i][k], v[k], s);
        if (own[i] >= 0) nbuf[own[i]] = s;
        // the halo copies go out as soon as they are known
        if (to_up >> i & 1)
          up_state[nxt_off + g * plane + own[i] + up_shift] = s;
        if (to_dn >> i & 1)
          dn_state[nxt_off + g * plane + own[i] + dn_shift] = s;
      }
    }
    if constexpr (TRANSPOSE) {
      for (int e = tid; e < n_edge * gc; e += RING_THREADS) {
        const int g = e / n_edge;
        const int j = e - g * n_edge;
        int gy, gx;
        if (j < n_side) {
          gy = r0 + j / n_cols;
          gx = (j % n_cols) ? W - 1 : 0;
        } else if (j < n_side + n_top) {
          gy = 0;
          gx = 1 + j - n_side;
        } else {
          gy = H - 1;
          gx = 1 + j - n_side - n_top;
        }
        const float* cb = cur + g * plane;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int ylo, yhi, xlo, xhi;
          source_run(gy, (ring_ky(k) - 1) * d, H, &ylo, &yhi);
          source_run(gx, (ring_kx(k) - 1) * d, W, &xlo, &xhi);
          for (int py = ylo; py <= yhi; ++py) {
            const int rowo = (py - r0 + d) * W;
            for (int px = xlo; px <= xhi; ++px)
              s += aff_s[k * plane + rowo + px] * cb[rowo + px];
          }
        }
        const int at = nxt_off + g * plane + (gy - r0 + d) * W + gx;
        state[at] = s;
        if (has_up && gy - r0 < d) up_state[at + up_shift] = s;
        if (has_dn && gy - r0 >= rows - d) dn_state[at + dn_shift] = s;
      }
    }
    cluster.sync();            // the round and its halo copies are done
  }
  const float* fin = state + (r.num_iter & 1) * r.G * plane;
  for (int g = 0; g < gc; ++g) {
    float* dst = out + ((size_t)b * r.C + c0 + g) * hw + (size_t)r0 * W;
    const float* src = fin + g * plane + d * W;
    for (int i = tid; i < rows * W; i += RING_THREADS) dst[i] = src[i];
  }
}

// the launch of a ring call: grid, block, shared memory and cluster
template <bool TRANSPOSE>
cudaError_t ring_config(const Ring& r, int B, int bands, void* stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t plane = (size_t)(r.band_rows + 2 * r.d) * r.W;
  const size_t smem =
      (2 * (size_t)r.G + (TRANSPOSE ? 8 : 0)) * plane * sizeof(float);
  *cfg = {};
  cfg->gridDim = dim3(bands, (r.C + r.G - 1) / r.G, B);
  cfg->blockDim = dim3(RING_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = bands;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(lcm_ring_kernel<TRANSPOSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool TRANSPOSE>
int launch_ring(const float* aff, const float* phi, float* out, int B,
                const Ring& r, int bands, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = ring_config<TRANSPOSE>(r, B, bands, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, lcm_ring_kernel<TRANSPOSE>, aff, phi, out,
                           r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool TRANSPOSE>
int ring_clusters(const Ring& r, int bands) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err = ring_config<TRANSPOSE>(r, 1, bands, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, lcm_ring_kernel<TRANSPOSE>,
                                         &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

int launch_generic(bool transpose, const float* aff, const float* phi,
                   float* out, int B, int C, int H, int W, int K,
                   const int* dy, const int* dx, int num_iter, void* stream) {
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
    err = cudaFuncSetAttribute(lcm_generic_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    lcm_generic_kernel<true><<<B * C, THREADS, smem, (cudaStream_t)stream>>>(
        aff, phi, out, C, H, W, off, num_iter);
  } else {
    err = cudaFuncSetAttribute(lcm_generic_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    lcm_generic_kernel<false><<<B * C, THREADS, smem, (cudaStream_t)stream>>>(
        aff, phi, out, C, H, W, off, num_iter);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success). aff (B, K, H, W), phi and out
// (B, C, H, W), fp32, contiguous; transpose 1 runs the adjoint.

// The 3x3 ring at dilation d (K = 8, row-major): G channels a block, bands
// of band_rows rows (the last may be shorter), `bands` blocks a cluster
// (ceil(H / band_rows), at most RING_MAX_BANDS).
int lcm_ring(int transpose, const float* aff, const float* phi, float* out,
             int B, int C, int H, int W, int d, int G, int band_rows,
             int bands, int num_iter, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || d <= 0 || G <= 0 ||
      band_rows <= 0 || bands <= 0 || bands > RING_MAX_BANDS ||
      (bands - 1) * band_rows >= H || bands * band_rows < H ||
      (bands > 1 && band_rows < d) || num_iter < 0 ||
      band_rows * W > RING_THREADS * RING_PPT)
    return (int)cudaErrorInvalidValue;
  Ring r{C, H, W, d, G, band_rows, num_iter};
  return transpose ? launch_ring<true>(aff, phi, out, B, r, bands, stream)
                   : launch_ring<false>(aff, phi, out, B, r, bands, stream);
}

// How many clusters of `bands` blocks of a ring call with G channels a
// block can run at once on the current device (a negative cudaError_t on
// failure): the wrapper sizes the channel groups to fill one wave.
int lcm_ring_clusters(int transpose, int C, int H, int W, int d, int G,
                      int band_rows, int bands) {
  Ring r{C, H, W, d, G, band_rows, 0};
  return transpose ? ring_clusters<true>(r, bands)
                   : ring_clusters<false>(r, bands);
}

// Any K <= 16 offsets, dy/dx K host ints; H * W * 8 bytes of shared memory.
int lcm_generic(int transpose, const float* aff, const float* phi,
                float* out, int B, int C, int H, int W, int K, const int* dy,
                const int* dx, int num_iter, void* stream) {
  return launch_generic(transpose != 0, aff, phi, out, B, C, H, W, K, dy, dx,
                        num_iter, stream);
}

}  // extern "C"
