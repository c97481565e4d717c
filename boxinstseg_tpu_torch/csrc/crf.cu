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
// starting from bin0 (read as st = bin0 != 0). The offsets run row-major
// from (-1, -1) and s starts from 0.0f, the JAX order; st is 0 or 1, so
// every product is exact and a product of 0 adds +0 or -0, which leaves s
// alone: s is the in-order sum of kern over the set neighbours, and the
// kernel computes exactly that, so it gives the plain version's bits.
//
// What bounds it on an H100: at the DiscoBox shape (B = 2, K = 128 planes
// of 200x336) a call reads kern 4.8 MB, thresh 0.5 MB, bin0 and targets
// 68.8 MB each and writes 68.8 MB, 63 us of device memory time. So bytes
// bound it, and the design reads each input once (16-byte loads where W is
// a multiple of 4) and keeps everything else on chip:
//
// - Planes are bit-packed, 8 to a byte: bit j of a pixel's byte is plane
//   k0 + j. One block holds one band of rows of 8 planes of one image (a
//   current and a next buffer with a zero border, the target bits, and
//   flags), and the bands of a plane group form a cluster that swaps its
//   one halo row a round through distributed shared memory, with one
//   cluster barrier a round.
// - A round visits only the bounding rows and columns of the band's
//   target pixels (over all 8 planes): elsewhere st' is 0 from the first
//   round on, so the other buffer is cleared once after the first round.
// - One byte load a neighbour serves 8 planes. The AND and the OR of the 9
//   neighbour bytes split the planes: where all 9 neighbours are set s is
//   the pixel's full in-order kernel sum, where none is set s is +0; both
//   comparisons with thresh are made once, before the rounds, into the
//   flags (kern and thresh are read once there). Only the planes with a
//   mixed neighbourhood, and the map's border pixels (whose neighbours
//   outside the map are padding), sum their set neighbours' kern, read
//   from L2 at that pixel. A thread takes XU pixels of a row at once, so
//   that their loads are in flight together.
//
// Limits (the wrapper checks them, ops/crf.py crf_plan): a band's buffers
// fit shared memory (2 (rows + 2)(W + 2) + 2 rows W bytes), at most
// MAX_BANDS bands a cluster.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TX = 32, TY = 16, THREADS = TX * TY;
constexpr int PLANES = 8;            // planes a byte
constexpr int OFFSETS = 9;
constexpr int XU = 4;                // pixels of a row a thread takes at once
constexpr int MAX_BANDS = 8;         // the portable cluster size

struct Crf {
  int K, H, W;
  int band_rows;   // rows of every band but the last
  int num_iter;
};

// flags of a target pixel
constexpr uint8_t ALL_ON = 1;        // full kernel sum > thresh
constexpr uint8_t NONE_ON = 2;       // 0 > thresh
constexpr uint8_t BORDER = 4;        // on the map's border rows or columns

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// grid (bands, plane groups, images); one cluster = the bands of a group.
// VEC = 4 when W is a multiple of 4 (16-byte loads and stores), else 1.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
crf_mean_field_kernel(const float* __restrict__ kern,
                      const float* __restrict__ thresh,
                      const float* __restrict__ bin0,
                      const float* __restrict__ targets,
                      float* __restrict__ out, Crf r) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem[];
  __shared__ int box[4];                        // y0, y1, x0, x1 (inclusive)
  const int H = r.H, W = r.W;
  const int band = blockIdx.x;                  // its rank in the cluster
  const int nb = gridDim.x;
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * PLANES;
  const int np = min(PLANES, r.K - k0);
  const int r0 = band * r.band_rows;
  const int r1 = min(H, r0 + r.band_rows);
  const int rows = r1 - r0;
  // a buffer holds global rows r0 - 1 .. r0 + band_rows, columns -1 .. W
  const int pw = W + 2;
  const int pplane = (r.band_rows + 2) * pw;
  uint8_t* tgt = smem + 2 * pplane;             // [band_rows][W]
  uint8_t* flg = tgt + r.band_rows * W;         // [band_rows][W]
  const int tid = threadIdx.y * TX + threadIdx.x;
  const size_t hw = (size_t)H * W;
  const float* src = bin0 + ((size_t)b * r.K + k0) * hw;
  const float* tsrc = targets + ((size_t)b * r.K + k0) * hw;
  const float* kb = kern + (size_t)b * OFFSETS * hw;
  const float* tb = thresh + (size_t)b * hw;

  for (int i = tid; i < 2 * pplane; i += THREADS) smem[i] = 0;
  if (tid < 4) box[tid] = (tid % 2 == 0) ? INT_MAX : INT_MIN;
  __syncthreads();

  // bin0's bits for the band and its halo rows, the targets' for the band
  const int g_lo = max(r0 - 1, 0), g_hi = min(r1 + 1, H);
  const int n_chunks = (g_hi - g_lo) * W / VEC;
  int ymin = INT_MAX, ymax = INT_MIN, xmin = INT_MAX, xmax = INT_MIN;
  for (int ch = tid; ch < n_chunks; ch += THREADS) {
    const int e = ch * VEC;
    const int gy = g_lo + e / W;                // a chunk stays in one row
    const int gx = e - (gy - g_lo) * W;
    const size_t off = (size_t)gy * W + gx;
    const bool own = gy >= r0 && gy < r1;
    uint32_t st[VEC] = {}, tg[VEC] = {};
#pragma unroll
    for (int j = 0; j < PLANES; ++j) {
      if (j < np) {
        float v[VEC];
        load_vec<VEC>(src + j * hw + off, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) st[i] |= (v[i] != 0.f) << j;
        if (own) {
          load_vec<VEC>(tsrc + j * hw + off, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) tg[i] |= (v[i] > 0.f) << j;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      smem[(gy - r0 + 1) * pw + gx + 1 + i] = (uint8_t)st[i];
      if (own) {
        tgt[(gy - r0) * W + gx + i] = (uint8_t)tg[i];
        if (tg[i]) {
          ymin = min(ymin, gy);
          ymax = max(ymax, gy);
          xmin = min(xmin, gx + i);
          xmax = max(xmax, gx + i);
        }
      }
    }
  }
  if (ymax >= 0) {
    atomicMin(&box[0], ymin);
    atomicMax(&box[1], ymax);
    atomicMin(&box[2], xmin);
    atomicMax(&box[3], xmax);
  }
  __syncthreads();
  const bool none = box[1] < box[0];           // no target pixel
  const int y0 = none ? 0 : box[0], y1 = none ? -1 : box[1];
  const int x0 = none ? 0 : box[2], x1 = none ? -1 : box[3];

  // the two comparisons of a pixel whose neighbourhood is all set or all
  // clear, for every plane: once, before the rounds
  for (int y = y0 + threadIdx.y; y <= y1; y += TY) {
    for (int x = x0 + threadIdx.x; x <= x1; x += TX) {
      const int li = (y - r0) * W + x;
      if (!tgt[li]) continue;
      const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
      const size_t p = (size_t)y * W + x;
      float s = 0.f;
      if (!border) {
#pragma unroll
        for (int o = 0; o < OFFSETS; ++o) s += __ldg(kb + o * hw + p);
      }
      const float th = __ldg(tb + p);
      flg[li] = (s > th ? ALL_ON : 0) | (0.f > th ? NONE_ON : 0) |
                (border ? BORDER : 0);
    }
  }

  cluster.sync();            // every block of the cluster has started
  for (int it = 0; it < r.num_iter; ++it) {
    uint8_t* cur = smem + (it & 1) * pplane;
    uint8_t* nxt = smem + ((it & 1) ^ 1) * pplane;
    for (int y = y0 + threadIdx.y; y <= y1; y += TY) {
      const int rl = (y - r0) * W, rp = (y - r0 + 1) * pw + 1;
      for (int xb = x0 + threadIdx.x; xb <= x1; xb += XU * TX) {
        // XU pixels of the row at once, so that their loads (the
        // neighbours, then the kernel values of the mixed ones) are in
        // flight together
        uint32_t t[XU], n[XU][OFFSETS], res[XU], mixed[XU];
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          const int x = xb + u * TX;
          t[u] = x <= x1 ? tgt[rl + x] : 0;
          res[u] = mixed[u] = 0;
          if (t[u]) {
            uint32_t all = 0xFF, any = 0;
#pragma unroll
            for (int o = 0; o < OFFSETS; ++o) {
              n[u][o] = cur[rp + x + (o / 3 - 1) * pw + (o % 3 - 1)];
              all &= n[u][o];
              any |= n[u][o];
            }
            const uint32_t f = flg[rl + x];
            if (f & BORDER) all = 0;
            res[u] = (all & ((f & ALL_ON) ? 0xFFu : 0u)) |
                     (~any & ((f & NONE_ON) ? 0xFFu : 0u));
            mixed[u] = any & ~all & t[u];
          }
        }
        float kv[XU][OFFSETS], th[XU];
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          if (mixed[u]) {
            const size_t p = (size_t)y * W + xb + u * TX;
#pragma unroll
            for (int o = 0; o < OFFSETS; ++o)
              kv[u][o] = __ldg(kb + o * hw + p);
            th[u] = __ldg(tb + p);
          }
        }
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          uint32_t m = mixed[u];
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            float s = 0.f;
#pragma unroll
            for (int o = 0; o < OFFSETS; ++o)
              if ((n[u][o] >> j) & 1) s += kv[u][o];
            if (s > th[u]) res[u] |= 1u << j;
          }
          if (xb + u * TX <= x1)
            nxt[rp + xb + u * TX] = (uint8_t)(res[u] & t[u]);
        }
      }
    }
    if (it == 0) {
      // from here on the state is 0 off the visited rectangle in both
      // buffers (bin0 may be set there)
      __syncthreads();
      for (int i = tid; i < pplane; i += THREADS) cur[i] = 0;
    }
    __syncthreads();
    // halo rows: the band's first row to the band above (its row
    // band_rows + 1), its last row to the band below (its row 0)
    if (band > 0) {
      uint8_t* up = cluster.map_shared_rank(nxt, band - 1);
      for (int i = tid; i < W; i += THREADS)
        up[(r.band_rows + 1) * pw + 1 + i] = nxt[pw + 1 + i];
    }
    if (band + 1 < nb) {
      uint8_t* dn = cluster.map_shared_rank(nxt, band + 1);
      for (int i = tid; i < W; i += THREADS)
        dn[1 + i] = nxt[rows * pw + 1 + i];
    }
    cluster.sync();
  }

  const uint8_t* fin = smem + (r.num_iter & 1) * pplane;
  float* dst = out + ((size_t)b * r.K + k0) * hw;
  for (int ch = tid; ch < rows * W / VEC; ch += THREADS) {
    const int e = ch * VEC;
    const int gy = r0 + e / W;
    const int gx = e - (gy - r0) * W;
    uint32_t st[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) st[i] = fin[(gy - r0 + 1) * pw + gx + 1 + i];
#pragma unroll
    for (int j = 0; j < PLANES; ++j) {
      if (j < np) {
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = ((st[i] >> j) & 1) ? 1.f : 0.f;
        store_vec<VEC>(dst + j * hw + (size_t)gy * W + gx, v);
      }
    }
  }
}

// the launch of a call: grid, block, shared memory and cluster
template <int VEC>
cudaError_t config(const Crf& r, int B, int bands, void* stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = 2 * (size_t)(r.band_rows + 2) * (r.W + 2) +
                      2 * (size_t)r.band_rows * r.W;
  *cfg = {};
  cfg->gridDim = dim3(bands, (r.K + PLANES - 1) / PLANES, B);
  cfg->blockDim = dim3(TX, TY);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = bands;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(crf_mean_field_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int VEC>
int launch(const float* kern, const float* thresh, const float* bin0,
           const float* targets, float* out, int B, const Crf& r, int bands,
           void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<VEC>(r, B, bands, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, crf_mean_field_kernel<VEC>, kern, thresh,
                           bin0, targets, out, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). kern (B, 9, H, W), thresh (B, H, W),
// bin0, targets and out (B, K, H, W), fp32, contiguous; bands of band_rows
// rows (the last may be shorter), `bands` = ceil(H / band_rows) blocks a
// cluster, at most MAX_BANDS. vec4 1 takes 16-byte loads and stores, which
// needs W % 4 == 0 and 16-byte aligned bin0, targets and out.
int crf_mean_field(const float* kern, const float* thresh, const float* bin0,
                   const float* targets, float* out, int B, int K, int H,
                   int W, int band_rows, int bands, int vec4, int num_iter,
                   void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || W <= 0 || num_iter < 0 ||
      band_rows <= 0 || bands <= 0 || bands > MAX_BANDS ||
      (bands - 1) * band_rows >= H || bands * band_rows < H ||
      (vec4 && W % 4))
    return (int)cudaErrorInvalidValue;
  Crf r{K, H, W, band_rows, num_iter};
  return vec4 ? launch<4>(kern, thresh, bin0, targets, out, B, r, bands,
                          stream)
              : launch<1>(kern, thresh, bin0, targets, out, B, r, bands,
                          stream);
}

// How many clusters of `bands` blocks of band_rows rows can run at once on
// the current device (a negative cudaError_t on failure): the wrapper picks
// the band count that fills one wave.
int crf_mean_field_clusters(int H, int W, int band_rows, int bands) {
  Crf r{PLANES, H, W, band_rows, 0};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err = config<4>(r, 1, bands, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, crf_mean_field_kernel<4>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
