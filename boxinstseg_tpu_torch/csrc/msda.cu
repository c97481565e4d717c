// Multi-scale deformable attention sampling, one level: forward (bilinear
// sample + attention-weighted point sum) and backward (d(value), d(loc_x),
// d(loc_y), d(weight)), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels in boxinstseg_tpu/ops/msda_pallas.py:
//   K4   _dpatch_kernel_factory          d(value) scatter of _pm_bwd
//   K4f  _fwd_kernel_factory             sample + point sum
//   K4r  _rdot_kernel_factory            per-sample corner row-dots
//   K4p  _postgather_fwd_kernel_factory  forward tail after the gather
// The semantics are those of msda_sample_psum_pm (_sample_flat_pm forward,
// _pm_bwd backward), in fp32 throughout:
//   value (BH, H, W, C); loc_x, loc_y, weight (BH, P*L) in P-major sample
//   order n = p*L + q; out (BH, L, C).
//   x = loc_x*W - 0.5, y = loc_y*H - 0.5, x0 = floor(x), y0 = floor(y).
//   A sample counts only if x0 in [-1, W-1] and y0 in [-1, H-1] (ok);
//   a corner outside the map reads 0 and receives no gradient.
//   out[q] = sum_p weight * sum_k cw_k * v[corner_k], cw = [(1-wy)(1-wx),
//   (1-wy)wx, wy(1-wx), wy wx], corners [TL, TR, BL, BR].
//   Backward with r_k = <v[corner_k], g[q]>:
//     d_weight = sum_k cw_k r_k,
//     d_loc_x  = W * weight * ((1-wy)(r1-r0) + wy(r3-r2)),
//     d_loc_y  = H * weight * ((1-wx)(r2-r0) + wx(r3-r1)),
//     d_value[corner_k] += weight * cw_k * g[q]; all zero where !ok.
// The TPU d(patch) kernel rounds its update rows to bf16; these kernels do
// not: every product and sum is fp32.
//
// What bounds them on an H100: bytes. One call at the largest level of the
// Box2Mask encoder (BH = 16, 128x128 map, L = 21,504 queries, P = 4,
// C = 32) reads 33.5 MB of value and 16.5 MB of loc/weight and writes
// 44 MB of output, against ~300 flops per sample (9 per corner channel). The design: one warp per
// (bh, query), a lane per channel, so each corner read is one coalesced
// 128-byte row of C = 32 floats; the warp walks the P points of its query,
// whose geometry every lane computes from the same broadcast loads. The
// backward reduces the four corner row-dots across the warp with shuffles
// (K4r), and scatters d(value) with float atomicAdd, as mmcv's
// ms_deform_attn CUDA kernel does: the order of the additions, and so the
// last bits of d(value), vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARPS_PER_BLOCK * 32;

struct Geom {
  bool ok;
  int ix, iy;        // top-left corner (may be -1)
  float wx, wy;
};

// x = loc*size - 0.5 rounded as two separate fp32 ops (no contraction), as
// the plain version computes it, so that floor() sees the same value.
__device__ __forceinline__ Geom geometry(float lx, float ly, int H, int W) {
  const float x = __fsub_rn(__fmul_rn(lx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)H), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Geom g;
  g.ok = (x0 >= -1.f) && (x0 <= (float)(W - 1)) && (y0 >= -1.f) &&
         (y0 <= (float)(H - 1));
  g.ix = g.ok ? (int)x0 : 0;
  g.iy = g.ok ? (int)y0 : 0;
  g.wx = __fsub_rn(x, x0);
  g.wy = __fsub_rn(y, y0);
  return g;
}

__global__ void __launch_bounds__(THREADS)
msda_forward_kernel(const float* __restrict__ value,
                    const float* __restrict__ loc_x,
                    const float* __restrict__ loc_y,
                    const float* __restrict__ weight,
                    float* __restrict__ out, int BH, int H, int W, int C,
                    int L, int P) {
  const long long warp =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)BH * L) return;
  const int bh = (int)(warp / L);
  const int q = (int)(warp % L);
  const float* v = value + (size_t)bh * H * W * C;
  const size_t sbase = (size_t)bh * P * L + q;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int ch = c0 + lane;
    const bool act = ch < C;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      const size_t n = sbase + (size_t)p * L;
      const Geom g = geometry(__ldg(loc_x + n), __ldg(loc_y + n), H, W);
      if (!g.ok) continue;
      const float wt = __ldg(weight + n);
      const float w00 = (1.f - g.wy) * (1.f - g.wx) * wt;
      const float w01 = (1.f - g.wy) * g.wx * wt;
      const float w10 = g.wy * (1.f - g.wx) * wt;
      const float w11 = g.wy * g.wx * wt;
      const bool t = g.iy >= 0, b = g.iy + 1 <= H - 1;
      const bool l = g.ix >= 0, r = g.ix + 1 <= W - 1;
      const long long row = (long long)g.iy * W + g.ix;  // < 0 at y0 = -1
      float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
      if (act) {
        if (t && l) v00 = __ldg(v + row * C + ch);
        if (t && r) v01 = __ldg(v + (row + 1) * C + ch);
        if (b && l) v10 = __ldg(v + (row + W) * C + ch);
        if (b && r) v11 = __ldg(v + (row + W + 1) * C + ch);
      }
      acc += w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
    }
    if (act) out[((size_t)bh * L + q) * C + ch] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
msda_backward_kernel(const float* __restrict__ value,
                     const float* __restrict__ loc_x,
                     const float* __restrict__ loc_y,
                     const float* __restrict__ weight,
                     const float* __restrict__ grad_out,
                     float* __restrict__ d_value, float* __restrict__ d_loc_x,
                     float* __restrict__ d_loc_y,
                     float* __restrict__ d_weight, int BH, int H, int W,
                     int C, int L, int P) {
  const long long warp =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)BH * L) return;
  const int bh = (int)(warp / L);
  const int q = (int)(warp % L);
  const float* v = value + (size_t)bh * H * W * C;
  float* dv = d_value + (size_t)bh * H * W * C;
  const float* gq = grad_out + ((size_t)bh * L + q) * C;
  const size_t sbase = (size_t)bh * P * L + q;
  for (int p = 0; p < P; ++p) {
    const size_t n = sbase + (size_t)p * L;
    const Geom g = geometry(__ldg(loc_x + n), __ldg(loc_y + n), H, W);
    if (!g.ok) {
      if (lane == 0) {
        d_weight[n] = 0.f;
        d_loc_x[n] = 0.f;
        d_loc_y[n] = 0.f;
      }
      continue;
    }
    const float wt = __ldg(weight + n);
    const float c00 = (1.f - g.wy) * (1.f - g.wx);
    const float c01 = (1.f - g.wy) * g.wx;
    const float c10 = g.wy * (1.f - g.wx);
    const float c11 = g.wy * g.wx;
    const bool t = g.iy >= 0, b = g.iy + 1 <= H - 1;
    const bool l = g.ix >= 0, r = g.ix + 1 <= W - 1;
    const long long row = (long long)g.iy * W + g.ix;    // < 0 at y0 = -1
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, r3 = 0.f;
    for (int ch = lane; ch < C; ch += 32) {
      const float gv = __ldg(gq + ch);
      if (t && l) {
        r0 += __ldg(v + row * C + ch) * gv;
        atomicAdd(dv + row * C + ch, c00 * wt * gv);
      }
      if (t && r) {
        r1 += __ldg(v + (row + 1) * C + ch) * gv;
        atomicAdd(dv + (row + 1) * C + ch, c01 * wt * gv);
      }
      if (b && l) {
        r2 += __ldg(v + (row + W) * C + ch) * gv;
        atomicAdd(dv + (row + W) * C + ch, c10 * wt * gv);
      }
      if (b && r) {
        r3 += __ldg(v + (row + W + 1) * C + ch) * gv;
        atomicAdd(dv + (row + W + 1) * C + ch, c11 * wt * gv);
      }
    }
    r0 = warp_sum(r0);
    r1 = warp_sum(r1);
    r2 = warp_sum(r2);
    r3 = warp_sum(r3);
    if (lane == 0) {
      d_weight[n] = c00 * r0 + c01 * r1 + c10 * r2 + c11 * r3;
      d_loc_x[n] = wt * ((1.f - g.wy) * (r1 - r0) + g.wy * (r3 - r2)) *
                   (float)W;
      d_loc_y[n] = wt * ((1.f - g.wx) * (r2 - r0) + g.wx * (r3 - r1)) *
                   (float)H;
    }
  }
}

int blocks_for(int BH, int L) {
  const long long warps = (long long)BH * L;
  return (int)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). d_value must be zeroed by the caller.
int msda_forward(const float* value, const float* loc_x, const float* loc_y,
                 const float* weight, float* out, int BH, int H, int W, int C,
                 int L, int P, void* stream) {
  if (BH <= 0 || L <= 0 || P <= 0 || C <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  msda_forward_kernel<<<blocks_for(BH, L), THREADS, 0,
                        (cudaStream_t)stream>>>(value, loc_x, loc_y, weight,
                                                out, BH, H, W, C, L, P);
  return (int)cudaGetLastError();
}

int msda_backward(const float* value, const float* loc_x, const float* loc_y,
                  const float* weight, const float* grad_out, float* d_value,
                  float* d_loc_x, float* d_loc_y, float* d_weight, int BH,
                  int H, int W, int C, int L, int P, void* stream) {
  if (BH <= 0 || L <= 0 || P <= 0 || C <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  msda_backward_kernel<<<blocks_for(BH, L), THREADS, 0,
                         (cudaStream_t)stream>>>(
      value, loc_x, loc_y, weight, grad_out, d_value, d_loc_x, d_loc_y,
      d_weight, BH, H, W, C, L, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
