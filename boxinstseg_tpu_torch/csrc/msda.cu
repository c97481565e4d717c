// Multi-scale deformable attention of one encoder layer, all levels in one
// launch: forward (bilinear sample + attention-weighted sum over levels and
// points) and backward (d(value), d(offsets), d(attn)), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels in boxinstseg_tpu/ops/msda_pallas.py:
//   K4   _dpatch_kernel_factory          d(value) scatter of _pm_bwd
//   K4f  _fwd_kernel_factory             sample + point sum
//   K4r  _rdot_kernel_factory            per-sample corner row-dots
//   K4p  _postgather_fwd_kernel_factory  forward tail after the gather
// together with the per-level glue of MultiScaleDeformableAttention around
// them (boxinstseg_tpu/models/utils/transformer.py).
//
// Layouts, all fp32 and contiguous, in the module's own order:
//   value   (B, S, H, D)          the levels' maps concatenated, row-major
//   ref     (B, L, 2)             normalised xy, shared by the levels
//   offsets (B, L, H, NL, P, 2)   sampling_offsets' output
//   attn    (B, L, H, NL, P)      after the softmax
//   out     (B, L, H*D)
// Semantics, per (b, q, head) and level l with map (Hl, Wl):
//   lx = ref_x + off_x / Wl, ly = ref_y + off_y / Hl,
//   x = lx*Wl - 0.5, y = ly*Hl - 0.5, x0 = floor(x), y0 = floor(y);
//   a sample counts only if x0 in [-1, Wl-1] and y0 in [-1, Hl-1]; a corner
//   outside the map reads 0 and receives no gradient;
//   out = sum over levels, in order, of sum_p attn * sum_k cw_k v[corner_k],
//   cw = [(1-wy)(1-wx), (1-wy)wx, wy(1-wx), wy wx], corners [TL, TR, BL, BR].
//   Backward with r_k = <v[corner_k], g>:
//     d_attn  = sum_k cw_k r_k,
//     d_off_x = (attn * ((1-wy)(r1-r0) + wy(r3-r2)) * Wl) / Wl,
//     d_off_y = (attn * ((1-wx)(r2-r0) + wx(r3-r1)) * Hl) / Hl,
//     d_value[corner_k] += attn * cw_k * g; all zero for a dropped sample.
// No gradient is returned for ref (the pixel decoder's constant grid).
//
// Rounding of the location. The plain version computes off / Wl as a
// tensor divided by a Python number; on a CUDA tensor PyTorch multiplies by
// the reciprocal, rounded once in fp32 on the host (div_true_kernel_cuda
// takes the CPU-scalar branch), and autograd's d(off) = d(lx) / Wl takes the
// same branch. These kernels match that card-side plain version: inv_w =
// 1.0f / Wl from the host, then ref + off * inv_w and x = lx * Wl - 0.5 each
// as separate round-to-nearest fp32 operations (no contraction), so floor()
// sees the plain version's value. On the CPU PyTorch divides; at the
// power-of-two widths of the main path both are exact.
//
// What bounds them on an H100. One layer of the Box2Mask encoder (B = 2,
// H = 8, D = 32, P = 4, maps 32^2, 64^2, 128^2, L = S = 21,504) moves 138 MB
// (forward) or 232 MB (backward) of HBM, 0.041 / 0.069 ms at 3.35 TB/s; but
// it gathers 16.5 M corner rows of 128 B, 2.1 GB, through L1 and L2, and
// the backward sends as many d(value) row updates, 2.1 GB, to L2. The
// forward is bound by the loads in flight and L1 reuse between neighbouring
// queries; the backward by that update traffic (plain stores in place of
// the atomics gain little; dropping the coarse levels' updates halves it).
//
// The design (D = 32, P = 4, levels fixed at compile time; 3 levels are
// instantiated): an 8-lane group owns one (b, q, head), a lane 4 channels,
// so a corner row is one 16-byte load a lane and one 128-byte line a group;
// a warp holds four heads of one query, and consecutive warps take
// consecutive queries, so neighbouring samples share L1 and L2 lines. The
// loops over levels and points are unrolled: the forward issues a level's
// 4 x 4 corner loads before any use, sums the levels in registers and
// writes the output once. The backward takes one point at a time (64
// registers, so four blocks a multiprocessor), reduces the four row-dots of
// a sample within the group (three xor shuffles) and scatters d(value) with
// one 16-byte vector atomicAdd(float4*) a lane and corner (compute
// capability 9.x, global memory): 4x fewer atomic instructions than scalar
// ones. The order of the additions, and so the last bits of d(value), vary
// from run to run. Staging a tile's updates in shared memory did not pay:
// shared-memory float atomics are compare-and-swap loops on sm_90. Other
// shapes take a generic pair: one warp per (b, q, head), a lane per
// channel, scalar loads and atomics, runtime levels and points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int FAST_D = 32;
constexpr int FAST_P = 4;
constexpr int GROUPS_PER_BLOCK = THREADS / 8;   // fast pair: 8 lanes a group
constexpr int WARPS_PER_BLOCK = THREADS / 32;   // generic pair

struct Levels {
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
  float inv_h[MAX_LEVELS], inv_w[MAX_LEVELS];
};

struct Sample {
  bool ok;                 // the sample counts
  bool tl, tr, bl, br;     // each corner lies inside the map (and ok)
  int row;                 // iy * W + ix of the top-left corner
  float wx, wy;
};

// ref + off / size as the card's plain version rounds it (see above)
__device__ __forceinline__ float location(float ref, float off, float inv) {
  return __fadd_rn(ref, __fmul_rn(off, inv));
}

__device__ __forceinline__ Sample geometry(float lx, float ly, int H, int W) {
  const float x = __fsub_rn(__fmul_rn(lx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)H), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Sample s;
  s.ok = (x0 >= -1.f) && (x0 <= (float)(W - 1)) && (y0 >= -1.f) &&
         (y0 <= (float)(H - 1));
  const int ix = s.ok ? (int)x0 : 0;
  const int iy = s.ok ? (int)y0 : 0;
  const bool t = s.ok && iy >= 0, b = s.ok && iy + 1 <= H - 1;
  const bool l = ix >= 0, r = ix + 1 <= W - 1;
  s.tl = t && l;
  s.tr = t && r;
  s.bl = b && l;
  s.br = b && r;
  s.row = iy * W + ix;     // < 0 at y0 = -1: that corner is never read
  s.wx = __fsub_rn(x, x0);
  s.wy = __fsub_rn(y, y0);
  return s;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float group_sum(float v) {   // over 8 lanes
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------ fast pair: D 32, P 4

template <int NL>
__global__ void __launch_bounds__(THREADS)
msda_forward_d32_kernel(const float* __restrict__ value,
                        const float* __restrict__ ref,
                        const float* __restrict__ offsets,
                        const float* __restrict__ attn,
                        float* __restrict__ out, const Levels lv, int B,
                        int S, int L, int H) {
  constexpr int P = FAST_P, D = FAST_D, K = NL * P;
  const long long g =
      (long long)blockIdx.x * GROUPS_PER_BLOCK + (threadIdx.x >> 3);
  if (g >= (long long)B * L * H) return;
  const int lane = threadIdx.x & 7;
  const long long bq = g / H;                       // b * L + q
  const int h = (int)(g - bq * H);
  const int b = (int)(bq / L);
  const float2 r = __ldg(reinterpret_cast<const float2*>(ref) + bq);
  const size_t pos = (size_t)H * D;                 // floats between pixels
  const float* vb = value + ((size_t)b * S * H + h) * D + lane * 4;
  const float* og = offsets + g * (2 * K);
  const float* ag = attn + g * K;
  float4 acc = zero4();
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const float* vl = vb + (size_t)lv.start[l] * pos;
    const float4 o01 = load4(og + 2 * P * l), o23 = load4(og + 2 * P * l + 4);
    const float4 wt = load4(ag + P * l);
    const float ox[P] = {o01.x, o01.z, o23.x, o23.z};
    const float oy[P] = {o01.y, o01.w, o23.y, o23.w};
    const float wp[P] = {wt.x, wt.y, wt.z, wt.w};
    Sample s[P];
    float4 v[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      s[p] = geometry(location(r.x, ox[p], lv.inv_w[l]),
                      location(r.y, oy[p], lv.inv_h[l]), Hl, Wl);
      const float* c = vl + (long long)s[p].row * (long long)pos;
      v[p][0] = s[p].tl ? load4(c) : zero4();
      v[p][1] = s[p].tr ? load4(c + pos) : zero4();
      v[p][2] = s[p].bl ? load4(c + Wl * pos) : zero4();
      v[p][3] = s[p].br ? load4(c + (Wl + 1) * pos) : zero4();
    }
    float4 lacc = zero4();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float wx = s[p].wx, wy = s[p].wy;
      const float c0 = (1.f - wy) * (1.f - wx) * wp[p];
      const float c1 = (1.f - wy) * wx * wp[p];
      const float c2 = wy * (1.f - wx) * wp[p];
      const float c3 = wy * wx * wp[p];
      lacc.x += c0 * v[p][0].x + c1 * v[p][1].x + c2 * v[p][2].x +
                c3 * v[p][3].x;
      lacc.y += c0 * v[p][0].y + c1 * v[p][1].y + c2 * v[p][2].y +
                c3 * v[p][3].y;
      lacc.z += c0 * v[p][0].z + c1 * v[p][1].z + c2 * v[p][2].z +
                c3 * v[p][3].z;
      lacc.w += c0 * v[p][0].w + c1 * v[p][1].w + c2 * v[p][2].w +
                c3 * v[p][3].w;
    }
    acc.x += lacc.x;
    acc.y += lacc.y;
    acc.z += lacc.z;
    acc.w += lacc.w;
  }
  *reinterpret_cast<float4*>(out + g * D + lane * 4) = acc;
}

template <int NL>
__global__ void __launch_bounds__(THREADS)
msda_backward_d32_kernel(const float* __restrict__ value,
                         const float* __restrict__ ref,
                         const float* __restrict__ offsets,
                         const float* __restrict__ attn,
                         const float* __restrict__ grad_out,
                         float* __restrict__ d_value,
                         float* __restrict__ d_offsets,
                         float* __restrict__ d_attn, const Levels lv, int B,
                         int S, int L, int H) {
  constexpr int P = FAST_P, D = FAST_D, K = NL * P;
  const long long total = (long long)B * L * H;
  long long g = (long long)blockIdx.x * GROUPS_PER_BLOCK + (threadIdx.x >> 3);
  // a group past the end runs the last group's samples without writing, so
  // that every lane of the warp takes part in the shuffles
  const bool live = g < total;
  if (!live) g = total - 1;
  const int lane = threadIdx.x & 7;
  const long long bq = g / H;
  const int h = (int)(g - bq * H);
  const int b = (int)(bq / L);
  const float2 r = __ldg(reinterpret_cast<const float2*>(ref) + bq);
  const size_t pos = (size_t)H * D;
  const size_t vofs = ((size_t)b * S * H + h) * D + lane * 4;
  const float* vb = value + vofs;
  float* dvb = d_value + vofs;
  const float* og = offsets + g * (2 * K);
  const float* ag = attn + g * K;
  const float4 gv = load4(grad_out + g * D + lane * 4);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const size_t lofs = (size_t)lv.start[l] * pos;
    const float4 o01 = load4(og + 2 * P * l), o23 = load4(og + 2 * P * l + 4);
    const float4 wt = load4(ag + P * l);
    const float ox[P] = {o01.x, o01.z, o23.x, o23.z};
    const float oy[P] = {o01.y, o01.w, o23.y, o23.w};
    const float wp[P] = {wt.x, wt.y, wt.z, wt.w};
    // one point at a time: 64 registers, four blocks a multiprocessor
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const Sample s = geometry(location(r.x, ox[p], lv.inv_w[l]),
                                location(r.y, oy[p], lv.inv_h[l]), Hl, Wl);
      const long long row = (long long)s.row * (long long)pos;
      const float* v = vb + lofs + row;
      const float4 v0 = s.tl ? load4(v) : zero4();
      const float4 v1 = s.tr ? load4(v + pos) : zero4();
      const float4 v2 = s.bl ? load4(v + Wl * pos) : zero4();
      const float4 v3 = s.br ? load4(v + (Wl + 1) * pos) : zero4();
      const float wx = s.wx, wy = s.wy;
      const float c0 = (1.f - wy) * (1.f - wx), c1 = (1.f - wy) * wx;
      const float c2 = wy * (1.f - wx), c3 = wy * wx;
      const float r0 = group_sum(dot4(v0, gv));
      const float r1 = group_sum(dot4(v1, gv));
      const float r2 = group_sum(dot4(v2, gv));
      const float r3 = group_sum(dot4(v3, gv));
      if (live) {
        float* dv = dvb + lofs + row;
        const float u0 = c0 * wp[p], u1 = c1 * wp[p];
        const float u2 = c2 * wp[p], u3 = c3 * wp[p];
        if (s.tl)
          atomicAdd(reinterpret_cast<float4*>(dv),
                    make_float4(u0 * gv.x, u0 * gv.y, u0 * gv.z, u0 * gv.w));
        if (s.tr)
          atomicAdd(reinterpret_cast<float4*>(dv + pos),
                    make_float4(u1 * gv.x, u1 * gv.y, u1 * gv.z, u1 * gv.w));
        if (s.bl)
          atomicAdd(reinterpret_cast<float4*>(dv + Wl * pos),
                    make_float4(u2 * gv.x, u2 * gv.y, u2 * gv.z, u2 * gv.w));
        if (s.br)
          atomicAdd(reinterpret_cast<float4*>(dv + (Wl + 1) * pos),
                    make_float4(u3 * gv.x, u3 * gv.y, u3 * gv.z, u3 * gv.w));
      }
      if (live && lane == (k & 7)) {
        float dw = 0.f, dx = 0.f, dy = 0.f;
        if (s.ok) {
          dw = c0 * r0 + c1 * r1 + c2 * r2 + c3 * r3;
          dx = wp[p] * ((1.f - wy) * (r1 - r0) + wy * (r3 - r2)) * (float)Wl *
               lv.inv_w[l];
          dy = wp[p] * ((1.f - wx) * (r2 - r0) + wx * (r3 - r1)) * (float)Hl *
               lv.inv_h[l];
        }
        reinterpret_cast<float2*>(d_offsets)[g * K + k] = make_float2(dx, dy);
        d_attn[g * K + k] = dw;
      }
    }
  }
}

// ------------------------------- generic pair: any D, P and level count

__global__ void __launch_bounds__(THREADS)
msda_forward_generic_kernel(const float* __restrict__ value,
                            const float* __restrict__ ref,
                            const float* __restrict__ offsets,
                            const float* __restrict__ attn,
                            float* __restrict__ out, const Levels lv, int B,
                            int S, int L, int H, int D, int NL, int P) {
  const long long g =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (g >= (long long)B * L * H) return;
  const int lane = threadIdx.x & 31;
  const long long bq = g / H;
  const int h = (int)(g - bq * H);
  const int b = (int)(bq / L);
  const int K = NL * P;
  const float rx = __ldg(ref + 2 * bq), ry = __ldg(ref + 2 * bq + 1);
  const size_t pos = (size_t)H * D;
  const float* vb = value + ((size_t)b * S * H + h) * D;
  const float* og = offsets + g * 2 * K;
  const float* ag = attn + g * K;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int ch = c0 + lane;
    const bool act = ch < D;
    float acc = 0.f;
    for (int l = 0; l < NL; ++l) {
      const int Wl = lv.w[l];
      const float* vl = vb + (size_t)lv.start[l] * pos + ch;
      float lacc = 0.f;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const Sample s =
            geometry(location(rx, __ldg(og + 2 * k), lv.inv_w[l]),
                     location(ry, __ldg(og + 2 * k + 1), lv.inv_h[l]),
                     lv.h[l], Wl);
        if (!s.ok || !act) continue;
        const float wt = __ldg(ag + k);
        const float* c = vl + (long long)s.row * (long long)pos;
        const float v0 = s.tl ? __ldg(c) : 0.f;
        const float v1 = s.tr ? __ldg(c + pos) : 0.f;
        const float v2 = s.bl ? __ldg(c + Wl * pos) : 0.f;
        const float v3 = s.br ? __ldg(c + (Wl + 1) * pos) : 0.f;
        lacc += (1.f - s.wy) * (1.f - s.wx) * wt * v0 +
                (1.f - s.wy) * s.wx * wt * v1 + s.wy * (1.f - s.wx) * wt * v2 +
                s.wy * s.wx * wt * v3;
      }
      acc += lacc;
    }
    if (act) out[g * D + ch] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
msda_backward_generic_kernel(const float* __restrict__ value,
                             const float* __restrict__ ref,
                             const float* __restrict__ offsets,
                             const float* __restrict__ attn,
                             const float* __restrict__ grad_out,
                             float* __restrict__ d_value,
                             float* __restrict__ d_offsets,
                             float* __restrict__ d_attn, const Levels lv,
                             int B, int S, int L, int H, int D, int NL,
                             int P) {
  const long long g =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (g >= (long long)B * L * H) return;            // whole warps
  const int lane = threadIdx.x & 31;
  const long long bq = g / H;
  const int h = (int)(g - bq * H);
  const int b = (int)(bq / L);
  const int K = NL * P;
  const float rx = __ldg(ref + 2 * bq), ry = __ldg(ref + 2 * bq + 1);
  const size_t pos = (size_t)H * D;
  const size_t vofs = ((size_t)b * S * H + h) * D;
  const float* og = offsets + g * 2 * K;
  const float* ag = attn + g * K;
  const float* gq = grad_out + g * D;
  for (int l = 0; l < NL; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const size_t lofs = vofs + (size_t)lv.start[l] * pos;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const Sample s =
          geometry(location(rx, __ldg(og + 2 * k), lv.inv_w[l]),
                   location(ry, __ldg(og + 2 * k + 1), lv.inv_h[l]), Hl, Wl);
      if (!s.ok) {
        if (lane == 0) {
          d_offsets[2 * (g * K + k)] = 0.f;
          d_offsets[2 * (g * K + k) + 1] = 0.f;
          d_attn[g * K + k] = 0.f;
        }
        continue;
      }
      const float wt = __ldg(ag + k);
      const float c0 = (1.f - s.wy) * (1.f - s.wx), c1 = (1.f - s.wy) * s.wx;
      const float c2 = s.wy * (1.f - s.wx), c3 = s.wy * s.wx;
      const long long row = (long long)s.row * (long long)pos;
      const float* v = value + lofs + row;
      float* dv = d_value + lofs + row;
      float r0 = 0.f, r1 = 0.f, r2 = 0.f, r3 = 0.f;
      for (int ch = lane; ch < D; ch += 32) {
        const float gv = __ldg(gq + ch);
        if (s.tl) {
          r0 += __ldg(v + ch) * gv;
          atomicAdd(dv + ch, c0 * wt * gv);
        }
        if (s.tr) {
          r1 += __ldg(v + pos + ch) * gv;
          atomicAdd(dv + pos + ch, c1 * wt * gv);
        }
        if (s.bl) {
          r2 += __ldg(v + Wl * pos + ch) * gv;
          atomicAdd(dv + Wl * pos + ch, c2 * wt * gv);
        }
        if (s.br) {
          r3 += __ldg(v + (Wl + 1) * pos + ch) * gv;
          atomicAdd(dv + (Wl + 1) * pos + ch, c3 * wt * gv);
        }
      }
      r0 = warp_sum(r0);
      r1 = warp_sum(r1);
      r2 = warp_sum(r2);
      r3 = warp_sum(r3);
      if (lane == 0) {
        d_attn[g * K + k] = c0 * r0 + c1 * r1 + c2 * r2 + c3 * r3;
        d_offsets[2 * (g * K + k)] =
            wt * ((1.f - s.wy) * (r1 - r0) + s.wy * (r3 - r2)) * (float)Wl *
            lv.inv_w[l];
        d_offsets[2 * (g * K + k) + 1] =
            wt * ((1.f - s.wx) * (r2 - r0) + s.wx * (r3 - r1)) * (float)Hl *
            lv.inv_h[l];
      }
    }
  }
}

// Fills the level table from (h, w) pairs; false if they do not tile S.
bool make_levels(const int* shapes, int NL, int S, Levels* lv) {
  if (NL < 1 || NL > MAX_LEVELS) return false;
  long long start = 0;
  for (int l = 0; l < NL; ++l) {
    const int h = shapes[2 * l], w = shapes[2 * l + 1];
    if (h <= 0 || w <= 0) return false;
    lv->h[l] = h;
    lv->w[l] = w;
    lv->start[l] = (int)start;
    // rounded once in fp32, as PyTorch's CUDA division by a Python number
    lv->inv_h[l] = 1.0f / (float)h;
    lv->inv_w[l] = 1.0f / (float)w;
    start += (long long)h * w;
  }
  return start == S;
}

bool fast(int D, int NL, int P) {
  return D == FAST_D && P == FAST_P && NL == 3;
}

unsigned blocks(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Both return a cudaError_t (0 on success). shapes: NL (h, w) pairs on the
// host. d_value must be zeroed by the caller.
int msda_forward(const float* value, const float* ref, const float* offsets,
                 const float* attn, float* out, const int* shapes, int NL,
                 int B, int S, int L, int H, int D, int P, void* stream) {
  Levels lv;
  if (B <= 0 || S <= 0 || L <= 0 || H <= 0 || D <= 0 || P <= 0 ||
      !make_levels(shapes, NL, S, &lv))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * L * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (fast(D, NL, P))
    msda_forward_d32_kernel<3><<<blocks(items, GROUPS_PER_BLOCK), THREADS, 0,
                                 st>>>(value, ref, offsets, attn, out, lv, B,
                                       S, L, H);
  else
    msda_forward_generic_kernel<<<blocks(items, WARPS_PER_BLOCK), THREADS, 0,
                                  st>>>(value, ref, offsets, attn, out, lv, B,
                                        S, L, H, D, NL, P);
  return (int)cudaGetLastError();
}

int msda_backward(const float* value, const float* ref, const float* offsets,
                  const float* attn, const float* grad_out, float* d_value,
                  float* d_offsets, float* d_attn, const int* shapes, int NL,
                  int B, int S, int L, int H, int D, int P, void* stream) {
  Levels lv;
  if (B <= 0 || S <= 0 || L <= 0 || H <= 0 || D <= 0 || P <= 0 ||
      !make_levels(shapes, NL, S, &lv))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * L * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (fast(D, NL, P))
    msda_backward_d32_kernel<3><<<blocks(items, GROUPS_PER_BLOCK), THREADS, 0,
                                  st>>>(value, ref, offsets, attn, grad_out,
                                        d_value, d_offsets, d_attn, lv, B, S,
                                        L, H);
  else
    msda_backward_generic_kernel<<<blocks(items, WARPS_PER_BLOCK), THREADS, 0,
                                   st>>>(value, ref, offsets, attn, grad_out,
                                         d_value, d_offsets, d_attn, lv, B, S,
                                         L, H, D, NL, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
