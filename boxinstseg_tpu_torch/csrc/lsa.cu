// Linear sum assignment (exact Jonker-Volgenant, shortest augmenting path
// with row and column potentials), one thread block a problem.
//
// The port's counterpart of boxinstseg_tpu/ops/lsa.py:24 solve_lsa (which
// is plain XLA, not a Pallas kernel). It runs the JAX algorithm step for
// step, in fp32 and in the same order of operations, so that exactly tied
// costs resolve as they do there:
//   - rows 0 .. n_rows[p] - 1 are augmented in order; n_rows is read here,
//     so the host never waits;
//   - a step relaxes every unused column j through the explored row i0,
//     cur = (cost[i0][j] - u[i0]) - v[j], and takes the tightest unused
//     column j1 with its slack delta: a warp-shuffle (value, index)
//     arg-min that keeps the lowest index on ties, as jnp.argmin;
//   - u[i] and u of every row owning a used column gain delta, the used
//     columns' v lose it, the unused columns' slack shrinks by it;
//   - the search ends at a free column or after m + 1 steps; one thread
//     then walks the path back, flipping column ownership.
// The problem's cost (n x m fp32) sits in shared memory with u, v, minv,
// way, used and col2row; a thread serves column j and j + blockDim.x, ...
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float INF = 1e30f;

// the smaller (value, index) pair; the lower index on equal values
__device__ __forceinline__ void argmin_pair(float& v, int& j, float ov,
                                            int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__global__ void __launch_bounds__(THREADS)
lsa_kernel(const float* __restrict__ cost_g, const int* __restrict__ n_rows,
           long long* __restrict__ col4row, int* __restrict__ steps_out,
           int n, int m) {
  extern __shared__ float smem[];
  float* cost = smem;                       // n * m
  float* u = cost + (size_t)n * m;          // n
  float* v = u + n;                         // m
  float* minv = v + m;                      // m
  int* way = reinterpret_cast<int*>(minv + m);   // m
  int* col2row = way + m;                   // m
  uint8_t* used = reinterpret_cast<uint8_t*>(col2row + m);   // m

  __shared__ float red_v[WARPS];
  __shared__ int red_j[WARPS];
  __shared__ int s_i0, s_last_j, s_j_free, s_steps;
  __shared__ float s_delta;
  __shared__ int s_j1;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* src = cost_g + (size_t)p * n * m;
  for (int k = tid; k < n * m; k += THREADS) cost[k] = src[k];
  for (int r = tid; r < n; r += THREADS) u[r] = 0.f;
  for (int j = tid; j < m; j += THREADS) {
    v[j] = 0.f;
    col2row[j] = -1;
  }
  int live = n_rows[p];
  live = live < 0 ? 0 : (live > n ? n : live);
  int total_steps = 0;
  __syncthreads();

  for (int i = 0; i < live; ++i) {
    for (int j = tid; j < m; j += THREADS) {
      minv[j] = INF;
      way[j] = -1;
      used[j] = 0;
    }
    if (tid == 0) {
      s_i0 = i;
      s_last_j = -1;
      s_j_free = -1;
      s_steps = 0;
    }
    __syncthreads();
    while (s_j_free < 0 && s_steps <= m) {
      const int i0 = s_i0, last_j = s_last_j;
      const float u_i0 = u[i0];
      const float* crow = cost + (size_t)i0 * m;
      // relax through row i0; this thread's tightest unused column
      float best = INF;
      int best_j = m;
      for (int j = tid; j < m; j += THREADS) {
        float masked = INF;
        if (!used[j]) {
          const float cur = __fsub_rn(__fsub_rn(crow[j], u_i0), v[j]);
          float mv = minv[j];
          if (cur < mv) {
            mv = cur;
            minv[j] = cur;
            way[j] = last_j;
          }
          masked = mv;
        }
        argmin_pair(best, best_j, masked, j);
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
        argmin_pair(best, best_j, ov, oj);
      }
      if (lane == 0) {
        red_v[warp] = best;
        red_j[warp] = best_j;
      }
      __syncthreads();
      if (tid == 0) {
        float bv = red_v[0];
        int bj = red_j[0];
        for (int w = 1; w < WARPS; ++w) argmin_pair(bv, bj, red_v[w], red_j[w]);
        s_delta = bv;
        s_j1 = bj;
      }
      __syncthreads();
      const float delta = s_delta;
      const int j1 = s_j1;
      // the dual update: used columns have distinct owners, none of them
      // row i (not yet assigned)
      for (int j = tid; j < m; j += THREADS) {
        if (used[j]) {
          const int r = col2row[j];
          if (r >= 0) u[r] = __fadd_rn(u[r], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      __syncthreads();
      if (tid == 0) {
        u[i] = __fadd_rn(u[i], delta);
        used[j1] = 1;
        const int owner = col2row[j1];
        if (owner < 0) s_j_free = j1; else s_i0 = owner;
        s_last_j = j1;
        s_steps += 1;
      }
      __syncthreads();
    }
    if (tid == 0) {
      total_steps += s_steps;
      int j0 = s_j_free;
      while (j0 >= 0) {
        const int jprev = way[j0];
        col2row[j0] = jprev < 0 ? i : col2row[jprev];
        j0 = jprev;
      }
    }
    __syncthreads();
  }

  long long* out = col4row + (size_t)p * n;
  for (int r = tid; r < n; r += THREADS) out[r] = 0;
  __syncthreads();
  for (int j = tid; j < m; j += THREADS) {
    const int r = col2row[j];
    if (r >= 0) out[r] = j;
  }
  if (steps_out != nullptr && tid == 0) steps_out[p] = total_steps;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). cost (P, n, m) fp32 contiguous with
// n <= m; n_rows (P,) int32 live rows a problem (clamped to [0, n]);
// col4row (P, n) int64 (0 past n_rows); steps (P,) int32 or null: the
// augmenting steps each problem took.
int lsa_solve(const float* cost, const int* n_rows, long long* col4row,
              int* steps, int P, int n, int m, void* stream) {
  if (P <= 0 || n <= 0 || m <= 0 || n > m) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)n * m + 4 * (size_t)n + 17 * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      lsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lsa_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(cost, n_rows,
                                                          col4row, steps, n,
                                                          m);
  return (int)cudaGetLastError();
}

}  // extern "C"
