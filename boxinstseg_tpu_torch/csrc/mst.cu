// Minimum spanning tree of the 4-connected h x w pixel grid, rooted at
// node 0, one thread block a tree.
//
// The port's counterpart of boxinstseg_tpu/ops/mst.py:501 grid_mst_device
// (plain XLA, not a Pallas kernel): parallel Boruvka (:115) and the
// rooting (:249). Its answer is unique: the edges are ordered totally by
// (weight, edge index), with -0.0 equal to 0.0 and every NaN last, as the
// JAX package's stable argsort orders them, so the tree and each node's
// parent and depth below node 0 admit no choice. Edge e is right edge
// y*(w-1)+x between (y,x) and (y,x+1), or down edge h*(w-1)+y*w+x between
// (y,x) and (y+1,x) (grid_edges). Its 64-bit key holds an order-preserving
// unsigned integer of the fp32 weight in the high 32 bits and e in the
// low 32, so one atomicMin over keys is that order's minimum (no sort).
//
// Shared memory, 14 bytes a node (127 KB at 96 x 96, the heads' tf_size):
//   lbl[n]     int32, each node's component (a node id of the component);
//              after Boruvka, each node's parent in the BFS;
//   least[n]   uint64, a component's least live key, then its partner;
//              after Boruvka, the BFS's two frontier queues (int32);
//   right[n], down[n]  uint8, the node's right / down edge is in the tree.
// Boruvka rounds, at most ceil(log2 n), until no edge joins two components:
//   1. every edge whose ends carry two labels atomicMins its key into both
//      components' slots; __syncthreads_or tells whether any edge was live;
//   2. each component marks its least edge chosen and writes the label
//      across it (its partner) into its slot;
//   3. each component points to its partner, but of a mutual pair (the
//      only cycles a total order allows) the smaller label points to itself;
//   4. pointer jumping over every node until no label moves.
// Rooting: a level-synchronous BFS from node 0 over the chosen edges, one
// barrier a level (a tree's height: a few hundred levels at 96 x 96 on
// the heads' guides), stopped after max_depth levels; nodes never reached
// stay their own parents at depth 0. An Euler tour would take O(log n)
// rounds but needs 4n arcs of scratch, more than a block's shared memory
// at 96 x 96. Bound: bytes (the weights read once, parent and depth
// written once) on paper; in practice the chain of dependent rounds and
// levels, each a barrier, as the LSA kernel's steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_LOOP = 64;     // rounds and jumps; ceil(log2 n) <= 15 here
constexpr unsigned long long NO_KEY = ~0ull;

__device__ __forceinline__ unsigned long long edge_key(float wt, int e) {
  unsigned int bits = __float_as_uint(wt == 0.f ? 0.f : wt);
  if (wt != wt) {
    bits = 0xFFFFFFFFu;                    // every NaN above +inf
  } else {
    bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  }
  return (static_cast<unsigned long long>(bits) << 32) |
         static_cast<unsigned int>(e);
}

__global__ void __launch_bounds__(THREADS)
grid_mst_kernel(const float* __restrict__ w_right,
                const float* __restrict__ w_down,
                long long* __restrict__ parent_out,
                long long* __restrict__ depth_out, int* __restrict__ stats,
                int h, int w, int max_depth) {
  extern __shared__ unsigned long long smem_u64[];
  const int n = h * w;
  const int n_right = h * (w - 1);
  const int n_edges = n_right + (h - 1) * w;
  unsigned long long* least = smem_u64;                    // n
  int* lbl = reinterpret_cast<int*>(least + n);            // n
  uint8_t* right = reinterpret_cast<uint8_t*>(lbl + n);    // n
  uint8_t* down = right + n;                               // n
  __shared__ int s_count[3];

  const int tid = threadIdx.x;
  const int tree = blockIdx.x;
  const float* wr = w_right + (size_t)tree * n_right;
  const float* wd = w_down + (size_t)tree * (h - 1) * w;
  long long* par_g = parent_out + (size_t)tree * n;
  long long* dep_g = depth_out + (size_t)tree * n;

  for (int v = tid; v < n; v += THREADS) {
    lbl[v] = v;
    right[v] = 0;
    down[v] = 0;
  }

  int rounds = 0;
  for (; rounds < MAX_LOOP; ++rounds) {
    for (int v = tid; v < n; v += THREADS) least[v] = NO_KEY;
    __syncthreads();
    // 1. each live edge's key into both of its components' slots
    int live = 0;
    for (int e = tid; e < n_edges; e += THREADS) {
      int a, b;
      float wt;
      if (e < n_right) {
        const int y = e / (w - 1), x = e - y * (w - 1);
        a = lbl[y * w + x];
        b = lbl[y * w + x + 1];
        wt = wr[e];
      } else {
        const int v = e - n_right;
        a = lbl[v];
        b = lbl[v + w];
        wt = wd[v];
      }
      if (a != b) {
        const unsigned long long k = edge_key(wt, e);
        atomicMin(&least[a], k);
        atomicMin(&least[b], k);
        live = 1;
      }
    }
    if (!__syncthreads_or(live)) break;
    // 2. each component's least edge joins the tree; its slot takes the
    // label across it (its own label when it has none)
    for (int c = tid; c < n; c += THREADS) {
      const unsigned long long k = least[c];
      if (k == NO_KEY) {
        least[c] = static_cast<unsigned long long>(c);
        continue;
      }
      const int e = static_cast<int>(k & 0xFFFFFFFFull);
      int u, v;
      if (e < n_right) {
        const int y = e / (w - 1);
        u = e + y;                         // y * w + x
        v = u + 1;
        right[u] = 1;
      } else {
        u = e - n_right;
        v = u + w;
        down[u] = 1;
      }
      least[c] = static_cast<unsigned long long>(lbl[u] + lbl[v] - c);
    }
    __syncthreads();
    // 3. hook each component to its partner; a mutual pair's smaller label
    // stays a root
    for (int c = tid; c < n; c += THREADS) {
      const int p = static_cast<int>(least[c]);
      if (p == c) continue;
      const int pp = static_cast<int>(least[p]);
      lbl[c] = (pp == c && c < p) ? c : p;
    }
    __syncthreads();
    // 4. pointer jumping over every node until no label moves
    for (int jump = 0; jump < MAX_LOOP; ++jump) {
      int moved = 0;
      for (int v = tid; v < n; v += THREADS) {
        const int p = lbl[v];
        const int pp = lbl[p];
        if (pp != p) {
          lbl[v] = pp;
          moved = 1;
        }
      }
      if (!__syncthreads_or(moved)) break;
    }
  }

  // rooting: BFS from node 0; lbl becomes the parent, least the queues
  int* parent = lbl;
  int* queue = reinterpret_cast<int*>(least);              // 2 x n
  for (int v = tid; v < n; v += THREADS) {
    parent[v] = v;
    par_g[v] = v;
    dep_g[v] = 0;
  }
  if (tid == 0) {
    queue[0] = 0;
    s_count[0] = 1;
    s_count[1] = 0;
    s_count[2] = 0;
  }
  __syncthreads();
  int levels = 0;
  for (int d = 1; d <= max_depth; ++d) {
    // level d reads count[(d-1)%3], appends to count[d%3] and clears
    // count[(d+1)%3], which level d-1 read before its barrier
    const int* cur = queue + ((d - 1) & 1) * n;
    int* next = queue + (d & 1) * n;
    const int n_cur = s_count[(d - 1) % 3];
    if (tid == 0) s_count[(d + 1) % 3] = 0;
    for (int i = tid; i < n_cur; i += THREADS) {
      const int u = cur[i];
      const int pu = parent[u];
      const int y = u / w, x = u - y * w;
      int nb[4];
      int k = 0;
      if (x > 0 && right[u - 1]) nb[k++] = u - 1;
      if (right[u]) nb[k++] = u + 1;
      if (y > 0 && down[u - w]) nb[k++] = u - w;
      if (down[u]) nb[k++] = u + w;
      for (int j = 0; j < k; ++j) {
        const int v = nb[j];
        if (v == pu) continue;
        parent[v] = u;
        par_g[v] = u;
        dep_g[v] = d;
        next[atomicAdd(&s_count[d % 3], 1)] = v;
      }
    }
    __syncthreads();
    if (s_count[d % 3] == 0) break;
    levels = d;
  }
  if (stats != nullptr && tid == 0) {
    stats[2 * tree] = rounds;
    stats[2 * tree + 1] = levels;
  }
}

}  // namespace

extern "C" int grid_mst(const float* w_right, const float* w_down,
                        long long* parent, long long* depth, int* stats,
                        int b, int h, int w, int max_depth,
                        cudaStream_t stream) {
  const size_t smem = (size_t)14 * h * w;
  cudaError_t err = cudaFuncSetAttribute(
      grid_mst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_mst_kernel<<<b, THREADS, smem, stream>>>(w_right, w_down, parent,
                                                depth, stats, h, w,
                                                max_depth);
  return static_cast<int>(cudaGetLastError());
}
