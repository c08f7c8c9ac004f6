// Agreement reduce: per-member (max, first-index argmax, sum exp(x - max))
// over the vocabulary, for logits (rows = E*B, V) float32.
//
// Replaces: src/repro/kernels/agreement/kernel.py member_stats_pallas
// (body _agree_kernel), which streams V through VMEM in (block_b, block_v)
// tiles along a sequential grid axis and so needs V % block_v == 0.
//
// Bound on the H100: the E*B*V*4 bytes read once (a few operations an
// element).  At classify (3, 32, 151936) one block a row would leave 36 of
// the 132 SMs idle, so the design is:
//   - each row is split over a thread-block cluster of 1-8 blocks, as many
//     as make rows x cluster >= 2 x the SMs while each block still sweeps at
//     least two rounds of loads (96 rows: clusters of 4, 384 blocks);
//   - each thread keeps kLoads 16-byte loads in flight, takes the group's max
//     and first argmax first, then rescales its running sum once a group:
//     one exp2 an element and no branch an element;
//   - threads merge by warp shuffles and shared memory, the cluster's blocks
//     through rank 0's shared memory (distributed shared memory) — one
//     launch, no second pass, no atomics.
// A row that does not start on a 16-byte boundary or ends off one (V % 4 !=
// 0) is swept as a masked head and tail around the float4 body.  Ties keep
// the smallest index everywhere: strict > within a thread (its indices
// increase), the smaller index on an equal max in every merge.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;        // float4 loads in flight a thread
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

struct Stat {
  float m;
  int i;
  float l;
};

__device__ __forceinline__ Stat empty_stat() { return Stat{-INFINITY, 0x7fffffff, 0.f}; }

// exp(x - ref) with ref the new max, or 0 while nothing finite was seen
__device__ __forceinline__ float ex(float x, float ref) { return exp2f((x - ref) * kLog2e); }

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  Stat r;
  r.m = fmaxf(a.m, b.m);
  const float ref = r.m == -INFINITY ? 0.f : r.m;
  r.l = a.l * ex(a.m, ref) + b.l * ex(b.m, ref);
  r.i = a.m > b.m ? a.i : (b.m > a.m ? b.i : min(a.i, b.i));
  return r;
}

__device__ __forceinline__ Stat shfl(Stat s, int off) {
  Stat o;
  o.m = __shfl_down_sync(0xffffffffu, s.m, off);
  o.i = __shfl_down_sync(0xffffffffu, s.i, off);
  o.l = __shfl_down_sync(0xffffffffu, s.l, off);
  return o;
}

// one element of the head or tail: merged, order-free
__device__ __forceinline__ Stat single(float x, int idx) { return Stat{x, idx, 1.f}; }

// kLoads float4s of the thread's next group, j0 + u * kThreads; -inf past hi
__device__ __forceinline__ void load_group(float4 (&v)[kLoads], const float4* __restrict__ x4, int j0,
                                           int hi) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = j0 + u * kThreads;
    v[u] = j < hi ? x4[j] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
}

// One group into the running triple: the group's max and first argmax
// first (four chains, one a component, each in increasing index order, then
// merged with the smaller index on ties), then one rescale of the running
// sum and one exp2 an element.  Element k of load u is at e0 + 4 u kThreads + k.
__device__ __forceinline__ void absorb(Stat& s, const float4 (&v)[kLoads], int e0) {
  float gm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int gi[4] = {0x7fffffff, 0x7fffffff, 0x7fffffff, 0x7fffffff};
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int e = e0 + 4 * u * kThreads;
    const float c[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool up = c[k] > gm[k];
      gm[k] = up ? c[k] : gm[k];
      gi[k] = up ? e + k : gi[k];
    }
  }
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const bool up = gm[k] > gm[0] || (gm[k] == gm[0] && gi[k] < gi[0]);
    gm[0] = up ? gm[k] : gm[0];
    gi[0] = up ? gi[k] : gi[0];
  }
  const float mn = fmaxf(s.m, gm[0]);
  const float ref = mn == -INFINITY ? 0.f : mn;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    a[0] += ex(v[u].x, ref);
    a[1] += ex(v[u].y, ref);
    a[2] += ex(v[u].z, ref);
    a[3] += ex(v[u].w, ref);
  }
  s.l = s.l * ex(s.m, ref) + ((a[0] + a[1]) + (a[2] + a[3]));
  s.i = gm[0] > s.m ? gi[0] : s.i;  // later groups hold later indices: strict >
  s.m = mn;
}

__global__ void __launch_bounds__(kThreads)
    member_stats_kernel(const float* __restrict__ x, float* __restrict__ m_out,
                        int* __restrict__ i_out, float* __restrict__ l_out, int V, int C) {
  __shared__ Stat part[kThreads / 32];
  __shared__ Stat inbox[kMaxCluster];  // rank 0's: one triple a block of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  // the first half of a barrier whose wait, before the remote store, shows
  // every block of the cluster (rank 0 above all) has started
  if (C > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const long row = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* xr = x + row * (long)V;
  // the float4 body: [head, head + 4 * n4) of the row
  const int head = (int)(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) >> 2);
  const int n4 = head < V ? (V - head) >> 2 : 0;
  const int tail0 = head + 4 * n4;
  const int per = (n4 + C - 1) / C;
  const int lo = rank * per, hi = min(n4, lo + per);
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  Stat s = empty_stat();
  for (int j0 = lo + t; j0 < hi; j0 += kLoads * kThreads) {
    float4 v[kLoads];
    load_group(v, x4, j0, hi);
    absorb(s, v, head + 4 * j0);
  }
  if (rank == 0 && t < min(head, V)) s = merge(s, single(xr[t], t));
  if (rank == C - 1 && tail0 + t < V) s = merge(s, single(xr[tail0 + t], tail0 + t));
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl(s, off));
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? part[lane] : empty_stat();
    for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl(s, off));
  }
  if (C > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (t == 0) cluster.map_shared_rank(inbox, 0)[rank] = s;
    cluster.sync();  // every block's triple has landed in rank 0's inbox
    if (rank != 0) return;
    if (t == 0) {
      s = inbox[0];
      for (int r = 1; r < C; ++r) s = merge(s, inbox[r]);
    }
  }
  if (t == 0) {
    m_out[row] = s.m;
    i_out[row] = s.i;
    l_out[row] = s.l;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 132;
  }
  return n;
}

// Cluster size: double while the grid is short of two blocks an SM and each
// block would still sweep at least two rounds of kLoads x kThreads float4s.
int plan_cluster(int rows, int V) {
  const long n4 = V / 4;
  int c = 1;
  while (c < kMaxCluster && (long)rows * c < 2L * sm_count() && n4 >= 4L * c * kLoads * kThreads) c *= 2;
  return c;
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// logits (rows, V) f32, rows 4-byte aligned -> m, l (rows,) f32 and idx (rows,) i32.
extern "C" int agreement_member_stats(const void* logits, void* m, void* idx, void* l, int rows,
                                      int V, void* stream) {
  if (rows <= 0 || V <= 0) return (int)cudaGetLastError();
  const int C = plan_cluster(rows, V);
  if ((long)rows * C >= (1L << 31)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * C));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one block a row: a plain launch, no cluster
  const cudaError_t e = cudaLaunchKernelEx(&cfg, member_stats_kernel, (const float*)logits, (float*)m,
                                           (int*)idx, (float*)l, V, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
