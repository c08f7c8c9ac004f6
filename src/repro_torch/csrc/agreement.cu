// Agreement reduce: per-member (max, first-index argmax, sum exp(x - max))
// over the vocabulary, for logits (rows = E*B, V) float32.
//
// Replaces: src/repro/kernels/agreement/kernel.py member_stats_pallas
// (body _agree_kernel), which streams V through VMEM in (block_b, block_v)
// tiles along a sequential grid axis and so needs V % block_v == 0.
//
// Bound on the H100: the E*B*V*4 bytes read once (the arithmetic is a few
// operations per element).  Design: one block per row, a strided sweep over
// V with 16-byte loads where the row is 16-byte aligned, an online
// (max, argmax, sumexp) triple per thread, then warp-shuffle and shared
// memory reductions; each thread keeps four 16-byte loads in flight.  No tiling constraint on V: a ragged tail is just the
// end of the sweep.  Argmax ties keep the smallest index, within a thread
// (strict >) and across threads (min index on equal max).
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Stat {
  float m;
  int i;
  float l;
};

__device__ __forceinline__ void push(Stat& s, float x, int idx) {
  if (x > s.m) {
    s.l = (s.m == -INFINITY ? 0.f : s.l * expf(s.m - x)) + 1.f;
    s.m = x;
    s.i = idx;
  } else if (s.m != -INFINITY) {
    s.l += expf(x - s.m);
  }
}

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.m == -INFINITY) return a;
  if (a.m == -INFINITY) return b;
  Stat r;
  r.m = fmaxf(a.m, b.m);
  r.l = a.l * expf(a.m - r.m) + b.l * expf(b.m - r.m);
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

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void member_stats_kernel(const float* __restrict__ x, float* __restrict__ m_out,
                                    int* __restrict__ i_out, float* __restrict__ l_out, int V) {
  const long row = blockIdx.x;
  const float* xr = x + row * (long)V;
  Stat s{-INFINITY, 0x7fffffff, 0.f};
  if ((V & 3) == 0) {  // 16-byte rows: float4 sweep, kUnroll loads in flight
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int n4 = V >> 2;
    int j = threadIdx.x;
    for (; j + (kUnroll - 1) * kThreads < n4; j += kUnroll * kThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = x4[j + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // indices increase: strict > keeps the first
        const int base = (j + u * kThreads) << 2;
        push(s, v[u].x, base);
        push(s, v[u].y, base + 1);
        push(s, v[u].z, base + 2);
        push(s, v[u].w, base + 3);
      }
    }
    for (; j < n4; j += kThreads) {
      const float4 v = x4[j];
      const int base = j << 2;
      push(s, v.x, base);
      push(s, v.y, base + 1);
      push(s, v.z, base + 2);
      push(s, v.w, base + 3);
    }
  } else {
    for (int j = threadIdx.x; j < V; j += kThreads) push(s, xr[j], j);
  }
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl(s, off));
  __shared__ Stat part[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? part[lane] : Stat{-INFINITY, 0x7fffffff, 0.f};
    for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl(s, off));
    if (lane == 0) {
      m_out[row] = s.m;
      i_out[row] = s.i;
      l_out[row] = s.l;
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// logits (rows, V) f32 -> m, l (rows,) f32 and idx (rows,) i32.
extern "C" int agreement_member_stats(const void* logits, void* m, void* idx, void* l, int rows,
                                      int V, void* stream) {
  if (rows > 0)
    member_stats_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)logits, (float*)m, (int*)idx, (float*)l, V);
  return (int)cudaGetLastError();
}
