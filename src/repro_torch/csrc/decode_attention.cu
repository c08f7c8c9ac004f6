// Decode attention: one query token per row against a dense bf16 KV cache.
// q (B, KVH, G, hd), caches (B, KVH, S, hd), cur_len (B,) i32 or a scalar, optional
// starts (B,) i32; window and tanh softcap optional; hd in {64, 128}.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
// decode_attention_bkgd (body _decode_kernel), which needs
// S % min(512, S) == 0.
//
// Bound on the H100: bytes — the visible K and V rows are read once and
// each cache element feeds only G multiply-adds.  Design: one block of 128
// threads per (b, kv-head) handles all G query heads, so each cache row is
// read once for the whole group.  The block sweeps 64-row cache tiles from
// the first visible row (max of starts, cur_len - window) up to cur_len:
// tiles outside that range are never read, and rows past cur_len load as
// zeros.  Each tile goes through shared memory (rows padded to an odd
// number of 4-byte words, so column reads are conflict-free); a thread
// scores one row for its share of the heads, one warp per head runs the
// f32 online softmax, and each thread accumulates a fixed slice of the
// (G, hd) output in registers.  A row with no visible column emits zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DT = 128, DBK = 64;

template <int HD, int G>
__global__ void __launch_bounds__(DT)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out,
                  const int* __restrict__ cur_len, int cur_scalar, const int* __restrict__ starts,
                  int KVH, int S, int window, float softcap, float scale) {
  constexpr int LK = HD + 2;               // bf16 row stride: HD/2 + 1 words (odd)
  constexpr int NO = (G * HD + DT - 1) / DT;  // outputs per thread
  constexpr int HSTEP = DT / DBK;          // heads interleave for the scoring phase
  __shared__ float qs[G][HD];
  __shared__ __align__(16) bf16 Ks[DBK * LK];
  __shared__ __align__(16) bf16 Vs[DBK * LK];
  __shared__ float Ps[G][DBK];
  __shared__ float alpha_s[G], m_s[G], l_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long row0 = ((long)b * KVH + kvh);
  const int cur = min(cur_len ? cur_len[b] : cur_scalar, S);
  int lo = starts ? max(starts[b], 0) : 0;
  if (window > 0) lo = max(lo, cur - window);

  for (int i = tid; i < G * HD; i += DT)
    qs[i / HD][i % HD] = __bfloat162float(q[row0 * G * HD + i]) * scale;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  const bf16* kb = kc + row0 * (long)S * HD;
  const bf16* vb = vc + row0 * (long)S * HD;
  for (int k0 = (lo / DBK) * DBK; k0 < cur; k0 += DBK) {
    __syncthreads();  // previous tile consumed (and q / m / l initialised)
    constexpr int W = HD / 2;  // 4-byte words per row
    for (int c = tid; c < DBK * W; c += DT) {
      const int r = c / W, w = c % W;
      unsigned kw = 0u, vw = 0u;
      if (k0 + r < cur) {
        kw = reinterpret_cast<const unsigned*>(kb + (long)(k0 + r) * HD)[w];
        vw = reinterpret_cast<const unsigned*>(vb + (long)(k0 + r) * HD)[w];
      }
      reinterpret_cast<unsigned*>(Ks + r * LK)[w] = kw;
      reinterpret_cast<unsigned*>(Vs + r * LK)[w] = vw;
    }
    __syncthreads();

    // scores: thread -> one cache row, heads g = tid / DBK (+ HSTEP ...)
    {
      const int j = tid % DBK, col = k0 + j;
      const bool valid = col >= lo && col < cur;
      for (int g = tid / DBK; g < G; g += HSTEP) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 2) {
          const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Ks + j * LK + d));
          s += qs[g][d] * kk.x + qs[g][d + 1] * kk.y;
        }
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        Ps[g][j] = valid ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += DT / 32) {
      float sv[DBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < DBK / 32; ++u) {
        sv[u] = Ps[g][lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = m_new == -INFINITY ? 1.f : (m_old == -INFINITY ? 0.f : expf(m_old - m_new));
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < DBK / 32; ++u) {
        const float p = sv[u] == -INFINITY ? 0.f : expf(sv[u] - m_new);
        Ps[g][lane + 32 * u] = p;
        psum += p;
      }
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        alpha_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int oi = tid + DT * i;
      if (oi < G * HD) {
        const int g = oi / HD, d = oi % HD;
        float a = acc[i] * alpha_s[g];
        for (int j = 0; j < DBK; ++j) a += Ps[g][j] * __bfloat162float(Vs[j * LK + d]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int oi = tid + DT * i;
    if (oi < G * HD) {
      const float l = l_s[oi / HD];
      out[row0 * G * HD + oi] = __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int HD, int G>
int launch(const void* q, const void* k, const void* v, void* o, const void* cur, int cur_scalar,
           const void* st, int B, int KVH, int S, int window, float softcap, float scale,
           cudaStream_t stream) {
  decode_kernel<HD, G><<<dim3(KVH, B), DT, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const int*)cur, cur_scalar,
      (const int*)st, KVH, S, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_g(int G, const void* q, const void* k, const void* v, void* o, const void* cur,
               int cur_scalar, const void* st, int B, int KVH, int S, int window, float softcap, float scale,
               cudaStream_t s) {
  switch (G) {
    case 1: return launch<HD, 1>(q, k, v, o, cur, cur_scalar, st, B, KVH, S, window, softcap, scale, s);
    case 2: return launch<HD, 2>(q, k, v, o, cur, cur_scalar, st, B, KVH, S, window, softcap, scale, s);
    case 4: return launch<HD, 4>(q, k, v, o, cur, cur_scalar, st, B, KVH, S, window, softcap, scale, s);
    case 8: return launch<HD, 8>(q, k, v, o, cur, cur_scalar, st, B, KVH, S, window, softcap, scale, s);
    case 16: return launch<HD, 16>(q, k, v, o, cur, cur_scalar, st, B, KVH, S, window, softcap, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// window <= 0: no window; softcap <= 0: no softcap; starts may be null;
// cur_len null means every row has cur_scalar valid cache rows.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* cur_len, int cur_scalar, const void* starts,
                                    int B, int KVH,
                                    int G, int S, int hd, int window, float softcap, float scale,
                                    void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 128)
    return dispatch_g<128>(G, q, k, v, o, cur_len, cur_scalar, starts, B, KVH, S, window, softcap, scale, s);
  if (hd == 64)
    return dispatch_g<64>(G, q, k, v, o, cur_len, cur_scalar, starts, B, KVH, S, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
