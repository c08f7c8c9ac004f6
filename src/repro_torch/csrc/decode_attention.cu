// Decode attention: one query token per row against a bf16 KV cache, dense or
// block-paged.  Two entry points share one kernel body:
//
//   decode_attention_fwd        q (B, KVH, G, hd), caches (B, KVH, S, hd),
//                               cur_len (B,) i32 or a scalar, optional starts (B,)
//   decode_attention_paged_fwd  q (E*B, KVH, G, hd), one layer's pool slab
//                               (E, P, KVH, ps, hd), ONE page table (B, n_pg) i32
//                               (-1 = unmapped) shared by the E member planes,
//                               cur_len (B,) i32; no starts
//
// Window and tanh softcap optional on both; hd in {64, 128}, G in {1, 2, 4, 8, 16};
// the dense entry also takes hd 80 with G = 1 (zamba2's shared attention:
// 32 heads of 80, as many KV heads).  The paged entry stays at hd {64, 128}:
// the only hd-80 family (hybrid) keeps dense slot caches.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
// decode_attention_bkgd (dense, body _decode_kernel), which needs
// S % min(512, S) == 0, and decode_attention_paged_bkgd (paged: the same body
// with block_k = page_size, pages fetched through the scalar-prefetched
// table), which needs page_size % 8 == 0 (a TPU sublane rule; here any
// page_size that divides max_seq will do).
//
// Bound on the H100: bytes — the visible K and V rows are read once and
// each cache element feeds only G multiply-adds; for the paged kernel these
// are the visible rows of the mapped pages.  Design: one block of 128
// threads per (row, kv-head) handles all G query heads, so each cache row is
// read once for the whole group.  The block sweeps 64-row cache tiles from
// the first visible row (max of starts, cur_len - window) up to cur_len:
// tiles outside that range are never read, and rows past cur_len load as
// zeros.  Each tile goes through shared memory (rows padded to an odd
// number of 4-byte words, so column reads are conflict-free); a thread
// scores one row for its share of the heads, one warp per head runs the
// f32 online softmax, and each thread accumulates a fixed slice of the
// (G, hd) output in registers.  A row with no visible column emits zeros.
//
// Paged: the only change is where a tile row comes from.  Row t of slot b
// lives at offset t % ps of page table[b, t / ps] in member plane r / B
// (row r of q); the tiles, their order and every reduction are the dense
// kernel's, so for a given gathered view (unmapped pages as zero rows) the
// paged output is bitwise the dense kernel's on that view.  No gathered copy
// is made, and the (B, n_pg) table serves all E planes.  An unmapped (-1)
// or out-of-range entry reads as zero rows — never an out-of-bounds load;
// the JAX kernel clamps such an entry to page 0 instead, which differs only
// on inactive slots whose output the server discards.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DT = 128, DBK = 64;

// Page-table geometry of the paged entry point (unused by the dense one).
struct Paged {
  const int* pages;  // (B, n_pg)
  int B, P, n_pg, ps;
};

template <int HD, int G, bool PAGED>
__global__ void __launch_bounds__(DT)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out,
                  const int* __restrict__ cur_len, int cur_scalar, const int* __restrict__ starts,
                  Paged pg, int KVH, int S, int window, float softcap, float scale) {
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
  // paged: row b of q is slot b % B of member plane b / B
  const int slot = PAGED ? b % pg.B : b;
  const int cur = min(cur_len ? cur_len[slot] : cur_scalar, S);
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

  const long base = PAGED ? (long)(b / pg.B) * pg.P * KVH * pg.ps * HD : row0 * (long)S * HD;
  const bf16* kb = kc + base;
  const bf16* vb = vc + base;
  const int* table = PAGED ? pg.pages + (long)slot * pg.n_pg : nullptr;
  for (int k0 = (lo / DBK) * DBK; k0 < cur; k0 += DBK) {
    __syncthreads();  // previous tile consumed (and q / m / l initialised)
    constexpr int W = HD / 2;  // 4-byte words per row
    for (int c = tid; c < DBK * W; c += DT) {
      const int r = c / W, w = c % W;
      const int t = k0 + r;
      unsigned kw = 0u, vw = 0u;
      long off = -1;  // element offset of cache row t, -1 = reads as zeros
      if (t < cur) {
        if (PAGED) {
          const int page = table[t / pg.ps];
          if (page >= 0 && page < pg.P) off = (((long)page * KVH + kvh) * pg.ps + t % pg.ps) * HD;
        } else {
          off = (long)t * HD;
        }
      }
      if (off >= 0) {
        kw = reinterpret_cast<const unsigned*>(kb + off)[w];
        vw = reinterpret_cast<const unsigned*>(vb + off)[w];
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

template <int HD, int G, bool PAGED>
int launch(const void* q, const void* k, const void* v, void* o, const void* cur, int cur_scalar,
           const void* st, Paged pg, int rows, int KVH, int S, int window, float softcap, float scale,
           cudaStream_t stream) {
  decode_kernel<HD, G, PAGED><<<dim3(KVH, rows), DT, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const int*)cur, cur_scalar,
      (const int*)st, pg, KVH, S, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool PAGED>
int dispatch_g(int G, const void* q, const void* k, const void* v, void* o, const void* cur,
               int cur_scalar, const void* st, Paged pg, int rows, int KVH, int S, int window,
               float softcap, float scale, cudaStream_t s) {
#define DA_CASE(g) \
  case g: return launch<HD, g, PAGED>(q, k, v, o, cur, cur_scalar, st, pg, rows, KVH, S, window, softcap, scale, s);
  switch (G) {
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(4)
    DA_CASE(8)
    DA_CASE(16)
  }
#undef DA_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool PAGED>
int dispatch(int hd, int G, const void* q, const void* k, const void* v, void* o, const void* cur,
             int cur_scalar, const void* st, Paged pg, int rows, int KVH, int S, int window,
             float softcap, float scale, cudaStream_t s) {
  if (rows == 0) return (int)cudaGetLastError();
  if (hd == 128)
    return dispatch_g<128, PAGED>(G, q, k, v, o, cur, cur_scalar, st, pg, rows, KVH, S, window, softcap, scale, s);
  if (hd == 64)
    return dispatch_g<64, PAGED>(G, q, k, v, o, cur, cur_scalar, st, pg, rows, KVH, S, window, softcap, scale, s);
  if constexpr (!PAGED) {
    if (hd == 80 && G == 1)
      return launch<80, 1, false>(q, k, v, o, cur, cur_scalar, st, pg, rows, KVH, S, window, softcap, scale, s);
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
  return dispatch<false>(hd, G, q, k, v, o, cur_len, cur_scalar, starts, Paged{nullptr, B, 0, 0, 1},
                         B, KVH, S, window, softcap, scale, (cudaStream_t)stream);
}

// q (E*B, KVH, G, hd); k_pool, v_pool (E, P, KVH, ps, hd); cur_len (B,); pages (B, n_pg).
extern "C" int decode_attention_paged_fwd(const void* q, const void* k_pool, const void* v_pool,
                                          void* o, const void* cur_len, const void* pages, int E,
                                          int B, int P, int KVH, int G, int ps, int n_pg, int hd,
                                          int window, float softcap, float scale, void* stream) {
  return dispatch<true>(hd, G, q, k_pool, v_pool, o, cur_len, 0, nullptr, Paged{(const int*)pages, B, P, n_pg, ps},
                        E * B, KVH, n_pg * ps, window, softcap, scale, (cudaStream_t)stream);
}
