// Building blocks shared by the flash prefill and the decode attention kernels:
// 16-byte asynchronous global->shared copies (cp.async with zero fill),
// ldmatrix fragment loads, the m16n8k16 bf16 tensor-core product and the
// f32 online softmax of one tile.
//
// Both kernels keep K and V tiles in shared memory as rows of HD bf16 padded
// to HD + 8 elements: a row then starts 16 bytes further along the banks than
// the one before, so the eight 16-byte row addresses of one ldmatrix phase
// fall in distinct banks at every HD the kernels are built at (32, 64, 80,
// 128).  A head size hd below HD (any multiple of 8 up to 128) runs at the
// next of these widths: the copies bring its hd real columns and zero-fill
// the rest, which leaves every dot product exact, and only the real columns
// are stored.
//
// The f32 route of both kernels (attend_f32 below) is plain FFMA on the SIMT
// cores with the same masks and online softmax: f32 inputs are never rounded,
// as a TF32 product would round them.  A head size past 256 in any type
// takes attend_any (below): a block a query row, its keys one at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with valid false nothing is read
// and the destination is zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row l % 8,
// and receives (row l / 4, columns 2 (l % 4) and + 1) of each matrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// four 8x8 b16 matrices, each transposed: lane l receives (rows 2 (l % 4) and + 1, column l / 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two f32 values as a pair of 16-bit elements of type T (bf16 by default,
// or f16), rounded to nearest, lo in the low half
template <class T = bf16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// One f32 value as a T
template <class T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, f16>::value) return __float2half_rn(x);
  else return __float2bfloat16(x);
}

// d += a (16x16, row) * b (16x8, col) with T (bf16 by default, or f16)
// inputs and f32 accumulation; the PTX fragment layouts, lane = 4 g + t:
// a regs (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// b regs (k 2t.., n g), (k 2t+8.., n g); d (g, 2t..), (g+8, 2t..).
template <class T = bf16>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 columns at column c0) of a row-major tile of row stride LD
template <int LD, class T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int c0, int lane) {
  ldsm_x4(a, tile + (lane & 15) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of S = Q K^T for keys [r0, r0 + 16) of a row-major K tile at
// head columns [c0, c0 + 16): b[0], b[1] serve keys r0..r0+7, b[2], b[3] keys r0+8..r0+15
template <int LD, class T>
__device__ __forceinline__ void load_b_keys(uint32_t (&b)[4], const T* tile, int r0, int c0, int lane) {
  ldsm_x4(b, tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of O += P V for keys [r0, r0 + 16) of a row-major V tile at head
// columns [c0, c0 + 16): b[0], b[1] serve columns c0..c0+7, b[2], b[3] c0+8..c0+15
template <int LD, class T>
__device__ __forceinline__ void load_b_values(uint32_t (&b)[4], const T* tile, int r0, int c0, int lane) {
  ldsm_x4_t(b, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// 2^x on the special-function unit; -inf gives +0 and results below 2^-126
// flush to zero (a softmax weight that small is zero in bf16 anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The score transform.  Without a softcap the kernels keep raw scores and
// fold scale * log2(e) into the exponent (one FFMA an element); with one
// (CAP, a template parameter so the main path carries no tanh code) the
// capped logit is already in base-2 units.  p = 2^(x k - m k).
template <bool CAP>
struct ScoreMap {
  float k, cap_l2, inv_cap;
  __device__ __forceinline__ ScoreMap(float scale, float softcap)
      : k(CAP ? 1.f : scale * LOG2E), cap_l2(softcap * LOG2E), inv_cap(scale / softcap) {}
  __device__ __forceinline__ float operator()(float s) const {
    if constexpr (CAP) return cap_l2 * tanhf(s * inv_cap);
    return s;
  }
};

// One tile of the f32 online softmax, in two halves so that a kernel whose
// warps share a row (decode) can merge their maxima in between.  Both act on
// this lane's rows g and g + 8 (rows 0 and 1 below) of a 16-row accumulator
// s: NJ 8-column n-tiles, s[4 j + e] in row e / 2, column 8 j + 2 t + e % 2
// of the tile.
//
// tile_max maps the scores and, with `masked`, sets column c of row r to -inf
// unless 0 <= base[r] + c < width[r] (one unsigned compare: base = first
// column of the lane minus the row's first visible key, width = its visible
// count, > 0); it returns each row's maximum over the tile and the lane's quad.
template <int NJ, bool CAP>
__device__ __forceinline__ void tile_max(float* s, float (&mx)[2], const ScoreMap<CAP>& sm, bool masked,
                                         const int (&base)[2], const int (&width)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sm(s[4 * j + e]);
      if (masked && (unsigned)(base[e >> 1] + 8 * j + (e & 1)) >= (unsigned)width[e >> 1]) x = -INFINITY;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// tile_exp takes the rows' new running maximum m_new (raw-score units), sets
// alpha to the rescale of the old state, m to m_new, leaves p = 2^(x k - m k)
// in s (0 where masked) and returns the lane's partial row sums of p in psum.
template <int NJ, bool CAP>
__device__ __forceinline__ void tile_exp(float* s, float (&m)[2], const float (&m_new)[2], float (&alpha)[2],
                                         float (&psum)[2], const ScoreMap<CAP>& sm) {
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mk[r] = m_new[r] == -INFINITY ? 0.f : m_new[r] * sm.k;  // a row that sees nothing yet keeps p = 0
    alpha[r] = ex2(m[r] * sm.k - mk[r]);                    // 0 while m was -inf (O and l are 0 then)
    m[r] = m_new[r];
    psum[r] = 0.f;
  }
#pragma unroll
  for (int x = 0; x < 4 * NJ; ++x) {
    const int r = (x >> 1) & 1;
    s[x] = ex2(fmaf(s[x], sm.k, -mk[r]));
    psum[r] += s[x];
  }
}

// Both halves for a warp that owns its rows: updates m and l (lane-partial
// sums) and returns the rescale of the old state in alpha.
template <int NJ, bool CAP>
__device__ __forceinline__ void softmax_tile(float* s, float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const ScoreMap<CAP>& sm, bool masked, const int (&base)[2],
                                             const int (&width)[2]) {
  float mx[2], psum[2];
  tile_max<NJ, CAP>(s, mx, sm, masked, base, width);
  const float m_new[2] = {fmaxf(m[0], mx[0]), fmaxf(m[1], mx[1])};
  tile_exp<NJ, CAP>(s, m, m_new, alpha, psum, sm);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

// ---------------------------------------------------------------------------
// The f32 route: one block attends BM query rows (each with its own visible
// key range) over keys [k_lo, k_hi), in BK-key tiles from k_lo rounded down
// to BK, so that two callers with the same rows and keys run the same tiles
// in the same order (the paged decode is bitwise the dense one).
//
// The caller fills, for r < BM, roff[r] (element offset of row r's q and
// output vectors, -1 for no row), rlo[r] and rhi[r] (its visible keys), then
// calls attend_f32 with key(j): the element offset of key j's K and V rows,
// or -1 (the row reads as zeros, as an unmapped page does).  Phases a tile,
// each behind a barrier: the K and V tile into shared memory; the scores
// (thread (r, j), j fastest: a warp reads one q row, by broadcast, against
// 32 K rows of stride HD + 1, in distinct banks); the online softmax (a
// thread a row: running max, rescale, exp and sum, in natural-log units);
// O = O * alpha + P V (thread (r, d), d fastest, BM * HD / NT outputs a
// thread in registers).  A row that sees no key ends with l == 0 and emits
// zeros; with an lse pointer each row also writes its log-sum-exp at
// lse[roff / hd] (-inf where l == 0): q is (..., H, hd) with one lse a head.
template <int HD, int BM, int BK>
struct F32Smem {
  static constexpr int QLD = HD + 1, KLD = HD + 1, SLD = BK + 1;
  static constexpr int floats = BM * QLD + BK * KLD + BK * HD + BM * SLD + 3 * BM;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int HD, int BM, int BK, int NT, bool CAP, class KeyFn>
__device__ __forceinline__ void attend_f32(float* sm, const long* roff, const int* rlo, const int* rhi,
                                           const float* __restrict__ q, const float* __restrict__ kc,
                                           const float* __restrict__ vc, float* __restrict__ o,
                                           float* __restrict__ lse, int hd, int k_lo, int k_hi,
                                           float scale, float softcap, KeyFn key) {
  using S = F32Smem<HD, BM, BK>;
  constexpr int QLD = S::QLD, KLD = S::KLD, SLD = S::SLD, NACC = BM * HD / NT;
  static_assert(BM * HD % NT == 0, "every thread holds NACC outputs");
  float* Qs = sm;
  float* Ks = Qs + BM * QLD;
  float* Vs = Ks + BK * KLD;
  float* Ss = Vs + BK * HD;
  float* m_s = Ss + BM * SLD;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;
  const int tid = threadIdx.x;

  for (int i = tid; i < BM * HD; i += NT) {  // q, scaled as the plain version scales it
    const int r = i / HD, d = i % HD;
    const long off = roff[r];
    Qs[r * QLD + d] = off >= 0 && d < hd ? q[off + d] * scale : 0.f;
  }
  for (int r = tid; r < BM; r += NT) m_s[r] = -INFINITY, l_s[r] = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int k0 = k_lo < k_hi ? k_lo / BK * BK : k_hi; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the last tile's products are done (and, the first time, Qs and the state are set)
    for (int i = tid; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD, kk = k0 + j;
      const long off = kk >= k_lo && kk < k_hi ? key(kk) : -1;
      const bool ok = off >= 0 && d < hd;
      Ks[j * KLD + d] = ok ? kc[off + d] : 0.f;
      Vs[j * HD + d] = ok ? vc[off + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, j = i % BK, kk = k0 + j;
      float x = -INFINITY;
      if (kk >= rlo[r] && kk < rhi[r]) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(Qs[r * QLD + d], Ks[j * KLD + d], dot);
        x = CAP ? softcap * tanhf(dot / softcap) : dot;
      }
      Ss[r * SLD + j] = x;
    }
    __syncthreads();
    for (int r = tid; r < BM; r += NT) {
      const float m_old = m_s[r];
      float mx = m_old;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, Ss[r * SLD + j]);
      const float a = m_old == -INFINITY ? 0.f : expf(m_old - mx);  // O and l are 0 while m is -inf
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float x = Ss[r * SLD + j];
        const float p = x == -INFINITY ? 0.f : expf(x - mx);
        Ss[r * SLD + j] = p;
        sum += p;
      }
      l_s[r] = l_s[r] * a + sum;
      m_s[r] = mx;
      a_s[r] = a;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * NT, r = e / HD, d = e % HD;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) pv = fmaf(Ss[r * SLD + j], Vs[j * HD + d], pv);
      acc[i] = fmaf(acc[i], a_s[r], pv);
    }
  }
  __syncthreads();  // l_s and m_s final (a block with no tile: as set above)
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * NT, r = e / HD, d = e % HD;
    const long off = roff[r];
    if (off >= 0 && d < hd) {
      const float l = l_s[r];
      o[off + d] = l == 0.f ? 0.f : acc[i] / l;
    }
  }
  if (lse)
    for (int r = tid; r < BM; r += NT)
      if (roff[r] >= 0) lse[roff[r] / hd] = l_s[r] == 0.f ? -INFINITY : m_s[r] + logf(l_s[r]);
}

// ---------------------------------------------------------------------------
// Any head size past the built widths (hd > 256), any element type: one
// block of ANY_NT threads a query row (a (position, head) pair of flash, a
// (row, head) pair of decode), its keys one at a time.  Thread t owns
// columns t, t + ANY_NT, ... of q (scaled) and of the f32 output
// accumulator, both in dynamic shared memory (2 hd floats); a key's score
// is the block's sum of the threads' partial dot products (warp shuffles,
// then the warps' sums through shared memory), its weight the f32 online
// softmax's (natural-log units, as attend_f32).  Every element is read as
// it is stored and converted to f32 (load_f32), so the body takes bf16, f16
// and f32 alike and any hd.  key(j) gives key j's element offset in the K
// and V arrays, or -1 (a row of zeros, as an unmapped page reads); rows
// [lo, hi) are visible.  A row with no visible key ends with l == 0 and
// emits zeros; with an lse pointer the row writes its log-sum-exp there
// (-inf where l == 0).  No speed is claimed: it exists so that no head size
// the reference takes is refused.
constexpr int ANY_NT = 128;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f32(const f16* p) { return __half2float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_from_f32(f16* p, float v) { *p = __float2half_rn(v); }

template <class T, bool CAP, class KeyFn>
__device__ __forceinline__ void attend_any(float* sm, const T* __restrict__ qrow, const T* __restrict__ kc,
                                           const T* __restrict__ vc, T* __restrict__ orow, float* __restrict__ lse,
                                           int hd, int lo, int hi, float scale, float softcap, KeyFn key) {
  float* qs = sm;        // hd floats: q * scale
  float* os = sm + hd;   // hd floats: the unnormalised output
  __shared__ float red[ANY_NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < hd; d += ANY_NT) qs[d] = load_f32(qrow + d) * scale, os[d] = 0.f;
  float m = -INFINITY, l = 0.f;  // the same in every thread
  for (int j = lo; j < hi; ++j) {
    const long off = key(j);
    float part = 0.f;
    if (off >= 0)
      for (int d = tid; d < hd; d += ANY_NT) part = fmaf(qs[d], load_f32(kc + off + d), part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    __syncthreads();  // the last key's sums are read (and, the first time, qs and os are set)
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ANY_NT / 32; ++w) s += red[w];
    if (CAP) s = softcap * tanhf(s / softcap);
    const float m_new = fmaxf(m, s), a = m == -INFINITY ? 0.f : expf(m - m_new), p = expf(s - m_new);
    l = l * a + p;
    m = m_new;
    for (int d = tid; d < hd; d += ANY_NT) os[d] = os[d] * a + (off >= 0 ? p * load_f32(vc + off + d) : 0.f);
  }
  const float inv = l == 0.f ? 0.f : 1.f / l;
  for (int d = tid; d < hd; d += ANY_NT) store_from_f32(orow + d, os[d] * inv);
  if (lse && tid == 0) *lse = l == 0.f ? -INFINITY : m + logf(l);
}

}  // namespace attn
