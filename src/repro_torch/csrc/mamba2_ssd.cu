// Mamba2 SSD (state-space dual) scan.  Reads what the Mamba2 block hands
// over, with the strides it has: x (B, S, H, P) and B, C (B, S, G, N), all
// bf16 or all f32 (head h reads group h / (H / G)), dt (B, S, H) f32, the
// decay A (E, H) f32 (row b reads member b / rows_per_member) and an
// optional initial state h0 (B, H, N, P) f32.  Writes y (B, S, H, P) in x's type and
// the final state hT (B, H, N, P) f32.  The prescale is fused: each kernel
// forms x~ = dt x and l = A dt itself, so one call is one device launch.
//
//   h_t = exp(l_t) h_{t-1} + B_t x~_t^T,   y_t = C_t^T h_t
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py ssd_pallas (body
// _ssd_kernel), which needs S % chunk == 0 and computes each 128-step chunk
// in the dual form on the MXU: (C B^T * exp(cum_t - cum_s)) x~, plus
// C exp(cum) h, and h exp(total) + (B exp(total - cum))^T x~.
//
// The routes, chosen by the inputs' type and shape (none falls back to another):
//
// bf16 x (the main path): the chunked dual form on the tensor cores
// (ssd_dual_kernel).  Bound on the H100: the bytes (x, B, C, dt in, y out,
// the states; the form's operations take about half the bytes' time at
// TF32's peak).  One block of 4 warps per (row, head) walks chunks of L = 64
// steps; the (N, P) state stays in f32 registers across chunks (each warp
// owns a 16-row slice as mma accumulators) and a TF32-rounded copy in shared
// memory feeds C h.  Per chunk, on mma.sync m16n8k8 TF32 with f32
// accumulation: warp w owns output rows 16w..16w+15 and computes
// Y = exp(cum) * (C h), then for each 8-wide s-tile at or below its rows
// G = C B^T (8 mma), the decayed causal tile M = G * exp(cum_t - cum_s) dt_s
// in registers, and Y += M x (8 mma); the state h <- exp(total) h +
// (B exp(total - cum) dt)^T x.  The prescale is folded into M and into the
// decayed B, so x, B and C feed the tensor cores as they arrive: bf16 is
// exact in TF32, and only M and the decayed B round (once, 2^-11 relative).
// M leaves the accumulators straight into the next product's A fragments:
// the k index inside each 8-step is permuted (slot q holds step 2q, slot
// q+4 step 2q+1), which matches the accumulator layout; with rows padded to
// 4 or 8 (mod 32) words every fragment read from shared memory is free of
// bank conflicts.  Cumulative sums are chunk-local, so every exponent is
// <= 0.  Chunks arrive by cp.async into a two-stage ring (chunk c + 2 lands
// while c + 1 computes; three blocks fit an SM), rows past S zero-filled in
// shared memory, never padded in device memory.  Rows of x, B and C must
// sit on 16-byte boundaries (the wrapper checks).  P a multiple of 32 (a
// block takes 64 or 32 of its columns), N in {16, 32, 64, 128} (128: the
// published Mamba2 checkpoints' d_state).
//
// f32 x: the per-step recurrence on the CUDA cores (ssd_step_kernel), the
// exact f32 route (every exponent one l_t <= 0, no TF32 rounding).  One
// block of P threads per (row, head): thread p owns column p of the state.
// P <= 128, N in {8, 16, 32, 64}.
//
// Every other shape, bf16 or f32: the same per-step recurrence with P and N
// read at run time (ssd_scan_kernel), the state in shared memory or, where
// N * 128 floats do not fit, in hT itself.  No (P, N) is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

struct Dims {
  int S, H, P, G, rows_per_member;
  long xb, xs, xh;  // x strides (elements) over row, step, head; p is contiguous
  long bb, bs, bg;  // B and C strides over row, step, group; n is contiguous
};

// ---------------------------------------------------------------------------
// f32 route: the per-step recurrence
// ---------------------------------------------------------------------------

constexpr int CH = 32, PMAX = 128;

template <int N>
__global__ void __launch_bounds__(PMAX)
    ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hT, Dims d) {
  __shared__ float xs[CH][PMAX];
  __shared__ float bs[CH][N], cs[CH][N], as[CH];
  const int h = blockIdx.x, b = blockIdx.y, p = threadIdx.x, S = d.S, H = d.H, P = d.P;
  const int g = h / (H / d.G);
  const float a_h = A[(long)(b / d.rows_per_member) * H + h];
  const long hbase = ((long)b * H + h) * N * P + p;
  const float* xrow = x + b * d.xb + h * d.xh + p;
  const float* dtrow = dt + (long)b * S * H + h;

  float hs[N];
#pragma unroll
  for (int n = 0; n < N; ++n) hs[n] = h0 ? h0[hbase + (long)n * P] : 0.f;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int m = min(CH, S - t0);
    __syncthreads();  // the previous pass is consumed
    for (int c = p; c < m * N; c += P) {
      const int tt = c / N, n = c % N;
      const long off = b * d.bb + (t0 + tt) * d.bs + g * d.bg + n;
      bs[tt][n] = Bm[off];
      cs[tt][n] = Cm[off];
    }
    for (int tt = p; tt < m; tt += P) as[tt] = expf(a_h * dtrow[(long)(t0 + tt) * H]);
    for (int tt = 0; tt < m; ++tt) xs[tt][p] = xrow[(t0 + tt) * d.xs] * dtrow[(long)(t0 + tt) * H];
    __syncthreads();
    for (int tt = 0; tt < m; ++tt) {
      const float a = as[tt], xv = xs[tt][p];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hs[n] = hs[n] * a + bs[tt][n] * xv;
        acc += cs[tt][n] * hs[n];
      }
      y[(((long)b * S + t0 + tt) * H + h) * P + p] = acc;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hT[hbase + (long)n * P] = hs[n];
}

// ---------------------------------------------------------------------------
// every other shape: the per-step recurrence with run-time P and N
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// One block of pb threads per (row, head, block of pb columns): thread p owns
// column p0 + p of the (N, P) state.  The state lives in dynamic shared
// memory (column-interleaved: thread p reads words p, p + pb, ..., free of
// bank conflicts) when N * pb floats fit, else in hT itself (the f32 output,
// updated in place); B_t and C_t are read straight from device memory, every
// lane the same address (one broadcast load, kept in L1).  The arithmetic is
// the f32 route's: h <- h e^(A dt_t) + B_t (dt_t x_t), y_t = C_t^T h.
template <class T>
__global__ void __launch_bounds__(PMAX)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ hT, Dims d, int N, int smem_state) {
  extern __shared__ float hsm[];
  const int h = blockIdx.x, b = blockIdx.y, pb = blockDim.x, p = blockIdx.z * pb + threadIdx.x;
  const int S = d.S, H = d.H, P = d.P;
  if (p >= P) return;  // no barrier below: a thread past P has nothing to do
  const int g = h / (H / d.G);
  const float a_h = A[(long)(b / d.rows_per_member) * H + h];
  const long hbase = ((long)b * H + h) * N * P + p;
  float* hs = smem_state ? hsm + threadIdx.x : hT + hbase;  // row n at hs[n * hstride]
  const long hstride = smem_state ? pb : P;
  for (int n = 0; n < N; ++n) hs[n * hstride] = h0 ? h0[hbase + (long)n * P] : 0.f;
  const T* xrow = x + b * d.xb + h * d.xh + p;
  const T* brow = Bm + b * d.bb + g * d.bg;
  const T* crow = Cm + b * d.bb + g * d.bg;
  const float* dtrow = dt + (long)b * S * H + h;
  for (int t = 0; t < S; ++t) {
    const float dtv = dtrow[(long)t * H], a = expf(a_h * dtv), xv = to_f32(xrow[t * d.xs]) * dtv;
    const T* bt = brow + t * d.bs;
    const T* ct = crow + t * d.bs;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      const float v = hs[n * hstride] * a + to_f32(bt[n]) * xv;
      hs[n * hstride] = v;
      acc += to_f32(ct[n]) * v;
    }
    store(y + (((long)b * S + t) * H + h) * P + p, acc);
  }
  if (smem_state)
    for (int n = 0; n < N; ++n) hT[hbase + (long)n * P] = hs[n * hstride];
}

// ---------------------------------------------------------------------------
// bf16 route: the chunked dual form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int L = 64, NW = 4, NTH = NW * 32;  // chunk length, warps a block

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float tf32f(float v) { return __uint_as_float(tf32(v)); }

// D += A B: A 16x8 (row), B 8x8 (col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (4) bytes into shared memory; with ok false the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

// an element of a raw stage as a TF32 operand: bf16 is exact in TF32
__device__ __forceinline__ uint32_t frag(bf16 v) { return (uint32_t)__bfloat16_as_ushort(v) << 16; }

template <int PB, int N>
struct DualSmem {
  // row strides: raw x and B, C padded by 16 bytes, the state by 8 words, so
  // every fragment read below is free of bank conflicts
  static constexpr int XR = PB + 8, BR = N + 8, HS = PB + 8;
  struct Stage {
    bf16 x[L * XR];
    bf16 b[L * BR], c[L * BR];
    float dt[L];
  } st[2];            // chunk c lives in st[c % 2]; chunk c + 2 lands there while c + 1 computes
  float hs[N * HS];   // the state entering this chunk, TF32
  float cum[L];       // chunk-local inclusive cumsum of l = A dt (<= 0)
  float ecum[L];      // exp(cum_t)
  float wdt[L];       // exp(total - cum_s) dt_s
  float etot;         // exp(total)
};

// A block owns PB columns of x, y and the state, p0 = blockIdx.z * PB on:
// the columns are independent (h[:, p] reads only x[:, p]), so a P of
// several PB runs as P / PB blocks, each forming C B^T and the decays again.
// N 128 holds 64 state accumulators and 64 C fragments a thread at PB 64:
// one block an SM.
template <int PB, int N>
__global__ void __launch_bounds__(NTH, N == 128 ? 1 : 3)
    ssd_dual_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ h0,
                    bf16* __restrict__ y, float* __restrict__ hT, Dims d) {
  using Sm = DualSmem<PB, N>;
  constexpr int XR = Sm::XR, BR = Sm::BR, HS = Sm::HS;
  constexpr int PT = PB / 8;         // 8-wide column tiles of y and h
  constexpr int NK = N / 8;          // 8-deep k-steps over the state dim
  constexpr int TPW = (N / 16) * PT / NW;  // h tiles a warp owns
  // a warp owns part of one 16-row block of the state (TPW <= PT), or RB
  // whole blocks (N 128: two): tile j is column tile j % TC of its block j / TC
  constexpr int RB = TPW > PT ? TPW / PT : 1, TC = TPW > PT ? PT : TPW;
  static_assert(TPW >= 1 && (N / 16) * PT % NW == 0 && (TPW <= PT ? PT % TPW == 0 : TPW % PT == 0),
                "unsupported PB, N");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int h = blockIdx.x, b = blockIdx.y, S = d.S, H = d.H, P = d.P, p0 = blockIdx.z * PB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int grp = h / (H / d.G);
  const float a_h = A[(long)(b / d.rows_per_member) * H + h];
  const bf16* xrow = x + b * d.xb + h * d.xh + p0;
  const bf16* brow = Bm + b * d.bb + grp * d.bg;
  const bf16* crow = Cm + b * d.bb + grp * d.bg;
  const float* dtrow = dt + (long)b * S * H + h;
  const long hbase = ((long)b * H + h) * N * P + p0;  // this block's column 0 of the state
  // this warp's slice of the state: row blocks hm.., hm + RB - 1 (rows
  // 16 hm ..), column tiles hn0 .. hn0 + TC - 1 of each
  const int hm = warp * TPW / PT, hn0 = TPW > PT ? 0 : warp * TPW % PT;
  const int n_lo = hm * 16 + gr, n_hi = n_lo + 8;  // rows of tile j: + 16 (j / TC)
  // this warp's 16 output rows of a chunk
  const int r0 = warp * 16, t_lo = r0 + gr, t_hi = t_lo + 8;

  // chunk c into st[c % 2]: all L rows, those past S zero-filled (zero x, B,
  // C and dt leave the state and the valid outputs untouched)
  auto stage = [&](int c) {
    typename Sm::Stage& sg = sm.st[c & 1];
    const int t0 = c * L, m = min(L, S - t0);
    constexpr int XV = PB / 8, BV = N / 8;  // 16-byte pieces a row
    for (int i = tid; i < L * XV; i += NTH) {
      const int t = i / XV, v = i % XV;
      cp_async16(sg.x + t * XR + v * 8, xrow + (t0 + (t < m ? t : 0)) * d.xs + v * 8, t < m);
    }
    for (int i = tid; i < L * BV; i += NTH) {
      const int t = i / BV, v = i % BV;
      const long off = (t0 + (t < m ? t : 0)) * d.bs + v * 8;
      cp_async16(sg.b + t * BR + v * 8, brow + off, t < m);
      cp_async16(sg.c + t * BR + v * 8, crow + off, t < m);
    }
    for (int t = tid; t < L; t += NTH) cp_async4(sg.dt + t, dtrow + (long)(t0 + (t < m ? t : 0)) * H, t < m);
    cp_commit();
  };
  auto store_h = [&](float(&hacc)[TPW][4]) {
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int p = (hn0 + j % TC) * 8 + 2 * tq, r = 16 * (j / TC);
      *reinterpret_cast<float2*>(&sm.hs[(n_lo + r) * HS + p]) = make_float2(tf32f(hacc[j][0]), tf32f(hacc[j][1]));
      *reinterpret_cast<float2*>(&sm.hs[(n_hi + r) * HS + p]) = make_float2(tf32f(hacc[j][2]), tf32f(hacc[j][3]));
    }
  };

  const int nch = (S + L - 1) / L;
  if (nch > 0) stage(0);
  if (nch > 1) stage(1);
  float hacc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int p = (hn0 + j % TC) * 8 + 2 * tq, r = 16 * (j / TC);
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (h0) {
      lo = *reinterpret_cast<const float2*>(h0 + hbase + (long)(n_lo + r) * P + p);
      hi = *reinterpret_cast<const float2*>(h0 + hbase + (long)(n_hi + r) * P + p);
    }
    hacc[j][0] = lo.x, hacc[j][1] = lo.y, hacc[j][2] = hi.x, hacc[j][3] = hi.y;
  }
  store_h(hacc);

  for (int c = 0; c < nch; ++c) {
    const typename Sm::Stage& sg = sm.st[c & 1];
    const int t0 = c * L, m = min(L, S - t0);
    if (c + 1 < nch) cp_wait_one(); else cp_wait_all();
    __syncthreads();  // chunk c landed; the state entering it is in hs

    if (warp == 0) {  // chunk-local cumulative log-decay, two steps a lane
      const int ta = 2 * lane, tb = ta + 1;
      const float da = sg.dt[ta], db = sg.dt[tb], la = a_h * da, lb = a_h * db;
      float s = la + lb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      float ex = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) ex = 0.f;
      const float ca = ex + la, cb = ca + lb;
      const float total = __shfl_sync(0xffffffffu, cb, 31);
      sm.cum[ta] = ca, sm.cum[tb] = cb;
      sm.ecum[ta] = expf(ca), sm.ecum[tb] = expf(cb);
      sm.wdt[ta] = expf(total - ca) * da, sm.wdt[tb] = expf(total - cb) * db;
      if (lane == 0) sm.etot = expf(total);
    }
    __syncthreads();

    if (r0 < m) {
      uint32_t cf[NK][4];  // C rows r0.. as A fragments over k = n
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        cf[k][0] = frag(sg.c[t_lo * BR + k * 8 + tq]);
        cf[k][1] = frag(sg.c[t_hi * BR + k * 8 + tq]);
        cf[k][2] = frag(sg.c[t_lo * BR + k * 8 + tq + 4]);
        cf[k][3] = frag(sg.c[t_hi * BR + k * 8 + tq + 4]);
      }
      float yacc[PT][4];
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
      // from the state entering the chunk: exp(cum_t) (C h)
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int nt = 0; nt < PT; ++nt)
          mma(yacc[nt], cf[k], __float_as_uint(sm.hs[(k * 8 + tq) * HS + nt * 8 + gr]),
              __float_as_uint(sm.hs[(k * 8 + tq + 4) * HS + nt * 8 + gr]));
      const float e_lo = sm.ecum[t_lo], e_hi = sm.ecum[t_hi];
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) yacc[nt][0] *= e_lo, yacc[nt][1] *= e_lo, yacc[nt][2] *= e_hi, yacc[nt][3] *= e_hi;
      // within the chunk: (C B^T * exp(cum_t - cum_s) dt_s, s <= t) x, one 8-wide s-tile at a time
      const float c_lo = sm.cum[t_lo], c_hi = sm.cum[t_hi];
      const int ns = min(2 * warp + 2, (m + 7) / 8);
      for (int j = 0; j < ns; ++j) {
        float gacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < NK; ++k)
          mma(gacc, cf[k], frag(sg.b[(j * 8 + gr) * BR + k * 8 + tq]), frag(sg.b[(j * 8 + gr) * BR + k * 8 + tq + 4]));
        const int sa = j * 8 + 2 * tq, sb = sa + 1;
        const float ca = sm.cum[sa], cb = sm.cum[sb], da = sg.dt[sa], db = sg.dt[sb];
        // accumulator (row, col) -> A fragment (row, permuted k slot): cols 2q, 2q+1 -> slots q, q+4
        const uint32_t mf[4] = {
            tf32(sa <= t_lo ? gacc[0] * __expf(c_lo - ca) * da : 0.f),
            tf32(sa <= t_hi ? gacc[2] * __expf(c_hi - ca) * da : 0.f),
            tf32(sb <= t_lo ? gacc[1] * __expf(c_lo - cb) * db : 0.f),
            tf32(sb <= t_hi ? gacc[3] * __expf(c_hi - cb) * db : 0.f),
        };
#pragma unroll
        for (int nt = 0; nt < PT; ++nt)
          mma(yacc[nt], mf, frag(sg.x[sa * XR + nt * 8 + gr]), frag(sg.x[sb * XR + nt * 8 + gr]));
      }
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        const int p = nt * 8 + 2 * tq;
        if (t_lo < m)
          *reinterpret_cast<__nv_bfloat162*>(y + (((long)b * S + t0 + t_lo) * H + h) * P + p0 + p) =
              __floats2bfloat162_rn(yacc[nt][0], yacc[nt][1]);
        if (t_hi < m)
          *reinterpret_cast<__nv_bfloat162*>(y + (((long)b * S + t0 + t_hi) * H + h) * P + p0 + p) =
              __floats2bfloat162_rn(yacc[nt][2], yacc[nt][3]);
      }
    }

    // the state: h <- exp(total) h + (B exp(total - cum) dt)^T x, this warp's rows of it
    const float et = sm.etot;
#pragma unroll
    for (int j = 0; j < TPW; ++j) hacc[j][0] *= et, hacc[j][1] *= et, hacc[j][2] *= et, hacc[j][3] *= et;
    const int nks = (m + 7) / 8;
    for (int ks = 0; ks < nks; ++ks) {
      const int sa = ks * 8 + 2 * tq, sb = sa + 1;
      const float wa = sm.wdt[sa], wb = sm.wdt[sb];
      uint32_t af[RB][4];  // the decayed B of each of this warp's row blocks
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int lo = n_lo + 16 * rb, hi = n_hi + 16 * rb;
        af[rb][0] = tf32(__bfloat162float(sg.b[sa * BR + lo]) * wa);
        af[rb][1] = tf32(__bfloat162float(sg.b[sa * BR + hi]) * wa);
        af[rb][2] = tf32(__bfloat162float(sg.b[sb * BR + lo]) * wb);
        af[rb][3] = tf32(__bfloat162float(sg.b[sb * BR + hi]) * wb);
      }
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int p = (hn0 + j % TC) * 8 + gr;
        mma(hacc[j], af[j / TC], frag(sg.x[sa * XR + p]), frag(sg.x[sb * XR + p]));
      }
    }
    __syncthreads();  // every warp is done with chunk c's stage and the old state
    store_h(hacc);
    if (c + 2 < nch) stage(c + 2);
  }
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int p = (hn0 + j % TC) * 8 + 2 * tq, r = 16 * (j / TC);
    *reinterpret_cast<float2*>(hT + hbase + (long)(n_lo + r) * P + p) = make_float2(hacc[j][0], hacc[j][1]);
    *reinterpret_cast<float2*>(hT + hbase + (long)(n_hi + r) * P + p) = make_float2(hacc[j][2], hacc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int PB, int N>
int launch_dual(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* h0, void* y, void* hT, int B, const Dims& d, cudaStream_t s) {
  constexpr int smem = sizeof(DualSmem<PB, N>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_dual_kernel<PB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  ssd_dual_kernel<PB, N><<<dim3(d.H, B, d.P / PB), NTH, smem, s>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm, (const bf16*)Cm,
      (const float*)h0, (bf16*)y, (float*)hT, d);
  return (int)cudaGetLastError();
}

// The dual form's shapes: P a multiple of 32 (blocks of 64 columns where P
// is a multiple of 64, else 32), N in {16, 32, 64, 128}.
bool dual_ok(int P, int N) { return P >= 32 && P % 32 == 0 && (N == 16 || N == 32 || N == 64 || N == 128); }

int dispatch_dual(int N, const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, const void* h0, void* y, void* hT, int B, const Dims& d,
                  cudaStream_t s) {
  const int PB = d.P % 64 == 0 ? 64 : 32;
#define SSD_DUAL(PP, NN) \
  if (PB == PP && N == NN) return launch_dual<PP, NN>(x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  SSD_DUAL(64, 64) SSD_DUAL(64, 32) SSD_DUAL(64, 16) SSD_DUAL(32, 64) SSD_DUAL(32, 32) SSD_DUAL(32, 16)
  SSD_DUAL(64, 128) SSD_DUAL(32, 128)
#undef SSD_DUAL
  return (int)cudaErrorInvalidValue;
}

template <int N>
int launch_step(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* h0, void* y, void* hT, int B, const Dims& d, cudaStream_t s) {
  ssd_step_kernel<N><<<dim3(d.H, B), d.P, 0, s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)h0, (float*)y, (float*)hT, d);
  return (int)cudaGetLastError();
}

// The f32 per-step kernel's shapes: P <= 128, N in {8, 16, 32, 64}.
bool step_ok(int P, int N) { return P <= PMAX && (N == 8 || N == 16 || N == 32 || N == 64); }

int dispatch_step(int N, const void* x, const void* dt, const void* A, const void* Bm,
                  const void* Cm, const void* h0, void* y, void* hT, int B, const Dims& d,
                  cudaStream_t s) {
  if (N == 64) return launch_step<64>(x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  if (N == 32) return launch_step<32>(x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  if (N == 16) return launch_step<16>(x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  if (N == 8) return launch_step<8>(x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  return (int)cudaErrorInvalidValue;
}

// The state in shared memory up to this many bytes a block, else in hT.
constexpr int SCAN_SMEM_MAX = 160 * 1024;

template <class T>
int launch_scan(int N, const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* h0, void* y, void* hT, int B, const Dims& d, cudaStream_t s) {
  const int pb = d.P < PMAX ? d.P : PMAX;
  const long bytes = (long)N * pb * sizeof(float);
  const int smem_state = bytes <= SCAN_SMEM_MAX;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  ssd_scan_kernel<T><<<dim3(d.H, B, (d.P + pb - 1) / pb), pb, smem_state ? bytes : 0, s>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const T*)Cm, (const float*)h0, (T*)y,
      (float*)hT, d, N, smem_state);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// h0 may be null (zero initial state).  bf16_io != 0: x, B, C and y are bf16
// (the dual form, or the run-time scan off its shapes), else f32 (the
// per-step form, or the run-time scan).  Strides in elements.
// S == 0 writes hT = h0 (or zeros).
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* h0, void* y, void* hT, int B, int S,
                              int H, int P, int G, int N, int rows_per_member, long xb, long xs,
                              long xh, long bb, long bs, long bg, int bf16_io, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (G < 1 || H % G || rows_per_member < 1 || P < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const Dims d{S, H, P, G, rows_per_member, xb, xs, xh, bb, bs, bg};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_io) {
    if (dual_ok(P, N)) return dispatch_dual(N, x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
    return launch_scan<bf16>(N, x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  }
  if (step_ok(P, N)) return dispatch_step(N, x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
  return launch_scan<float>(N, x, dt, A, Bm, Cm, h0, y, hT, B, d, s);
}
