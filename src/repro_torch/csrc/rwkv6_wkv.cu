// RWKV6 (Finch) WKV: the time-mix recurrence with a data-dependent decay per
// key channel, for r, k, v (B, S, H, D) bf16 or f32, logw (B, S, H, D) f32
// (log decay <= 0), the bonus u (E, H, D) f32 (row b reads member
// b / rows_per_member) and an optional initial state s0 (B, H, D, D) f32
// [key, value].  Writes y (B, S, H, D) in r's type and the final state sT.
//
//   y_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(exp(logw_t)) S + k_t v_t^T
//
// Replaces: src/repro/kernels/rwkv6_wkv/kernel.py wkv6_pallas (body
// _wkv_kernel), which needs S % chunk == 0 and builds the exact pairwise
// decay exp(ecum_t - cum_s) as an (L, L, D) = 32*32*64 f32 tile (256 KiB) in
// VMEM, more than an H100 block's shared memory.
//
// Bound on the H100: the f32 operations of the per-step form (k v, S w +
// k v, r S: 5 per state element a step, on the CUDA cores) at the main
// path's shapes with many steps; the bytes (the state in and out) at S = 1.
// Design: the exact per-step recurrence, so no pairwise tensor and no
// exponent split (exp(-cum) would overflow f32 under strong decay; here
// every exponent is a single logw <= 0), laid out like a register-tiled
// product so the CUDA cores, not the loads, do the work:
//  - a thread owns R keys of CC value columns of the (D, D) state in
//    registers, the key index split over IS = D / R lanes, so y_t[j] is a
//    shuffle reduction over IS lanes and no dependent chain is longer than R
//    FMAs; a block owns JB columns of one (row, head);
//  - the tile follows the call (see launch): R 16, CC 4, JB = D when there
//    are (row, head) pairs enough to fill the card (prefill, decode), R 8,
//    CC 2, JB 32 when there are few (one slot's admission chunk);
//  - a lane's keys are groups of 4 interleaved over the IS lanes, so the
//    float4 reads of r, k and exp(logw) from shared memory hit distinct
//    banks (contiguous keys cost a 2-way conflict on every read); the state
//    moves in and out a row of CC columns at a time;
//  - the bonus u enters as v_t[j] * beta_t with beta_t = sum_i r_i u_i k_i,
//    computed once a step while the pass is converted;
//  - CH steps of raw r, k, v, logw arrive by cp.async into a raw stage while
//    the previous pass computes from its converted (f32) copy; y leaves from
//    registers, CC columns a store;
//  - a one-step call (S = 1, the models' decode) loads its operands straight
//    into registers, passes no barrier and stores each state row as soon as
//    it is updated (reading each key once through shared memory measured
//    slower, and so did the general pass loop at the decode shape: PERF.md
//    section 6).
// Any S with a ragged last pass.  D in {16, 32, 64}.
//
// Every other D (say 128, or 48): wkv6_scan_kernel, the same per-step
// recurrence with D read at run time, a thread a value column, the state in
// shared memory (or, past 160 KB, in sT).  A D up to 10240 runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 16;  // steps a pass

// A thread owns R keys of CC value columns; a block owns JB value columns of
// one (row, head); IS lanes split a column group's keys.
template <int D_, int R_, int CC_, int JB_>
struct Tile {
  static constexpr int D = D_, R = R_ < D_ ? R_ : D_, CC = CC_, JB = JB_ < D_ ? JB_ : D_;
  static constexpr int IS = D / R, NT = IS * JB / CC;
  static constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1;
  static_assert(R % 4 == 0 && (CC == 2 || CC == 4) && NT % (D / 8) == 0, "unsupported tile");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// N (2 or 4) consecutive elements as f32, and back
template <int N>
__device__ __forceinline__ void loadn(const float* p, float* o) {
  if (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    o[0] = a.x, o[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void loadn(const bf16* p, float* o) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(q[i]);
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void storen(float* p, const float* v) {
  if (N == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int N>
__device__ __forceinline__ void storen(bf16* p, const float* v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

template <typename Tl, typename T>
__global__ void __launch_bounds__(Tl::NT)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int S,
                int H, int rows_per_member) {
  constexpr int D = Tl::D, R = Tl::R, CC = Tl::CC, JB = Tl::JB, IS = Tl::IS, NT = Tl::NT;
  constexpr unsigned MASK = Tl::MASK;
  constexpr int EV = 16 / sizeof(T);                    // elements in 16 bytes
  constexpr int RV = D / EV, VV = JB / EV, WV = D / 4;  // 16-byte pieces of a row
  constexpr int CI = D / 8;                             // 8-key items a step in the conversion
  __shared__ __align__(16) unsigned char raw[(2 * CH * D + CH * JB) * sizeof(T)];  // raw stage
  __shared__ __align__(16) float lr[CH * D];
  T* rr = reinterpret_cast<T*>(raw);
  T* kr = rr + CH * D;
  T* vr = kr + CH * D;
  __shared__ __align__(16) float rs[CH * D], ks[CH * D], ws[CH * D], vs[CH * JB];  // converted
  __shared__ float beta[CH];

  const int h = blockIdx.x / (D / JB), j0 = blockIdx.x % (D / JB) * JB, b = blockIdx.y;
  const int tid = threadIdx.x, q = tid % IS, jj = tid / IS * CC;  // key lane, first column in the block
  // this thread's e-th key: groups of 4 interleaved over the IS lanes, so the
  // lanes' float4 reads of r, k, exp(logw) fall in distinct banks
  auto key = [&](int e) { return (e / 4) * (4 * IS) + 4 * q + e % 4; };
  const long ts = (long)H * D;                       // between two steps of one row
  const long base = (long)b * S * ts + (long)h * D;  // (b, 0, h, 0)
  const long sbase = ((long)b * H + h) * D * D + j0 + jj;
  const float* urow = u + ((long)(b / rows_per_member) * H + h) * D;

  float st[R][CC];  // S[key(e)][j0 + jj + c]
  auto load_state = [&] {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      if (s0) loadn<CC>(s0 + sbase + (long)key(e) * D, st[e]);
#pragma unroll
      for (int c = 0; c < CC; ++c) if (!s0) st[e][c] = 0.f;
    }
  };
  // one step from this thread's operands: y_t at its CC columns (written by
  // the lane with q == 0) and the state update
  auto step = [&](const float(&rv)[R], const float(&kv)[R], const float(&wv)[R],
                  const float(&vv)[CC], float bt, T* yp) {
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        acc[c] = fmaf(rv[e], st[e][c], acc[c]);
        st[e][c] = fmaf(st[e][c], wv[e], kv[e] * vv[c]);
      }
#pragma unroll
    for (int o = IS / 2; o > 0; o >>= 1)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] += __shfl_xor_sync(MASK, acc[c], o);
    if (q == 0) {
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] = fmaf(vv[c], bt, acc[c]);
      storen<CC>(yp, acc);
    }
  };

  if (S == 1) {
    // a decode step: every operand straight into registers, no barrier
    float rv[R], kv[R], wv[R], vv[CC], bt = 0.f;
#pragma unroll
    for (int e = 0; e < R; e += 4) {
      float uq[4];
      loadn<4>(r + base + key(e), rv + e);
      loadn<4>(k + base + key(e), kv + e);
      loadn<4>(logw + base + key(e), wv + e);
      loadn<4>(urow + key(e), uq);
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[e + i] = expf(wv[e + i]), bt = fmaf(rv[e + i] * uq[i], kv[e + i], bt);
    }
    loadn<CC>(v + base + j0 + jj, vv);
    // the state's loads go out after the operands', so the exponentials above
    // overlap them; each row leaves as soon as it is updated
    load_state();
    float acc[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int e = 0; e < R; ++e) {
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        acc[c] = fmaf(rv[e], st[e][c], acc[c]);
        st[e][c] = fmaf(st[e][c], wv[e], kv[e] * vv[c]);
      }
      storen<CC>(sT + sbase + (long)key(e) * D, st[e]);
    }
#pragma unroll
    for (int o = IS / 2; o > 0; o >>= 1) {
      bt += __shfl_xor_sync(MASK, bt, o);
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] += __shfl_xor_sync(MASK, acc[c], o);
    }
    if (q == 0) {
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[c] = fmaf(vv[c], bt, acc[c]);
      storen<CC>(y + base + j0 + jj, acc);
    }
    return;
  } else {
    load_state();
    float uu[8];  // u at this thread's 8 keys in the conversion (item % CI == tid % CI)
    loadn<4>(urow + tid % CI * 8, uu);
    loadn<4>(urow + tid % CI * 8 + 4, uu + 4);

    auto stage = [&](int t0, int n) {
      for (int c = tid; c < n * RV; c += NT) {
        const int tt = c / RV, e = c % RV;
        const long off = base + (t0 + tt) * ts + e * EV;
        cp_async16(rr + tt * D + e * EV, r + off);
        cp_async16(kr + tt * D + e * EV, k + off);
      }
      for (int c = tid; c < n * VV; c += NT) {
        const int tt = c / VV, e = c % VV;
        cp_async16(vr + tt * JB + e * EV, v + base + (t0 + tt) * ts + j0 + e * EV);
      }
      for (int c = tid; c < n * WV; c += NT) {
        const int tt = c / WV, e = c % WV;
        cp_async16(lr + tt * D + e * 4, logw + base + (t0 + tt) * ts + e * 4);
      }
      cp_commit();
    };

    if (S > 0) stage(0, min(CH, S));
    for (int t0 = 0; t0 < S; t0 += CH) {
      const int n = min(CH, S - t0);
      cp_wait_all();
      __syncthreads();  // this pass's raw stage landed; the previous pass is consumed

      // convert: 8 keys of one step per item, and beta_t = sum_i r u k reduced
      // over the CI lanes of a step; whole warps, rows past n are never read
      const int nci = min(CH * CI, (n * CI + 31) & ~31);
      for (int c = tid; c < nci; c += NT) {
        const int tt = c / CI, i8 = c % CI * 8;
        float rv[8], kv[8], wv[8];
        loadn<4>(rr + tt * D + i8, rv), loadn<4>(rr + tt * D + i8 + 4, rv + 4);
        loadn<4>(kr + tt * D + i8, kv), loadn<4>(kr + tt * D + i8 + 4, kv + 4);
        loadn<4>(lr + tt * D + i8, wv), loadn<4>(lr + tt * D + i8 + 4, wv + 4);
        float bsum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) wv[e] = expf(wv[e]), bsum = fmaf(rv[e] * uu[e], kv[e], bsum);
        storen<4>(rs + tt * D + i8, rv), storen<4>(rs + tt * D + i8 + 4, rv + 4);
        storen<4>(ks + tt * D + i8, kv), storen<4>(ks + tt * D + i8 + 4, kv + 4);
        storen<4>(ws + tt * D + i8, wv), storen<4>(ws + tt * D + i8 + 4, wv + 4);
#pragma unroll
        for (int o = CI / 2; o > 0; o >>= 1) bsum += __shfl_xor_sync(MASK, bsum, o);
        if (i8 == 0) beta[tt] = bsum;
      }
      for (int c = tid; c < n * JB; c += NT) vs[c] = to_f32(vr[c]);
      __syncthreads();
      if (t0 + CH < S) stage(t0 + CH, min(CH, S - t0 - CH));  // lands while this pass computes

#pragma unroll 2
      for (int tt = 0; tt < n; ++tt) {
        float rv[R], kv[R], wv[R], vv[CC];
#pragma unroll
        for (int e = 0; e < R; e += 4) {
          loadn<4>(rs + tt * D + key(e), rv + e);
          loadn<4>(ks + tt * D + key(e), kv + e);
          loadn<4>(ws + tt * D + key(e), wv + e);
        }
        loadn<CC>(vs + tt * JB + jj, vv);
        step(rv, kv, wv, vv, beta[tt], y + base + (t0 + tt) * ts + j0 + jj);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < R; ++e) storen<CC>(sT + sbase + (long)key(e) * D, st[e]);
}

// ---------------------------------------------------------------------------
// every other D: the per-step recurrence with D read at run time
// ---------------------------------------------------------------------------

constexpr int SCAN_NT = 128;                // the most value columns a block owns
constexpr int SCAN_SMEM_MAX = 160 * 1024;   // the state in shared memory up to this, else in sT

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

// One block of jb threads per (row, head, block of jb value columns): thread
// j owns column j of the (D, D) state, in dynamic shared memory (column-
// interleaved, conflict-free) when D * jb floats fit, else in sT itself (the
// f32 output, updated in place; a warp's columns are adjacent, so each row
// moves coalesced).  Each step the block stages r_t, k_t and exp(logw_t)
// (and u, once) in shared memory; every thread then runs the f32 route's
// arithmetic over all D keys: y_t[j] = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
// S_ij <- S_ij e^(logw_i) + k_i v_j.
template <typename T>
__global__ void __launch_bounds__(SCAN_NT)
    wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ s0,
                     T* __restrict__ y, float* __restrict__ sT, int S, int H, int D, int rows_per_member,
                     int smem_state) {
  extern __shared__ float wsm[];
  const int jb = blockDim.x, nb = (D + jb - 1) / jb, tid = threadIdx.x;
  const int h = blockIdx.x / nb, j = blockIdx.x % nb * jb + tid, b = blockIdx.y;
  const bool live = j < D;
  float* rs = wsm;  // r_t, k_t, exp(logw_t) and u, D floats each, then (smem_state) the state
  float* ks = rs + D;
  float* ws = ks + D;
  float* us = ws + D;
  const long ts = (long)H * D, base = (long)b * S * ts + (long)h * D;
  const long sbase = ((long)b * H + h) * D * D + j;  // S[i][j] at sbase + i * D
  float* st = smem_state ? us + D + tid : sT + sbase;  // S[i][j] at st[i * sstride]
  const long sstride = smem_state ? jb : D;
  const float* urow = u + ((long)(b / rows_per_member) * H + h) * D;
  for (int i = tid; i < D; i += jb) us[i] = urow[i];
  if (live)
    for (int i = 0; i < D; ++i) st[i * sstride] = s0 ? s0[sbase + (long)i * D] : 0.f;
  for (int t = 0; t < S; ++t) {
    __syncthreads();  // the last step's operands are consumed (the first time: u is staged)
    const long off = base + t * ts;
    for (int i = tid; i < D; i += jb) {
      rs[i] = to_f32(r[off + i]);
      ks[i] = to_f32(k[off + i]);
      ws[i] = expf(logw[off + i]);
    }
    __syncthreads();
    if (live) {
      const float vj = to_f32(v[off + j]);
      float acc = 0.f, bt = 0.f;
      for (int i = 0; i < D; ++i) {
        const float sv = st[i * sstride];
        acc = fmaf(rs[i], sv, acc);
        st[i * sstride] = fmaf(sv, ws[i], ks[i] * vj);
        bt = fmaf(rs[i] * us[i], ks[i], bt);
      }
      store1(y + off + j, fmaf(vj, bt, acc));
    }
  }
  if (smem_state && live)
    for (int i = 0; i < D; ++i) sT[sbase + (long)i * D] = st[i * sstride];
}

template <typename T>
int launch_scan(int D, const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, void* y, void* sT, int B, int S, int H, int rpm, cudaStream_t stream) {
  const int jb = D >= SCAN_NT ? SCAN_NT : (D + 31) / 32 * 32;
  const long state = (long)D * jb * sizeof(float), ops = 4L * D * sizeof(float);
  const int smem_state = state + ops <= SCAN_SMEM_MAX;
  if (ops > SCAN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(wkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  wkv6_scan_kernel<T><<<dim3(H * ((D + jb - 1) / jb), B), jb, ops + (smem_state ? state : 0), stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw, (const float*)u, (const float*)s0, (T*)y,
      (float*)sT, S, H, D, rpm, smem_state);
  return (int)cudaGetLastError();
}

template <typename Tl, typename T>
int launch_tile(const void* r, const void* k, const void* v, const void* logw, const void* u,
                const void* s0, void* y, void* sT, int B, int S, int H, int rows_per_member,
                cudaStream_t stream) {
  wkv6_kernel<Tl, T><<<dim3(H * (Tl::D / Tl::JB), B), Tl::NT, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw, (const float*)u,
      (const float*)s0, (T*)y, (float*)sT, S, H, rows_per_member);
  return (int)cudaGetLastError();
}

// The tile by the call's (row, head) pairs: with two or more a streaming
// multiprocessor, 16 keys of 4 columns a thread, one 64-thread block a pair
// (fewest instructions a state element); with fewer, as for one slot's
// admission chunk, 8 keys of 2 columns a thread, 32 columns a block (four
// times the threads, so each step's latency is spread over more warps).
template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* y, void* sT, int B, int S, int H, int rpm, cudaStream_t s) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  if ((long)B * H >= 2L * sms)
    return launch_tile<Tile<D, 16, 4, 64>, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  return launch_tile<Tile<D, 8, 2, 32>, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
}

template <typename T>
int dispatch(int D, const void* r, const void* k, const void* v, const void* logw, const void* u,
             const void* s0, void* y, void* sT, int B, int S, int H, int rpm, cudaStream_t s) {
  if (D == 64) return launch<64, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  if (D == 32) return launch<32, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  if (D == 16) return launch<16, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  return launch_scan<T>(D, r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// s0 may be null (zero initial state); bf16 != 0: r, k, v, y are bf16, else f32.
// Every tensor contiguous.  S == 0 writes sT = s0 (or zeros).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* s0, void* y, void* sT, int B, int S,
                             int H, int D, int rows_per_member, int bf16_io, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_io) return dispatch<bf16>(D, r, k, v, logw, u, s0, y, sT, B, S, H, rows_per_member, s);
  return dispatch<float>(D, r, k, v, logw, u, s0, y, sT, B, S, H, rows_per_member, s);
}
