// Flash attention forward (prefill) for q (B, Sq, H, hd) and k, v
// (B, Sk, KVH, hd), GQA by h / (H / KVH), any Sq and Sk, hd a multiple of 8
// from 8 to 128: bf16 on the tensor cores (below), f32 on the SIMT cores
// (flash_attention_fwd_f32, attention_common.cuh attend_f32).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py flash_attention_bhsd
// (body _flash_kernel), which needs Sq % block_q == 0 and Sk % block_k == 0.
//
// Bound on the H100: bytes at the main path's shapes (256-token prompts:
// q and out dominate, about 64 multiply-adds a byte), operations for long
// prompts.  Short prompts make short blocks, so what decides the time is
// how few instructions a tile costs and how much of a block's life the
// copies leave idle.  FlashAttention-2's register layout on an asynchronous
// ring:
//   - rows are (query position, head of the GQA group) pairs, position-major,
//     so the G heads that share a KV head share its K/V tiles; one block of
//     4 warps takes BM = 64 * MT rows of one (b, kv head), each warp MT
//     16-row m-tiles (two at hd 64 and 128: every K/V fragment feeds two
//     products); the row tiles of a (b, kv head) run back to back, the last
//     (which see the most keys when causal) first;
//   - Q and the first K/V tiles are requested together, then K/V stream
//     through a two-stage ring of BK-key tiles with 16-byte cp.async copies
//     (zero-filled past the visible range), a tile's copy overlapping the
//     products on the one before;
//   - S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32
//     accumulate), every fragment read with ldmatrix (K as is, V
//     transposed; Q re-read per tile to keep registers); S, P and O stay in
//     registers in the accumulator layout;
//   - the f32 online softmax (attention_common.cuh softmax_tile) keeps the
//     row max in raw-score units and folds scale * log2(e) into one FFMA
//     before ex2.approx; masks (causal / window / starts, one visible key
//     range a row) cost one unsigned compare an element and only on tiles
//     that some row of the warp sees in part;
//   - a warp skips the products of a tile none of its rows sees;
//   - the output goes through shared memory (each warp's own Q rows) and
//     leaves as 16-byte coalesced row stores.
// K tiles wholly acausal, wholly outside the window or wholly below the row's
// start are never loaded.  Rows with no visible key (pure left padding) end
// with l == 0 and emit zeros.  Rows and keys past the end read as zeros.
// With an lse output (the forward of a training step: its backward
// recomputes P = exp(s - lse)), each row also writes the log-sum-exp of its
// scaled (and softcapped) scores in natural-log units, f32 (B, Sq, H), -inf
// where l == 0; LSE is a template parameter, so the kernel without it (the
// serving path, lse null) is the same code as before.
// hd 80 has 160-byte rows: 10 ldmatrix columns of 16 bytes, on the same ring.
// The kernel is built at HD 32, 64, 80 and 128; another hd runs at the next
// of these widths (PAD: its hd columns copied, the rest zero-filled in shared
// memory, only the hd real columns stored), so hd 64, 80 and 128 keep the
// code they had.
#include "attention_common.cuh"

using namespace attn;

namespace {

// Per head size, measured on the H100 at the main path's shapes: two m-tiles
// a warp and 32-key tiles at hd 64 and 128; hd 80 (zamba2, G = 1) is faster
// with one m-tile and 64-key tiles.  HD 32 (the padded width of hd <= 32)
// takes hd 64's tiles, untuned.
template <int HD>
struct Tune {
  static constexpr int MT = HD == 80 ? 1 : 2, BK = HD == 80 ? 64 : 32, MINB = HD == 80 ? 4 : 2;
};

template <int HD>
struct Cfg {
  static constexpr int NW = 4, NT = 32 * NW, ST = 2;  // warps, threads, ring stages
  static constexpr int MT = Tune<HD>::MT, BK = Tune<HD>::BK;
  static constexpr int WM = 16 * MT, BM = WM * NW;
  static constexpr int LD = HD + 8;  // padded bf16 row stride: conflict-free ldmatrix
  static constexpr int CH = HD / 8;  // 16-byte chunks a row
  static constexpr int q_elems = BM * LD, kv_elems = BK * LD;
  static constexpr size_t bytes = sizeof(bf16) * (q_elems + 2 * ST * kv_elems);
  static constexpr int MINB = Tune<HD>::MINB;  // blocks an SM must hold: caps the registers
};

template <int HD, bool CAP, bool LSE, bool PAD>
__global__ void __launch_bounds__(Cfg<HD>::NT, Cfg<HD>::MINB)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ starts, int Sq, int Sk, int H, int KVH, int hd_in,
                     int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int MT = C::MT, BM = C::BM, WM = C::WM, BK = C::BK, ST = C::ST, NT = C::NT, LD = C::LD,
                CH = C::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + C::q_elems;        // ST stages
  bf16* Vs = Ks + ST * C::kv_elems;  // ST stages
  __shared__ long rbase[BM];         // each row's element offset in q and o, -1 past the end

  // rows are (position, head of the group) pairs, position-major: row m is
  // query position m / G of head kvh * G + m % G
  const int G = H / KVH, n_rows = Sq * G;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int start = starts ? max(starts[b], 0) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * WM;
  const int hd = PAD ? hd_in : HD;  // the real head size: columns [hd, HD) are zeros in shared memory
  const long q_row = (long)H * hd, kv_row = (long)KVH * hd;
  const ScoreMap<CAP> score(scale, softcap);

  // visible keys of position p: [pos_lo(p), pos_hi(p)), both non-decreasing in p
  auto pos_lo = [&](int p) { return window > 0 ? max(start, p - window + 1) : start; };
  auto pos_hi = [&](int p) { return p < Sq ? min(Sk, causal ? p + 1 : Sk) : pos_lo(p); };

  // the block's key range, in whole tiles
  const int p_first = m0 / G, p_last = (min(m0 + BM, n_rows) - 1) / G;
  const int k_lo = pos_lo(p_first);
  const int k_hi = causal ? min(Sk, p_last + 1) : Sk;
  const int t0 = k_lo / BK;
  const int n_tiles = k_hi > t0 * BK ? (k_hi - t0 * BK + BK - 1) / BK : 0;

  const bf16* kb = k + (long)b * Sk * kv_row + (long)kvh * hd;
  const bf16* vb = v + (long)b * Sk * kv_row + (long)kvh * hd;
  auto load_tile = [&](int i) {  // tile i of the range into stage i % ST
    const int k0 = (t0 + i) * BK;
    bf16* ks = Ks + (i % ST) * C::kv_elems;
    bf16* vs = Vs + (i % ST) * C::kv_elems;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool col = !PAD || cc < hd, ok = k0 + r < k_hi && col;
      const long off = (long)(ok ? k0 + r : k0) * kv_row + (col ? cc : 0);
      cp_async16(ks + r * LD + cc, kb + off, ok);
      cp_async16(vs + r * LD + cc, vb + off, ok);
    }
  };

  // the row offsets once (a division by G a row), then Q with the first
  // ST - 1 tiles, one commit group per tile
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    rbase[r] = m < n_rows ? ((long)b * Sq + m / G) * q_row + (long)(kvh * G + m % G) * hd : -1;
  }
  __syncthreads();
  for (int c = tid; c < BM * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    const long off = rbase[r];
    const bool col = !PAD || cc < hd;
    cp_async16(Qs + r * LD + cc, q + (off >= 0 ? off : rbase[0]) + (col ? cc : 0), off >= 0 && col);
  }
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // this lane's rows: g and g + 8 of each of the warp's m-tiles; the warp's span
  int lo[MT][2], hi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = m0 + wr + mt * 16 + g + 8 * rr;
      const int p = m < n_rows ? m / G : Sq;
      lo[mt][rr] = pos_lo(p);
      hi[mt][rr] = pos_hi(p);
    }
  const int wa = m0 + wr, wz = min(m0 + wr + WM, n_rows) - 1;  // first and last valid row
  const bool w_rows = wa < n_rows;
  const int pa_ = wa / G, pz = w_rows ? wz / G : 0;
  const int w_lo = pos_lo(pa_), w_hi = w_rows ? pos_hi(pz) : 0;          // keys any row sees
  const int w_lo_all = pos_lo(pz), w_hi_all = w_rows ? pos_hi(pa_) : 0;  // keys every row sees

  float acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m_run[mt][0] = m_run[mt][1] = -INFINITY, l_run[mt][0] = l_run[mt][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + ST - 1 < n_tiles) load_tile(i + ST - 1);  // into the stage freed last iteration
    cp_async_commit();
    cp_async_wait<ST - 1>();  // tile i (and Q) landed, for this thread's copies
    __syncthreads();          // ... and for every thread's

    const int k0 = (t0 + i) * BK;
    if (w_rows && k0 < w_hi && k0 + BK > w_lo) {
      const bf16* ks = Ks + (i % ST) * C::kv_elems;
      const bf16* vs = Vs + (i % ST) * C::kv_elems;
      // S = Q K^T: per m-tile, BK / 8 tiles of 16 rows x 8 keys; each K fragment serves every m-tile
      float s[MT][BK / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a<LD>(qa[mt], Qs + (wr + mt * 16) * LD, kk * 16, lane);
#pragma unroll
        for (int j2 = 0; j2 < BK / 16; ++j2) {
          uint32_t kf[4];
          load_b_keys<LD>(kf, ks, j2 * 16, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(s[mt][2 * j2], qa[mt], kf[0], kf[1]);
            mma(s[mt][2 * j2 + 1], qa[mt], kf[2], kf[3]);
          }
        }
      }

      // online softmax; a row's scores live in the 4 lanes of its group
      const bool masked = !(k0 >= w_lo_all && k0 + BK <= w_hi_all);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        int base[2], width[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          base[rr] = k0 + 2 * t - lo[mt][rr];
          width[rr] = max(hi[mt][rr] - lo[mt][rr], 0);
        }
        float alpha[2];
        softmax_tile<BK / 8, CAP>(&s[mt][0][0], m_run[mt], l_run[mt], alpha, score, masked, base, width);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
      }

      // O += P V: P's accumulator layout is the A layout of the next product
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          uint32_t vf[4];
          load_b_values<LD>(vf, vs, kk * 16, n2 * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][2 * n2], pa[mt], vf[0], vf[1]);
            mma(acc[mt][2 * n2 + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage i % ST
  }

  // epilogue: each warp stages its rows in its own Q rows (no other warp reads
  // them), then stores them as 16-byte row chunks; with a tile every copy has
  // landed, so a warp does not wait for the others
  if (n_tiles == 0) {  // the Q copies may still be in flight
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  bf16* os = Qs + wr * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_run[mt][rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      if constexpr (LSE) {
        // the running max is in raw-score units (capped, base-2 units with a
        // softcap): p = 2^(x k - m k), so ln sum exp = ln 2 (m k + log2 l)
        const int m = m0 + wr + mt * 16 + g + 8 * rr;
        if (t == 0 && m < n_rows)
          lse[((long)b * Sq + m / G) * H + kvh * G + m % G] =
              l == 0.f ? -INFINITY : (m_run[mt][rr] * score.k + __log2f(l)) * 0.6931471805599453f;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(os + (mt * 16 + g + 8 * rr) * LD + n * 8 + 2 * t) =
            pack(acc[mt][n][2 * rr] * inv, acc[mt][n][2 * rr + 1] * inv);
    }
  __syncwarp();
  for (int c = lane; c < WM * CH; c += 32) {
    const int r = c / CH, cc = (c % CH) * 8;
    const long off = rbase[wr + r];
    if (off >= 0 && (!PAD || cc < hd))
      *reinterpret_cast<uint4*>(o + off + cc) = *reinterpret_cast<const uint4*>(os + r * LD + cc);
  }
}

template <int HD, bool CAP, bool LSE, bool PAD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* starts, int B,
           int Sq, int Sk, int H, int KVH, int hd, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kernel = flash_fwd_kernel<HD, CAP, LSE, PAD>;
  static int attr_set_on = -1;  // the device whose attribute is set: once, not per call
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_set_on != dev) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set_on = dev;
  }
  // the row tile varies fastest, last first: the blocks of one (b, kv head)
  // run together and share its K/V tiles in L2
  const long n_rows = (long)Sq * (H / KVH);
  dim3 grid((unsigned)((n_rows + C::BM - 1) / C::BM), KVH, B);
  kernel<<<grid, C::NT, C::bytes, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            (bf16*)o, (float*)lse, (const int*)starts, Sq, Sk, H, KVH, hd, causal,
                                            window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool LSE, bool PAD>
int launch_cap(const void* q, const void* k, const void* v, void* o, void* lse, const void* starts, int B,
               int Sq, int Sk, int H, int KVH, int hd, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  return softcap > 0.f
             ? launch<HD, true, LSE, PAD>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap,
                                          scale, stream)
             : launch<HD, false, LSE, PAD>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap,
                                           scale, stream);
}

template <int HD, bool PAD>
int launch_hd(const void* q, const void* k, const void* v, void* o, void* lse, const void* starts, int B,
              int Sq, int Sk, int H, int KVH, int hd, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  return lse ? launch_cap<HD, true, PAD>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap,
                                         scale, stream)
             : launch_cap<HD, false, PAD>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap,
                                          scale, stream);
}

// ---------------------------------------------------------------------------
// The f32 route: rows as above ((position, head of the group) pairs,
// position-major), F32_BM of them a block, the block's keys the union of its
// rows' visible ranges; the body is attend_f32 (attention_common.cuh).
constexpr int F32_BM = 32, F32_BK = 32, F32_NT = 128;

template <int HD, bool CAP>
__global__ void __launch_bounds__(F32_NT)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                         const int* __restrict__ starts, int Sq, int Sk, int H, int KVH, int hd, int causal,
                         int window, float softcap, float scale) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ long roff[F32_BM];
  __shared__ int rlo[F32_BM], rhi[F32_BM];
  const int G = H / KVH, n_rows = Sq * G;
  const int m0 = blockIdx.x * F32_BM, kvh = blockIdx.y, b = blockIdx.z;
  const int start = starts ? max(starts[b], 0) : 0;
  auto pos_lo = [&](int p) { return window > 0 ? max(start, p - window + 1) : start; };
  auto pos_hi = [&](int p) { return min(Sk, causal ? p + 1 : Sk); };
  for (int r = threadIdx.x; r < F32_BM; r += F32_NT) {
    const int m = m0 + r, p = m / G;
    const bool ok = m < n_rows;
    roff[r] = ok ? (((long)b * Sq + p) * H + kvh * G + m % G) * hd : -1;
    rlo[r] = ok ? pos_lo(p) : 0;
    rhi[r] = ok ? pos_hi(p) : 0;
  }
  // both bounds are non-decreasing in the position: the block's first and last rows bound its keys
  const int p_first = m0 / G, p_last = (min(m0 + F32_BM, n_rows) - 1) / G;
  const long kv_base = (long)b * Sk * KVH * hd + (long)kvh * hd, kv_row = (long)KVH * hd;
  __syncthreads();
  attend_f32<HD, F32_BM, F32_BK, F32_NT, CAP>(fsm, roff, rlo, rhi, q, k, v, o, lse, hd, pos_lo(p_first),
                                              pos_hi(p_last), scale, softcap,
                                              [&](int key) { return kv_base + key * kv_row; });
}

template <int HD, bool CAP>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, const void* starts, int B,
               int Sq, int Sk, int H, int KVH, int hd, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = F32Smem<HD, F32_BM, F32_BK>::bytes;
  auto kernel = flash_fwd_f32_kernel<HD, CAP>;
  static int attr_set_on = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_set_on != dev) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set_on = dev;
  }
  const long n_rows = (long)Sq * (H / KVH);
  dim3 grid((unsigned)((n_rows + F32_BM - 1) / F32_BM), KVH, B);
  kernel<<<grid, F32_NT, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v, (float*)o,
                                          (float*)lse, (const int*)starts, Sq, Sk, H, KVH, hd, causal, window,
                                          softcap, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32_cap(const void* q, const void* k, const void* v, void* o, void* lse, const void* starts, int B,
                   int Sq, int Sk, int H, int KVH, int hd, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  return softcap > 0.f
             ? launch_f32<HD, true>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale,
                                    stream)
             : launch_f32<HD, false>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale,
                                     stream);
}

bool head_size_ok(int hd) { return hd >= 8 && hd <= 128 && hd % 8 == 0; }

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// bf16 q, k, v, o.  window <= 0: no window; softcap <= 0: no softcap; starts
// may be null; lse (f32 (B, Sq, H)) may be null: the kernel without the lse
// output.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   const void* starts, int B, int Sq, int Sk, int H, int KVH,
                                   int hd, int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (!head_size_ok(hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define FA_LAUNCH(HD_, PAD_) \
  return launch_hd<HD_, PAD_>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale, s);
  if (hd == 128) FA_LAUNCH(128, false)
  if (hd == 80) FA_LAUNCH(80, false)
  if (hd == 64) FA_LAUNCH(64, false)
  if (hd <= 32) FA_LAUNCH(32, true)
  if (hd <= 64) FA_LAUNCH(64, true)
  if (hd <= 80) FA_LAUNCH(80, true)
  FA_LAUNCH(128, true)
#undef FA_LAUNCH
}

// The same arguments for f32 q, k, v, o.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                       const void* starts, int B, int Sq, int Sk, int H, int KVH,
                                       int hd, int causal, int window, float softcap, float scale,
                                       void* stream) {
  if (!head_size_ok(hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32) return launch_f32_cap<32>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale, s);
  if (hd <= 64) return launch_f32_cap<64>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale, s);
  return launch_f32_cap<128>(q, k, v, o, lse, starts, B, Sq, Sk, H, KVH, hd, causal, window, softcap, scale, s);
}
