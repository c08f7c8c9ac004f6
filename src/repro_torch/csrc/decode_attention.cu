// Decode attention: one query token per row against a KV cache, dense or
// block-paged.  Two entry points share one kernel body (bf16), and two more
// (the _f32 entries) share the f32 route's body:
//
//   decode_attention_fwd        q (B, KVH, G, hd), caches (B, KVH, S, hd),
//                               cur_len (B,) i32 or a scalar, optional starts (B,)
//   decode_attention_paged_fwd  q (E*B, KVH, G, hd), one layer's pool slab
//                               (E, P, KVH, ps, hd), ONE page table (B, n_pg) i32
//                               (-1 = unmapped) shared by the E member planes,
//                               cur_len (B,) i32; no starts
//
// Window and tanh softcap optional on both; hd a multiple of 8 from 8 to 128,
// any G from 1 to 16.  The bf16 body is built at HD 32, 64, 80 and 128; another
// hd runs at the next of these widths (PAD: its hd columns copied, the rest
// zero-filled in shared memory, only the real columns stored), so hd 64, 80
// and 128 keep the code they had.  The f32 route (attention_common.cuh
// attend_f32) is plain FFMA, one block a (row, kv head) pair with the G heads
// as its rows, no split; the paged f32 entry is bitwise the dense one on the
// gathered view, as the bf16 entries are.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
// decode_attention_bkgd (dense, body _decode_kernel), which needs
// S % min(512, S) == 0, and decode_attention_paged_bkgd (paged: the same body
// with block_k = page_size, pages fetched through the scalar-prefetched
// table), which needs page_size % 8 == 0 (a TPU sublane rule; here any
// page_size that divides max_seq will do).
//
// Bound on the H100: bytes — the visible K and V rows are read once and each
// cache element feeds only G multiply-adds; for the paged kernel these are
// the visible rows of the mapped pages.  At the main path's shapes a call
// reads 1-10 MB, a few microseconds of bandwidth, so the time is set by the
// latency of one block's chain: copy, products, softmax, merge.  Design
// (split-K, in the manner of flash-decoding):
//   - each (row, kv head) pair's cache rows are shared out evenly among
//     n_split blocks of 8 warps (as many splits as 128-row tiles, aiming at
//     4 * 132 blocks, at most 8); a block sweeps its rows in 128-row tiles
//     and masks the rows of its neighbours.  The plan is a function of
//     (rows, KVH, S) alone, never of cur_len, and is the same for both
//     entries;
//   - inside a block, 16-byte cp.async copies bring the q row and the
//     split's tiles into shared memory (a two-stage ring when a split has
//     more than one tile), zero-filling rows outside the split's visible
//     range and unmapped pages; a split with no visible row reads no cache;
//   - the G query heads, padded to 16, are the M rows of mma.sync m16n8k16.
//     Each warp scores 16 keys of the tile (S = Q K^T, K fragments through
//     ldmatrix); the block's row maxima and sums go through shared memory,
//     so the whole tile shares one running max; P (bf16) goes to shared
//     memory and each warp then accumulates O += P V for its own 8-column
//     slices of hd over all the tile's keys (V through ldmatrix.trans).  A
//     block thus ends with one partial (m, l, O) and needs no merge of its
//     warps; with one split it writes the output from registers;
//   - with several splits the n_split blocks of a pair form one thread-block
//     cluster.  Block sp owns a chunk of the (G, hd) outputs; every block
//     pushes its m, l and its O on that chunk into the owner's shared memory
//     (distributed shared memory, posted stores), and after one cluster
//     barrier each block merges its chunk locally in log-sum-exp form, in
//     split order: no atomics, no scratch, one launch, deterministic.  A
//     chunk with no visible row gives the empty partial (m = -inf, l = 0);
//     a row with no visible column emits zeros.
//
// Paged: the only change is where a cache row comes from.  Row t of slot b
// lives at offset t % ps of page table[b, t / ps] in member plane r / B (row
// r of q); the split plan, tiles, their order and every reduction are the
// dense kernel's, so for a given gathered view (unmapped pages as zero rows)
// the paged output is bitwise the dense kernel's on that view.  No gathered
// copy is made, and the (B, n_pg) table serves all E planes.  An unmapped
// (-1) or out-of-range entry reads as zero rows — never an out-of-bounds
// load; the JAX kernel clamps such an entry to page 0 instead, which differs
// only on inactive slots whose output the server discards.
#include <cooperative_groups.h>

#include <algorithm>

#include "attention_common.cuh"

namespace cg = cooperative_groups;
using namespace attn;

namespace {

constexpr int NW = 8, NT = 32 * NW;      // warps, threads
constexpr int KW = 16, BK = KW * NW;     // keys a warp scores in a tile, rows a tile
constexpr int GM = 16;                   // the product's M: the G heads, padded
constexpr int MAX_SPLITS = 8;            // the portable thread-block cluster size
constexpr int TARGET_BLOCKS = 4 * 132;   // four blocks for each of the H100's SMs

// Page-table geometry of the paged entry point (unused by the dense one).
struct Paged {
  const int* pages;  // (B, n_pg)
  int B, P, n_pg, ps;
};

template <int HD, int ST>
struct Cfg {
  static constexpr int LD = HD + 8, CH = HD / 8;
  static constexpr int q_elems = GM * LD;                // bf16
  // floats the cluster's merge receives: a slot of m, l and an output chunk per split
  static constexpr int recv = (MAX_SPLITS * (2 * GM + 1) + GM * HD + 3) / 4 * 4;  // 16-byte multiple
  static constexpr int stage_elems = 2 * BK * LD;        // bf16: a K tile and a V tile
  static constexpr size_t bytes =
      sizeof(bf16) * q_elems + sizeof(float) * recv + sizeof(bf16) * ST * stage_elems;
};

template <int HD, int ST, bool PAGED, bool CAP, bool PAD>
__global__ void __launch_bounds__(NT, 1)
    decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                  const bf16* __restrict__ vc, bf16* __restrict__ out,
                  const int* __restrict__ cur_len, int cur_scalar, const int* __restrict__ starts,
                  Paged pg, int G, int KVH, int S, int hd_in, int rows_per_split, int window, float softcap,
                  float scale) {
  using C = Cfg<HD, ST>;
  constexpr int LD = C::LD, CH = C::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  float* Rv = reinterpret_cast<float*>(smem + sizeof(bf16) * C::q_elems);  // the merge's inbox
  bf16* ring = reinterpret_cast<bf16*>(Rv + C::recv);
  constexpr int NTW = (HD / 8 + NW - 1) / NW;  // 8-column n-tiles of the output a warp owns
  constexpr int PLD = BK + 8;                  // padded bf16 row stride of P
  __shared__ __align__(16) bf16 Ps[GM * PLD];  // the tile's probabilities, bf16
  __shared__ float mx_s[NW][GM], sum_s[NW][GM];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;  // the cluster spans blockIdx.x
  // the first half of a barrier whose wait, before the merge, shows every peer has started
  if (n_split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = (long)b * KVH + kvh;
  const int hd = PAD ? hd_in : HD;  // the real head size: columns [hd, HD) are zeros in shared memory
  // the q row (heads past G as zeros) first: it depends on nothing the block reads
  for (int c = tid; c < GM * CH; c += NT) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool col = !PAD || cc < hd;
    cp_async16(Qs + r * LD + cc, q + (row0 * G + (r < G ? r : 0)) * hd + (col ? cc : 0), r < G && col);
  }
  // paged: row b of q is slot b % B of member plane b / B
  const int slot = PAGED ? b % pg.B : b;
  const int cur = min(cur_len ? cur_len[slot] : cur_scalar, S);
  int lo = starts ? max(starts[b], 0) : 0;
  if (window > 0) lo = max(lo, cur - window);
  const ScoreMap<CAP> score(scale, softcap);

  // this split's rows [sa, sz) and the visible ones among them [va, vz), swept
  // in BK-row tiles from `origin` (rows outside [va, vz) load as zeros and
  // are masked, so no row is counted by two splits)
  const int sa = split * rows_per_split, sz = min(S, sa + rows_per_split);
  const int va = max(sa, lo), vz = min(sz, cur);
  const int origin = va < vz ? sa + (va - sa) / BK * BK : sa;
  const int n_tiles = va < vz ? (vz - origin + BK - 1) / BK : 0;

  const long base = PAGED ? (long)(b / pg.B) * pg.P * KVH * pg.ps * hd : row0 * (long)S * hd;
  const bf16* kb = kc + base;
  const bf16* vb = vc + base;
  const int* table = PAGED ? pg.pages + (long)slot * pg.n_pg : nullptr;
  auto load_tile = [&](int i) {  // tile i into stage i % ST
    const int k0 = origin + i * BK;
    bf16* ks = ring + (i % ST) * C::stage_elems;
    bf16* vs = ks + BK * LD;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, cc = (c % CH) * 8, row = k0 + r;
      long off = -1;  // element offset of cache row `row`, -1 = reads as zeros
      if (row >= va && row < vz) {
        if (PAGED) {
          const int page = table[row / pg.ps];
          if (page >= 0 && page < pg.P) off = (((long)page * KVH + kvh) * pg.ps + row % pg.ps) * hd;
        } else {
          off = (long)row * hd;
        }
      }
      const bool col = !PAD || cc < hd;
      const long src = (off < 0 ? 0 : off) + (col ? cc : 0);
      cp_async16(ks + r * LD + cc, kb + src, off >= 0 && col);
      cp_async16(vs + r * LD + cc, vb + src, off >= 0 && col);
    }
  };

  // prologue: the first ST tiles, one commit group each (the q row rides in the first)
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // the f32 online softmax state of this lane's rows g and g + 8, the same in every warp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // this warp's output columns, n-tiles warp, warp + NW, ...; the odd key
  // steps accumulate apart (acc2) so the products form two short chains
  float acc[NTW][4], acc2[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc2[j][e] = 0.f;
  uint32_t qa[HD / 16][4];

  for (int i = 0; i < n_tiles; ++i) {
    // groups committed: ST in the prologue, one per iteration from the second
    if (i == 0) cp_async_wait<ST - 1>(); else cp_async_wait<(ST >= 2 ? ST - 2 : 0)>();  // ST 1: one tile
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i >= 1) {
      if (i - 1 + ST < n_tiles) load_tile(i - 1 + ST);  // into tile i - 1's stage
      cp_async_commit();
    }
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) load_a<LD>(qa[kk], Qs, kk * 16, lane);
    }
    const bf16* ks = ring + (i % ST) * C::stage_elems;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T over this warp's KW keys (two 8-key n-tiles); every head sees the same columns
    constexpr int NJ = KW / 8;
    const int k0 = origin + i * BK + warp * KW;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (k0 < vz && k0 + KW > va) {
      float s2[NJ][4];  // the odd k-steps: two short dependent chains, not one long one
#pragma unroll
      for (int j = 0; j < NJ; ++j) s2[j][0] = s2[j][1] = s2[j][2] = s2[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kf[4];
        load_b_keys<LD>(kf, ks, warp * KW, kk * 16, lane);
        mma(kk % 2 ? s2[0] : s[0], qa[kk], kf[0], kf[1]);
        mma(kk % 2 ? s2[1] : s[1], qa[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    }
    // the tile's max of each head row over this warp's keys, then over the block's
    const int base[2] = {k0 + 2 * t - va, k0 + 2 * t - va}, width[2] = {vz - va, vz - va};
    float mx[2];
    tile_max<NJ, CAP>(&s[0][0], mx, score, true, base, width);
    if (t == 0) mx_s[warp][g] = mx[0], mx_s[warp][g + 8] = mx[1];
    __syncthreads();  // the tile's row maxima, warp by warp
    float m_new[2], alpha[2], psum[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m_new[rr] = m[rr];
#pragma unroll
      for (int w = 0; w < NW; ++w) m_new[rr] = fmaxf(m_new[rr], mx_s[w][g + 8 * rr]);
    }
    tile_exp<NJ, CAP>(&s[0][0], m, m_new, alpha, psum, score);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 1);
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 2);
      if (t == 0) sum_s[warp][g + 8 * rr] = psum[rr];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<uint32_t*>(Ps + (g + 8 * rr) * PLD + warp * KW + j * 8 + 2 * t) =
            pack(s[j][2 * rr], s[j][2 * rr + 1]);
    }
    __syncthreads();  // P of the whole tile and its row sums
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float ps = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ps += sum_s[w][g + 8 * rr];
      l[rr] = l[rr] * alpha[rr] + ps;
    }
    // O += P V over the whole tile, this warp's columns only
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] *= alpha[e >> 1];
        acc2[j][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int kp = 0; kp < BK / 32; ++kp) {
      uint32_t pa0[4], pa1[4];
      load_a<PLD>(pa0, Ps, kp * 32, lane);
      load_a<PLD>(pa1, Ps, kp * 32 + 16, lane);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = warp + NW * j;
        if (n < HD / 8) {
          uint32_t vf[4];  // keys kp * 32 + lane: two k-steps of one 8-column n-tile
          ldsm_x4_t(vf, vs + (kp * 32 + lane) * LD + n * 8);
          mma(acc[j], pa0, vf[0], vf[1]);
          mma(acc2[j], pa1, vf[2], vf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += acc2[j][e];
  cp_async_commit();
  cp_async_wait<0>();  // no copy is in flight (a block with no visible row issued the q row)

  // with one split the output leaves from registers; otherwise this block's
  // partial (m, l per head row, unnormalised O) goes to shared memory
  if (n_split == 1) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = warp + NW * j;
        if (r < G && n * 8 < hd)
          *reinterpret_cast<uint32_t*>(out + (row0 * G + r) * hd + n * 8 + 2 * t) =
              pack(acc[j][2 * rr] * inv, acc[j][2 * rr + 1] * inv);
      }
    }
    return;
  }
  // The cluster's merge.  Block sp owns outputs [sp * chunk, (sp + 1) * chunk)
  // of the row's G * hd, and every block pushes into the owner's shared
  // memory, box `split`, its m and l of every head row and its unnormalised
  // O on those outputs (posted remote stores); after one cluster barrier each
  // block merges its outputs from local memory, in split order.
  const int E = G * HD, chunk = (E + n_split - 1) / n_split, box = 2 * GM + chunk;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (warp == 0 && t == 0)
      for (int dst = 0; dst < n_split; ++dst) {
        float* rv = cluster.map_shared_rank(Rv, dst) + split * box;
        rv[r] = m[rr];
        rv[GM + r] = l[rr];
      }
    if (r < G) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = warp + NW * j;
        if (n >= HD / 8) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = r * HD + n * 8 + 2 * t + c, dst = e / chunk;
          cluster.map_shared_rank(Rv, dst)[split * box + 2 * GM + e - dst * chunk] = acc[j][2 * rr + c];
        }
      }
    }
  }
  cluster.sync();  // every block's pushes have landed
  for (int e = split * chunk + tid; e < min(E, (split + 1) * chunk); e += NT) {
    const int r = e / HD, off = e - split * chunk;
    float ms[MAX_SPLITS], mx = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_split) mx = fmaxf(mx, ms[sp] = Rv[sp * box + r]);
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < n_split) {
        const float a = ms[sp] == -INFINITY ? 0.f : ex2((ms[sp] - mx) * score.k);
        ov += a * Rv[sp * box + 2 * GM + off];
        lv += a * Rv[sp * box + GM + r];
      }
    const bf16 y = __float2bfloat16(ov / (lv == 0.f ? 1.f : lv));
    if constexpr (PAD) {
      if (e % HD < hd) out[(row0 * G + r) * hd + e % HD] = y;
    } else {
      out[row0 * E + e] = y;
    }
  }
}

// The split plan: a function of the shapes alone, shared by both entries.
// As many splits as tiles, the grid wants and a cluster holds; the rows are
// shared out evenly (not in whole tiles), so no block of a cluster carries
// much more than the others.
int plan_splits(int pairs, int S, int* rows_per_split) {
  const int rows = std::max(1, S), n_tiles = (rows + BK - 1) / BK;
  const int want = std::max(1, (TARGET_BLOCKS + pairs - 1) / pairs);
  const int n = std::min(std::min(MAX_SPLITS, n_tiles), want);
  *rows_per_split = (rows + n - 1) / n;
  return (rows + *rows_per_split - 1) / *rows_per_split;
}

template <int HD, int ST, bool PAGED, bool CAP, bool PAD>
int launch_cap(const void* q, const void* k, const void* v, void* o, const void* cur, int cur_scalar,
           const void* st, Paged pg, int G, int rows, int KVH, int S, int hd, int n_split, int rps, int window,
           float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<HD, ST>;
  auto kernel = decode_kernel<HD, ST, PAGED, CAP, PAD>;
  static int attr_set_on = -1;  // the device whose attribute is set: once, not per call
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_set_on != dev) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set_on = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KVH, rows);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;  // one split: a plain launch, no cluster
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const int*)cur,
      cur_scalar, (const int*)st, pg, G, KVH, S, hd, rps, window, softcap, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD, int ST, bool PAGED, bool PAD>
int launch(const void* q, const void* k, const void* v, void* o, const void* cur, int cur_scalar,
           const void* st, Paged pg, int G, int rows, int KVH, int S, int hd, int n_split, int rps, int window,
           float softcap, float scale, cudaStream_t stream) {
  return softcap > 0.f ? launch_cap<HD, ST, PAGED, true, PAD>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH,
                                                              S, hd, n_split, rps, window, softcap, scale, stream)
                       : launch_cap<HD, ST, PAGED, false, PAD>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH,
                                                               S, hd, n_split, rps, window, softcap, scale, stream);
}

// hd a multiple of 8 from 8 to 128, G from 1 to GM: any G <= GM fits the
// body (heads past G are zero rows, never stored) and the merge (chunk =
// ceil(G * HD / n_split) per split: the n_split boxes of 2 * GM + chunk
// floats stay within Cfg::recv)
bool shapes_ok(int hd, int G) { return hd >= 8 && hd <= 128 && hd % 8 == 0 && G >= 1 && G <= GM; }

template <bool PAGED>
int dispatch(int hd, int G, const void* q, const void* k, const void* v, void* o, const void* cur,
             int cur_scalar, const void* st, Paged pg, int rows, int KVH, int S, int window,
             float softcap, float scale, cudaStream_t s) {
  if (!shapes_ok(hd, G)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  int rps = 1;
  const int n_split = plan_splits(rows * KVH, S, &rps);
#define DA_LAUNCH(HD_)                                                                                     \
  return rps <= BK ? launch<HD_, 1, PAGED, false>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH, S, hd,  \
                                                  n_split, rps, window, softcap, scale, s)                 \
                   : launch<HD_, 2, PAGED, false>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH, S, hd,  \
                                                  n_split, rps, window, softcap, scale, s);
  if (hd == 128) DA_LAUNCH(128)
  if (hd == 64) DA_LAUNCH(64)
  if (hd == 80) DA_LAUNCH(80)
#undef DA_LAUNCH
  // a padded width always takes the two-stage ring (with one tile its second
  // stage stays empty): half the instantiations, the same results
#define DA_PAD(HD_) \
  return launch<HD_, 2, PAGED, true>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH, S, hd, n_split, rps, window, \
                                     softcap, scale, s);
  if (hd <= 32) DA_PAD(32)
  if (hd <= 64) DA_PAD(64)
  if (hd <= 80) DA_PAD(80)
  DA_PAD(128)
#undef DA_PAD
}

// ---------------------------------------------------------------------------
// The f32 route: one block of F32_NT threads a (row, kv head) pair, its G
// heads the rows of attend_f32 (attention_common.cuh), keys [lo, cur) of the
// row, K/V rows from the dense cache or through the page table.
constexpr int F32_BK = 32, F32_NT = 128;

template <int HD, bool PAGED, bool CAP>
__global__ void __launch_bounds__(F32_NT)
    decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
                      float* __restrict__ out, const int* __restrict__ cur_len, int cur_scalar,
                      const int* __restrict__ starts, Paged pg, int G, int KVH, int S, int hd, int window,
                      float softcap, float scale) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ long roff[GM];
  __shared__ int rlo[GM], rhi[GM];
  const int kvh = blockIdx.y, b = blockIdx.z;
  const long row0 = (long)b * KVH + kvh;
  const int slot = PAGED ? b % pg.B : b;
  const int cur = min(cur_len ? cur_len[slot] : cur_scalar, S);
  int lo = starts ? max(starts[b], 0) : 0;
  if (window > 0) lo = max(lo, cur - window);
  for (int r = threadIdx.x; r < GM; r += F32_NT) {
    roff[r] = r < G ? (row0 * G + r) * hd : -1;
    rlo[r] = r < G ? lo : 0;
    rhi[r] = r < G ? cur : 0;
  }
  __syncthreads();
  const long base = PAGED ? (long)(b / pg.B) * pg.P * KVH * pg.ps * hd : row0 * (long)S * hd;
  const int* table = PAGED ? pg.pages + (long)slot * pg.n_pg : nullptr;
  attend_f32<HD, GM, F32_BK, F32_NT, CAP>(fsm, roff, rlo, rhi, q, kc + base, vc + base, out, nullptr, hd, lo, cur,
                                          scale, softcap, [&](int row) -> long {
                                            if (!PAGED) return (long)row * hd;
                                            const int page = table[row / pg.ps];
                                            return page >= 0 && page < pg.P
                                                       ? (((long)page * KVH + kvh) * pg.ps + row % pg.ps) * hd
                                                       : -1;
                                          });
}

template <int HD, bool PAGED, bool CAP>
int launch_f32(const void* q, const void* k, const void* v, void* o, const void* cur, int cur_scalar,
               const void* st, Paged pg, int G, int rows, int KVH, int S, int hd, int window, float softcap,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = F32Smem<HD, GM, F32_BK>::bytes;
  auto kernel = decode_f32_kernel<HD, PAGED, CAP>;
  static int attr_set_on = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_set_on != dev) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set_on = dev;
  }
  kernel<<<dim3(1, KVH, rows), F32_NT, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                                         (float*)o, (const int*)cur, cur_scalar, (const int*)st, pg,
                                                         G, KVH, S, hd, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int dispatch_f32(int hd, int G, const void* q, const void* k, const void* v, void* o, const void* cur,
                 int cur_scalar, const void* st, Paged pg, int rows, int KVH, int S, int window, float softcap,
                 float scale, cudaStream_t s) {
  if (!shapes_ok(hd, G)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
#define DF_LAUNCH(HD_)                                                                                        \
  return softcap > 0.f ? launch_f32<HD_, PAGED, true>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH, S, hd, \
                                                      window, softcap, scale, s)                              \
                       : launch_f32<HD_, PAGED, false>(q, k, v, o, cur, cur_scalar, st, pg, G, rows, KVH, S, hd, \
                                                       window, softcap, scale, s);
  if (hd <= 32) DF_LAUNCH(32)
  if (hd <= 64) DF_LAUNCH(64)
  DF_LAUNCH(128)
#undef DF_LAUNCH
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

// The same arguments for f32 q, caches and output.
extern "C" int decode_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        const void* cur_len, int cur_scalar, const void* starts,
                                        int B, int KVH,
                                        int G, int S, int hd, int window, float softcap, float scale,
                                        void* stream) {
  return dispatch_f32<false>(hd, G, q, k, v, o, cur_len, cur_scalar, starts, Paged{nullptr, B, 0, 0, 1},
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

// The same arguments for f32 q, pools and output.
extern "C" int decode_attention_paged_fwd_f32(const void* q, const void* k_pool, const void* v_pool,
                                              void* o, const void* cur_len, const void* pages, int E,
                                              int B, int P, int KVH, int G, int ps, int n_pg, int hd,
                                              int window, float softcap, float scale, void* stream) {
  return dispatch_f32<true>(hd, G, q, k_pool, v_pool, o, cur_len, 0, nullptr,
                            Paged{(const int*)pages, B, P, n_pg, ps}, E * B, KVH, n_pg * ps, window, softcap,
                            scale, (cudaStream_t)stream);
}
