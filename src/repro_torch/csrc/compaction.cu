// Deferral compaction and the paged K/V view: byte-exact row copies through
// an index map, one launch a call.
//
// Replaces: src/repro/kernels/compaction/kernel.py compact_pallas (body
// _compact_kernel).  The TPU kernel expresses the row permutation as a
// one-hot (B, B) matmul on the MXU, exact only for float payloads; here the
// permutation is a scan plus a row copy, exact for every dtype.  The same
// row copy gathers chunked prefill's paged K/V views (the JAX package's
// layers.paged_view gathers through compaction.ops.gather_rows too).
//
// Bound on the H100: bytes — each payload row is read once and written once
// (plus B mask bytes and B index-map words); there is no arithmetic to speak
// of.  At the main path's sizes (a few KB at the tier transition, 1.5-2 MB a
// paged view) a launch and its host issue cost more than the bytes, so each
// call is one launch:
//
//   compact_kernel<true>  every block scans the whole (B,) mask itself (a
//       block scan over 1024 bytes a step, which stops once the block's rows
//       are found) and keeps the source row of each of its output rows in
//       shared memory; block 0 scans to the end for the count.  Then it
//       copies its rows of every leaf (up to kMaxLeaves, a by-value table in
//       the kernel parameters) in 16/8/4/2/1-byte words, all leaves' words
//       one flat range over the block's threads with kUnroll in flight a
//       thread, and zeroes rows past the count.  Each block writes its rows
//       of the index map, block 0 the count.  No carry crosses blocks, so
//       no second launch.
//   compact_kernel<false> the same copy through a given index map (gather_rows).
//   paged_view_kernel     the K and the V view of one layer's paged pool in
//       one launch: one block per (member, slot, head, page) tile and pool
//       copies the contiguous page_size x hd tile from the pool to the
//       view's (E*B, KVH, n_pg*page_size, hd) layout, zeros where the page
//       table says -1.  No index ops and no permute copy around it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 8;        // leaves one launch copies
constexpr int kMaxRowsPerBlock = 256;
constexpr int kScanStep = 4 * kThreads;  // mask bytes a block scans a step
constexpr int kUnroll = 4;               // words in flight a thread

struct Leaf {
  const char* src;
  char* dst;
  long long row_bytes;
  int word;  // bytes a copied word: 16, 8, 4, 2 or 1
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int n;
};

__device__ __forceinline__ uint4 load_word(const char* p, int word) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  switch (word) {
    case 16: r = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.x = v.x;
      r.y = v.y;
      break;
    }
    case 4: r.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: r.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: r.x = *reinterpret_cast<const uint8_t*>(p); break;
  }
  return r;
}

__device__ __forceinline__ void store_word(char* p, int word, uint4 v) {
  switch (word) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v.x; break;
    default: *reinterpret_cast<uint8_t*>(p) = (uint8_t)v.x; break;
  }
}

// Rows [r0, r0 + rows) of every leaf, row r from source row smap[r] (a zero
// row where smap[r] < 0).  The block's (leaf, row, word) triples form one
// flat range, so a small leaf takes other threads than a large one and each
// thread keeps kUnroll words in flight: no leaf's loads wait for another's.
__device__ __forceinline__ void copy_leaves(const Leaves& lv, const int* smap, long long r0, int rows) {
  int ends[kMaxLeaves];  // leaf l's words end at ends[l] of the flat range
  int total = 0;
#pragma unroll
  for (int l = 0; l < kMaxLeaves; ++l) {
    if (l < lv.n) total += (int)(lv.leaf[l].row_bytes / lv.leaf[l].word) * rows;
    ends[l] = total;
  }
  for (int base = threadIdx.x; base < total; base += kUnroll * kThreads) {
    uint4 v[kUnroll];
    char* dst[kUnroll];
    int word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kThreads;
      dst[u] = nullptr;
      if (w >= total) continue;
      // word w's leaf, picked by selects rather than an indexed parameter table
      int first = 0;
      Leaf lf = lv.leaf[0];
#pragma unroll
      for (int l = 1; l < kMaxLeaves; ++l)
        if (w >= ends[l - 1]) {
          first = ends[l - 1];
          lf = lv.leaf[l];
        }
      const int words = (int)(lf.row_bytes / lf.word), i = w - first, r = i / words, c = i - r * words;
      const int s = smap[r];
      word[u] = lf.word;
      dst[u] = lf.dst + ((r0 + r) * words + c) * lf.word;
      v[u] = s >= 0 ? load_word(lf.src + ((long long)s * words + c) * lf.word, lf.word)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (dst[u]) store_word(dst[u], word[u], v[u]);
  }
}

// The exclusive prefix of the mask, by the whole block: smap[d - r0] = i for
// every deferred row i whose rank d falls in [r0, r0 + rows), -1 for the
// block's rows past the count.  Stops once the block's rows are found unless
// ``full``; returns the count when it scanned to the end.
__device__ int scan_block(const uint8_t* __restrict__ mask, int B, int r0, int rows, int* smap,
                          bool full) {
  __shared__ int warp_tot[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int r = t; r < rows; r += kThreads) smap[r] = -1;
  __syncthreads();
  int carry = 0;  // deferred rows before this step: the same in every thread
  for (int base = 0; base < B; base += kScanStep) {
    if (!full && carry >= r0 + rows) break;
    const int i0 = base + 4 * t;
    int bits = 0, c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < B && mask[i0 + k]) {
        bits |= 1 << k;
        ++c;
      }
    int x = c;  // inclusive scan of the per-thread counts within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    int before = 0, step = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int v = warp_tot[w];
      before += w < warp ? v : 0;
      step += v;
    }
    int d = carry + before + x - c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (bits >> k & 1) {
        if (d >= r0 && d < r0 + rows) smap[d - r0] = i0 + k;
        ++d;
      }
    carry += step;
    __syncthreads();  // warp_tot is written again next step
  }
  return carry;
}

template <bool SCAN>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const uint8_t* __restrict__ mask, int B, int* __restrict__ index_map,
                   int* __restrict__ count, int rows_out, int rows_per_block, int write_map,
                   Leaves leaves) {
  __shared__ int smap[kMaxRowsPerBlock];
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = max(0, min(rows_per_block, rows_out - r0));
  if (SCAN) {
    const int total = scan_block(mask, B, r0, rows, smap, write_map && blockIdx.x == 0);
    if (write_map) {
      if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
      for (int r = threadIdx.x; r < rows; r += kThreads) index_map[r0 + r] = smap[r];
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += kThreads) smap[r] = index_map[r0 + r];
    __syncthreads();
  }
  copy_leaves(leaves, smap, r0, rows);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    paged_view_kernel(const W* __restrict__ k_pool, const W* __restrict__ v_pool,
                      const int* __restrict__ pages, W* __restrict__ k_out, W* __restrict__ v_out,
                      int P, int KVH, int B, int n_pg, int tile_words) {
  const long long tile = blockIdx.x;  // ((e * B + b) * KVH + h) * n_pg + j
  const int j = (int)(tile % n_pg);
  const long long ebh = tile / n_pg;
  const int h = (int)(ebh % KVH);
  const long long eb = ebh / KVH;
  const int b = (int)(eb % B), e = (int)(eb / B);
  const int page = pages[(long long)b * n_pg + j];
  W* dst = (blockIdx.y ? v_out : k_out) + tile * tile_words;
  if (page < 0) {
    for (int w = threadIdx.x; w < tile_words; w += kThreads) dst[w] = W{};
    return;
  }
  const W* src = (blockIdx.y ? v_pool : k_pool) + ((long long)(e * P + page) * KVH + h) * tile_words;
  for (int w = threadIdx.x; w < tile_words; w += kUnroll * kThreads) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (w + u * kThreads < tile_words) v[u] = src[w + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (w + u * kThreads < tile_words) dst[w + u * kThreads] = v[u];
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

bool valid_word(long long word) {
  return word == 16 || word == 8 || word == 4 || word == 2 || word == 1;
}

// Launches for ``n_leaves`` leaves described by ``desc`` (4 int64 a leaf:
// src, dst, row_bytes, word bytes), kMaxLeaves a launch; the first launch
// writes the index map and the count (scan) — with no leaves it is the only
// one.  Rows are shared out so about two blocks an SM run.
int launch_compact(bool scan, const uint8_t* mask, int B, int* index_map, int* count, int rows_out,
                   const long long* desc, int n_leaves, cudaStream_t s) {
  const int target = 2 * sm_count();
  const int rpb = std::max(1, std::min(kMaxRowsPerBlock, (rows_out + target - 1) / target));
  const int grid = std::max(1, (rows_out + rpb - 1) / rpb);
  int done = 0;
  do {
    Leaves lv{};
    lv.n = std::min(kMaxLeaves, n_leaves - done);
    long long words = 0;  // a block's flat (leaf, row, word) range must fit an int
    for (int l = 0; l < lv.n; ++l) {
      const long long* d = desc + 4 * (done + l);
      if (!valid_word(d[3]) || d[2] % d[3] || (words += d[2] / d[3] * rpb) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
      lv.leaf[l] = Leaf{reinterpret_cast<const char*>(d[0]), reinterpret_cast<char*>(d[1]), d[2], (int)d[3]};
    }
    if (scan)
      compact_kernel<true><<<grid, kThreads, 0, s>>>(mask, B, index_map, count, rows_out, rpb, done == 0, lv);
    else
      compact_kernel<false><<<grid, kThreads, 0, s>>>(nullptr, 0, index_map, nullptr, rows_out, rpb, 0, lv);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    done += lv.n;
  } while (done < n_leaves);
  return 0;
}

template <typename W>
void launch_view(const void* k_pool, const void* v_pool, const int* pages, void* k_out, void* v_out,
                 long long tiles, int P, int KVH, int B, int n_pg, int tile_words, cudaStream_t s) {
  paged_view_kernel<W><<<dim3((unsigned)tiles, 2), kThreads, 0, s>>>(
      (const W*)k_pool, (const W*)v_pool, pages, (W*)k_out, (W*)v_out, P, KVH, B, n_pg, tile_words);
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// mask (B,) bool -> index_map (B,) i32, count () i32, and for every leaf its
// compacted rows: dst row d = src row index_map[d], zero past the count.
// Launches max(1, ceil(n_leaves / 8)) kernels.
extern "C" int compaction_compact(const void* mask, int B, void* index_map, void* count,
                                  const long long* leaves, int n_leaves, void* stream) {
  return launch_compact(true, (const uint8_t*)mask, B, (int*)index_map, (int*)count, B, leaves,
                        n_leaves, (cudaStream_t)stream);
}

// dst row d = src row index_map[d] (rows_out rows), zero where index_map[d] < 0.
extern "C" int compaction_gather(const void* index_map, int rows_out, const long long* leaves,
                                 int n_leaves, void* stream) {
  if (rows_out <= 0 || n_leaves <= 0) return (int)cudaGetLastError();
  return launch_compact(false, nullptr, 0, (int*)index_map, nullptr, rows_out, leaves, n_leaves,
                        (cudaStream_t)stream);
}

// Pools (E, P, KVH, ps, hd) under one (B, n_pg) i32 table (-1 = unmapped)
// -> views (E*B, KVH, n_pg*ps, hd) of each; tile_bytes = ps*hd*itemsize,
// ``word`` in {16, 8, 4, 2, 1} divides it and aligns every pointer.
extern "C" int compaction_paged_kv_view(const void* k_pool, const void* v_pool, const void* pages,
                                        void* k_out, void* v_out, int E, int P, int KVH, int B,
                                        int n_pg, long long tile_bytes, int word, void* stream) {
  const long long tiles = (long long)E * B * KVH * n_pg;
  if (tiles == 0) return (int)cudaGetLastError();
  if (!valid_word(word) || tile_bytes % word || tile_bytes / word >= (1LL << 31) || tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int tw = (int)(tile_bytes / word);
  const int* pg = (const int*)pages;
  cudaStream_t s = (cudaStream_t)stream;
  switch (word) {
    case 16: launch_view<uint4>(k_pool, v_pool, pg, k_out, v_out, tiles, P, KVH, B, n_pg, tw, s); break;
    case 8: launch_view<uint2>(k_pool, v_pool, pg, k_out, v_out, tiles, P, KVH, B, n_pg, tw, s); break;
    case 4: launch_view<uint32_t>(k_pool, v_pool, pg, k_out, v_out, tiles, P, KVH, B, n_pg, tw, s); break;
    case 2: launch_view<uint16_t>(k_pool, v_pool, pg, k_out, v_out, tiles, P, KVH, B, n_pg, tw, s); break;
    default: launch_view<uint8_t>(k_pool, v_pool, pg, k_out, v_out, tiles, P, KVH, B, n_pg, tw, s); break;
  }
  return (int)cudaGetLastError();
}
