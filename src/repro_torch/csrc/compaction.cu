// Deferral compaction: defer mask -> exclusive prefix sum -> index map and
// count, then a byte-exact row gather of the payload through the map.
//
// Replaces: src/repro/kernels/compaction/kernel.py compact_pallas (body
// _compact_kernel).  The TPU kernel expresses the row permutation as a
// one-hot (B, B) matmul on the MXU, exact only for float payloads; here the
// permutation is a scan plus a row copy, exact for every dtype.
//
// Bound on the H100: bytes — the payload is read once and written once
// (plus B mask bytes and B index-map words); there is no arithmetic to
// speak of.  Design: launch 1 is a single block of 1024 threads that scans
// the mask in chunks of 1024 (warp-shuffle scans, a carry across chunks),
// scatters each deferred row's source index to its compacted slot, writes
// -1 past the count and the count itself — all on the device.  Launch 2
// copies row index_map[d] of x to row d of out (zero rows where the map is
// -1), one block per output row, in 16-, 4-, 2- or 1-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;

__global__ void scan_kernel(const uint8_t* __restrict__ mask, int* __restrict__ index_map,
                            int* __restrict__ count, int B) {
  __shared__ int warp_sums[32];
  __shared__ int carry_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) carry_s = 0;
  __syncthreads();
  for (int base = 0; base < B; base += kScanThreads) {
    const int i = base + t;
    const int v = (i < B && mask[i]) ? 1 : 0;
    int x = v;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int carry = carry_s;
    const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (v) index_map[carry + excl] = i;
    __syncthreads();  // every thread has read carry_s and warp_sums
    if (t == 0) carry_s = carry + warp_sums[31];
    __syncthreads();
  }
  const int total = carry_s;
  for (int d = total + t; d < B; d += kScanThreads) index_map[d] = -1;
  if (t == 0) *count = total;
}

template <typename W>
__global__ void gather_kernel(const W* __restrict__ x, const int* __restrict__ index_map,
                              W* __restrict__ out, long words) {
  const long d = blockIdx.x;
  const int src = index_map[d];
  W* o = out + d * words;
  if (src >= 0) {
    const W* s = x + (long)src * words;
    for (long w = threadIdx.x; w < words; w += blockDim.x) o[w] = s[w];
  } else {
    for (long w = threadIdx.x; w < words; w += blockDim.x) o[w] = W{};
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// mask (B,) bool -> index_map (B,) i32, count () i32.
extern "C" int compaction_scan(const void* mask, void* index_map, void* count, int B,
                               void* stream) {
  scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int*)index_map, (int*)count, B);
  return (int)cudaGetLastError();
}

// out[d] = x[index_map[d]] (row_bytes each), zero where index_map[d] < 0.
// word_bytes in {16, 4, 2, 1} divides row_bytes; both pointers are aligned to it.
extern "C" int compaction_gather(const void* x, const void* index_map, void* out, int rows_out,
                                 long row_bytes, int word_bytes, void* stream) {
  if (rows_out <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long words = row_bytes / word_bytes;
  const int threads = words >= 256 ? 256 : (words >= 64 ? 64 : 32);
  const int* im = (const int*)index_map;
  switch (word_bytes) {
    case 16: gather_kernel<uint4><<<rows_out, threads, 0, s>>>((const uint4*)x, im, (uint4*)out, words); break;
    case 4: gather_kernel<uint32_t><<<rows_out, threads, 0, s>>>((const uint32_t*)x, im, (uint32_t*)out, words); break;
    case 2: gather_kernel<uint16_t><<<rows_out, threads, 0, s>>>((const uint16_t*)x, im, (uint16_t*)out, words); break;
    case 1: gather_kernel<uint8_t><<<rows_out, threads, 0, s>>>((const uint8_t*)x, im, (uint8_t*)out, words); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
