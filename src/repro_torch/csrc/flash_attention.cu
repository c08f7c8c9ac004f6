// Flash attention forward (prefill) for bf16 q (B, Sq, H, hd) and k, v
// (B, Sk, KVH, hd), GQA by h / (H / KVH), hd in {64, 80, 128} (80: zamba2's
// shared attention, 5 k-steps and 10 n-tiles of the m16n8k16 product; its
// rows are 160 bytes, so the 16-byte row loads hold).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py flash_attention_bhsd
// (body _flash_kernel), which needs Sq % block_q == 0 and Sk % block_k == 0.
//
// Bound on the H100: operations for long sequences (4*Sq*Sk*hd per head,
// halved when causal, on the bf16 tensor cores), bytes for short ones.
// Design (the FlashAttention-2 register layout): one block of 4 warps per
// (b, h, 64-row q tile); each warp owns 16 q rows.  Q fragments stay in
// registers; 64-row K and V tiles are staged through shared memory one
// after another.  S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in,
// f32 accumulate) with S, P and O held in registers in the accumulator
// layout, so the f32 online softmax (scale, tanh softcap, causal / window /
// starts masks as one visible key range per row, ragged Sk) rescales O in
// place and P feeds the second product without touching shared memory.
// K tiles that are wholly acausal, wholly outside the window, or wholly
// below the row's start are never loaded.  Rows with no visible key (pure
// left padding) end with l == 0 and emit zeros.  Rows and keys past the
// end load as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BK = 64, NT = 128;

template <int HD>
struct Layout {
  static constexpr int LQ = HD + 8;  // bf16 row stride of Q, K, V: conflict-free fragment loads
  static constexpr size_t bytes = sizeof(bf16) * (BQ + 2 * BK) * LQ;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// d += a (16x16, row) * b (16x8, col); the PTX fragment layouts:
// lane = 4 g + t; a regs: (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
// b regs: (k 2t.., n g), (k 2t+8.., n g); d: (g, 2t..), (g+8, 2t..).
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long row_stride, int rows,
                                          int n_valid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CH; c += NT) {
    const int r = c / CH, cc = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * Layout<HD>::LQ + cc * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const int* __restrict__ starts, int Sq, int Sk, int H, int KVH, int causal,
                     int window, float softcap, float scale) {
  constexpr int LQ = Layout<HD>::LQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LQ;
  bf16* Vs = Ks + BK * LQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int start = starts ? max(starts[b], 0) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const long q_row = (long)H * HD, kv_row = (long)KVH * HD;

  load_rows<HD>(Qs, q + ((long)b * Sq + q0) * q_row + (long)h * HD, q_row, BQ, Sq - q0);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* p = Qs + (r0 + g) * LQ + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LQ);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LQ + 8);
  }

  // this lane's two rows (g and g + 8 of the warp's 16): visible keys [lo, hi)
  int lo[2], hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + g + 8 * rr;
    lo[rr] = window > 0 ? max(start, qi - window + 1) : start;
    hi[rr] = qi < Sq ? min(Sk, causal ? qi + 1 : Sk) : lo[rr];
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = start;
  if (window > 0) k_lo = max(k_lo, q0 - window + 1);
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K and V are consumed
    const long kv_off = ((long)b * Sk + k0) * kv_row + (long)kvh * HD;
    load_rows<HD>(Ks, k + kv_off, kv_row, BK, k_hi - k0);
    load_rows<HD>(Vs, v + kv_off, kv_row, BK, k_hi - k0);
    __syncthreads();

    // S = Q K^T: 8 tiles of 16 rows x 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kp = Ks + (j * 8 + g) * LQ + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) mma(s[j], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    // online softmax; a row's 64 scores live in the 4 lanes of its group
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, kj = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = (kj >= lo[rr] && kj < hi[rr]) ? x : -INFINITY;
        s[j][e] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = m_new == -INFINITY ? 1.f : (m[rr] == -INFINITY ? 0.f : expf(m[rr] - m_new));
      m[rr] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const float p = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[rr]);
        s[j][e] = p;
        psum[rr] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + psum[rr];  // lane-partial sums
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A layout of the next product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vp = Vs + (kk * 16 + 2 * t) * LQ + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* c = vp + n * 8;
        mma(acc[n], pa, pack(c[0], c[LQ]), pack(c[8 * LQ], c[9 * LQ]));
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qi = q0 + r0 + g + 8 * rr;
    if (qi < Sq) {
      const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
      bf16* op = o + ((long)b * Sq + qi) * q_row + (long)h * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * rr] * inv, acc[n][2 * rr + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, const void* starts, int B, int Sq,
           int Sk, int H, int KVH, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t bytes = Layout<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, NT, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const int*)starts, Sq, Sk, H, KVH,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// window <= 0: no window; softcap <= 0: no softcap; starts may be null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const void* starts, int B, int Sq, int Sk, int H, int KVH,
                                   int hd, int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 128)
    return launch<128>(q, k, v, o, starts, B, Sq, Sk, H, KVH, causal, window, softcap, scale, s);
  if (hd == 80)
    return launch<80>(q, k, v, o, starts, B, Sq, Sk, H, KVH, causal, window, softcap, scale, s);
  if (hd == 64)
    return launch<64>(q, k, v, o, starts, B, Sq, Sk, H, KVH, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
