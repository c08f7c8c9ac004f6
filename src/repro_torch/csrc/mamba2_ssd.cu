// Mamba2 SSD (state-space dual) scan, for the pre-scaled inputs
// x~ = dt*x (B, S, H, P) f32 and l = A*dt (B, S, H) f32 (<= 0), B and C
// (B, S, G, N) f32 (head h reads group h / (H / G)), and an optional
// initial state h0 (B, H, N, P) f32.  Writes y (B, S, H, P) in bf16 or f32
// and the final state hT (B, H, N, P) f32.
//
//   h_t = exp(l_t) h_{t-1} + B_t x~_t^T,   y_t = C_t^T h_t
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py ssd_pallas (body
// _ssd_kernel), which needs S % chunk == 0 and computes each 128-step chunk
// in the dual form on the MXU: (C B^T * exp(cum_t - cum_s)) x~, plus
// C exp(cum) h, and h exp(total) + (B exp(total - cum))^T x~.
//
// Bound on the H100: on this design, the f32 operations (3 N P per step
// and head, on the CUDA cores); the bytes (x~, l, B, C in, y out, read and
// written once) bound it only on the tensor cores, which a later version
// would reach with the chunked dual form.  Design: the chunk-length-1 form
// of the same function, which does the fewest operations (3 N P a step,
// against L N + L P + 2 N P for the dual form at chunk L) and needs no
// L x L tile.  One block of P threads per (row, head): thread p owns column
// p of the (N, P) state in registers, so y_t[p] = sum_n C_t[n] h[n][p] needs
// no reduction across threads.  CH steps of x~, exp(l), B and C are staged
// through shared memory per pass; every exponent is a single l_t <= 0.  Any
// S, with a ragged last pass and no padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 32, PMAX = 128;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <int N, typename OutT>
__global__ void __launch_bounds__(PMAX)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ l,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ h0, OutT* __restrict__ y, float* __restrict__ hT, int S,
               int H, int P, int G) {
  __shared__ float xs[CH][PMAX];
  __shared__ float bs[CH][N], cs[CH][N], as[CH];
  const int h = blockIdx.x, b = blockIdx.y, p = threadIdx.x;
  const int g = h / (H / G);
  const long hbase = ((long)b * H + h) * N * P + p;

  float hs[N];
#pragma unroll
  for (int n = 0; n < N; ++n) hs[n] = h0 ? h0[hbase + (long)n * P] : 0.f;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int m = min(CH, S - t0);
    __syncthreads();  // the previous pass is consumed
    const long row0 = (long)b * S + t0;  // (b, t0) in the (B, S) grid
    for (int c = p; c < m * N; c += P) {
      const int tt = c / N, n = c % N;
      const long off = ((row0 + tt) * G + g) * N + n;
      bs[tt][n] = Bm[off];
      cs[tt][n] = Cm[off];
    }
    for (int tt = p; tt < m; tt += P) as[tt] = expf(l[(row0 + tt) * H + h]);
    for (int tt = 0; tt < m; ++tt) xs[tt][p] = x[((row0 + tt) * H + h) * P + p];
    __syncthreads();
    for (int tt = 0; tt < m; ++tt) {
      const float a = as[tt], xv = xs[tt][p];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hs[n] = hs[n] * a + bs[tt][n] * xv;
        acc += cs[tt][n] * hs[n];
      }
      store(y + ((row0 + tt) * H + h) * P + p, acc);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hT[hbase + (long)n * P] = hs[n];
}

template <int N, typename OutT>
int launch(const void* x, const void* l, const void* Bm, const void* Cm, const void* h0, void* y,
           void* hT, int B, int S, int H, int P, int G, cudaStream_t stream) {
  ssd_kernel<N, OutT><<<dim3(H, B), P, 0, stream>>>(
      (const float*)x, (const float*)l, (const float*)Bm, (const float*)Cm, (const float*)h0,
      (OutT*)y, (float*)hT, S, H, P, G);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(int N, const void* x, const void* l, const void* Bm, const void* Cm, const void* h0,
             void* y, void* hT, int B, int S, int H, int P, int G, cudaStream_t s) {
  if (N == 64) return launch<64, OutT>(x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
  if (N == 32) return launch<32, OutT>(x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
  if (N == 16) return launch<16, OutT>(x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
  if (N == 8) return launch<8, OutT>(x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// h0 may be null (zero initial state); bf16_out != 0: y is bf16, else f32.
// S == 0 writes hT = h0 (or zeros).
extern "C" int mamba2_ssd_fwd(const void* x, const void* l, const void* Bm, const void* Cm,
                              const void* h0, void* y, void* hT, int B, int S, int H, int P,
                              int G, int N, int bf16_out, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  if (P < 1 || P > PMAX || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_out) return dispatch<bf16>(N, x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
  return dispatch<float>(N, x, l, Bm, Cm, h0, y, hT, B, S, H, P, G, s);
}
