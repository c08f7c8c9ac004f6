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
// Bound on the H100: bytes.  Each input element feeds at most ~3*D
// multiply-adds (the S = 1 decode step and the S = 256 prefill both sit far
// below the f32 ridge), and the state never leaves the chip.
// Design: the exact per-step recurrence, so no pairwise tensor and no
// exponent split (exp(-cum) would overflow f32 under strong decay; here
// every exponent is a single logw <= 0).  One block of D threads per
// (row, head): thread j owns column j of the (D, D) state in registers, so
// y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]) needs no reduction
// across threads.  CH time steps of r, k, v and exp(logw) are staged
// through shared memory per pass (one barrier pair per pass, broadcast
// reads inside it); any S, S = 1 included, with a ragged last pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CH = 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <int D, typename T>
__global__ void __launch_bounds__(D)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT, int S,
                int H, int rows_per_member) {
  __shared__ float rs[CH][D], ks[CH][D], vs[CH][D], ws[CH][D];
  __shared__ float us[D];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long step = (long)H * D;  // elements between two time steps of one row
  const long base = (long)b * S * step + (long)h * D + j;
  const long sbase = ((long)b * H + h) * D * D + j;

  float st[D];
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0 ? s0[sbase + (long)i * D] : 0.f;
  us[j] = u[((long)(b / rows_per_member) * H + h) * D + j];

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous pass is consumed (and us is written)
    for (int tt = 0; tt < n; ++tt) {
      const long off = base + (long)(t0 + tt) * step;
      rs[tt][j] = load(r + off);
      ks[tt][j] = load(k + off);
      vs[tt][j] = load(v + off);
      ws[tt][j] = expf(logw[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[tt][i] * vj;
        acc += rs[tt][i] * (st[i] + us[i] * kv);
        st[i] = st[i] * ws[tt][i] + kv;
      }
      store(y + base + (long)(t0 + tt) * step, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sT[sbase + (long)i * D] = st[i];
}

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* y, void* sT, int B, int S, int H, int rows_per_member,
           cudaStream_t stream) {
  wkv6_kernel<D, T><<<dim3(H, B), D, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw, (const float*)u,
      (const float*)s0, (T*)y, (float*)sT, S, H, rows_per_member);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* r, const void* k, const void* v, const void* logw, const void* u,
             const void* s0, void* y, void* sT, int B, int S, int H, int rpm, cudaStream_t s) {
  if (D == 64) return launch<64, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  if (D == 32) return launch<32, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  if (D == 16) return launch<16, T>(r, k, v, logw, u, s0, y, sT, B, S, H, rpm, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// s0 may be null (zero initial state); bf16 != 0: r, k, v, y are bf16, else f32.
// S == 0 writes sT = s0 (or zeros).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* logw,
                             const void* u, const void* s0, void* y, void* sT, int B, int S,
                             int H, int D, int rows_per_member, int bf16_io, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_io) return dispatch<bf16>(D, r, k, v, logw, u, s0, y, sT, B, S, H, rows_per_member, s);
  return dispatch<float>(D, r, k, v, logw, u, s0, y, sT, B, S, H, rows_per_member, s);
}
