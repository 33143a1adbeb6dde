// Row LayerNorm forward and backward over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernels of `fused_layer_norm`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py):
//   - ln_fwd_kernel <- `_ln_fwd_kernel` / `_ln_fwd_call`. Same function: f32
//     two-pass statistics (mu = mean(x), var = mean((x - mu)^2)),
//     rs = rsqrt(var + eps), y = (x - mu) * rs * gamma + beta written
//     directly in the output type, and, when the caller passes them (the
//     training path), mu and rs per row in f32 as the TPU kernel writes them;
//   - ln_bwd_kernel <- `_ln_bwd_kernel` / `_ln_bwd_call`. Same function:
//     xhat = (x - mu) * rs, dxhat = dy * gamma,
//     dx = rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) in x's
//     type, and per-block partial sums of dgamma = sum(dy * xhat) and
//     dbeta = sum(dy), which the caller sums (the TPU path sums its
//     per-block partials outside the kernel too).
//
// What bounds them: bytes. The forward reads each row once and writes it
// once (2 * N * D * elem bytes; gamma and beta are shared by all rows),
// the backward reads x and dy and writes dx, with a handful of FLOPs per
// element either way. At GptMini's serving shapes (N <= 128 rows of
// D = 128) that is at most 128 KB, under a microsecond at 3.35 TB/s, so a
// launch costs more than the work; at BertBase training (N = 8192,
// D = 768) the backward moves 40 MB, about 12 us.
// The design: one warp per row. Lanes stride across the row, so every
// pass is a coalesced read; the passes re-read the row from L1, which
// holds it. The backward's blocks take 32 consecutive rows each (8 per
// warp); every warp sums its rows' dgamma / dbeta terms into its own
// shared-memory row, and the block adds its 4 warp rows in a fixed order
// into one partial row: no atomics, so results repeat bit for bit.
// Any (N, D) works: the TPU kernel's fallback for shapes with no legal
// Mosaic tiling has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_fwd_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, TOut* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rs_out,
              long long N, int D, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const TIn* xr = x + row * D;
  TOut* yr = y + row * D;
  const float inv_d = 1.f / static_cast<float>(D);

  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32(xr[d]);
  const float mu = warp_sum(s) * inv_d;

  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_f32(xr[d]) - mu;
    ss += c * c;
  }
  const float rs = rsqrtf(warp_sum(ss) * inv_d + eps);

  for (int d = lane; d < D; d += 32)
    yr[d] = from_f32<TOut>((to_f32(xr[d]) - mu) * rs * gamma[d] + beta[d]);
  if (lane == 0 && mu_out != nullptr) {
    mu_out[row] = mu;
    rs_out[row] = rs;
  }
}

constexpr int kBwdWarps = 4;
constexpr int kBwdRowsPerBlock = 32;

template <typename TX, typename TDY>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd_kernel(const TX* __restrict__ x, const TDY* __restrict__ dy,
              const float* __restrict__ mu, const float* __restrict__ rs,
              const float* __restrict__ gamma, TX* __restrict__ dx,
              float* __restrict__ dg_part, float* __restrict__ db_part,
              long long N, int D) {
  extern __shared__ float sums[];  // [kBwdWarps][2][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dg = sums + warp * 2 * D;
  float* db = dg + D;
  for (int d = lane; d < D; d += 32) dg[d] = db[d] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);
  const long long row0 = static_cast<long long>(blockIdx.x) * kBwdRowsPerBlock;
  for (int r = warp; r < kBwdRowsPerBlock; r += kBwdWarps) {
    const long long row = row0 + r;
    if (row >= N) break;
    const TX* xr = x + row * D;
    const TDY* dyr = dy + row * D;
    const float m = mu[row], s = rs[row];
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xh = (to_f32(xr[d]) - m) * s;
      const float g = to_f32(dyr[d]);
      const float dxh = g * gamma[d];
      s1 += dxh;
      s2 += dxh * xh;
      dg[d] += g * xh;  // each lane owns its columns: no race
      db[d] += g;
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    TX* dxr = dx + row * D;
    for (int d = lane; d < D; d += 32) {
      const float xh = (to_f32(xr[d]) - m) * s;
      const float dxh = to_f32(dyr[d]) * gamma[d];
      dxr[d] = from_f32<TX>(s * (dxh - m1 - xh * m2));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += 32 * kBwdWarps) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) {
      a += sums[w * 2 * D + d];
      b += sums[w * 2 * D + D + d];
    }
    dg_part[static_cast<long long>(blockIdx.x) * D + d] = a;
    db_part[static_cast<long long>(blockIdx.x) * D + d] = b;
  }
}

struct FwdArgs {
  const void* x;
  const float *gamma, *beta;
  void* y;
  float *mu, *rs;
  long long N;
  int D;
  float eps;
  cudaStream_t stream;
};

template <typename TIn, typename TOut>
cudaError_t launch_fwd(const FwdArgs& a) {
  const long long blocks = (a.N + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<TIn, TOut><<<static_cast<unsigned>(blocks),
                             32 * kRowsPerBlock, 0, a.stream>>>(
      static_cast<const TIn*>(a.x), a.gamma, a.beta, static_cast<TOut*>(a.y),
      a.mu, a.rs, a.N, a.D, a.eps);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *dy;
  const float *mu, *rs, *gamma;
  void* dx;
  float *dg_part, *db_part;
  long long N;
  int D;
  cudaStream_t stream;
};

int bwd_smem(int D) { return kBwdWarps * 2 * D * static_cast<int>(sizeof(float)); }

template <typename TX, typename TDY>
cudaError_t launch_bwd(const BwdArgs& a) {
  static int allowed = 48 * 1024;  // opted-in dynamic shared memory so far
  const int smem = bwd_smem(a.D);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<TX, TDY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const long long blocks = (a.N + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  ln_bwd_kernel<TX, TDY><<<static_cast<unsigned>(blocks), 32 * kBwdWarps,
                           smem, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TDY*>(a.dy), a.mu, a.rs,
      a.gamma, static_cast<TX*>(a.dx), a.dg_part, a.db_part, a.N, a.D);
  return cudaGetLastError();
}

// Runs L<T1, T2> for the two type codes (0 = float32, 1 = bfloat16).
template <template <typename, typename> class L, typename A>
int by_types(int t1, int t2, const A& a) {
  cudaError_t err = cudaErrorInvalidValue;
  if (t1 == 0 && t2 == 0) err = L<float, float>::run(a);
  if (t1 == 0 && t2 == 1) err = L<float, __nv_bfloat16>::run(a);
  if (t1 == 1 && t2 == 0) err = L<__nv_bfloat16, float>::run(a);
  if (t1 == 1 && t2 == 1) err = L<__nv_bfloat16, __nv_bfloat16>::run(a);
  return static_cast<int>(err);
}
template <typename A, typename B>
struct Fwd {
  static cudaError_t run(const FwdArgs& a) { return launch_fwd<A, B>(a); }
};
template <typename A, typename B>
struct Bwd {
  static cudaError_t run(const BwdArgs& a) { return launch_bwd<A, B>(a); }
};

bool bad_shape(long long N, int D) {
  return N < 1 || D < 1 || N > 4LL * 0x7fffffffLL;
}

}  // namespace

extern "C" {

// x (N, D) and y (N, D) are row-major contiguous; gamma and beta are (D,)
// float32; mu and rs are (N,) float32 outputs, or both null (the serving
// path needs neither). Types: 0 = float32, 1 = bfloat16. Returns the
// launch's cudaError_t (0 on success).
int pdtn_layer_norm_fwd(int in_dtype, int out_dtype, const void* x,
                        const float* gamma, const float* beta, void* y,
                        float* mu, float* rs, long long N, int D, float eps,
                        void* stream) {
  if (bad_shape(N, D) || (mu == nullptr) != (rs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, gamma, beta, y, mu, rs, N, D, eps,
                  static_cast<cudaStream_t>(stream)};
  return by_types<Fwd>(in_dtype, out_dtype, a);
}

// Rows per block of the backward: dg_part and db_part are
// (ceil(N / rows), D) float32.
int pdtn_layer_norm_bwd_rows_per_block() { return kBwdRowsPerBlock; }

// x (N, D) in x_dtype, dy (N, D) in dy_dtype, both row-major contiguous;
// mu, rs (N,) and gamma (D,) float32. Writes dx (N, D) in x_dtype and the
// per-block partial sums dg_part, db_part.
int pdtn_layer_norm_bwd(int x_dtype, int dy_dtype, const void* x,
                        const void* dy, const float* mu, const float* rs,
                        const float* gamma, void* dx, float* dg_part,
                        float* db_part, long long N, int D, void* stream) {
  if (bad_shape(N, D) || bwd_smem(D) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dy, mu, rs, gamma, dx, dg_part, db_part, N, D,
                  static_cast<cudaStream_t>(stream)};
  return by_types<Bwd>(x_dtype, dy_dtype, a);
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
