// Row LayerNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_fwd_kernel` / `_ln_fwd_call`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py), reached through
// `fused_layer_norm`. Same function: f32 two-pass statistics
// (mu = mean(x), var = mean((x - mu)^2)), rs = rsqrt(var + eps),
// y = (x - mu) * rs * gamma + beta written directly in the output type.
//
// What bounds it: bytes. Each row is read once and written once
// (2 * N * D * elem bytes, gamma and beta are shared by all rows); the
// arithmetic is a handful of FLOPs per element. At GptMini shapes
// (N <= 128 rows of D = 128) that is at most 128 KB, far under a
// microsecond at 3.35 TB/s, so a launch costs more than the work.
// The design: one warp per row, four rows per block. Lanes stride across
// the row, so every pass is a coalesced read; the three passes (sum,
// centred square sum, normalise) re-read the row from L1, which holds it.
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
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, long long N, int D, float eps,
                   cudaStream_t stream) {
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<TIn, TOut><<<static_cast<unsigned>(blocks),
                             32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const TIn*>(x), gamma, beta, static_cast<TOut*>(y), N, D,
      eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, D) and y (N, D) are row-major contiguous; gamma and beta are (D,)
// float32. Types: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 on success).
int pdtn_layer_norm_fwd(int in_dtype, int out_dtype, const void* x,
                        const float* gamma, const float* beta, void* y,
                        long long N, int D, float eps, void* stream) {
  if (N < 1 || D < 1 || N > 4LL * 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return static_cast<int>(
        launch<float, float>(x, gamma, beta, y, N, D, eps, st));
  if (in_dtype == 0 && out_dtype == 1)
    return static_cast<int>(
        launch<float, __nv_bfloat16>(x, gamma, beta, y, N, D, eps, st));
  if (in_dtype == 1 && out_dtype == 0)
    return static_cast<int>(
        launch<__nv_bfloat16, float>(x, gamma, beta, y, N, D, eps, st));
  if (in_dtype == 1 && out_dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, beta, y, N, D, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
