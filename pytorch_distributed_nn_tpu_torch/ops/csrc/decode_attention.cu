// Single-position decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_attn_kernel` / `pallas_decode_attention`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py). Same function: one
// query row per (batch, head) against the cached K/V panel, keys with index
// > positions[b] masked out, softmax with f32 statistics
// (m = max, p = exp(s - m), l = max(sum p, 1e-30)), out = (p / l) @ V with
// the probabilities rounded to the cache type and an f32 accumulator.
//
// What bounds it: the K/V panel read, 2 * (pos + 1) * D elements per
// (batch, head) -- a memory-bound operation with about one FLOP per byte.
// At GptMini shapes (B <= 8, S <= 128, H = 4, D = 32) that is at most
// 256 KB, well under a microsecond at 3.35 TB/s, so a launch costs more
// than the work. The design reads only what the data needs:
//   - one block per (batch, head); the loop over keys stops at
//     positions[b], so dead rows of the page are never read;
//   - the cache is read in place through its (B, S, H, D) strides: no
//     transposed copy per step (the TPU kernel's (B*H, S, D) relayout was a
//     tiling need of Mosaic);
//   - scores: one thread per key, all keys of the panel at once (S <= 256
//     in one pass), each thread's D loads independent of one another, so
//     the loads of the whole panel are in flight together. (A first
//     version gave each warp one key at a time with a shuffle reduction
//     per key: a serial chain whose time grew with S, 17 us at S = 128.)
//   - scores live in shared memory; the block-wide max and sum are warp
//     shuffles plus one shared-memory pass;
//   - P @ V: each warp takes every kWarps-th key, its lanes read D
//     contiguous elements (one coalesced 128-byte load at D = 32 f32),
//     the key loop unrolled so several loads are in flight; per-warp
//     sums in registers are reduced across warps in shared memory.
// Positions must lie in [0, S): the engine guarantees it (padding rows use
// position 0 of the scratch page).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxDPerLane = kMaxD / 32;

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
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ positions,
                   T* __restrict__ out, int H, int S, int D,
                   long long q_sb, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // D
  float* part = q_s + D;             // kWarps * D
  float* red = part + kWarps * D;    // kWarps
  float* sc = red + kWarps;          // S

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(positions[b] + 1, S);  // live keys 0..positions[b]

  const T* qp = q + b * q_sb + h * q_sh;
  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f32(qp[d]);
  __syncthreads();

  // scores: one thread per key
  const T* kp = k + b * k_sb + h * k_sh;
  for (int j = tid; j < n; j += kThreads) {
    const T* row = kp + j * k_ss;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc += q_s[d] * to_f32(row[d]);
    sc[j] = acc * scale;
  }
  __syncthreads();

  // block max
  float m = -INFINITY;
  for (int j = tid; j < n; j += kThreads) m = fmaxf(m, sc[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();

  // p = exp(s - m) and its block sum
  float l = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    float p = expf(sc[j] - m);
    sc[j] = p;
    l += p;
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
  for (int w = 0; w < kWarps; ++w) l += red[w];
  const float inv_l = 1.f / fmaxf(l, 1e-30f);

  // out = (p / l) @ V: per-warp partial sums over its keys, lanes across D
  float acc[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) acc[i] = 0.f;
  const T* vp = v + b * v_sb + h * v_sh;
#pragma unroll 4
  for (int j = warp; j < n; j += kWarps) {
    // probabilities are rounded to the cache type, as the reference does
    const float w = to_f32(from_f32<T>(sc[j] * inv_l));
    const T* row = vp + j * v_ss;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] += w * to_f32(row[d]);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part[warp * D + d] = acc[i];
  }
  __syncthreads();
  T* op = out + (static_cast<long long>(b) * H + h) * D;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += part[w * D + d];
    op[d] = from_f32<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* positions, void* out, int B, int H, int S,
                   int D, long long q_sb, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D + kWarps * D + kWarps + S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  decode_attn_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), positions, static_cast<T*>(out), H, S, D,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (D) axis of q, k and v must be contiguous. out is (B, 1, H, D)
// contiguous. Returns the launch's cudaError_t (0 on success).
int pdtn_decode_attention(int dtype, const void* q, const void* k,
                          const void* v, const int* positions, void* out,
                          int B, int H, int S, int D, long long q_sb,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, float scale, void* stream) {
  if (D > kMaxD || D < 1 || S < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, positions, out, B, H, S,
                                          D, q_sb, q_sh, k_sb, k_ss, k_sh,
                                          v_sb, v_ss, v_sh, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k, v, positions, out, B, H, S, D, q_sb, q_sh, k_sb, k_ss, k_sh,
        v_sb, v_ss, v_sh, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
