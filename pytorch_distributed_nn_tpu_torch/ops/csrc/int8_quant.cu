// Int8 gradient codec for Hopper (sm_90a): stochastic-rounding quantize
// with a given scale, quantize with its own scale, and dequantize.
//
// Replaces the TPU kernels of the int8 codec
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py):
//   - quant_scaled_kernel <- `quantize_int8_scaled` (`_quant_scaled_kernel_prng`):
//     q = clip(floor(x / scale + u), -127, 127) as int8, scale given (the
//     cross-replica amax / 127 of the gradient collective);
//   - amax_kernel + quant_own_kernel <- `quantize_int8` (`_quant_kernel_prng`):
//     amax = max |x|, scale = amax * f32(1/127) (1 when amax is 0; XLA's
//     form of the TPU program's amax / 127), then the same rounding; the
//     scale is written beside q;
//   - dequant_kernel <- `dequantize_int8` (`_dequant_kernel`): q * scale in f32.
//
// Noise. The TPU kernels draw u from the chip's own generator, which has
// no counterpart here. These kernels draw it from Philox4x32-10 written
// out below: element i takes word (i & 3) of Philox(counter = (i >> 2,
// i >> 34, 0, 0), key = (seed, 0)), and u = (bits >> 8) * 2^-24, the TPU
// kernel's mapping of 32 random bits onto [0, 1). The plain version
// (ops/reference.py) runs the same generator in integer torch arithmetic,
// so kernel and plain version agree bit for bit. x / scale is IEEE
// division (__fdiv_rn; the build has no fast-math flag).
//
// What bounds them: bytes. Each element is read once as f32 and written
// once as int8 (5 bytes; the own-scale kernel reads x twice, once for
// amax, but L2 holds a gradient leaf of up to 9.4 MB between the passes),
// against 10 Philox rounds per 4 elements, about 40 integer operations an
// element, far under the card's integer rate at 5 bytes an element.
// Design: one thread per 4 consecutive elements, one Philox call for the
// four, a 16-byte load and a 4-byte store when the quad is whole and the
// pointers aligned; a grid-stride loop covers any n, so one launch covers
// a whole leaf (the TPU kernel streamed 131072-element chunks through its
// VMEM; on this card no staging is needed). amax is order-free, so the
// own-scale kernel takes it with atomicMax on the bit patterns of |x|
// (non-negative floats order as their bits), which repeats bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 1/127 rounded to f32: XLA compiles the JAX package's `amax / 127.0` into a
// product with it, so the own-scale kernel multiplies too
constexpr float kRecip127 = 1.0f / 127.0f;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

struct U4 {
  uint32_t v[4];
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  U4 out;
  out.v[0] = c0;
  out.v[1] = c1;
  out.v[2] = c2;
  out.v[3] = c3;
  return out;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ int8_t round_stochastic(float x, float scale,
                                                   float u) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// The quantize body of both quantize kernels: every quad of x, grid-stride.
__device__ __forceinline__ void quantize_quads(const float* __restrict__ x,
                                               int8_t* __restrict__ q,
                                               long long n, float scale,
                                               uint32_t seed, bool aligned) {
  const long long quads = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < quads; t += stride) {
    const U4 r = philox4x32_10(static_cast<uint32_t>(t),
                               static_cast<uint32_t>(t >> 32), 0u, 0u, seed,
                               0u);
    const long long i0 = t << 2;
    if (aligned && i0 + 3 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[t];
      char4 out;
      out.x = round_stochastic(v.x, scale, uniform24(r.v[0]));
      out.y = round_stochastic(v.y, scale, uniform24(r.v[1]));
      out.z = round_stochastic(v.z, scale, uniform24(r.v[2]));
      out.w = round_stochastic(v.w, scale, uniform24(r.v[3]));
      reinterpret_cast<char4*>(q)[t] = out;
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j)
        q[i0 + j] = round_stochastic(x[i0 + j], scale, uniform24(r.v[j]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quant_scaled_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale, int8_t* __restrict__ q,
                    long long n, uint32_t seed, int aligned) {
  quantize_quads(x, q, n, scale[0], seed, aligned != 0);
}

__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ x, long long n,
            unsigned int* __restrict__ amax_bits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float m = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    m = fmaxf(m, fabsf(x[i]));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(amax_bits, __float_as_uint(m));
}

__global__ void __launch_bounds__(kThreads)
quant_own_kernel(const float* __restrict__ x,
                 const unsigned int* __restrict__ amax_bits,
                 int8_t* __restrict__ q, float* __restrict__ scale_out,
                 long long n, uint32_t seed, int aligned) {
  const float amax = __uint_as_float(amax_bits[0]);
  const float scale = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  quantize_quads(x, q, n, scale, seed, aligned != 0);
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, long long n, int aligned) {
  const float s = scale[0];
  const long long quads = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < quads; t += stride) {
    const long long i0 = t << 2;
    if (aligned && i0 + 3 < n) {
      const char4 v = reinterpret_cast<const char4*>(q)[t];
      reinterpret_cast<float4*>(out)[t] = make_float4(
          __fmul_rn(static_cast<float>(v.x), s),
          __fmul_rn(static_cast<float>(v.y), s),
          __fmul_rn(static_cast<float>(v.z), s),
          __fmul_rn(static_cast<float>(v.w), s));
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j)
        out[i0 + j] = __fmul_rn(static_cast<float>(q[i0 + j]), s);
    }
  }
}

inline unsigned int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > (1ll << 20)) b = 1ll << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned int>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// x (n,) f32, scale (1,) f32 on the card -> q (n,) int8. `aligned`: x is
// 16-byte and q 4-byte aligned (the wrapper checks).
int pdtn_quantize_int8_scaled(const void* x, const void* scale, void* q,
                              long long n, unsigned int seed, int aligned,
                              void* stream) {
  if (n <= 0) return 0;
  quant_scaled_kernel<<<blocks_for((n + 3) >> 2), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), n, seed, aligned);
  return static_cast<int>(cudaGetLastError());
}

// x (n,) f32 -> q (n,) int8 and scale (1,) f32; amax_scratch is one
// 4-byte word on the card, zeroed here before the amax pass.
int pdtn_quantize_int8(const void* x, void* q, void* scale,
                       void* amax_scratch, long long n, unsigned int seed,
                       int aligned, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax_scratch, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long amax_blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (amax_blocks > 1024) amax_blocks = 1024;
  amax_kernel<<<static_cast<unsigned int>(amax_blocks), kThreads, 0, s>>>(
      static_cast<const float*>(x), n,
      static_cast<unsigned int*>(amax_scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_own_kernel<<<blocks_for((n + 3) >> 2), kThreads, 0, s>>>(
      static_cast<const float*>(x),
      static_cast<const unsigned int*>(amax_scratch),
      static_cast<int8_t*>(q), static_cast<float*>(scale), n, seed, aligned);
  return static_cast<int>(cudaGetLastError());
}

// q (n,) int8, scale (1,) f32 -> out (n,) f32. `aligned`: q 4-byte and
// out 16-byte aligned.
int pdtn_dequantize_int8(const void* q, const void* scale, void* out,
                         long long n, int aligned, void* stream) {
  if (n <= 0) return 0;
  dequant_kernel<<<blocks_for((n + 3) >> 2), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), n, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
