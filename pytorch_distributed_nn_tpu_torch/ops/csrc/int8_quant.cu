// Int8 gradient codec for Hopper (sm_90a): stochastic-rounding quantize
// with a given scale over a group of gradient leaves, quantize with its own
// scale, and dequantize.
//
// Replaces the TPU kernels of the int8 codec
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py):
//   - quant_group_kernel <- `quantize_int8_scaled` (`_quant_scaled_kernel_prng`):
//     for each leaf of the group, q = clip(floor(x / scale + u), -127, 127)
//     as int8, its scale given (the cross-replica amax / 127 of the
//     gradient collective). The TPU program makes one call per leaf; one
//     launch here covers up to 64 leaves;
//   - amax_kernel + quant_own_kernel <- `quantize_int8` (`_quant_kernel_prng`):
//     amax = max |x|, scale = amax * f32(1/127) (1 when amax is 0; XLA's
//     form of the TPU program's amax / 127), then the same rounding; the
//     scale is written beside q;
//   - dequant_kernel <- `dequantize_int8` (`_dequant_kernel`): q * scale in f32.
//
// Noise. The TPU kernels draw u from the chip's own generator, which has
// no counterpart here. These kernels draw it from Philox4x32-10 written
// out below: element i of a leaf takes word (i & 3) of Philox(counter =
// (i >> 2, i >> 34, 0, 0), key = (the leaf's seed, 0)), and
// u = (bits >> 8) * 2^-24, the TPU kernel's mapping of 32 random bits onto
// [0, 1). The plain version (ops/reference.py) runs the same generator in
// integer torch arithmetic, so kernel and plain version agree bit for bit.
// x / scale is IEEE division (__fdiv_rn; the build has no fast-math flag).
//
// What bounds them: bytes. Each element is read once as f32 and written
// once as int8 (5 bytes; the own-scale kernel reads x twice, once for
// amax, but L2 holds a gradient leaf of up to 9.4 MB between the passes),
// against 10 Philox rounds per 4 elements, about 40 integer operations an
// element, under the card's integer rate at 5 bytes an element.
//
// The grouped quantize. A ResNet-18 step quantizes 18 leaves of 36,864 to
// 2,359,296 elements; one launch each spent most of its time in the
// launch's ramp and tail (1.65 us at 36,864 elements, whose bytes take
// 0.055 us). So one launch covers the group:
//   - a descriptor table (x, q, scale pointer, element count, first quad,
//     seed, alignment of each leaf; 48 bytes a leaf, 64 leaves, 3 KB) is
//     passed by value as the kernel's parameter (`__grid_constant__`, read
//     in place from the constant bank); no copy to the card, no host sync
//     (the scales stay on the card). Larger groups take one launch per 64;
//   - the leaves' quads (4 elements) are numbered one after another;
//     each block takes an equal share of them (a whole number of tiles
//     per block would leave the last round a quarter full at ResNet-18's
//     sizes), in tiles of 1024 quads, and finds the leaf of each quad
//     from the table's first-quad offsets;
//   - each thread takes 4 quads of a tile (256 apart, so each load
//     instruction is coalesced across the warp) and issues their 16-byte
//     loads before any Philox round; the grid is the card's resident
//     capacity, not the size of any leaf;
//   - a tile that lies inside one aligned leaf (all but a few per group)
//     looks nothing up per quad: one 16-byte load, the rounds, one 4-byte
//     store. The instructions a quad takes to issue cost about as much
//     time as its bytes (Philox, then an IEEE division, floor and clip per
//     element), so a lookup and bounds checks per quad would cost time.
//     Tiles across a leaf boundary, at a ragged end or in an unaligned
//     leaf go quad by quad, element by element.
//
// ptxas -v (sm_90a, CUDA 12.8, H100 build): quant_group_kernel takes 71
// registers, no spills (3 blocks of 256 an SM; capped at 64 for 4 blocks it
// spills 16 bytes). chip_smoke.py phase 2 prints them and fails on a spill.

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

// The quantize body of the own-scale kernel: every quad of x, grid-stride.
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

// -- the grouped quantize ---------------------------------------------------

constexpr int kGroupLeaves = 64;
constexpr int kQuadsPerThread = 4;
constexpr int kTileQuads = kThreads * kQuadsPerThread;

struct Leaf {
  const float* x;
  int8_t* q;
  const float* scale;     // one f32 on the card
  long long n;            // elements, > 0
  long long quad_begin;   // the leaf's first quad in the group's numbering
  uint32_t seed;
  int aligned;            // x 16-byte and q 4-byte aligned
};

struct LeafGroup {
  Leaf leaf[kGroupLeaves];
  long long quads;  // all leaves' quads
  int count;
};
static_assert(sizeof(LeafGroup) <= 4096,
              "the descriptor table must fit the 4 KB kernel parameter "
              "space of every toolkit");

__device__ __forceinline__ char4 round_quad(float4 v, float scale,
                                            const U4& r) {
  char4 out;
  out.x = round_stochastic(v.x, scale, uniform24(r.v[0]));
  out.y = round_stochastic(v.y, scale, uniform24(r.v[1]));
  out.z = round_stochastic(v.z, scale, uniform24(r.v[2]));
  out.w = round_stochastic(v.w, scale, uniform24(r.v[3]));
  return out;
}

__device__ __forceinline__ U4 leaf_noise(long long u, uint32_t seed) {
  return philox4x32_10(static_cast<uint32_t>(u),
                       static_cast<uint32_t>(u >> 32), 0u, 0u, seed, 0u);
}

// A tile that is `count` whole quads of one aligned leaf from its quad u0:
// nothing to look up per quad, one 16-byte load and one 4-byte store each.
__device__ __forceinline__ void whole_tile(const Leaf& f, long long u0,
                                           int count) {
  const float4* x4 = reinterpret_cast<const float4*>(f.x) + u0;
  char4* q4 = reinterpret_cast<char4*>(f.q) + u0;
  const float scale = *f.scale;
  const uint32_t seed = f.seed;
  float4 v[kQuadsPerThread];
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < count) v[k] = x4[i];
  }
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < count) q4[i] = round_quad(v[k], scale, leaf_noise(u0 + i, seed));
  }
}

// Any other tile [t0, end): each quad finds its leaf, from leaf `lo` on,
// and a quad that is ragged or in an unaligned leaf goes element by
// element.
__device__ __forceinline__ void mixed_tile(const LeafGroup& g, int lo,
                                           long long t0, long long end) {
  int which[kQuadsPerThread];
  long long quad[kQuadsPerThread];
  float scale[kQuadsPerThread];
  float v[kQuadsPerThread][4];
  int leaf = lo;
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const long long t = t0 + k * kThreads + threadIdx.x;
    which[k] = -1;
    v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0.f;
    if (t >= end) continue;
    while (leaf + 1 < g.count && t >= g.leaf[leaf + 1].quad_begin) ++leaf;
    const Leaf& f = g.leaf[leaf];
    const long long u = t - f.quad_begin, i0 = u << 2;
    which[k] = leaf;
    quad[k] = u;
    scale[k] = *f.scale;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < f.n) v[k][j] = f.x[i0 + j];
  }
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    if (which[k] < 0) continue;
    const Leaf& f = g.leaf[which[k]];
    const long long u = quad[k], i0 = u << 2;
    const U4 r = leaf_noise(u, f.seed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < f.n)
        f.q[i0 + j] = round_stochastic(v[k][j], scale[k], uniform24(r.v[j]));
  }
}

__global__ void __launch_bounds__(kThreads)
quant_group_kernel(const __grid_constant__ LeafGroup g) {
  // an equal share of the quads for every block, in tiles
  const long long end = g.quads * (blockIdx.x + 1) / gridDim.x;
  for (long long t0 = g.quads * blockIdx.x / gridDim.x; t0 < end;
       t0 += kTileQuads) {
    const long long t1 = t0 + kTileQuads < end ? t0 + kTileQuads : end;
    // the leaf of the tile's first quad (the same search in every thread)
    int lo = 0, hi = g.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (g.leaf[mid].quad_begin <= t0)
        lo = mid;
      else
        hi = mid - 1;
    }
    const Leaf& f = g.leaf[lo];
    // almost every tile lies inside one aligned leaf, short of its ragged
    // end: the branch is the same for the whole block
    if (f.aligned && t1 <= f.quad_begin + (f.n >> 2))
      whole_tile(f, t0 - f.quad_begin, static_cast<int>(t1 - t0));
    else
      mixed_tile(g, lo, t0, end);
  }
}

// blocks of the grouped quantize: the card's resident capacity, or fewer
// tiles
int group_blocks(long long quads) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, quant_group_kernel, kThreads, 0) != cudaSuccess)
      return -1;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (quads + kTileQuads - 1) / kTileQuads;
  return static_cast<int>(tiles < resident ? tiles : resident);
}

inline unsigned int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > (1ll << 20)) b = 1ll << 20;  // the grid-stride loop covers the rest
  return static_cast<unsigned int>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" {

// The grouped quantize over k leaves (1 <= k <= 64 = kGroupLeaves,
// kernels.QUANT_GROUP_LEAVES): leaf i is x[i] (n[i],) f32 -> q[i] (n[i],)
// int8 with the one-value f32 scale at scale[i] on the card and noise
// seed seed[i]; aligned[i]: x[i] 16-byte and q[i] 4-byte aligned (the
// wrapper checks). The arrays are host memory; one launch.
int pdtn_quantize_int8_scaled_group(int k, void* const* x, void* const* q,
                                    void* const* scale, const long long* n,
                                    const unsigned int* seed,
                                    const int* aligned, void* stream) {
  if (k < 1 || k > kGroupLeaves) return static_cast<int>(cudaErrorInvalidValue);
  LeafGroup g;
  long long quads = 0;
  for (int i = 0; i < k; ++i) {
    if (n[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    g.leaf[i] = Leaf{static_cast<const float*>(x[i]),
                     static_cast<int8_t*>(q[i]),
                     static_cast<const float*>(scale[i]), n[i], quads,
                     seed[i], aligned[i]};
    quads += (n[i] + 3) >> 2;
  }
  g.quads = quads;
  g.count = k;
  const int blocks = group_blocks(quads);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  quant_group_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g);
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
