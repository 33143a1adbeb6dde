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
//   - quant_own_kernel <- `quantize_int8` (`_quant_kernel_prng`):
//     amax = max |x|, scale = amax * f32(1/127) (1 when amax is 0; XLA's
//     form of the TPU program's amax / 127), then the same rounding; the
//     scale is written beside q. One cooperative launch (below);
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
// A leaf of the group may be a region of a larger one (a tensor-parallel
// shard of a gradient): its `first` element offset, a multiple of 4,
// numbers its elements from there, so that each region draws the whole
// leaf's noise at its elements and the quantized leaf does not depend on
// how it is split. The wrapper pads a region whose offset is not a
// multiple of 4 (kernels.py): a quad then never straddles two Philox
// draws, and no path holds two (it took the kernel from 71 to 92
// registers, 2 blocks an SM instead of 3).
//
// What bounds them: bytes. Each element is read once as f32 and written
// once as int8 (5 bytes), against 10 Philox rounds per 4 elements, about
// 40 integer operations an element, under the card's integer rate at 5
// bytes an element.
//
// The own-scale quantize. The scale needs every element before any can be
// rounded: a grid-wide dependency. The TPU program holds the whole array
// in VMEM for it; here the card's registers hold it. One cooperative launch
// (cudaLaunchCooperativeKernel, so every block is resident) of at most the
// card's resident blocks: each thread loads up to 5 quads (16-byte loads,
// 2.7M elements over the whole card at 4 blocks of 256 an SM) and reduces
// |x|, to one partial amax a block, written to that block's slot of a
// scratch array. After the grid barrier (cooperative_groups' grid sync)
// every block takes the max of the slots, draws the Philox noise of its
// quads and rounds the quads it holds. x is read from device memory once;
// no memset (every slot is written before it is read) and no float
// atomics (a max is exact in any order, so the result is deterministic). Inputs
// larger than the registers hold read their remaining quads once for the
// amax and again, from L2, for the rounding, in the same launch. (It was
// a memset, an amax kernel with one atomicMax a warp, and a second pass
// over x from a second kernel.)
//
// The grouped quantize. A ResNet-18 step quantizes 18 leaves of 36,864 to
// 2,359,296 elements; one launch each spent most of its time in the
// launch's ramp and tail (1.65 us at 36,864 elements, whose bytes take
// 0.055 us). So one launch covers the group:
//   - a descriptor table (x, q, scale pointer, element count, first quad,
//     noise offset, seed, alignment of each leaf; 56 bytes a leaf, 64
//     leaves, 3.5 KB) is
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
// spills 16 bytes); quant_own_kernel 55 registers under its 4-block
// launch bound (Q = 3 or 4 quads a thread at 6 or 5 blocks an SM ran
// slower), no spills. chip_smoke.py phase 2 prints them and fails on a
// spill.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  long long first;        // element 0's index in the noise numbering, % 4 == 0
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
  const long long q0 = f.first >> 2;
  float4 v[kQuadsPerThread];
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < count) v[k] = x4[i];
  }
#pragma unroll
  for (int k = 0; k < kQuadsPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < count)
      q4[i] = round_quad(v[k], scale, leaf_noise(q0 + u0 + i, seed));
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
    const U4 r = leaf_noise((f.first >> 2) + u, f.seed);
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

// -- the own-scale quantize: one cooperative launch -----------------------

// quads a thread holds in registers
constexpr int kOwnQuads = 5;

__device__ __forceinline__ float4 load_quad(const float* __restrict__ x,
                                            long long t, long long n,
                                            bool aligned) {
  const long long i0 = t << 2;
  if (aligned && i0 + 3 < n) return reinterpret_cast<const float4*>(x)[t];
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = i0 + j < n ? x[i0 + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ void store_quad(int8_t* __restrict__ q,
                                           long long t, long long n,
                                           bool aligned, char4 c) {
  const long long i0 = t << 2;
  if (aligned && i0 + 3 < n) {
    reinterpret_cast<char4*>(q)[t] = c;
    return;
  }
  const int8_t v[4] = {c.x, c.y, c.z, c.w};
  for (int j = 0; j < 4 && i0 + j < n; ++j) q[i0 + j] = v[j];
}

// Quad k of a thread is t = g + k * T (g the thread's index in the grid, T
// the grid's threads: each load instruction coalesced across the warp).
// Its first kOwnQuads quads stay in registers across the grid barrier;
// the quads past kOwnQuads * T (inputs larger than the grid holds) are
// read once for the amax and again, from L2, for the rounding. The noise
// is drawn after the barrier: drawn before it (into shared memory, while
// the loads flew) it lengthened the slowest block's way to the barrier,
// and the whole launch ran longer on an H100.
__global__ void __launch_bounds__(kThreads, 4)
quant_own_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scale_out, float* __restrict__ partial,
                 long long n, uint32_t seed, int aligned_flag) {
  __shared__ float red[kThreads / 32];
  const bool aligned = aligned_flag != 0;
  const long long quads = (n + 3) >> 2;
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  float4 v[kOwnQuads];
#pragma unroll
  for (int k = 0; k < kOwnQuads; ++k)
    v[k] = load_quad(x, g + k * T, n, aligned);  // zeros past n
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kOwnQuads; ++k) m = abs_max4(m, v[k]);
  for (long long t = g + kOwnQuads * T; t < quads; t += T)
    m = abs_max4(m, load_quad(x, t, n, aligned));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = red[0];
    for (int w = 1; w < kThreads / 32; ++w) b = fmaxf(b, red[w]);
    partial[blockIdx.x] = b;  // every block's slot is written: no memset
  }
  cg::this_grid().sync();
  // amax over the blocks' slots (a max: exact in any order)
  m = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    m = fmaxf(m, __ldcg(partial + i));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();  // red is reused
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float amax = red[0];
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
#pragma unroll
  for (int k = 0; k < kOwnQuads; ++k)
    if (g + k * T < quads)
      store_quad(q, g + k * T, n, aligned,
                 round_quad(v[k], scale, leaf_noise(g + k * T, seed)));
  for (long long t = g + kOwnQuads * T; t < quads; t += T)
    store_quad(q, t, n, aligned,
               round_quad(load_quad(x, t, n, aligned), scale,
                          leaf_noise(t, seed)));
}

// the most blocks of `kernel` (blocks of kThreads) the current card holds
// at once, -1 on error; kept per device in `cache`
constexpr int kMaxDevices = 64;
int resident_blocks(const void* kernel, int (&cache)[kMaxDevices]) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  if (dev < kMaxDevices) cache[dev] = sms * per_sm;
  return sms * per_sm;
}
int own_resident[kMaxDevices];
int group_resident[kMaxDevices];

// blocks of the own-scale quantize for n elements: enough to hold every
// quad in registers, at most the resident ones (the cooperative launch's
// limit); -1 on error
int own_blocks(long long n) {
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(quant_own_kernel), own_resident);
  if (resident < 1) return -1;
  const long long per_block = kThreads * kOwnQuads;
  const long long need = ((n + 3) / 4 + per_block - 1) / per_block;
  return static_cast<int>(need < resident ? need : resident);
}

// blocks of the grouped quantize: the card's resident capacity, or fewer
// tiles
int group_blocks(long long quads) {
  const int resident = resident_blocks(
      reinterpret_cast<const void*>(quant_group_kernel), group_resident);
  if (resident < 1) return -1;
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
                                    const long long* first,
                                    const unsigned int* seed,
                                    const int* aligned, void* stream) {
  if (k < 1 || k > kGroupLeaves) return static_cast<int>(cudaErrorInvalidValue);
  LeafGroup g;
  long long quads = 0;
  for (int i = 0; i < k; ++i) {
    if (n[i] <= 0 || first[i] < 0 || (first[i] & 3))
      return static_cast<int>(cudaErrorInvalidValue);
    g.leaf[i] = Leaf{static_cast<const float*>(x[i]),
                     static_cast<int8_t*>(q[i]),
                     static_cast<const float*>(scale[i]), n[i], quads,
                     first[i], seed[i], aligned[i]};
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

// Blocks the own-scale quantize of n elements launches on the current
// card: the length of its partial-amax scratch (-1 on error).
int pdtn_quantize_int8_blocks(long long n) {
  return n > 0 ? own_blocks(n) : 0;
}

// Elements the own-scale quantize holds in registers across its grid
// barrier on the current card; a larger x takes a second pass over its
// remaining quads in the same launch (-1 on error).
int pdtn_quantize_int8_register_elements() {
  const int blocks = own_blocks(1LL << 62);
  return blocks < 1 ? -1 : 4 * kThreads * kOwnQuads * blocks;
}

// x (n,) f32 -> q (n,) int8 and scale (1,) f32, in one cooperative launch
// of pdtn_quantize_int8_blocks(n) blocks of 256 threads; partial holds
// `slots` f32 on the card, at least one a block, each written before it
// is read (no memset).
int pdtn_quantize_int8(const void* x, void* q, void* scale, void* partial,
                       long long n, unsigned int seed, int aligned,
                       int slots, void* stream) {
  if (n <= 0) return 0;
  const int blocks = own_blocks(n);
  if (blocks < 1 || blocks > slots)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  float* pp = static_cast<float*>(partial);
  uint32_t sd = seed;
  void* args[] = {&xp, &qp, &sp, &pp, &n, &sd, &aligned};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quant_own_kernel),
      dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
