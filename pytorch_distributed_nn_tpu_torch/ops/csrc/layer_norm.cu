// Row LayerNorm forward and backward over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernels of `fused_layer_norm`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py):
//   - ln_fwd_vec_kernel / ln_fwd_kernel <- `_ln_fwd_kernel` /
//     `_ln_fwd_call`. Same function: f32
//     two-pass statistics (mu = mean(x), var = mean((x - mu)^2)),
//     rs = rsqrt(var + eps), y = (x - mu) * rs * gamma + beta written
//     directly in the output type, and, when the caller passes them (the
//     training path), mu and rs per row in f32 as the TPU kernel writes them;
//   - ln_bwd_vec_kernel / ln_bwd_kernel, then ln_bwd_sum_kernel <-
//     `_ln_bwd_kernel` / `_ln_bwd_call`. Same function:
//     xhat = (x - mu) * rs, dxhat = dy * gamma,
//     dx = rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) in x's
//     type, dgamma = sum(dy * xhat) and dbeta = sum(dy) in f32. The row
//     kernel writes one partial row of dgamma / dbeta per block (the TPU
//     path sums its per-block partials outside the kernel too);
//     ln_bwd_sum_kernel adds them up in a fixed order.
//
// What bounds them: bytes. The forward reads each row once and writes it
// once (2 * N * D * elem bytes; gamma and beta are shared by all rows),
// the backward reads x and dy and writes dx, with a handful of FLOPs per
// element either way. At GptMini's serving shapes (N <= 128 rows of
// D = 128) that is at most 128 KB, under a microsecond at 3.35 TB/s, so a
// launch costs more than the work; at BertBase training (N = 8192,
// D = 768, x bf16, dy f32, dx bf16) the backward moves 50.4 MB, 15 us.
//
// Forward, the vectorised path (ln_fwd_vec_kernel: the same widths and
// the same 16-byte rule as the backward's, on x, y, gamma and beta). A
// row costs one memory round trip:
//   - a row lives in registers. A group of LANES lanes takes a row; each
//     lane owns quads of 4 columns, the group's quads side by side, so
//     every load and store instruction covers one contiguous span of the
//     row: 16-byte vectors of f32 (x, y, gamma, beta), 8-byte of bf16.
//     (A lane owning 8 columns could load bf16 x 16 bytes at a time, but
//     its f32 y would then leave as two 16-byte stores 32 bytes apart
//     across the lanes, and with y the larger half of the traffic that
//     layout ran slower than the general kernel at (4096, 768).) All of
//     the row's loads, and the lane's gamma and beta with its first row,
//     are issued before the first reduction; the mean, then sum
//     (x - mu)^2, come from registers (two-pass, no second read);
//   - gamma and beta stay in registers across every row the lane takes;
//   - the grid is at most the card's resident capacity, each warp
//     striding over row groups, so a large N keeps the SMs' registers
//     full of rows in flight (D = 768: 16 warps an SM, one row each). At
//     N = 1 that is one block and one row group: a launch, one round
//     trip, ten shuffles, the stores.
// Other widths, or misaligned rows, take ln_fwd_kernel: one warp per row,
// lanes striding across it, three passes (the second and third re-read
// the row from L1, which holds it).
//
// Backward, the vectorised path (ln_bwd_vec_kernel: D in 64, 128 and
// 768, the widths of the port's models, and x, dy, dx on 16-byte
// boundaries; the wrapper decides and says which). To run at the memory's rate the card needs tens of KB
// in flight per SM, so:
//   - a row lives in registers. A group of LANES lanes takes a row; each
//     lane owns CHUNKS fixed 8-column chunks (D = LANES * CHUNKS * 8) and
//     loads them as 16-byte vectors (8 bf16, or 2 x 4 f32), all of the
//     row's loads issued before the first reduction, x and dy read once;
//   - dgamma / dbeta partials stay in registers across every row the lane
//     sees (its columns never change), then one fixed-order sum over the
//     block's warps in shared memory;
//   - two blocks an SM (12 warps at D = 768, where a thread needs about
//     140 registers; 16 at 64 and 128; see by_width), some 55 KB of loads in
//     flight per SM; the grid is the card's resident capacity (264 blocks
//     on an H100), each block an equal share of the rows, which its row
//     groups stride over. The trade: more blocks hide more latency but
//     each adds a partial row of 2 * D floats to write and sum (264 rows
//     = 1.6 MB at D = 768, 3% of the kernel's bytes);
// Other widths, or misaligned rows, take ln_bwd_kernel (one warp per row,
// scalar loads, 32 rows a block).
// ln_bwd_sum_kernel then sums the partial rows column by column, each
// thread over a fixed stride of rows and the block's slices in order: no
// atomics, so dgamma and dbeta repeat bit for bit.
//
// ptxas -v (sm_90a, CUDA 12.8, H100 build): ln_bwd_vec_kernel takes 64
// registers at D = 64 and 128 and 137-141 at 768 over the four type
// pairs, with no spills (at a cap of 128, D = 768 spilled up to 52
// bytes); ln_fwd_vec_kernel 47-48 at 64 and 128 and 92-96 at 768 (capped
// for three blocks an SM, D = 768 spilled). chip_smoke.py phase 2 prints
// them and fails on a spill or a missing instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// -- backward, general path: any D, any alignment --------------------------

constexpr int kBwdWarps = 4;
constexpr int kBwdRowsPerBlock = 32;

template <typename TX, typename TDY>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd_kernel(const TX* __restrict__ x, const TDY* __restrict__ dy,
              const float* __restrict__ mu, const float* __restrict__ rs,
              const float* __restrict__ gamma, TX* __restrict__ dx,
              float* __restrict__ part, long long N, int D) {
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
  const long long P = gridDim.x;
  for (int d = threadIdx.x; d < D; d += 32 * kBwdWarps) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) {
      a += sums[w * 2 * D + d];
      b += sums[w * 2 * D + D + d];
    }
    part[static_cast<long long>(blockIdx.x) * D + d] = a;
    part[(P + blockIdx.x) * D + d] = b;
  }
}

// -- backward, vectorised path: the row in registers ------------------------

// 8 consecutive elements as one lane loads them: 16 bytes of bf16, or
// 2 x 16 bytes of f32
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  float4 a, b;
};
template <>
struct Vec8<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void load8(const float* p, Vec8<float>& v) {
  v.a = reinterpret_cast<const float4*>(p)[0];
  v.b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      Vec8<__nv_bfloat16>& v) {
  v.a = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void zero8(Vec8<float>& v) {
  v.a = v.b = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero8(Vec8<__nv_bfloat16>& v) {
  v.a = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void unpack8(const Vec8<float>& v, float (&f)[8]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
  f[4] = v.b.x; f[5] = v.b.y; f[6] = v.b.z; f[7] = v.b.w;
}
__device__ __forceinline__ void unpack8(const Vec8<__nv_bfloat16>& v,
                                        float (&f)[8]) {
  const uint32_t w[4] = {v.a.x, v.a.y, v.a.z, v.a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a bf16 is the high half of an f32
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// LANES lanes take one row, each lane CHUNKS chunks of 8 columns: lane l
// of the group owns columns (c * LANES + l) * 8 .. + 7, so each chunk's
// loads are consecutive 16-byte words across the group. THREADS a block,
// at least MINB blocks an SM (which caps the registers a thread).
template <typename TX, typename TDY, int LANES, int CHUNKS, int THREADS,
          int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
ln_bwd_vec_kernel(const TX* __restrict__ x, const TDY* __restrict__ dy,
                  const float* __restrict__ mu, const float* __restrict__ rs,
                  const float* __restrict__ gamma, TX* __restrict__ dx,
                  float* __restrict__ part, long long N) {
  constexpr int D = LANES * CHUNKS * 8;
  constexpr int kVecWarps = THREADS / 32;
  constexpr int kPerWarp = 32 / LANES;          // rows a warp takes at once
  constexpr int kGroups = kVecWarps * kPerWarp;  // rows the block takes
  __shared__ __align__(16) float gamma_s[D];
  __shared__ __align__(16) float red[kVecWarps][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % LANES;
  for (int d = threadIdx.x; d < D; d += THREADS) gamma_s[d] = gamma[d];
  __syncthreads();

  float dg[CHUNKS][8], db[CHUNKS][8];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) dg[c][j] = db[c][j] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);
  // an equal share of the rows for every block, its row groups striding
  // over them; the loop runs warp-uniformly (the shuffles need every
  // lane), and a row group past the share loads nothing and adds zeros
  const long long end = N * (blockIdx.x + 1) / gridDim.x;
  for (long long base = N * blockIdx.x / gridDim.x + warp * kPerWarp;
       base < end; base += kGroups) {
    const long long row = base + lane / LANES;
    const bool valid = row < end;
    Vec8<TX> xv[CHUNKS];
    Vec8<TDY> gv[CHUNKS];
    float m = 0.f, s = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const long long off = row * D + (c * LANES + gl) * 8;
        load8(x + off, xv[c]);
        load8(dy + off, gv[c]);
      }
      m = mu[row];
      s = rs[row];
    } else {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        zero8(xv[c]);
        zero8(gv[c]);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float xf[8], gf[8];
      unpack8(xv[c], xf);
      unpack8(gv[c], gf);
      const float* gam = gamma_s + (c * LANES + gl) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xh = (xf[j] - m) * s;
        const float dxh = gf[j] * gam[j];
        s1 += dxh;
        s2 += dxh * xh;
        dg[c][j] += gf[j] * xh;
        db[c][j] += gf[j];
      }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 * inv_d, m2 = s2 * inv_d;
    if (valid) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        float xf[8], gf[8], out[8];
        unpack8(xv[c], xf);
        unpack8(gv[c], gf);
        const float* gam = gamma_s + (c * LANES + gl) * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xf[j] - m) * s;
          out[j] = s * (gf[j] * gam[j] - m1 - xh * m2);
        }
        store8(dx + row * D + (c * LANES + gl) * 8, out);
      }
    }
  }

  // the warp's row groups hold the same columns: fold them (fixed order),
  // then the block's warps in shared memory, dgamma first, then dbeta
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int o = 16; o >= LANES; o >>= 1) {
        dg[c][j] += __shfl_xor_sync(0xffffffffu, dg[c][j], o);
        db[c][j] += __shfl_xor_sync(0xffffffffu, db[c][j], o);
      }
  const long long P = gridDim.x;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (lane < LANES) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[warp][(c * LANES + gl) * 8 + j] = half ? db[c][j] : dg[c][j];
    }
    __syncthreads();
    float* out = part + (half * P + blockIdx.x) * D;
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float a = red[0][d];
#pragma unroll
      for (int w = 1; w < kVecWarps; ++w) a += red[w][d];
      out[d] = a;
    }
    __syncthreads();
  }
}

// -- forward, vectorised path: the row in registers -------------------------

// 4 consecutive elements as one lane loads or stores them: 16 bytes of
// f32, 8 of bf16
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  float4 a;
};
template <>
struct Vec4<__nv_bfloat16> {
  uint2 a;
};

__device__ __forceinline__ void load4(const float* p, Vec4<float>& v) {
  v.a = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      Vec4<__nv_bfloat16>& v) {
  v.a = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void unpack4(const Vec4<float>& v, float (&f)[4]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
}
__device__ __forceinline__ void unpack4(const Vec4<__nv_bfloat16>& v,
                                        float (&f)[4]) {
  f[0] = __uint_as_float(v.a.x << 16);
  f[1] = __uint_as_float(v.a.x & 0xffff0000u);
  f[2] = __uint_as_float(v.a.y << 16);
  f[3] = __uint_as_float(v.a.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// LANES lanes take a row, each lane QUADS quads of 4 columns: lane l of
// the group owns columns (q * LANES + l) * 4 .. + 3, so each quad's loads
// and stores are consecutive vectors across the group. THREADS a block,
// at least MINB blocks an SM (which caps the registers a thread).
template <typename TIn, typename TOut, int LANES, int QUADS, int THREADS,
          int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
ln_fwd_vec_kernel(const TIn* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, TOut* __restrict__ y,
                  float* __restrict__ mu_out, float* __restrict__ rs_out,
                  long long N, float eps) {
  constexpr int D = LANES * QUADS * 4;
  constexpr int kPerWarp = 32 / LANES;  // rows a warp takes at once
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % LANES;
  // warp w of block b starts at row group b * warps + w and strides over
  // the grid's; the loop runs warp-uniformly (the shuffles need every
  // lane), and a row past N loads nothing and stores nothing
  long long base =
      (static_cast<long long>(blockIdx.x) * (THREADS / 32) + warp) * kPerWarp;
  if (base >= N) return;
  const long long step =
      static_cast<long long>(gridDim.x) * (THREADS / 32) * kPerWarp;
  // the lane's gamma and beta, loaded with its first row and kept
  Vec4<float> gv[QUADS], bv[QUADS];
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    load4(gamma + (q * LANES + gl) * 4, gv[q]);
    load4(beta + (q * LANES + gl) * 4, bv[q]);
  }
  const float inv_d = 1.f / static_cast<float>(D);
  for (; base < N; base += step) {
    const long long row = base + lane / LANES;
    const bool valid = row < N;
    Vec4<TIn> xv[QUADS];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      if (valid) load4(x + row * D + (q * LANES + gl) * 4, xv[q]);
      else xv[q].a = {};
    }
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      float xf[4];
      unpack4(xv[q], xf);
#pragma unroll
      for (int j = 0; j < 4; ++j) s += xf[j];
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s * inv_d;
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      float xf[4];
      unpack4(xv[q], xf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = xf[j] - mu;
        ss += d * d;
      }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (!valid) continue;
    const float rs = rsqrtf(ss * inv_d + eps);
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      float xf[4], g[4], b[4], out[4];
      unpack4(xv[q], xf);
      unpack4(gv[q], g);
      unpack4(bv[q], b);
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = (xf[j] - mu) * rs * g[j] + b[j];
      store4(y + row * D + (q * LANES + gl) * 4, out);
    }
    if (gl == 0 && mu_out != nullptr) {
      mu_out[row] = mu;
      rs_out[row] = rs;
    }
  }
}

// -- backward: the partial rows' sum ----------------------------------------

constexpr int kSumCols = 32;
constexpr int kSumSlices = 32;

// part (2, P, D) f32 -> out (2, D): thread (slice, col) adds rows slice,
// slice + 32, ... in order, then slice 0 adds the 32 slices in order. 32
// slices leave a thread P / 32 loads (9 at P = 264), all in flight at once.
__global__ void __launch_bounds__(kSumCols * kSumSlices)
ln_bwd_sum_kernel(const float* __restrict__ part, int P, int D,
                  float* __restrict__ out) {
  __shared__ float acc[kSumSlices][kSumCols];
  const int c = threadIdx.x % kSumCols, sl = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + c;
  float a = 0.f;
  if (j < 2 * D) {
    const int half = j / D;
    const float* p = part + static_cast<long long>(half) * P * D + (j - half * D);
#pragma unroll 8
    for (int r = sl; r < P; r += kSumSlices)
      a += p[static_cast<long long>(r) * D];
  }
  acc[sl][c] = a;
  __syncthreads();
  if (sl == 0 && j < 2 * D) {
    float t = acc[0][c];
#pragma unroll
    for (int s = 1; s < kSumSlices; ++s) t += acc[s][c];
    out[j] = t;
  }
}

// -- launchers ---------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// Runs f(Tag<T1>, Tag<T2>) for the two type codes (0 = float32,
// 1 = bfloat16); `fallback` for any other code.
template <typename F>
int by_types(int t1, int t2, int fallback, F f) {
  using bf16 = __nv_bfloat16;
  if (t1 == 0 && t2 == 0) return f(Tag<float>{}, Tag<float>{});
  if (t1 == 0 && t2 == 1) return f(Tag<float>{}, Tag<bf16>{});
  if (t1 == 1 && t2 == 0) return f(Tag<bf16>{}, Tag<float>{});
  if (t1 == 1 && t2 == 1) return f(Tag<bf16>{}, Tag<bf16>{});
  return fallback;
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
  float* part;
  long long N;
  int D;
  cudaStream_t stream;
};

int bwd_smem(int D) { return kBwdWarps * 2 * D * static_cast<int>(sizeof(float)); }

int general_blocks(long long N) {
  return static_cast<int>((N + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock);
}

template <typename TX, typename TDY>
cudaError_t launch_general(const BwdArgs& a) {
  static int allowed = 48 * 1024;  // opted-in dynamic shared memory so far
  const int smem = bwd_smem(a.D);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<TX, TDY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  ln_bwd_kernel<TX, TDY><<<general_blocks(a.N), 32 * kBwdWarps, smem,
                           a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TDY*>(a.dy), a.mu, a.rs,
      a.gamma, static_cast<TX*>(a.dx), a.part, a.N, a.D);
  return cudaGetLastError();
}

// Blocks of `kernel` at `threads` a block that the card holds at once,
// into *resident.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int* resident) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err == cudaSuccess) *resident = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// The widths the vectorised kernels are built for, the port's models'
// (GptTiny 64, GptMini and BertTiny 128, BertBase 768), and each one's
// shapes: LANES lanes a row, each with CHUNKS 8-column chunks in the
// backward and as many columns, 2 * CHUNKS quads, in the forward (D =
// LANES * CHUNKS * 8); the backward's blocks of BWD_THREADS (two an SM)
// and the forward's of FWD_THREADS (FWD_MINB an SM). The backward needs
// 64 registers a thread at 64 and 128, so 8 warps a block; at 768 about
// 140 (at 128 it spilled), so 6 warps (12 an SM, 170 registers allowed).
// The forward holds a row, gamma and beta: about 96 registers at 768,
// under the 128 that two blocks of 8 warps an SM allow; under 64 at 64
// and 128, four blocks or more.
template <int LANES, int CHUNKS, int BWD_THREADS, int FWD_THREADS,
          int FWD_MINB>
struct Width {
  static constexpr int kLanes = LANES, kChunks = CHUNKS;
  static constexpr int kBwdThreads = BWD_THREADS;
  static constexpr int kFwdThreads = FWD_THREADS, kFwdMinBlocks = FWD_MINB;
};

// f(Width<...>{}) for D among the widths; -1 for any other D, which takes
// the general kernels.
template <typename F>
int by_width(int D, F f) {
  switch (D) {
    case 64: return f(Width<8, 1, 256, 256, 4>{});
    case 128: return f(Width<16, 1, 256, 256, 4>{});
    case 768: return f(Width<32, 3, 192, 256, 2>{});
    default: return -1;
  }
}

template <typename TX, typename TDY, typename W>
struct VecBwd {
  static constexpr int kThreads = W::kBwdThreads;
  static constexpr int kGroups = kThreads / W::kLanes;

  static auto kernel() {
    return ln_bwd_vec_kernel<TX, TDY, W::kLanes, W::kChunks, kThreads, 2>;
  }

  // the partial rows (= blocks) at N rows: the card's resident capacity,
  // or fewer when N is small; -1 if the card cannot be queried
  static int blocks(long long N) {
    static int resident = 0;
    if (resident == 0 &&
        resident_blocks(kernel(), kThreads, &resident) != cudaSuccess)
      return -1;
    const long long need = (N + kGroups - 1) / kGroups;
    return static_cast<int>(need < resident ? need : resident);
  }

  static cudaError_t launch(const BwdArgs& a, int P) {
    const auto k = kernel();
    k<<<P, kThreads, 0, a.stream>>>(
        static_cast<const TX*>(a.x), static_cast<const TDY*>(a.dy), a.mu,
        a.rs, a.gamma, static_cast<TX*>(a.dx), a.part, a.N);
    return cudaGetLastError();
  }
};

template <typename TIn, typename TOut, typename W>
struct VecFwd {
  static constexpr int kThreads = W::kFwdThreads;
  static constexpr int kBlockRows = kThreads / W::kLanes;

  static auto kernel() {
    return ln_fwd_vec_kernel<TIn, TOut, W::kLanes, 2 * W::kChunks, kThreads,
                             W::kFwdMinBlocks>;
  }

  // a grid of the card's resident capacity, or of as many blocks as N
  // rows fill (one at N = 1)
  static cudaError_t launch(const FwdArgs& a) {
    static int resident = 0;
    if (resident == 0) {
      const cudaError_t err = resident_blocks(kernel(), kThreads, &resident);
      if (err != cudaSuccess) return err;
    }
    const long long need = (a.N + kBlockRows - 1) / kBlockRows;
    const auto k = kernel();
    k<<<static_cast<unsigned>(need < resident ? need : resident), kThreads,
        0, a.stream>>>(
        static_cast<const TIn*>(a.x), a.gamma, a.beta,
        static_cast<TOut*>(a.y), a.mu, a.rs, a.N, a.eps);
    return cudaGetLastError();
  }
};

// partial rows of the backward at (N, D) on the chosen path, -1 if the
// vectorised path has no kernel for D (or the card cannot be queried)
int partial_rows(int x_dtype, int dy_dtype, long long N, int D, int vec) {
  if (!vec) return general_blocks(N);
  return by_types(x_dtype, dy_dtype, -1, [&](auto tx, auto tdy) {
    using TX = typename decltype(tx)::type;
    using TDY = typename decltype(tdy)::type;
    return by_width(D, [&](auto w) {
      return VecBwd<TX, TDY, decltype(w)>::blocks(N);
    });
  });
}

bool bad_shape(long long N, int D) {
  return N < 1 || D < 1 || N > 4LL * 0x7fffffffLL;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x (N, D) and y (N, D) are row-major contiguous; gamma and beta are (D,)
// float32; mu and rs are (N,) float32 outputs, or both null (the serving
// path needs neither). Types: 0 = float32, 1 = bfloat16. vec = 1 takes
// the vectorised kernel: D one of its widths and x, gamma, beta and y
// 16-byte aligned, else cudaErrorInvalidValue /
// cudaErrorMisalignedAddress; vec = 0 the general one. Returns the
// launch's cudaError_t (0 on success).
int pdtn_layer_norm_fwd(int in_dtype, int out_dtype, int vec, const void* x,
                        const float* gamma, const float* beta, void* y,
                        float* mu, float* rs, long long N, int D, float eps,
                        void* stream) {
  if (bad_shape(N, D) || (mu == nullptr) != (rs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned16(x) && aligned16(gamma) && aligned16(beta) &&
               aligned16(y)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const FwdArgs a{x, gamma, beta, y, mu, rs, N, D, eps,
                  static_cast<cudaStream_t>(stream)};
  return by_types(in_dtype, out_dtype, cudaErrorInvalidValue,
                  [&](auto ti, auto to) {
    using TIn = typename decltype(ti)::type;
    using TOut = typename decltype(to)::type;
    if (!vec) return static_cast<int>(launch_fwd<TIn, TOut>(a));
    const int err = by_width(D, [&](auto w) {
      return static_cast<int>(VecFwd<TIn, TOut, decltype(w)>::launch(a));
    });
    return err == -1 ? static_cast<int>(cudaErrorInvalidValue) : err;
  });
}

// Partial rows P of the backward at (N, D): the size of its scratch
// (2, P, D) float32. vec = 1 for the vectorised path, 0 for the general
// one. -1 when the vectorised path has no kernel for D.
int pdtn_layer_norm_bwd_partial_rows(int x_dtype, int dy_dtype, long long N,
                                     int D, int vec) {
  if (bad_shape(N, D)) return -1;
  return partial_rows(x_dtype, dy_dtype, N, D, vec);
}

// x (N, D) in x_dtype, dy (N, D) in dy_dtype, both row-major contiguous;
// mu, rs (N,) and gamma (D,) float32. Writes dx (N, D) in x_dtype and
// dgdb (2, D) float32 = (dgamma, dbeta), through part, a (2, P, D) float32
// scratch with P from pdtn_layer_norm_bwd_partial_rows. vec = 1 takes the
// vectorised path: D one of its widths and x, dy and dx 16-byte aligned,
// else cudaErrorInvalidValue / cudaErrorMisalignedAddress. Two launches
// (rows, then the partial rows' sum) on `stream`.
int pdtn_layer_norm_bwd(int x_dtype, int dy_dtype, int vec, const void* x,
                        const void* dy, const float* mu, const float* rs,
                        const float* gamma, void* dx, float* part, int P,
                        float* dgdb, long long N, int D, void* stream) {
  if (bad_shape(N, D) || (!vec && bwd_smem(D) > 227 * 1024) ||
      P != partial_rows(x_dtype, dy_dtype, N, D, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(aligned16(x) && aligned16(dy) && aligned16(dx)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const BwdArgs a{x, dy, mu, rs, gamma, dx, part, N, D,
                  static_cast<cudaStream_t>(stream)};
  const int err = by_types(x_dtype, dy_dtype, cudaErrorInvalidValue,
                           [&](auto tx, auto tdy) {
    using TX = typename decltype(tx)::type;
    using TDY = typename decltype(tdy)::type;
    if (!vec) return static_cast<int>(launch_general<TX, TDY>(a));
    return by_width(D, [&](auto w) {
      return static_cast<int>(VecBwd<TX, TDY, decltype(w)>::launch(a, P));
    });
  });
  if (err != cudaSuccess) return err;
  ln_bwd_sum_kernel<<<(2 * D + kSumCols - 1) / kSumCols,
                      kSumCols * kSumSlices, 0, a.stream>>>(part, P, D, dgdb);
  return static_cast<int>(cudaGetLastError());
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
