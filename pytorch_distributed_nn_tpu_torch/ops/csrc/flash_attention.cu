// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of `pallas_attention`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py):
//   - flash_fwd_kernel  <- `_flash_forward` (`_flash_fwd_kernel_res`,
//     `_flash_fwd_kernel`);
//   - flash_dq_kernel   <- `_flash_backward`'s dq call (`_flash_dq_kernel_res`,
//     `_flash_dq_kernel`);
//   - flash_dkv_kernel  <- `_flash_backward`'s dk/dv call
//     (`_flash_dkv_kernel_res`, `_flash_dkv_kernel`).
// Same function and the same rounding points:
//   s = (q . k) * D^-1/2 + bias[key]   (bias 0 keep / -1e30 pad, optional);
//   causal: s = -1e30 where q_pos < k_pos;
//   forward: online softmax with m starting at -1e30, l = max(l, 1e-30),
//     p rounded to v's type before P @ V, f32 accumulator,
//     out = acc / l in the input type, lse = m + log(l) in f32;
//   dq:  p = exp(s - lse), dp = dO . V (f32), ds = p * (dp - delta) * scale,
//        dq = round(ds, k's type) @ K;
//   dkv: dv = p^T @ dO and dk = ds^T @ Q with p, ds, Q and dO all in f32.
// delta = rowsum(dO * O) is computed outside, as the TPU path does.
//
// Layouts. q, k, v and dO are read in their (B, L, H, D) layout through
// their batch / sequence / head strides (D contiguous): the TPU path's
// (B*H, L, D) relayout and its lane-major lse / delta / mask tiles were
// Mosaic tiling needs. lse and delta are (B, H, L) f32, the pad bias is
// (B, L) f32, outputs are contiguous (B, L, H, D).
//
// What bounds it on this card: operations. Per (batch, head) the forward
// does 4 * L^2 * D FLOPs against 8 * L * D bytes of q/k/v/out; at
// BertBase (L = 512, D = 64, bf16) that is 256 FLOPs per byte, and the
// backward does 14 * L^2 * D. The design, a simple first one on the CUDA
// cores in f32 (the backward's f32 products are what the TPU kernel
// computes; tensor cores, wgmma and TMA are later work):
//   - one block of 256 threads per (batch*head, 64-row tile); the loop
//     over the other operand's 64-row tiles runs inside the block, so no
//     block depends on another and the backward needs no atomics (dq and
//     dk/dv are two kernels, as on the TPU), and results repeat bit for bit;
//   - tiles are staged in shared memory as f32 rows padded by 4 floats, so
//     the 128-bit loads of the score products hit distinct banks;
//   - each thread owns a 4 x 4 micro-tile of every 64 x 64 score panel
//     (rows ty + 16i, columns tx + 16j): per 4-element step along D it
//     loads 8 float4 and does 64 FMAs, and the row max / sum of the online
//     softmax reduce over the 16 lanes that share a row with 4 shuffles;
//   - causal: tiles wholly above the diagonal are skipped; a ragged last
//     tile (L not a multiple of 64) is masked in the kernel, so any L works.
// Shared memory exceeds the 48 KB static limit from D = 32 on (dq and
// dk/dv), so every kernel runs with opted-in dynamic shared memory (at most
// 103 KB, dk/dv at D = 64). D is instantiated for 16, 32 and 64, the head
// dims of the port's models.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of a Q tile and of a K/V tile
constexpr int kPS = kTile + 4;     // padded row of a 64 x 64 panel
constexpr float kNegInf = -1e30f;  // the JAX kernels' _NEG_INF

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
// x rounded to T and back (the TPU kernels' `.astype(dtype)` before a dot)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// max / sum over the 16 lanes that share a row (lanes differing in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, l, h;
};

// Stage rows [row0, row0 + 64) of one (batch, head) slice into `dst`
// (64 rows of SD floats); rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base,
                                          long long s_l, int row0, int L) {
  constexpr int SD = D + 4;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = row0 + r;
    dst[r * SD + d] = row < L ? to_f32(base[row * s_l + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] over two staged tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int tx, int ty, float acc[4][4]) {
  constexpr int SD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * SD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * SD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        acc[i][j] = t;
      }
  }
}

// acc[i][c] += sum_k P[ty + 16i][k] * V[k][tx + 16c] with P a 64 x kPS
// panel and V a staged 64 x SD tile
template <int D>
__device__ __forceinline__ void panel_times_tile(const float* P, const float* V,
                                                 int tx, int ty,
                                                 float acc[4][D / 16]) {
  constexpr int SD = D + 4, DC = D / 16;
#pragma unroll 2
  for (int kk = 0; kk < kTile; kk += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = V[(kk + u) * SD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z
                                                                   : p[i].w;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
      }
    }
  }
}

// The masked, scaled score of (q_pos, key) from a raw dot product; keys
// past L are -inf (they take no part at all).
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* __restrict__ bias_b,
                                              int causal, int q_pos, int key,
                                              int L) {
  if (key >= L) return -INFINITY;
  float s = dot * scale;
  if (bias_b) s += bias_b[key];
  if (causal && q_pos < key) s = kNegInf;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int H, int L,
                 Strides qs, Strides ks, Strides vs, int causal, float scale) {
  constexpr int SD = D + 4, DC = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* Ps = Vs + kTile * SD;  // kTile x kPS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.x, q0 = qt * kTile;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }
  const int nk = (L + kTile - 1) / kTile;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, ks.l, k0, L);
    load_tile<T, D>(Vs, vb, vs.l, k0, L);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], scale, bias_b, causal, q_pos,
                               k0 + tx + 16 * j, L);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= corr;
    }
    __syncthreads();
    panel_times_tile<D>(Ps, Vs, tx, ty, o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= L) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f32<T>(o[i][c] / lc);
    if (tx == 0) lse[static_cast<long long>(bh) * L + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ bias, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int L, Strides qs, Strides ks, Strides vs, Strides dos,
                int causal, float scale) {
  constexpr int SD = D + 4, DC = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * SD;
  float* Ks = dOs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* Ps = Vs + kTile * SD;  // ds, rounded to T
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.x, q0 = qt * kTile;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  load_tile<T, D>(dOs, dout + b * dos.b + h * dos.h, dos.l, q0, L);
  float row_lse[4], row_delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = static_cast<long long>(bh) * L + row;
    row_lse[i] = row < L ? lse[at] : 0.f;
    row_delta[i] = row < L ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int nk = (L + kTile - 1) / kTile;
  const int kt_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, kb, ks.l, k0, L);
    load_tile<T, D>(Vs, vb, vs.l, k0, L);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float x = masked_score(s[i][j], scale, bias_b, causal,
                                     q0 + ty + 16 * i, key, L);
        const float p = key < L ? expf(x - row_lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - row_delta[i]) * scale;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = round_to<T>(ds);
      }
    __syncthreads();
    panel_times_tile<D>(Ps, Ks, tx, ty, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= L) continue;
    T* drow = dq + ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) drow[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ bias, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int L, Strides qs, Strides ks,
                 Strides vs, Strides dos, int causal, float scale) {
  constexpr int SD = D + 4, DC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * SD;
  float* Qs = Vs + kTile * SD;
  float* dOs = Qs + kTile * SD;
  float* PsT = dOs + kTile * SD;  // [key][q]: p
  float* DsT = PsT + kTile * kPS;  // [key][q]: ds
  float* lse_s = DsT + kTile * kPS;
  float* delta_s = lse_s + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  load_tile<T, D>(Ks, k + b * ks.b + h * ks.h, ks.l, k0, L);
  load_tile<T, D>(Vs, v + b * vs.b + h * vs.h, vs.l, k0, L);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nq = (L + kTile - 1) / kTile;
  // causal: a Q tile takes part only if its last row reaches k0
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, qb, qs.l, q0, L);
    load_tile<T, D>(dOs, dob, dos.l, q0, L);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * L + row;
      lse_s[threadIdx.x] = row < L ? lse[at] : 0.f;
      delta_s[threadIdx.x] = row < L ? delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);   // rows: queries, columns: keys
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        const float x = masked_score(s[i][j], scale, bias_b, causal, q_pos,
                                     key, L);
        const float p =
            (key < L && q_pos < L) ? expf(x - lse_s[r]) : 0.f;
        PsT[c * kPS + r] = p;
        DsT[c * kPS + r] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    panel_times_tile<D>(PsT, dOs, tx, ty, dv_acc);  // rows: keys
    panel_times_tile<D>(DsT, Qs, tx, ty, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= L) continue;
    const long long at = ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[at + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[at + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <int D>
constexpr int fwd_smem() { return (3 * kTile * (D + 4) + kTile * kPS) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * kTile * (D + 4) + kTile * kPS) * 4; }
template <int D>
constexpr int dkv_smem() {
  return (4 * kTile * (D + 4) + 2 * kTile * kPS + 2 * kTile) * 4;
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per process
// (before any CUDA graph capture: the first launch of each kernel is eager).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *out, *out2;
  float* lse_out;
  int B, H, L, causal;
  Strides qs, ks, vs, dos;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  static bool ready[3] = {false, false, false};
  cudaError_t err;
  if (which == kFwd) {
    auto kern = flash_fwd_kernel<T, D>;
    if ((err = allow_smem(kern, fwd_smem<D>(), &ready[kFwd])) != cudaSuccess)
      return err;
    kern<<<grid, kThreads, fwd_smem<D>(), a.stream>>>(
        q, k, v, a.bias, static_cast<T*>(a.out), a.lse_out, a.H, a.L, a.qs,
        a.ks, a.vs, a.causal, a.scale);
  } else if (which == kDq) {
    auto kern = flash_dq_kernel<T, D>;
    if ((err = allow_smem(kern, dq_smem<D>(), &ready[kDq])) != cudaSuccess)
      return err;
    kern<<<grid, kThreads, dq_smem<D>(), a.stream>>>(
        q, k, v, dout, a.bias, a.lse, a.delta, static_cast<T*>(a.out), a.H,
        a.L, a.qs, a.ks, a.vs, a.dos, a.causal, a.scale);
  } else {
    auto kern = flash_dkv_kernel<T, D>;
    if ((err = allow_smem(kern, dkv_smem<D>(), &ready[kDkv])) != cudaSuccess)
      return err;
    kern<<<grid, kThreads, dkv_smem<D>(), a.stream>>>(
        q, k, v, dout, a.bias, a.lse, a.delta, static_cast<T*>(a.out),
        static_cast<T*>(a.out2), a.H, a.L, a.qs, a.ks, a.vs, a.dos, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, int dtype, int D, const Args& a) {
  if (a.B < 1 || a.H < 1 || a.L < 1 || static_cast<long long>(a.B) * a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(dispatch_d<float>(which, D, a));
  if (dtype == 1)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(which, D, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v: (B, L, H, D) with the given (batch, sequence, head) element
// strides and D contiguous; dtype 0 = float32, 1 = bfloat16; D in
// {16, 32, 64}. bias: (B, L) f32 additive key bias or null. Writes
// out (B, L, H, D) contiguous and lse (B, H, L) f32. Returns the launch's
// cudaError_t (0 on success).
int pdtn_flash_fwd(int dtype, int D, int causal, const void* q, const void* k,
                   const void* v, const float* bias, void* out, float* lse,
                   int B, int H, int L, long long q_sb, long long q_sl,
                   long long q_sh, long long k_sb, long long k_sl,
                   long long k_sh, long long v_sb, long long v_sl,
                   long long v_sh, float scale, void* stream) {
  Args a{q, k, v, nullptr, bias, nullptr, nullptr, out, nullptr, lse,
         B, H, L, causal, {q_sb, q_sl, q_sh}, {k_sb, k_sl, k_sh},
         {v_sb, v_sl, v_sh}, {0, 0, 0}, scale,
         static_cast<cudaStream_t>(stream)};
  return run(kFwd, dtype, D, a);
}

// dq (B, L, H, D) contiguous from q, k, v, dout (strided as above), the
// forward's lse and delta = rowsum(dout * out), both (B, H, L) f32.
int pdtn_flash_dq(int dtype, int D, int causal, const void* q, const void* k,
                  const void* v, const void* dout, const float* bias,
                  const float* lse, const float* delta, void* dq, int B, int H,
                  int L, long long q_sb, long long q_sl, long long q_sh,
                  long long k_sb, long long k_sl, long long k_sh,
                  long long v_sb, long long v_sl, long long v_sh,
                  long long do_sb, long long do_sl, long long do_sh,
                  float scale, void* stream) {
  Args a{q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr,
         B, H, L, causal, {q_sb, q_sl, q_sh}, {k_sb, k_sl, k_sh},
         {v_sb, v_sl, v_sh}, {do_sb, do_sl, do_sh}, scale,
         static_cast<cudaStream_t>(stream)};
  return run(kDq, dtype, D, a);
}

// dk and dv (B, L, H, D) contiguous; arguments as for pdtn_flash_dq.
int pdtn_flash_dkv(int dtype, int D, int causal, const void* q, const void* k,
                   const void* v, const void* dout, const float* bias,
                   const float* lse, const float* delta, void* dk, void* dv,
                   int B, int H, int L, long long q_sb, long long q_sl,
                   long long q_sh, long long k_sb, long long k_sl,
                   long long k_sh, long long v_sb, long long v_sl,
                   long long v_sh, long long do_sb, long long do_sl,
                   long long do_sh, float scale, void* stream) {
  Args a{q, k, v, dout, bias, lse, delta, dk, dv, nullptr,
         B, H, L, causal, {q_sb, q_sl, q_sh}, {k_sb, k_sl, k_sh},
         {v_sb, v_sl, v_sh}, {do_sb, do_sl, do_sh}, scale,
         static_cast<cudaStream_t>(stream)};
  return run(kDkv, dtype, D, a);
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
