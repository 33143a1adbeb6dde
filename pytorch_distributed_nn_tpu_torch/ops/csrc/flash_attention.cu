// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of `pallas_attention`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py), each in a bf16
// (`*_tc_kernel`, tensor cores) and an f32 (CUDA cores) version:
//   - flash_fwd_[tc_]kernel  <- `_flash_forward` (`_flash_fwd_kernel_res`,
//     `_flash_fwd_kernel`);
//   - flash_dq_[tc_]kernel   <- `_flash_backward`'s dq call
//     (`_flash_dq_kernel_res`, `_flash_dq_kernel`);
//   - flash_dkv_[tc_]kernel  <- `_flash_backward`'s dk/dv call
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
// backward does 14 * L^2 * D (dk/dv's two f32 products count twice in
// bf16, below). Two designs, one per dtype.
//
// bfloat16 (the training path): the *_tc kernels, on the tensor cores.
//   - one block of 4 warps per (batch*head, 64-row tile), each warp owning
//     16 rows, so a softmax row never leaves its warp (its max and sum
//     reduce over the 4 lanes of a quad with two shuffles);
//   - every product is `mma.sync.m16n8k16` bf16 x bf16 -> f32. The tile
//     the block keeps (Q in the forward; Q and dO in dq; K and V in dk/dv)
//     is loaded once: Q and dO into registers as A fragments
//     (`ldmatrix.x4`), K and V into shared memory, their A fragments read
//     again per use (registers, not shared memory, bound the blocks per
//     SM there). The other operand streams in 64-row tiles through a
//     2-stage ring of 16-byte `cp.async` copies, the next tile loading
//     under the current one's products. Shared-memory rows are padded by
//     16 bytes, so the eight row addresses of every `ldmatrix` phase fall
//     in eight different bank groups;
//   - registers: `ptxas -v` reports no spills; dq works on 16-key and
//     dk/dv on 16-query chunks of the score tile, so at D = 64 the
//     forward takes 160 registers (3 blocks an SM), dq 128 (4) and dk/dv
//     168 (3);
//   - scores never leave registers: the m16n8 f32 accumulator of S (or
//     of dS) is, two n8 tiles at a time, the m16k16 A fragment of the next
//     product once rounded to bf16, so P @ V and dS @ K take their A
//     operand straight from registers and their B operand (V, K) through
//     `ldmatrix.trans`;
//   - dk/dv work per key tile on S^T = K Q^T and dP^T = V dO^T, keys as
//     the accumulator rows, so p^T and ds^T are A fragments with no
//     transpose. The TPU kernel multiplies p^T @ dO and ds^T @ Q in f32;
//     here p (and ds) splits into hi = bf16(p) and lo = bf16(p - hi), and
//     hi @ dO + lo @ dO accumulates in f32: p is kept to 16 bits
//     (relative error <= 2^-17 before the sum) against exact bf16 dO and
//     Q, far below the 2^-8 of dk/dv's own bf16 rounding. Four products
//     instead of two; ops/reference.py's plain version splits the same.
//   - forward and dq round p and ds to bf16 where the TPU kernel does.
//
// float32 (tests, the f32 gradient check): flash_{fwd,dq,dkv}_kernel, on
// the CUDA cores, the backward's f32 products as the TPU kernel computes
// them:
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
// 103 KB, dk/dv at D = 64; the tensor-core kernels at most 56 KB). D is
// instantiated for 16, 32 and 64, the head dims of the port's models.
// Neither design uses atomics: each block writes its own rows, so results
// repeat bit for bit from run to run.

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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 rows = one 64-row tile

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (the
// source address must still be valid)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 in one register, `lo` (the lower column) in the
// low half, as an mma fragment holds them
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// what pack_bf16 dropped: bf16(x - bf16(x)) for both halves
__device__ __forceinline__ unsigned pack_bf16_rest(float lo, float hi,
                                                   unsigned packed) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

// The k16 A fragment of columns 16 kk .. 16 kk + 15 of n8 f32
// accumulators x, split into hi = bf16(x) and lo = bf16(x - hi)
template <int N>
__device__ __forceinline__ void split_a_frag(const float (&x)[N][4], int kk,
                                             unsigned hi[4], unsigned lo[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = 2 * kk + (r >> 1), e = 2 * (r & 1);
    hi[r] = pack_bf16(x[n][e], x[n][e + 1]);
    lo[r] = pack_bf16_rest(x[n][e], x[n][e + 1], hi[r]);
  }
}

// The register layouts of m16n8k16 (lane = 4 * g + t): an A fragment holds
// rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; a B fragment
// holds columns (n) g, rows (k) 2t, 2t + 1, 2t + 8, 2t + 9; an accumulator
// c[0..1] row g, columns 2t, 2t + 1, and c[2..3] the same of row g + 8.
// Two n8 accumulators side by side are therefore one A fragment of k16:
//   a = {c0[0..1], c0[2..3], c1[0..1], c1[2..3]}.
template <int SD>
__device__ __forceinline__ void a_frag(unsigned r[4], const bf16* tile,
                                       int row0, int col0) {
  // A (rows x k) row-major in shared memory, rows row0.., k col0..
  const int l = threadIdx.x & 31;
  ldsm_x4(r, smem_u32(tile + (row0 + (l & 15)) * SD + col0 + (l >> 4) * 8));
}
template <int SD>
__device__ __forceinline__ void b_frags(unsigned r[4], const bf16* tile,
                                        int n0, int k0) {
  // B^T (n x k) row-major: r[0..1] the B fragment of n0.., r[2..3] of n0+8..
  const int l = threadIdx.x & 31;
  ldsm_x4(r, smem_u32(tile + (n0 + ((l >> 4) << 3) + (l & 7)) * SD + k0 +
                      ((l >> 3) & 1) * 8));
}
template <int SD>
__device__ __forceinline__ void b_frags_trans(unsigned r[4], const bf16* tile,
                                              int k0, int n0) {
  // B (k x n) row-major: r[0..1] the B fragment of n0.., r[2..3] of n0+8..
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(r, smem_u32(tile + (k0 + (l & 15)) * SD + n0 + (l >> 4) * 8));
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice, D bf16 each,
// into `dst` (rows of D + 8) with 16-byte cp.async copies; rows past L
// are zero.
template <int D>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* base,
                                           long long s_l, int row0, int L) {
  constexpr int CH = D / 8, SD = D + 8;
  static_assert(kTile * CH % kTcThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kTile * CH / kTcThreads; ++it) {
    const int c = threadIdx.x + it * kTcThreads;
    const int r = c / CH, cc = c - r * CH, row = row0 + r;
    const bool ok = row < L;
    cp_async16(smem_u32(dst + r * SD + cc * 8),
               base + (ok ? row : 0) * s_l + cc * 8, ok);
  }
}

static_assert(kTcThreads == 2 * kTile, "rows_async: one row value a thread");

// The lse and delta of Q tile rows [q0, q0 + 64) into dst[0..63] and
// dst[64..127], one f32 copy per thread; rows past L are zero.
__device__ __forceinline__ void rows_async(float* dst, const float* lse,
                                           const float* delta, int q0,
                                           int L) {
  const int i = threadIdx.x & (kTile - 1), row = q0 + i;
  const bool first = threadIdx.x < kTile;
  cp_async4(smem_u32(dst + (first ? 0 : kTile) + i),
            (first ? lse : delta) + (row < L ? row : 0), row < L);
}

// max / sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write a warp's 16 x D f32 accumulator rows (row0 + g, row0 + g + 8 of
// the (b, h) slice) as bf16, rows < L only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[D / 8][4], int b,
                                           int h, int H, int L, int row0,
                                           const float div[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= L) continue;
    bf16* orow = out + ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * half] / div[half],
                    acc[n][2 * half + 1] / div[half]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int H,
                    int L, Strides qs, Strides ks, Strides vs, int causal,
                    float scale) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, TS = kTile * SD;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + TS;      // 2 stages
  bf16* Vs = Ks + 2 * TS;  // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.x, q0 = qt * kTile, r0 = q0 + 16 * warp;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int nk = (L + kTile - 1) / kTile;
  const int kt_end = causal ? min(nk, qt + 1) : nk;

  tile_async<D>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  cp_async_commit();
  tile_async<D>(Ks, kb, ks.l, 0, L);
  tile_async<D>(Vs, vb, vs.l, 0, L);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; K/V tile 0 may still be in flight
  __syncthreads();
  unsigned qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) a_frag<SD>(qf[kk], Qs, 16 * warp, 16 * kk);

  float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1, k0 = kt * kTile;
    if (kt + 1 < kt_end) {  // the next K/V tile loads under this one
      tile_async<D>(Ks + (stage ^ 1) * TS, kb, ks.l, k0 + kTile, L);
      tile_async<D>(Vs + (stage ^ 1) * TS, vb, vs.l, k0 + kTile, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * TS;
    const bf16* Vt = Vs + stage * TS;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned bk[4];
        b_frags<SD>(bk, Kt, 16 * np, 16 * kk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = masked_score(s[n][e], scale, bias_b, causal,
                               r0 + g + 8 * (e >> 1),
                               k0 + 8 * n + 2 * t + (e & 1), L);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];  // per-lane partial sums; the quad adds them last
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        unsigned bv[4];
        b_frags_trans<SD>(bv, Vt, 16 * kk, 16 * dp);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lc[i] = fmaxf(quad_sum(l[i]), 1e-30f);
  store_rows<D>(out, o, b, h, H, L, r0, lc);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < L) lse[static_cast<long long>(bh) * L + row] = m[i] + logf(lc[i]);
    }
  }
}

// dq: keys per chunk of S and dP. Chunks of 16 keep the kernel within 128
// registers without spills at D = 64, so 4 blocks fit an SM (chunks of 32
// need more registers and fit 3).
constexpr int KC = 16;

template <int D>
__global__ void __launch_bounds__(kTcThreads, 4)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ bias,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int L, Strides qs, Strides ks, Strides vs,
                   Strides dos, int causal, float scale) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, TS = kTile * SD;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + TS;
  bf16* Ks = dOs + TS;     // 2 stages
  bf16* Vs = Ks + 2 * TS;  // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int qt = blockIdx.x, q0 = qt * kTile, r0 = q0 + 16 * warp;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int nk = (L + kTile - 1) / kTile;
  const int kt_end = causal ? min(nk, qt + 1) : nk;

  tile_async<D>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  tile_async<D>(dOs, dout + b * dos.b + h * dos.h, dos.l, q0, L);
  cp_async_commit();
  tile_async<D>(Ks, kb, ks.l, 0, L);
  tile_async<D>(Vs, vb, vs.l, 0, L);
  cp_async_commit();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const long long at = static_cast<long long>(bh) * L + row;
    row_lse[i] = row < L ? lse[at] : 0.f;
    row_delta[i] = row < L ? delta[at] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  unsigned qf[KD][4], dof[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    a_frag<SD>(qf[kk], Qs, 16 * warp, 16 * kk);
    a_frag<SD>(dof[kk], dOs, 16 * warp, 16 * kk);
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1, k0 = kt * kTile;
    if (kt + 1 < kt_end) {
      tile_async<D>(Ks + (stage ^ 1) * TS, kb, ks.l, k0 + kTile, L);
      tile_async<D>(Vs + (stage ^ 1) * TS, vb, vs.l, k0 + kTile, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * TS;
    const bf16* Vt = Vs + stage * TS;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += KC) {  // keys c0 .. c0 + KC - 1
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int np = 0; np < KC / 16; ++np)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          unsigned bk[4], bv[4];
          b_frags<SD>(bk, Kt, c0 + 16 * np, 16 * kk);
          b_frags<SD>(bv, Vt, c0 + 16 * np, 16 * kk);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          mma_bf16(dp[2 * np], dof[kk], bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
        }
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = k0 + c0 + 8 * n + 2 * t + (e & 1);
          const float x = masked_score(s[n][e], scale, bias_b, causal,
                                       r0 + g + 8 * i, key, L);
          const float p = key < L ? expf(x - row_lse[i]) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[i]) * scale;  // ds
        }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {  // dq += bf16(ds) @ K
        const unsigned da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < KD; ++dp2) {
          unsigned bk[4];
          b_frags_trans<SD>(bk, Kt, c0 + 16 * kk, 16 * dp2);
          mma_bf16(acc[2 * dp2], da, bk[0], bk[1]);
          mma_bf16(acc[2 * dp2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, b, h, H, L, r0, one);
}

// dk/dv: queries per chunk of S^T and dP^T. Chunks of 16, and K and V
// fragments reloaded from shared memory per use rather than held in
// registers for the whole loop, keep the kernel within 168 registers
// without spills at D = 64, so 3 blocks fit an SM (held, they need nearly
// all 255 registers a thread may have, and 2 blocks fit).
constexpr int QC = 16;

template <int D>
__global__ void __launch_bounds__(kTcThreads, 3)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int L, Strides qs,
                    Strides ks, Strides vs, Strides dos, int causal,
                    float scale) {
  constexpr int SD = D + 8, KD = D / 16, ND = D / 8, TS = kTile * SD;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TS;
  bf16* Qs = Vs + TS;        // 2 stages
  bf16* dOs = Qs + 2 * TS;   // 2 stages
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * TS);  // 2 x (lse, delta)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kt = blockIdx.x, k0 = kt * kTile, r0 = k0 + 16 * warp;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * L;
  const float* delta_bh = delta + static_cast<long long>(bh) * L;
  const int nq = (L + kTile - 1) / kTile;
  const int qt0 = causal ? kt : 0;  // causal: earlier Q tiles see no key here

  tile_async<D>(Ks, k + b * ks.b + h * ks.h, ks.l, k0, L);
  tile_async<D>(Vs, v + b * vs.b + h * vs.h, vs.l, k0, L);
  tile_async<D>(Qs, qb, qs.l, qt0 * kTile, L);
  tile_async<D>(dOs, dob, dos.l, qt0 * kTile, L);
  rows_async(rows_s, lse_bh, delta_bh, qt0 * kTile, L);
  cp_async_commit();

  // the bias of this lane's two keys, and whether they exist
  float kbias[2];
  bool kin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = r0 + g + 8 * i;
    kin[i] = key < L;
    kbias[i] = (bias && kin[i]) ? bias[static_cast<long long>(b) * L + key]
                                : 0.f;
  }
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int stage = (qt - qt0) & 1, q0 = qt * kTile;
    if (qt + 1 < nq) {
      tile_async<D>(Qs + (stage ^ 1) * TS, qb, qs.l, q0 + kTile, L);
      tile_async<D>(dOs + (stage ^ 1) * TS, dob, dos.l, q0 + kTile, L);
      rows_async(rows_s + (stage ^ 1) * 2 * kTile, lse_bh, delta_bh,
                 q0 + kTile, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + stage * TS;
    const bf16* dOt = dOs + stage * TS;
    const float* lse_s = rows_s + stage * 2 * kTile;
    const float* delta_s = lse_s + kTile;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += QC) {  // queries c0 .. c0 + QC - 1
      float st[QC / 8][4], dpt[QC / 8][4];  // S^T, dP^T: rows keys
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned ka[4], va[4];  // this warp's 16 keys of K and V
        a_frag<SD>(ka, Ks, 16 * warp, 16 * kk);
        a_frag<SD>(va, Vs, 16 * warp, 16 * kk);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          unsigned bq[4], bd[4];
          b_frags<SD>(bq, Qt, c0 + 16 * np, 16 * kk);
          b_frags<SD>(bd, dOt, c0 + 16 * np, 16 * kk);
          mma_bf16(st[2 * np], ka, bq[0], bq[1]);
          mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dpt[2 * np], va, bd[0], bd[1]);
          mma_bf16(dpt[2 * np + 1], va, bd[2], bd[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = c0 + 8 * n + 2 * t + (e & 1);
          const int key = r0 + g + 8 * i, q_pos = q0 + c;
          float x = st[n][e] * scale + kbias[i];
          if (causal && q_pos < key) x = kNegInf;
          const float p = (kin[i] && q_pos < L) ? expf(x - lse_s[c]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[c]) * scale;  // ds
        }
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {  // queries c0 + 16 kk .. + 15
        unsigned hi[4], lo[4];
        split_a_frag(st, kk, hi, lo);  // dv += p^T @ dO
#pragma unroll
        for (int dp2 = 0; dp2 < KD; ++dp2) {
          unsigned bd[4];
          b_frags_trans<SD>(bd, dOt, c0 + 16 * kk, 16 * dp2);
          mma_bf16(dv_acc[2 * dp2], hi, bd[0], bd[1]);
          mma_bf16(dv_acc[2 * dp2 + 1], hi, bd[2], bd[3]);
          mma_bf16(dv_acc[2 * dp2], lo, bd[0], bd[1]);
          mma_bf16(dv_acc[2 * dp2 + 1], lo, bd[2], bd[3]);
        }
        split_a_frag(dpt, kk, hi, lo);  // dk += ds^T @ Q
#pragma unroll
        for (int dp2 = 0; dp2 < KD; ++dp2) {
          unsigned bq[4];
          b_frags_trans<SD>(bq, Qt, c0 + 16 * kk, 16 * dp2);
          mma_bf16(dk_acc[2 * dp2], hi, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dp2 + 1], hi, bq[2], bq[3]);
          mma_bf16(dk_acc[2 * dp2], lo, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dp2 + 1], lo, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dk_acc, b, h, H, L, r0, one);
  store_rows<D>(dv, dv_acc, b, h, H, L, r0, one);
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

// The tensor-core kernels' shared memory: 64-row bf16 tiles of D + 8
// (Q + 2 x K + 2 x V; Q + dO + 2 x K + 2 x V; K + V + 2 x Q + 2 x dO and
// 2 x 64 (lse, delta) pairs)
template <int D>
constexpr int tc_tile_bytes() { return kTile * (D + 8) * 2; }
template <int D>
constexpr int fwd_tc_smem() { return 5 * tc_tile_bytes<D>(); }
template <int D>
constexpr int dq_tc_smem() { return 6 * tc_tile_bytes<D>(); }
template <int D>
constexpr int dkv_tc_smem() { return 6 * tc_tile_bytes<D>() + 4 * kTile * 4; }

template <int D>
cudaError_t launch_tc(Which which, const Args& a) {
  const dim3 grid((a.L + kTile - 1) / kTile, a.B * a.H);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  static bool ready[3] = {false, false, false};
  cudaError_t err;
  if (which == kFwd) {
    auto kern = flash_fwd_tc_kernel<D>;
    if ((err = allow_smem(kern, fwd_tc_smem<D>(), &ready[kFwd])) !=
        cudaSuccess)
      return err;
    kern<<<grid, kTcThreads, fwd_tc_smem<D>(), a.stream>>>(
        q, k, v, a.bias, static_cast<bf16*>(a.out), a.lse_out, a.H, a.L,
        a.qs, a.ks, a.vs, a.causal, a.scale);
  } else if (which == kDq) {
    auto kern = flash_dq_tc_kernel<D>;
    if ((err = allow_smem(kern, dq_tc_smem<D>(), &ready[kDq])) != cudaSuccess)
      return err;
    kern<<<grid, kTcThreads, dq_tc_smem<D>(), a.stream>>>(
        q, k, v, dout, a.bias, a.lse, a.delta, static_cast<bf16*>(a.out),
        a.H, a.L, a.qs, a.ks, a.vs, a.dos, a.causal, a.scale);
  } else {
    auto kern = flash_dkv_tc_kernel<D>;
    if ((err = allow_smem(kern, dkv_tc_smem<D>(), &ready[kDkv])) !=
        cudaSuccess)
      return err;
    kern<<<grid, kTcThreads, dkv_tc_smem<D>(), a.stream>>>(
        q, k, v, dout, a.bias, a.lse, a.delta, static_cast<bf16*>(a.out),
        static_cast<bf16*>(a.out2), a.H, a.L, a.qs, a.ks, a.vs, a.dos,
        a.causal, a.scale);
  }
  return cudaGetLastError();
}

// 16-byte cp.async copies need every row of q, k, v and dO to start on a
// 16-byte boundary: the wrapper copies an operand that does not
bool tc_aligned(const Args& a, bool bwd) {
  auto ok = [](const void* p, const Strides& s) {
    return p && reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
           s.b % 8 == 0 && s.l % 8 == 0 && s.h % 8 == 0;
  };
  return ok(a.q, a.qs) && ok(a.k, a.ks) && ok(a.v, a.vs) &&
         (!bwd || ok(a.dout, a.dos));
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

cudaError_t dispatch_tc(Which which, int D, const Args& a) {
  if (!tc_aligned(a, which != kFwd)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return launch_tc<16>(which, a);
    case 32: return launch_tc<32>(which, a);
    case 64: return launch_tc<64>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, int dtype, int D, const Args& a) {
  if (a.B < 1 || a.H < 1 || a.L < 1 || static_cast<long long>(a.B) * a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(dispatch_d<float>(which, D, a));
  if (dtype == 1) return static_cast<int>(dispatch_tc(which, D, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v: (B, L, H, D) with the given (batch, sequence, head) element
// strides and D contiguous; dtype 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores; every row 16-byte aligned, else cudaErrorMisalignedAddress
// and no launch); D in {16, 32, 64}. bias: (B, L) f32 additive key bias or null. Writes
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
