// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of `pallas_attention`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py), each in a bf16
// (`*_tc_kernel`) and an f32 (`*_3xtf32_kernel`) version, all on the
// tensor cores:
//   - flash_fwd_*  <- `_flash_forward` (`_flash_fwd_kernel_res`,
//     `_flash_fwd_kernel`);
//   - flash_dq_*   <- `_flash_backward`'s dq call
//     (`_flash_dq_kernel_res`, `_flash_dq_kernel`);
//   - flash_dkv_*  <- `_flash_backward`'s dk/dv call
//     (`_flash_dkv_kernel_res`, `_flash_dkv_kernel`).
// Same function and the same rounding points:
//   s = (q . k) * D^-1/2 + bias[key]   (bias 0 keep / -1e30 pad, optional);
//   causal: s = -1e30 where q_pos < k_pos;
//   forward: online softmax with m starting at -1e30, l = max(l, 1e-30),
//     p rounded to v's type before P @ V (f32: not rounded), f32
//     accumulator, out = acc / l in the input type, lse = m + log(l) in f32;
//   dq:  p = exp(s - lse), dp = dO . V (f32), ds = p * (dp - delta) * scale,
//        dq = round(ds, k's type) @ K;
//   dkv: dv = p^T @ dO and dk = ds^T @ Q with p, ds, Q and dO all in f32.
// delta = rowsum(dO * O) is computed outside, as the TPU path does.
//
// Layouts. q, k, v and dO are read in their (B, L, H, D) layout through
// their batch / sequence / head strides (D contiguous, every row on a
// 16-byte boundary, else cudaErrorMisalignedAddress and no launch): the
// TPU path's (B*H, L, D) relayout and its lane-major lse / delta / mask
// tiles were Mosaic tiling needs. lse and delta are (B, H, L) f32, the pad
// bias is (B, L) f32, outputs are contiguous (B, L, H, D).
//
// What bounds it on this card: operations. Per (batch, head) the forward
// does 4 * L^2 * D FLOPs against 8 * L * D bytes of q/k/v/out; at
// BertBase (L = 512, D = 64, bf16) that is 256 FLOPs per byte, and the
// backward does 14 * L^2 * D (dk/dv's two f32 products count twice in
// bf16, and every f32 product three times, below). Both dtypes share one
// geometry:
//   - one block of 4 warps per (batch*head, 64-row tile), each warp owning
//     16 rows (the f32 forward and dk/dv: 128 rows, 32 a warp), so a
//     softmax row never leaves its warp (its max and sum reduce over the 4
//     lanes of a quad with two shuffles);
//   - the tile the block keeps (Q in the forward; Q and dO in dq; K and V
//     in dk/dv) is loaded once; the other operand streams through a
//     2-stage ring of 16-byte `cp.async` copies, the next tile loading
//     under the current one's products. Shared-memory rows are padded by
//     16 bytes against bank conflicts;
//   - scores never leave registers: the accumulator of S (or of dS) is
//     the A operand of the next product, P @ V or dS @ K, as it stands;
//   - dk/dv work per query tile on S^T = K Q^T and dP^T = V dO^T, keys as
//     the accumulator rows, so p^T and ds^T are A fragments with no
//     transpose;
//   - causal: tiles wholly above the diagonal are skipped; a ragged last
//     tile (L not a multiple of the tile) is masked in the kernel, so any
//     L works. D is instantiated for 16, 32 and 64, the head dims of the
//     port's models. No atomics: each block writes its own rows, so
//     results repeat bit for bit from run to run.
//
// bfloat16 (the training path's default): the *_tc kernels.
//   - every product is `mma.sync.m16n8k16` bf16 x bf16 -> f32. Q and dO
//     are loaded into registers as A fragments (`ldmatrix.x4`), K and V
//     into shared memory, their A fragments read again per use (registers,
//     not shared memory, bound the blocks per SM there); the streamed
//     tiles have 64 rows. `ldmatrix` reads every operand: the eight row
//     addresses of each phase fall in eight different bank groups;
//   - registers: `ptxas -v` reports no spills; dq works on 16-key and
//     dk/dv on 16-query chunks of the score tile, so at D = 64 the
//     forward takes 160 registers (3 blocks an SM), dq 128 (4) and dk/dv
//     168 (3);
//   - the m16n8 f32 accumulator of S (or of dS) is, two n8 tiles at a
//     time, the m16k16 A fragment of the next product once rounded to
//     bf16; its B operand (V, K) comes through `ldmatrix.trans`;
//   - dk/dv: the TPU kernel multiplies p^T @ dO and ds^T @ Q in f32; here
//     p (and ds) splits into hi = bf16(p) and lo = bf16(p - hi), and
//     hi @ dO + lo @ dO accumulates in f32: p is kept to 16 bits
//     (relative error <= 2^-17 before the sum) against exact bf16 dO and
//     Q, far below the 2^-8 of dk/dv's own bf16 rounding. Four products
//     instead of two; ops/reference.py's plain version splits the same.
//   - forward and dq round p and ds to bf16 where the TPU kernel does.
//
// float32 (the train and evaluator CLIs' default dtype, the f32 gradient
// check): the *_3xtf32 kernels, f32-accurate on the TF32 tensor cores.
//   - not "TF32 mode": every f32 operand x splits exactly into
//     hi = tf32(x) and lo = tf32(x - hi), both rounded as
//     `cvt.rna.tf32.f32` rounds (10 explicit mantissa bits, to nearest,
//     ties away from zero; `split`); together they keep 22 significant
//     bits. Every product a @ b is three `mma.sync.m16n8k8` TF32 products,
//     lo(a) hi(b) and hi(a) lo(b) first, then hi(a) hi(b), as CUTLASS's
//     3xTF32 does; the dropped lo(a) lo(b) and the two roundings of lo are
//     each below 2^-22 of |a||b|, so a sum of products is within about
//     2^-20 of sum |a||b| of the f32 result, whatever
//     `torch.backends.cuda.matmul.allow_tf32` says (ops/reference.py's
//     `einsum_3xtf32` is the plain version of such a product). Three
//     products at the data sheet's 494.7 TFLOP/s dense TF32 would be an
//     effective 165 TFLOP/s of f32, 2.5x the CUDA cores' 67; `mma.sync`
//     reaches 250-285 of the 494.7 (tools/mma_tf32.py), so about 90;
//   - the operands are split where their fragments are read, in each warp
//     (splitting a streamed tile once into hi and lo planes in shared
//     memory would double its shared-memory traffic, and the kernels are
//     bound by instruction issue and latency, not by the tensor pipe):
//     Q, dO, K and V from shared memory with 4-byte loads, rows padded by
//     4 floats, which makes both fragment roles free of bank conflicts:
//     an A fragment or a B^T fragment (row g, column t / t + 4) hits bank
//     4g + t (+ 4), a B fragment read in the relabelled order below (rows
//     2t and 2t + 1, column g) bank 8t + g (+ 4);
//   - sums along the sequence (O over keys, dq over keys, dk and dv over
//     queries) are not chained in the tensor cores' accumulator, whose
//     truncating adds bias a long sum toward zero (ten times an f32 FMA
//     loop's error over 512 keys on an H100, and dS = P (dP - delta)
//     magnifies it where dP and delta nearly cancel): each tile's share
//     is summed in a fresh accumulator and added in f32 registers, rounded
//     to nearest (`add_tile_products`);
//   - P and dS stay in registers. An m16n8 f32 accumulator holds columns
//     2t and 2t + 1 of each 8-key group; a tf32 m16k8 A fragment wants
//     columns t and t + 4. So the keys inside each 8-key group are
//     relabelled (2t -> t, 2t + 1 -> t + 4) and the B operand's rows are
//     read in the same order: the accumulator {c0, c1, c2, c3} of S (or
//     dS) is the A fragment {c0, c2, c1, c3} of P @ V (or dS @ K), split
//     into hi and lo, with no shared-memory round trip and no shuffle;
//   - shapes (kFwd*, kDq*, kDkv*): a warp of the forward and of dk/dv owns
//     two m16 tiles (32 rows; a block keeps 128), so every streamed K, V,
//     Q or dO fragment it splits feeds two products; dq keeps one (two
//     would need Q and dO tiles of 128 rows). The streamed tiles have 16
//     rows (forward, dk/dv) and 32 (dq), 2 stages. At D = 64 `ptxas -v`
//     reports no spills and 168 registers for the forward (3 blocks an SM;
//     51 KB of shared memory a block), 160 for dq (3; 68 KB) and 255 for
//     dk/dv (2; 85.25 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;  // rows of the tile a block keeps
constexpr float kNegInf = -1e30f;  // the JAX kernels' _NEG_INF

struct Strides {
  long long b, l, h;
};

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

// ---------------------------------------------------------------------------
// Copies and stores of both dtypes, then the bfloat16 kernels
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

// Stage rows [row0, row0 + ROWS) of one (batch, head) slice, D elements
// each, into `dst` (rows of D + E, E the elements of 16 bytes) with
// 16-byte cp.async copies; rows past L are zero.
template <int D, int ROWS = kTile, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* base,
                                           long long s_l, int row0, int L) {
  constexpr int E = 16 / sizeof(T), CH = D / E, SD = D + E, N = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (N + kTcThreads - 1) / kTcThreads; ++it) {
    const int c = threadIdx.x + it * kTcThreads;
    if (N % kTcThreads != 0 && c >= N) break;
    const int r = c / CH, cc = c - r * CH, row = row0 + r;
    const bool ok = row < L;
    cp_async16(smem_u32(dst + r * SD + cc * E),
               base + (ok ? row : 0) * s_l + cc * E, ok);
  }
}

// The lse and delta of Q tile rows [q0, q0 + ROWS) into dst[0..ROWS-1]
// and dst[ROWS..2 ROWS-1], one f32 copy per thread; rows past L are zero.
template <int ROWS = kTile>
__device__ __forceinline__ void rows_async(float* dst, const float* lse,
                                           const float* delta, int q0,
                                           int L) {
  static_assert(2 * ROWS <= kTcThreads, "rows_async: one row value a thread");
  if (2 * ROWS < kTcThreads && threadIdx.x >= 2 * ROWS) return;
  const int i = threadIdx.x & (ROWS - 1), row = q0 + i;
  const bool first = threadIdx.x < ROWS;
  cp_async4(smem_u32(dst + (first ? 0 : ROWS) + i),
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

// Two neighbouring columns of an accumulator row, in the output's type
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write a warp's 16 x D f32 accumulator rows (row0 + g, row0 + g + 8 of
// the (b, h) slice) in T, rows < L only.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[D / 8][4], int b,
                                           int h, int H, int L, int row0,
                                           const float div[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= L) continue;
    T* orow = out + ((static_cast<long long>(b) * L + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(orow + 8 * n + 2 * t, acc[n][2 * half] / div[half],
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

// ---------------------------------------------------------------------------
// float32: three TF32 products a product
// ---------------------------------------------------------------------------

// c (16 x 8 f32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col)
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An mma fragment of N f32 values, each split into hi = tf32(x) and
// lo = tf32(x - hi)
template <int N>
struct Split {
  unsigned hi[N], lo[N];
};

// Both terms round as `cvt.rna.tf32.f32` does (to nearest, ties away from
// zero: half a tf32 unit, 0x1000, added to the bits), but in integer
// operations: the tensor cores read only the top 19 bits of a .tf32
// operand, so lo needs no mask, and hi only for x - hi. `cvt.rna` itself
// compiles into a longer sequence with a guard for inf and NaN, which no
// operand here is, and the kernels are bound by instruction issue.
template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    s.lo[i] = __float_as_uint(x[i] - __uint_as_float(s.hi[i])) + 0x1000u;
  }
  return s;
}

// c += a * b to f32 accuracy: lo(a) hi(b) and hi(a) lo(b) first, then
// hi(a) hi(b)
__device__ __forceinline__ void mma_3xtf32(float c[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The register layouts of m16n8k8 with tf32 operands (lane = 4 g + t): an
// A fragment holds rows g (a0, a2) and g + 8 (a1, a3) of columns t (a0,
// a1) and t + 4 (a2, a3); a B fragment column (n) g of rows (k) t (b0)
// and t + 4 (b1); an accumulator rows g (c0, c1) and g + 8 (c2, c3) of
// columns 2t (c0, c2) and 2t + 1 (c1, c3). Relabelling the columns of
// each 8-column group (2t -> t, 2t + 1 -> t + 4) makes an accumulator the
// A fragment {c0, c2, c1, c3} of a product whose B rows are read in the
// same order (b_frag_relabelled).

// The A fragment of rows row0 .. row0 + 15, columns col0 .. col0 + 7 of a
// row-major f32 tile with rows of SD floats
template <int SD>
__device__ __forceinline__ Split<4> a_frag_f32(const float* tile, int row0,
                                               int col0) {
  const int l = threadIdx.x & 31;
  const float* p = tile + (row0 + (l >> 2)) * SD + col0 + (l & 3);
  const float x[4] = {p[0], p[8 * SD], p[4], p[8 * SD + 4]};
  return split(x);
}
// The B fragment of columns n0 .. n0 + 7, rows k0 .. k0 + 7 of B, from
// B^T (n x k) row-major in the tile (K in Q K^T, Q in K Q^T)
template <int SD>
__device__ __forceinline__ Split<2> b_frag_f32(const float* tile, int n0,
                                               int k0) {
  const int l = threadIdx.x & 31;
  const float* p = tile + (n0 + (l >> 2)) * SD + k0 + (l & 3);
  const float x[2] = {p[0], p[4]};
  return split(x);
}
// The same from B (k x n) row-major in the tile, rows k0 .. k0 + 7 in the
// relabelled order (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q)
template <int SD>
__device__ __forceinline__ Split<2> b_frag_relabelled(const float* tile,
                                                      int k0, int n0) {
  const int l = threadIdx.x & 31;
  const float* p = tile + (k0 + 2 * (l & 3)) * SD + n0 + (l >> 2);
  const float x[2] = {p[0], p[SD]};
  return split(x);
}
// An n8 accumulator as the (relabelled) A fragment of the next product
__device__ __forceinline__ Split<4> acc_as_a(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split(x);
}

// acc[mt] += a[mt] @ B over one streamed tile: a[mt][j] the A fragment of
// its rows 8j .. 8j + 7 (relabelled), B (k x n) row-major in the tile. The
// tensor cores add a product into its accumulator with a truncating sum:
// chained over a whole sequence (L / 8 x 3 products) that biases a sum
// toward zero by some 1e-6 of itself, ten times an f32 FMA loop's error,
// and dS = P (dP - delta) magnifies it where dP and delta nearly cancel.
// So each n8 column block of the tile is summed in a fresh accumulator
// (NJ x 3 products) and added to acc in f32, rounded to nearest.
template <int SD, int ND, int MT, int NJ>
__device__ __forceinline__ void add_tile_products(
    float (&acc)[MT][ND][4], const Split<4> (&a)[MT][NJ], const float* tile) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float part[MT][4] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const Split<2> bf = b_frag_relabelled<SD>(tile, 8 * j, 8 * n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_3xtf32(part[mt], a[mt][j], bf);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[mt][e];
  }
}

// The (relabelled) A fragments of MT x NJ n8 accumulators
template <int MT, int NJ>
__device__ __forceinline__ void accs_as_a(Split<4> (&a)[MT][NJ],
                                          const float (&c)[MT][NJ][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) a[mt][j] = acc_as_a(c[mt][j]);
}

// The f32 kernels' shared memory at head dim D (rows of D + 4 floats): a
// block keeps R rows (64 MT) and streams S-row tiles through 2 stages:
// Q + 2 x K + 2 x V; Q + dO + 2 x K + 2 x V; K + V + 2 x Q + 2 x dO and
// 2 x (lse, delta) of S rows
template <int D>
constexpr int f32_rows_bytes(int rows) { return rows * (D + 4) * 4; }
template <int D, int S, int MT>
constexpr int fwd_f32_smem() {
  return f32_rows_bytes<D>(kTile * MT) + 4 * f32_rows_bytes<D>(S);
}
template <int D, int S, int MT>
constexpr int dq_f32_smem() {
  return 2 * f32_rows_bytes<D>(kTile * MT) + 4 * f32_rows_bytes<D>(S);
}
template <int D, int S, int MT>
constexpr int dkv_f32_smem() { return dq_f32_smem<D, S, MT>() + 4 * S * 4; }

// The key columns of an S-key tile this lane's accumulators hold (8 n +
// 2t + e for n8 tile n, e in {0, 1}) as an additive term: the pad bias,
// or -inf past L (those keys take no part at all)
template <int NK>
__device__ __forceinline__ void key_terms(float (&kt)[NK][2],
                                          const float* __restrict__ bias_b,
                                          int k0, int L) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * n + 2 * t + e;
      kt[n][e] = key >= L ? -INFINITY : bias_b ? bias_b[key] : 0.f;
    }
}

// masked_score from a raw dot product and the key's term
__device__ __forceinline__ float masked(float dot, float scale, float term,
                                        int causal, int q_pos, int key) {
  const float s = dot * scale + term;
  return causal && q_pos < key && s != -INFINITY ? kNegInf : s;
}

// Forward. A block keeps 64 MT query rows, a warp 16 MT of them as MT
// m16 tiles, so every K and V fragment a warp splits feeds MT products.
template <int D, int KT, int MT, int MINB>
__global__ void __launch_bounds__(kTcThreads, MINB)
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ lse,
                        int H, int L, Strides qs, Strides ks, Strides vs,
                        int causal, float scale) {
  constexpr int SD = D + 4, ND = D / 8, NK = KT / 8, TS = KT * SD;
  constexpr int QR = kTile * MT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + QR * SD;  // 2 stages
  float* Vs = Ks + 2 * TS;   // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * QR, w0 = 16 * MT * warp, r0 = q0 + w0;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int nk = (L + KT - 1) / KT;
  // causal: key tiles past the Q tile's last row are skipped
  const int kt_end = causal ? min(nk, (q0 + QR + KT - 1) / KT) : nk;

  tile_async<D, QR>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  tile_async<D, KT>(Ks, kb, ks.l, 0, L);
  tile_async<D, KT>(Vs, vb, vs.l, 0, L);
  cp_async_commit();

  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1, k0 = kt * KT;
    if (kt + 1 < kt_end) {  // the next K/V tile loads under this one
      tile_async<D, KT>(Ks + (stage ^ 1) * TS, kb, ks.l, k0 + KT, L);
      tile_async<D, KT>(Vs + (stage ^ 1) * TS, vb, vs.l, k0 + KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + stage * TS;
    const float* Vt = Vs + stage * TS;
    float s[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {  // S = Q K^T, 8 of D at a time
      Split<4> qa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        qa[mt] = a_frag_f32<SD>(Qs, w0 + 16 * mt, 8 * kk);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const Split<2> kf = b_frag_f32<SD>(Kt, 8 * n, 8 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(s[mt][n], qa[mt], kf);
      }
    }
    float terms[NK][2];
    key_terms(terms, bias_b, k0, L);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = masked(s[mt][n][e], scale, terms[n][e & 1], causal,
                               r0 + 16 * mt + g + 8 * (e >> 1),
                               k0 + 8 * n + 2 * t + (e & 1));
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][n][e]);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mt][i], quad_max(mx[i]));
        corr[i] = expf(m[mt][i] - m_new);
        m[mt][i] = m_new;
        l[mt][i] *= corr[i];  // per-lane partial sums; the quad adds them last
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = expf(s[mt][n][e] - m[mt][e >> 1]);
          l[mt][e >> 1] += s[mt][n][e];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[mt][n][0] *= corr[0];
        o[mt][n][1] *= corr[0];
        o[mt][n][2] *= corr[1];
        o[mt][n][3] *= corr[1];
      }
    }
    Split<4> pa[MT][NK];
    accs_as_a(pa, s);
    add_tile_products<SD>(o, pa, Vt);  // o += P V
    __syncthreads();  // this stage's readers are done before it refills
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rm = r0 + 16 * mt;
    float lc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lc[i] = fmaxf(quad_sum(l[mt][i]), 1e-30f);
    store_rows<D>(out, o[mt], b, h, H, L, rm, lc);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rm + g + 8 * i;
        if (row < L)
          lse[static_cast<long long>(bh) * L + row] = m[mt][i] + logf(lc[i]);
      }
    }
  }
}

// dq. A block keeps 64 MT rows of Q and dO, a warp MT m16 tiles of them.
template <int D, int KT, int MT, int MINB>
__global__ void __launch_bounds__(kTcThreads, MINB)
flash_dq_3xtf32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dq, int H, int L, Strides qs,
                       Strides ks, Strides vs, Strides dos, int causal,
                       float scale) {
  constexpr int SD = D + 4, ND = D / 8, NK = KT / 8, TS = KT * SD;
  constexpr int QR = kTile * MT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + QR * SD;
  float* Ks = dOs + QR * SD;  // 2 stages
  float* Vs = Ks + 2 * TS;    // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * QR, w0 = 16 * MT * warp, r0 = q0 + w0;
  const float* bias_b = bias ? bias + static_cast<long long>(b) * L : nullptr;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int nk = (L + KT - 1) / KT;
  const int kt_end = causal ? min(nk, (q0 + QR + KT - 1) / KT) : nk;

  tile_async<D, QR>(Qs, q + b * qs.b + h * qs.h, qs.l, q0, L);
  tile_async<D, QR>(dOs, dout + b * dos.b + h * dos.h, dos.l, q0, L);
  tile_async<D, KT>(Ks, kb, ks.l, 0, L);
  tile_async<D, KT>(Vs, vb, vs.l, 0, L);
  cp_async_commit();

  float row_lse[MT][2], row_delta[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * mt + g + 8 * i;
      const long long at = static_cast<long long>(bh) * L + row;
      row_lse[mt][i] = row < L ? lse[at] : 0.f;
      row_delta[mt][i] = row < L ? delta[at] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt & 1, k0 = kt * KT;
    if (kt + 1 < kt_end) {
      tile_async<D, KT>(Ks + (stage ^ 1) * TS, kb, ks.l, k0 + KT, L);
      tile_async<D, KT>(Vs + (stage ^ 1) * TS, vb, vs.l, k0 + KT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + stage * TS;
    const float* Vt = Vs + stage * TS;
    float s[MT][NK][4], dp[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {  // S = Q K^T and dP = dO V^T
      Split<4> qa[MT], da[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        qa[mt] = a_frag_f32<SD>(Qs, w0 + 16 * mt, 8 * kk);
        da[mt] = a_frag_f32<SD>(dOs, w0 + 16 * mt, 8 * kk);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const Split<2> kf = b_frag_f32<SD>(Kt, 8 * n, 8 * kk);
        const Split<2> vf = b_frag_f32<SD>(Vt, 8 * n, 8 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(s[mt][n], qa[mt], kf);
          mma_3xtf32(dp[mt][n], da[mt], vf);
        }
      }
    }
    float terms[NK][2];
    key_terms(terms, bias_b, k0, L);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = k0 + 8 * n + 2 * t + (e & 1);
          const float x = masked(s[mt][n][e], scale, terms[n][e & 1], causal,
                                 r0 + 16 * mt + g + 8 * i, key);
          const float p = key < L ? expf(x - row_lse[mt][i]) : 0.f;
          s[mt][n][e] = p * (dp[mt][n][e] - row_delta[mt][i]) * scale;  // ds
        }
    Split<4> sa[MT][NK];
    accs_as_a(sa, s);
    add_tile_products<SD>(acc, sa, Kt);  // dq += dS K
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<D>(dq, acc[mt], b, h, H, L, r0 + 16 * mt, one);
}

// dk/dv. A block keeps 64 MT rows of K and V, a warp MT m16 tiles of them
// (keys as the accumulator rows).
template <int D, int QT, int MT, int MINB>
__global__ void __launch_bounds__(kTcThreads, MINB)
flash_dkv_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ bias,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int L, Strides qs, Strides ks, Strides vs,
                        Strides dos, int causal, float scale) {
  constexpr int SD = D + 4, ND = D / 8, NQ = QT / 8, TS = QT * SD;
  constexpr int KR = kTile * MT;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + KR * SD;
  float* Qs = Vs + KR * SD;      // 2 stages
  float* dOs = Qs + 2 * TS;      // 2 stages
  float* rows_s = dOs + 2 * TS;  // 2 x (lse, delta)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * KR, w0 = 16 * MT * warp, r0 = k0 + w0;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * L;
  const float* delta_bh = delta + static_cast<long long>(bh) * L;
  const int nq = (L + QT - 1) / QT;
  const int qt0 = causal ? k0 / QT : 0;  // earlier Q tiles see no key here

  tile_async<D, KR>(Ks, k + b * ks.b + h * ks.h, ks.l, k0, L);
  tile_async<D, KR>(Vs, v + b * vs.b + h * vs.h, vs.l, k0, L);
  tile_async<D, QT>(Qs, qb, qs.l, qt0 * QT, L);
  tile_async<D, QT>(dOs, dob, dos.l, qt0 * QT, L);
  rows_async<QT>(rows_s, lse_bh, delta_bh, qt0 * QT, L);
  cp_async_commit();

  // the bias of this lane's keys, and whether they exist
  float kbias[MT][2];
  bool kin[MT][2];
  float dk_acc[MT][ND][4], dv_acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = r0 + 16 * mt + g + 8 * i;
      kin[mt][i] = key < L;
      kbias[mt][i] = (bias && kin[mt][i])
                         ? bias[static_cast<long long>(b) * L + key]
                         : 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[mt][n][e] = dv_acc[mt][n][e] = 0.f;
  }

  for (int qt = qt0; qt < nq; ++qt) {
    const int stage = (qt - qt0) & 1, q0 = qt * QT;
    if (qt + 1 < nq) {
      tile_async<D, QT>(Qs + (stage ^ 1) * TS, qb, qs.l, q0 + QT, L);
      tile_async<D, QT>(dOs + (stage ^ 1) * TS, dob, dos.l, q0 + QT, L);
      rows_async<QT>(rows_s + (stage ^ 1) * 2 * QT, lse_bh, delta_bh,
                     q0 + QT, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + stage * TS;
    const float* dOt = dOs + stage * TS;
    const float* lse_s = rows_s + stage * 2 * QT;
    const float* delta_s = lse_s + QT;
    float st[MT][NQ][4], dpt[MT][NQ][4];  // S^T, dP^T: rows keys
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][n][e] = dpt[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {  // S^T = K Q^T and dP^T = V dO^T
      Split<4> ka[MT], va[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ka[mt] = a_frag_f32<SD>(Ks, w0 + 16 * mt, 8 * kk);
        va[mt] = a_frag_f32<SD>(Vs, w0 + 16 * mt, 8 * kk);
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const Split<2> qf = b_frag_f32<SD>(Qt, 8 * n, 8 * kk);
        const Split<2> df = b_frag_f32<SD>(dOt, 8 * n, 8 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(st[mt][n], ka[mt], qf);
          mma_3xtf32(dpt[mt][n], va[mt], df);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
          const int key = r0 + 16 * mt + g + 8 * i, q_pos = q0 + c;
          float x = st[mt][n][e] * scale + kbias[mt][i];
          if (causal && q_pos < key) x = kNegInf;
          const float p =
              (kin[mt][i] && q_pos < L) ? expf(x - lse_s[c]) : 0.f;
          st[mt][n][e] = p;
          dpt[mt][n][e] = p * (dpt[mt][n][e] - delta_s[c]) * scale;  // ds
        }
    Split<4> xa[MT][NQ];
    accs_as_a(xa, st);
    add_tile_products<SD>(dv_acc, xa, dOt);  // dv += p^T dO
    accs_as_a(xa, dpt);
    add_tile_products<SD>(dk_acc, xa, Qt);  // dk += ds^T Q
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_rows<D>(dk, dk_acc[mt], b, h, H, L, r0 + 16 * mt, one);
    store_rows<D>(dv, dv_acc[mt], b, h, H, L, r0 + 16 * mt, one);
  }
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

// The f32 kernels' shapes: rows of a streamed tile, m16 tiles a warp (the
// block keeps 64 x that many rows) and the blocks an SM the launch bound
// asks for (its register cap: 65536 / (128 x blocks))
constexpr int kFwdStream = 16, kFwdTiles = 2, kFwdBlocks = 3;
constexpr int kDqStream = 32, kDqTiles = 1, kDqBlocks = 3;
constexpr int kDkvStream = 16, kDkvTiles = 2, kDkvBlocks = 2;

template <int D, int S, int MT, int MINB>
cudaError_t launch_f32_fwd(const Args& a) {
  static bool ready = false;
  auto kern = flash_fwd_3xtf32_kernel<D, S, MT, MINB>;
  constexpr int smem = fwd_f32_smem<D, S, MT>();
  const cudaError_t err = allow_smem(kern, smem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kTile * MT - 1) / (kTile * MT), a.B * a.H);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, static_cast<float*>(a.out),
      a.lse_out, a.H, a.L, a.qs, a.ks, a.vs, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D, int S, int MT, int MINB>
cudaError_t launch_f32_dq(const Args& a) {
  static bool ready = false;
  auto kern = flash_dq_3xtf32_kernel<D, S, MT, MINB>;
  constexpr int smem = dq_f32_smem<D, S, MT>();
  const cudaError_t err = allow_smem(kern, smem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kTile * MT - 1) / (kTile * MT), a.B * a.H);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.bias, a.lse, a.delta, static_cast<float*>(a.out), a.H, a.L, a.qs,
      a.ks, a.vs, a.dos, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D, int S, int MT, int MINB>
cudaError_t launch_f32_dkv(const Args& a) {
  static bool ready = false;
  auto kern = flash_dkv_3xtf32_kernel<D, S, MT, MINB>;
  constexpr int smem = dkv_f32_smem<D, S, MT>();
  const cudaError_t err = allow_smem(kern, smem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kTile * MT - 1) / (kTile * MT), a.B * a.H);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.bias, a.lse, a.delta, static_cast<float*>(a.out),
      static_cast<float*>(a.out2), a.H, a.L, a.qs, a.ks, a.vs, a.dos,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(Which which, const Args& a) {
  if (which == kFwd)
    return launch_f32_fwd<D, kFwdStream, kFwdTiles, kFwdBlocks>(a);
  if (which == kDq) return launch_f32_dq<D, kDqStream, kDqTiles, kDqBlocks>(a);
  return launch_f32_dkv<D, kDkvStream, kDkvTiles, kDkvBlocks>(a);
}

// 16-byte cp.async copies need every row of q, k, v and dO to start on a
// 16-byte boundary: data pointers 16-byte aligned and strides multiples of
// the E elements of 16 bytes. The wrapper copies an operand that is not.
bool rows_aligned(const Args& a, bool bwd, int E) {
  auto ok = [E](const void* p, const Strides& s) {
    return p && reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
           s.b % E == 0 && s.l % E == 0 && s.h % E == 0;
  };
  return ok(a.q, a.qs) && ok(a.k, a.ks) && ok(a.v, a.vs) &&
         (!bwd || ok(a.dout, a.dos));
}

template <int D>
cudaError_t launch(Which which, int dtype, const Args& a) {
  return dtype == 0 ? launch_f32<D>(which, a) : launch_tc<D>(which, a);
}

int run(Which which, int dtype, int D, const Args& a) {
  if (a.B < 1 || a.H < 1 || a.L < 1 ||
      static_cast<long long>(a.B) * a.H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!rows_aligned(a, which != kFwd, dtype == 0 ? 4 : 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(which, dtype, a));
    case 32: return static_cast<int>(launch<32>(which, dtype, a));
    case 64: return static_cast<int>(launch<64>(which, dtype, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, L, H, D) with the given (batch, sequence, head) element
// strides, D contiguous and every row 16-byte aligned (else
// cudaErrorMisalignedAddress and no launch); dtype 0 = float32 (three TF32
// products a product), 1 = bfloat16; D in {16, 32, 64}. bias: (B, L) f32
// additive key bias or null. Writes out (B, L, H, D) contiguous and lse
// (B, H, L) f32. Returns the launch's cudaError_t (0 on success).
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
