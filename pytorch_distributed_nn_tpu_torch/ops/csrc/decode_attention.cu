// Single-position decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_attn_kernel` / `pallas_decode_attention`
// (pytorch_distributed_nn_tpu/ops/pallas_kernels.py). Same function: one
// query row per (batch, head) against the cached K/V panel, keys with index
// > positions[b] dropped, scores (q . k) * D^-1/2 in f32, softmax with f32
// statistics (m = max, p = exp(s - m), l = max(sum p, 1e-30)), then
// out = (p / l) @ V with the weights p / l rounded to the cache type and an
// f32 accumulator.
//
// What bounds it: the K/V panel read, 2 * (pos + 1) * D elements per
// (batch, head), about one FLOP per byte. At GptMini's decode shapes
// (B <= 8, S <= 128, H = 4, D = 32) that is at most 256 KB, well under a
// microsecond at 3.35 TB/s: the kernel's time is latency, the launch plus
// each dependent trip to memory and each barrier. The design cuts those:
//   - one warp per (batch, head) when the head's K and V fit one warp's
//     staging buffer (S <= 128 at the port's head widths), a block of one
//     warp, and no block-wide barrier on that path (blocks of several
//     such heads measured no faster on an H100, so one head a block
//     everywhere);
//   - the warp issues every load it needs at once: positions[b], its
//     lanes' pieces of q, and the K and V rows of the head as 16-byte
//     `cp.async` copies into shared memory, consecutive lanes on
//     consecutive 16 bytes of a row, so each row is one coalesced segment.
//     K and V are in flight together: one memory round trip. The rows are
//     copied up to the panel's length S, live or not, because the count of
//     live rows (positions[b]) is itself a load; rows past positions[b]
//     are never used;
//   - lanes cooperate on a row: at D = 32 f32, 8 lanes each take 16 bytes
//     (a float4) of a key and multiply it by their 4 elements of q, held in
//     registers; 3 shuffles add the row, and one warp-wide read scores 4
//     keys. Of the 8 rows a group scores for a slot of 32 keys, lane c
//     keeps row c's score, so every lane holds one score a slot (4 at
//     S = 128) in registers. The max and the sum are warp shuffles;
//   - the rounding point: p / l can be rounded to the cache type only
//     once l is known, so the whole softmax is two-pass over the scores
//     held in registers (no running-max rescaling), exact as the reference
//     for f32 and bf16;
//   - P @ V in the same layout: each lane multiplies its 16 bytes of a V
//     row by the row's weight (one shuffle from the lane that holds it)
//     into 4 (f32) or 8 (bf16) accumulators; the groups' sums are added
//     by shuffles in a fixed order at the end. Shared-memory rows are
//     padded by 16 bytes, so the 8 lanes of a 16-byte read phase hit
//     distinct banks.
// Long caches (the plan gives a head more than one warp): the warps of one
// block split the keys; each stages its share K tile by tile (tiles of
// 32 * k keys under one staging budget), scores it in rounds of as many
// keys as its lanes hold scores (512), and keeps the round's m and l,
// rescaling l when a later round raises m. One barrier publishes the
// warps' m and l; each warp forms the head's m and l from them in a fixed
// order. Only then are the weights formed: with one round the scores are
// still in registers, with several each round is scored again from K, so
// p / l is rounded against the final m and l as above, and V is staged
// tile by tile after (its first tile copied during the reductions). The
// partial P @ V sums are added in a fixed order after a second barrier.
// Still one launch, and no limit on S but the int range.
// Every sum is taken in a fixed order: two launches on the same inputs give
// the same bits.
//
// The launch plan (warps per head, keys per warp, tile keys, staging
// mode, shared memory) is computed in Python
// (`kernels.decode_launch_plan`); this file checks it and launches. Head
// dims 16, 32 and 64 (GptTiny, GptMini, BertBase) are compiled as
// templates with q in registers; any other D <= 256 takes the general
// instantiation (a lane per key, q in shared memory, scalar reads). A
// cache whose rows are not 16-byte aligned is staged with scalar loads by
// a branch inside the same kernel (`vec` = 0), never by the plain version.
// Positions must lie in [0, S): the engine guarantees it (padding rows use
// position 0 of the scratch page).
//
// ptxas -v (sm_90a, CUDA 12.9, H100 build): 72 to 128 registers over the 16
// instantiations (95 for f32 at D = 32 with 4 slots, GptMini's), no
// spills. chip_smoke.py phase 2 prints them and fails on a spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// launch bounds (512, 1): up to 128 registers a thread. With the minimum
// of blocks left out, ptxas (CUDA 12.9) capped the 4-slot instantiations
// below what they need, and they spilled
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// scores a lane holds, a round of 32 of them a warp: kFewSlots (128 keys)
// on the short path and wherever a warp's share is that small, else
// kMaxSlots (512 keys); a longer share takes several rounds
constexpr int kFewSlots = 4;
constexpr int kMaxSlots = 16;
constexpr int kMaxD = 256;
constexpr int kMaxOut = kMaxD / 32;  // output elements a lane accumulates
constexpr unsigned kFull = 0xffffffffu;

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
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 16 bytes of a row in shared memory as f32: 4 floats or 8 bf16
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// Lanes of a row for the head dims compiled with q in registers: a row of
// kD elements is kLanes 16-byte pieces, one a lane, so one warp-wide
// read covers kKeys rows.
template <typename T, int kD>
struct Geo {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLanes = kD > 0 ? kD / kPer : 1;
  static constexpr int kKeys = 32 / kLanes;
};

// Copy rows [r0, r1) of one head's panel (row j at src + j * row_stride
// elements) into shared memory rows of `row_bytes` from dst: 16-byte
// cp.async copies when `vec` (consecutive lanes on consecutive 16 bytes
// of a row), else scalar loads. Not waited for.
template <typename T, int kD>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* src,
                                           long long row_stride, int r0,
                                           int r1, int D, int row_bytes,
                                           bool vec, int lane) {
  if (r1 <= r0) return;
  if (vec && kD > 0) {
    using G = Geo<T, kD>;
    const int c = lane % G::kLanes;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src) +
                             16 * c;
    const long long step = row_stride * static_cast<long long>(sizeof(T));
    unsigned char* d = dst + 16 * c - r0 * row_bytes;
#pragma unroll 4
    for (int r = r0 + lane / G::kLanes; r < r1; r += G::kKeys)
      cp_async16(d + r * row_bytes, s + r * step);
  } else if (vec) {
    const int per_row = D * static_cast<int>(sizeof(T)) / 16;
    for (int i = lane; i < (r1 - r0) * per_row; i += 32) {
      const int r = i / per_row, c = i - r * per_row;
      cp_async16(dst + r * row_bytes + 16 * c,
                 reinterpret_cast<const unsigned char*>(
                     src + (r0 + r) * row_stride) + 16 * c);
    }
  } else {
    for (int i = lane; i < (r1 - r0) * D; i += 32) {
      const int r = i / D, d = i - r * D;
      reinterpret_cast<T*>(dst + r * row_bytes)[d] =
          src[(r0 + r) * row_stride + d];
    }
  }
}

// The slots hold a lane's scores, then weights: slot s covers keys
// [32 s, 32 s + 32) of the warp. They are filled and read one slot at a
// time in order, through a register array that turns over by one per slot
// (static indices in a loop that is not unrolled): `push` appends slot s
// at the end; after NS pushes sc[s] is slot s. `pop` takes slot 0
// and turns the array over, so the next slot comes first.
template <int NS>
__device__ __forceinline__ void push(float (&sc)[NS], float v) {
#pragma unroll
  for (int i = 0; i + 1 < NS; ++i) sc[i] = sc[i + 1];
  sc[NS - 1] = v;
}
template <int NS>
__device__ __forceinline__ float pop(float (&sc)[NS]) {
  const float v = sc[0];
  push(sc, v);
  return v;
}

// Scores of the warp's live keys in tile [t0, t1) (warp-local key indices,
// multiples of 32), K rows of the tile in shared memory from kt, pushed
// slot by slot (-inf past `live`). kD > 0: the kLanes lanes of a row
// multiply their 16 bytes by their piece of q (qf) and add across the row
// by shuffles; of the kLanes rows a group scores for a slot, its lane c
// keeps row c's score (key 32 s + kKeys c + group). kD == 0: key
// 32 s + lane, a lane per key, q in shared memory (qs).
template <typename T, int kD, int NS>
__device__ __forceinline__ void score_tile(float (&sc)[NS],
                                           const float* qf, const float* qs,
                                           const unsigned char* kt, int t0,
                                           int t1, int live, int D,
                                           int row_bytes, float scale,
                                           int lane) {
  using G = Geo<T, kD>;
  const int c = lane % G::kLanes, grp = lane / G::kLanes;
#pragma unroll 1
  for (int s0 = t0; s0 < min(t1, live); s0 += 32) {
    float mine = -INFINITY;
    if constexpr (kD > 0) {
#pragma unroll
      for (int j = 0; j < G::kLanes; ++j) {
        const int key = s0 + G::kKeys * j + grp;
        float f[G::kPer];
        Vec<T>::load(kt + (key - t0) * row_bytes + 16 * c, f);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < G::kPer; ++e) d = fmaf(qf[e], f[e], d);
#pragma unroll
        for (int o = G::kLanes / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(kFull, d, o);
        if (j == c && key < live) mine = d * scale;
      }
    } else {
      const int key = s0 + lane;
      if (key < live) {
        const T* r = reinterpret_cast<const T*>(kt + (key - t0) * row_bytes);
        float d = 0.f;
#pragma unroll 1
        for (int e = 0; e < D; ++e) d = fmaf(qs[e], to_f32(r[e]), d);
        mine = d * scale;
      }
    }
    push(sc, mine);
  }
}

// acc += sum over the warp's live keys in tile [t0, t1) of w_j * V_j, the
// weights popped slot by slot, V rows from vt. kD > 0: each lane
// accumulates its 16-byte piece of the rows its group takes, even rows in
// acc[0..kPer) and odd ones in acc[kPer..2 kPer) (two chains of
// dependent adds); the caller adds the two, then the groups. kD == 0:
// lanes across D (acc[i] is element lane + 32 i), keys one after another.
template <typename T, int kD, int NS>
__device__ __forceinline__ void pv_tile(float (&acc)[2 * kMaxOut],
                                        float (&w)[NS],
                                        const unsigned char* vt, int t0,
                                        int t1, int live, int D,
                                        int row_bytes, int lane) {
  using G = Geo<T, kD>;
  const int c = lane % G::kLanes, grp = lane / G::kLanes;
#pragma unroll 1
  for (int s0 = t0; s0 < min(t1, live); s0 += 32) {
    const float ws = pop(w);
    if constexpr (kD > 0) {
#pragma unroll
      for (int j = 0; j < G::kLanes; ++j) {
        const int key = s0 + G::kKeys * j + grp;
        const float wj = __shfl_sync(kFull, ws, grp * G::kLanes + j);
        // a row past `live` may hold anything, NaN included: read it (it
        // lies in the buffer) and drop it by a select, not a branch
        const bool use = key < live;
        float f[G::kPer];
        Vec<T>::load(vt + (key - t0) * row_bytes + 16 * c, f);
        float* to = j & 1 ? acc + G::kPer : acc;  // two chains of sums
#pragma unroll
        for (int e = 0; e < G::kPer; ++e)
          to[e] = fmaf(wj, use ? f[e] : 0.f, to[e]);
      }
    } else {
      const int cnt = min(32, live - s0);
#pragma unroll 1
      for (int t = 0; t < cnt; ++t) {
        const float wj = __shfl_sync(kFull, ws, t);
        const T* r =
            reinterpret_cast<const T*>(vt + (s0 + t - t0) * row_bytes);
#pragma unroll
        for (int i = 0; i < kMaxOut; ++i)
          if (lane + 32 * i < D)
            acc[i] = fmaf(wj, to_f32(r[lane + 32 * i]), acc[i]);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* positions;
  void* out;
  int H, S, D;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int warps_per_head;  // W
  int keys_per_warp;   // C, a multiple of 32
  int tile_keys;       // keys staged at a time, a multiple of 32, <= C
  int together;        // K and V of the warp's C keys staged at once
  int vec;             // 16-byte cp.async staging (rows 16-byte aligned)
  int row_bytes;       // shared-memory row: D * elem rounded up to 16, + 16
  int stage_bytes;     // staging buffer of a warp
};

// The scores of the warp's live keys in round [r0, r0 + 32 NS) into sc
// (slot s at sc[s], -inf past `live`): from the K rows staged with V
// (`together`: the warp has one round), else staged tile by tile from kw.
template <typename T, int kD, int NS>
__device__ __forceinline__ void score_round(float (&sc)[NS], const Args& a,
                                            const float* qf, const float* qs,
                                            unsigned char* stage, const T* kw,
                                            int r0, int live, int D,
                                            bool vec, int lane) {
  const int r1 = min(r0 + 32 * NS, live);
  if (a.together) {
    score_tile<T, kD, NS>(sc, qf, qs, stage, 0, a.keys_per_warp, live, D,
                          a.row_bytes, a.scale, lane);
  } else {
#pragma unroll 1
    for (int t0 = r0; t0 < r1; t0 += a.tile_keys) {
      const int t1 = min(t0 + a.tile_keys, r1);
      stage_rows<T, kD>(stage, kw, a.k_ss, t0, t1, D, a.row_bytes, vec,
                        lane);
      cp_async_wait_all();
      __syncwarp();
      score_tile<T, kD, NS>(sc, qf, qs, stage, t0, t1, live, D, a.row_bytes,
                            a.scale, lane);
      __syncwarp();
    }
  }
#pragma unroll 1
  for (int s = (r1 - r0 + 31) / 32; s < NS; ++s) push(sc, -INFINITY);
}

template <typename T, int kD, int NS>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_attn_kernel(const __grid_constant__ Args a) {
  using G = Geo<T, kD>;
  constexpr int kRound = 32 * NS;  // keys whose scores a warp holds
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = kD > 0 ? kD : a.D;
  const int W = a.warps_per_head;  // the block's warps: one head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head = blockIdx.x;
  const int b = head / a.H, h = head % a.H;

  unsigned char* stage = smem + warp * a.stage_bytes;
  float* part = reinterpret_cast<float*>(smem + W * a.stage_bytes);
  float* qs = part + W * D + warp * D;  // this warp's q (kD == 0)
  float* red = part + 2 * W * D;       // 2 floats a warp
  float* mypart = part + warp * D;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const int key0 = warp * a.keys_per_warp;  // the warp's first key
  const T* kw = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh +
                key0 * a.k_ss;
  const T* vw = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh +
                key0 * a.v_ss;
  const int span = max(0, min(a.keys_per_warp, a.S - key0));
  const int c = lane % G::kLanes;

  // every load at once: positions, q, and (when they fit) K and V
  const int pos = a.positions[b];
  float qf[kD > 0 ? G::kPer : 1];
  if constexpr (kD > 0) {
#pragma unroll
    for (int e = 0; e < G::kPer; ++e)
      qf[e] = to_f32(qp[c * G::kPer + e]);
  } else {
    for (int d = lane; d < D; d += 32) qs[d] = to_f32(qp[d]);
  }
  const bool vec = a.vec != 0;
  if (a.together) {
    stage_rows<T, kD>(stage, kw, a.k_ss, 0, span, D, a.row_bytes, vec, lane);
    stage_rows<T, kD>(stage + a.keys_per_warp * a.row_bytes, vw, a.v_ss, 0,
                      span, D, a.row_bytes, vec, lane);
    cp_async_wait_all();
  }
  __syncwarp();
  // live keys of this warp: 0..pos of the head, within the warp's share
  const int live = max(0, min(span, min(pos + 1, a.S) - key0));
  const int rounds = (live + kRound - 1) / kRound;

  // pass 1: the warp's m and l over its rounds of kRound keys (l rescaled
  // when a later round raises m); with one round, its scores stay in sc
  float sc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) sc[s] = -INFINITY;
  float mw = -INFINITY, lw = 0.f;
#pragma unroll 1
  for (int r0 = 0; r0 < live; r0 += kRound) {
    score_round<T, kD, NS>(sc, a, qf, qs, stage, kw, r0, live, D, vec, lane);
    float mr = -INFINITY;
#pragma unroll
    for (int s = 0; s < NS; ++s) mr = fmaxf(mr, sc[s]);
    const float mn = fmaxf(mw, warp_max(mr));
    float lr = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      lr += sc[s] == -INFINITY ? 0.f : expf(sc[s] - mn);
    lw = (mw == -INFINITY ? 0.f : lw * expf(mw - mn)) + warp_sum(lr);
    mw = mn;
  }
  // the first V tile is on its way while the statistics are reduced
  const bool v_early = !a.together && rounds == 1;
  if (v_early)
    stage_rows<T, kD>(stage, vw, a.v_ss, 0, min(a.tile_keys, live), D,
                      a.row_bytes, vec, lane);

  // m and l of the head: the warp's, or over its W warps (fixed order)
  float m = mw, l = lw;
  if (W > 1) {
    if (lane == 0) {
      red[2 * warp] = mw;
      red[2 * warp + 1] = lw;
    }
    __syncthreads();
    m = red[0];
    for (int i = 1; i < W; ++i) m = fmaxf(m, red[2 * i]);
    l = 0.f;
    for (int i = 0; i < W; ++i)
      if (red[2 * i] != -INFINITY) l += red[2 * i + 1] * expf(red[2 * i] - m);
  }
  l = fmaxf(l, 1e-30f);

  // pass 2, round by round (scored again when there are several): the
  // weights p / l = exp(s - m) / l rounded to the cache type, then P @ V
  float acc[2 * kMaxOut];
#pragma unroll
  for (int i = 0; i < 2 * kMaxOut; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int r0 = 0; r0 < live; r0 += kRound) {
    if (rounds > 1)
      score_round<T, kD, NS>(sc, a, qf, qs, stage, kw, r0, live, D, vec,
                             lane);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      sc[s] = sc[s] == -INFINITY ? 0.f
                                 : to_f32(from_f32<T>(expf(sc[s] - m) / l));
    if (a.together) {
      pv_tile<T, kD, NS>(acc, sc, stage + a.keys_per_warp * a.row_bytes, 0,
                         a.keys_per_warp, live, D, a.row_bytes, lane);
      continue;
    }
    const int r1 = min(r0 + kRound, live);
#pragma unroll 1
    for (int t0 = r0; t0 < r1; t0 += a.tile_keys) {
      const int t1 = min(t0 + a.tile_keys, r1);
      if (!(v_early && t0 == 0))
        stage_rows<T, kD>(stage, vw, a.v_ss, t0, t1, D, a.row_bytes, vec,
                          lane);
      cp_async_wait_all();
      __syncwarp();
      pv_tile<T, kD, NS>(acc, sc, stage, t0, t1, live, D, a.row_bytes, lane);
      __syncwarp();
    }
  }
  // kD > 0: add the groups' sums (fixed order); lanes 0..kLanes-1 then
  // hold elements c * kPer .. c * kPer + kPer - 1 of the warp's sum
  if constexpr (kD > 0) {
#pragma unroll
    for (int e = 0; e < G::kPer; ++e) acc[e] += acc[G::kPer + e];
#pragma unroll
    for (int o = G::kLanes; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < G::kPer; ++e)
        acc[e] += __shfl_xor_sync(kFull, acc[e], o);
  }
  // the warp's sums: kD > 0, lanes 0..kLanes-1, each its kPer elements;
  // kD == 0, every lane, elements lane + 32 i. One warp writes the
  // output; W warps write their sums to shared memory, and the first adds
  // them in order.
  T* op = static_cast<T*>(a.out) + static_cast<long long>(head) * D;
  if (kD == 0 || lane < G::kLanes) {
#pragma unroll
    for (int i = 0; i < (kD > 0 ? G::kPer : kMaxOut); ++i) {
      const int d = kD > 0 ? c * G::kPer + i : lane + 32 * i;
      if (d >= D) continue;
      if (W > 1)
        mypart[d] = acc[i];
      else
        op[d] = from_f32<T>(acc[i]);
    }
  }
  if (W == 1) return;
  __syncthreads();
  if (warp != 0) return;
  for (int d = lane; d < D; d += 32) {
    float o = part[d];
    for (int i = 1; i < W; ++i) o += part[i * D + d];
    op[d] = from_f32<T>(o);
  }
}

// The shared-memory attribute is a device's, so it is set before every
// launch that needs it (a host call, next to nothing beside the launch)
template <typename T, int kD, int NS>
cudaError_t launch_one(const Args& a, int blocks, int threads, int smem,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {  // the default dynamic limit
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, kD, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_kernel<T, kD, NS><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t launch_slots(const Args& a, int blocks, int threads, int smem,
                         cudaStream_t stream) {
  if (a.keys_per_warp <= 32 * kFewSlots)
    return launch_one<T, kD, kFewSlots>(a, blocks, threads, smem, stream);
  return launch_one<T, kD, kMaxSlots>(a, blocks, threads, smem, stream);
}

template <typename T>
cudaError_t launch(const Args& a, int blocks, int threads, int smem,
                   cudaStream_t stream) {
  switch (a.D) {
    case 16:
      return launch_slots<T, 16>(a, blocks, threads, smem, stream);
    case 32:
      return launch_slots<T, 32>(a, blocks, threads, smem, stream);
    case 64:
      return launch_slots<T, 64>(a, blocks, threads, smem, stream);
    default:
      return launch_slots<T, 0>(a, blocks, threads, smem, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (D) axis of q, k and v must be contiguous. out is (B, 1, H, D)
// contiguous. The plan (kernels.decode_launch_plan): warps per head (the
// block's warps; one block a head), keys per warp, keys per staged tile, K
// and V staged together (1) or in tiles (0), shared-memory bytes of the
// block; vec = 1 when k and v rows are 16-byte aligned. Returns the
// launch's cudaError_t (0 on success).
int pdtn_decode_attention(int dtype, const void* q, const void* k,
                          const void* v, const int* positions, void* out,
                          int B, int H, int S, int D, long long q_sb,
                          long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, float scale, int warps_per_head,
                          int keys_per_warp, int tile_keys, int together,
                          int vec, int smem_bytes, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const int W = warps_per_head;
  if (D > kMaxD || D < 1 || S < 1 || B < 1 || H < 1 || W < 1 ||
      W > kMaxWarps || keys_per_warp < 32 || keys_per_warp % 32 ||
      static_cast<long long>(W) * keys_per_warp < S || tile_keys < 32 ||
      tile_keys % 32 || tile_keys > keys_per_warp ||
      (together &&
       (tile_keys != keys_per_warp || keys_per_warp > 32 * kMaxSlots)) ||
      (vec && (D * elem) % 16) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, positions, out, H, S, D, q_sb, q_sh, k_sb, k_ss,
         k_sh, v_sb, v_ss, v_sh, scale, W, keys_per_warp, tile_keys,
         together, vec, 0, 0};
  a.row_bytes = (D * elem + 15) / 16 * 16 + 16;
  a.stage_bytes = (together ? 2 : 1) * tile_keys * a.row_bytes;
  const long long need = static_cast<long long>(W) *
                         (a.stage_bytes + 8 * D + 8);
  if (smem_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, B * H, 32 * W, smem_bytes, st));
  return static_cast<int>(launch<__nv_bfloat16>(a, B * H, 32 * W,
                                                smem_bytes, st));
}

const char* pdtn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
