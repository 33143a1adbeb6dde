"""The card's ``mma.sync`` TF32 products: their rate, and the accuracy of a
sum chained in their accumulator. What the f32 flash kernels are built on.

    python -m pytorch_distributed_nn_tpu_torch.tools.mma_tf32

The f32 flash kernels (``ops/csrc/flash_attention.cu``, ``*_3xtf32``)
take every product as three ``mma.sync.aligned.m16n8k8`` TF32 products
of split operands. Two facts of the card set their design:

- the rate: the data sheet's TF32 peak (494.7 TFLOP/s dense on an H100)
  is ``wgmma``'s. ``mma_tf32_rate`` has warps do nothing but m16n8k8
  TF32 products on 8 (or 4) independent accumulators, 4 blocks of 4
  warps an SM, and one warp an SM on a single accumulator (the latency
  of one dependent product);
- the accuracy of a long sum: ``mma_tf32_sums`` takes 4096 random
  16 x K by K x 8 products (one warp each, K = 64 and 512, normal
  entries) as an f32 FMA loop, as three TF32 products a step chained in
  one accumulator over all of K, and as the same with each step's three
  products in a fresh accumulator added to the sum in f32 (what the
  kernels do along the sequence), each against the f64 product.

It prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.utils import native_build

_SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float c[4], const unsigned a[4],
                                    const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <int CH>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i)
    b[i] = __float_as_uint(1e-3f * (threadIdx.x - i)) & 0xffffe000u;
  float c[CH][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CH; ++j) mma(c[j], a, b);
  float s = 0.f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}
// C (16 x 8) = A (16 x K, row-major) B (K x 8, row-major), a warp each:
// how 0 = f32 FMA loop, 1 = 3xTF32 chained, 2 = 3xTF32 fresh a step
__global__ void sums(const float* A, const float* B, float* C, int K,
                     int how) {
  const int l = threadIdx.x, g = l >> 2, t = l & 3;
  const float* a = A + static_cast<size_t>(blockIdx.x) * 16 * K;
  const float* b = B + static_cast<size_t>(blockIdx.x) * K * 8;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (how == 0) {
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
      for (int k = 0; k < K; ++k) c[i] = fmaf(a[r * K + k], b[k * 8 + n], c[i]);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float ax[4] = {a[g * K + k0 + t], a[(g + 8) * K + k0 + t],
                           a[g * K + k0 + t + 4], a[(g + 8) * K + k0 + t + 4]};
      const float bx[2] = {b[(k0 + t) * 8 + g], b[(k0 + t + 4) * 8 + g]};
      unsigned ah[4], al[4], bh[2], bl[2];
      for (int i = 0; i < 4; ++i) split(ax[i], ah[i], al[i]);
      for (int i = 0; i < 2; ++i) split(bx[i], bh[i], bl[i]);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      float* acc = how == 1 ? c : d;
      mma(acc, al, bh);
      mma(acc, ah, bl);
      mma(acc, ah, bh);
      if (how == 2)
        for (int i = 0; i < 4; ++i) c[i] += d[i];
    }
  }
  float* o = C + static_cast<size_t>(blockIdx.x) * 128;
  for (int i = 0; i < 4; ++i) o[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[i];
}
extern "C" int mma_loop_launch(int chains, int blocks, int threads,
                               int iters, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 1) mma_loop<1><<<blocks, threads, 0, st>>>(out, iters);
  else if (chains == 4) mma_loop<4><<<blocks, threads, 0, st>>>(out, iters);
  else mma_loop<8><<<blocks, threads, 0, st>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int sums_launch(const float* A, const float* B, float* C, int P,
                           int K, int how, void* stream) {
  sums<<<P, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C, K, how);
  return cudaGetLastError();
}
"""

#: (independent accumulators a warp, blocks an SM, threads a block)
RATE_CASES = ((8, 4, 128), (4, 4, 128), (1, 1, 32))
ITERS = 2000
#: the sums' ways, as ``sums`` numbers them
SUMS = ("f32 FMA loop", "3xTF32 chained", "3xTF32 fresh a step")
PROBLEMS = 4096


def _library() -> ctypes.CDLL:
    os.makedirs(native_build.BUILD_DIR, exist_ok=True)
    tag = hashlib.sha256(_SOURCE.encode()).hexdigest()[:12]
    so = os.path.join(native_build.BUILD_DIR, f"libpdtn_mma_tf32-{tag}.so")
    if not os.path.exists(so):
        src = so[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(_SOURCE)
        flags = [f for f in native_build.NVCC_FLAGS if "ptxas" not in f]
        subprocess.run([native_build.nvcc_path(), *flags, "-o", so, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.mma_loop_launch.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.sums_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {rc}")


def mma_tf32_rate(lib=None) -> list:
    """One row per case: TFLOP/s of m16n8k8 TF32 products over the card,
    and ns per product a warp (with one accumulator: its latency)."""
    lib = lib or _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for chains, per_sm, threads in RATE_CASES:
        blocks = sms * per_sm
        _check(lib.mma_loop_launch(chains, blocks, threads, 10,
                                   out.data_ptr(), stream), "mma_loop")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.mma_loop_launch(chains, blocks, threads, ITERS,
                                 out.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        _check(rc, "mma_loop")
        ms = start.elapsed_time(end)
        mmas = blocks * threads // 32 * ITERS * chains
        rows.append({
            "chains": chains, "blocks_per_sm": per_sm, "threads": threads,
            "ms": ms, "tflop_per_s": mmas * 2048 / (ms * 1e-3) / 1e12,
            "ns_per_mma_a_warp": ms * 1e6 / (ITERS * chains)})
    return rows


def mma_tf32_sums(lib=None, seed: int = 0) -> list:
    """One row per (K, way): the error of the sums against the f64
    product, the median and largest relative to |c|, and the mean signed
    error over sum |a| |b| (a bias shows there)."""
    lib = lib or _library()
    rng = np.random.RandomState(seed)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for K in (64, 512):
        a = rng.randn(PROBLEMS, 16, K).astype(np.float32)
        b = rng.randn(PROBLEMS, K, 8).astype(np.float32)
        want = np.einsum("pik,pkn->pin", a.astype(np.float64),
                         b.astype(np.float64))
        size = np.einsum("pik,pkn->pin", np.abs(a).astype(np.float64),
                         np.abs(b).astype(np.float64))
        A, B = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        C = torch.empty((PROBLEMS, 16, 8), device="cuda")
        for how, name in enumerate(SUMS):
            _check(lib.sums_launch(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                   PROBLEMS, K, how, stream), "sums")
            err = C.cpu().numpy().astype(np.float64) - want
            rel = np.abs(err) / np.abs(want)
            rows.append({"K": K, "sum": name,
                         "median_rel_err": float(np.median(rel)),
                         "max_err_over_size": float(
                             (np.abs(err) / size).max()),
                         "mean_err_over_size": float((err / size).mean())})
    return rows


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    lib = _library()
    print(json.dumps({"rate": mma_tf32_rate(lib),
                      "sums": mma_tf32_sums(lib)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
