// Shared helpers for the hand-written Hopper kernels of multihmr_tpu_torch.
//
// Storage types: bf16 tensors are passed as raw 16-bit words (uint16_t) and
// converted with the cuda_bf16.h intrinsics; fp32 tensors as float. Every
// kernel computes in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mhmr {

// dtype codes shared with the Python bindings (ops/cuda_lib.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float load(T v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ T store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(T v) { return v; }
  static __device__ __forceinline__ T store(float f) { return f; }
};

// element strides of a [B, H, 64, N] view: batch, head, channel, token
struct Strides {
  long long b, h, d, n;
};

// ---- mma.sync building blocks (bf16 operands, fp32 accumulators)
//
// Fragment recipes used by the attention kernels, for a tile in shared
// memory with row stride `ld` (elements); mi = lane / 8, mr = lane % 8:
//  * A (16 x 16, row = m, col = k) from a [k][m] tile, with .trans:
//      &s[(16 * ks + (mi / 2) * 8 + mr) * ld + m0 + (mi % 2) * 8]
//  * B of two n-tiles (2 x 8 wide, 16 deep) from a [k][n] tile, with .trans:
//      &s[(16 * ks + (mi % 2) * 8 + mr) * ld + 8 * (2 * np + mi / 2)]
//  * B of two n-tiles from an [n][k] tile, without .trans:
//      &s[(8 * (2 * np + mi / 2) + mr) * ld + 16 * ks + (mi % 2) * 8]
// and the C fragments of n-tiles 2j, 2j + 1 re-pack in registers into the A
// fragment of k-step j (C element i sits at row g + 8 * (i / 2), column
// 2 * tq + i % 2 of its 16 x 8 tile; g = lane / 4, tq = lane % 4).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(BF16::store(lo)) |
         (static_cast<uint32_t>(BF16::store(hi)) << 16);
}

// A fragment of k-step j from the C fragments of n-tiles 2j and 2j + 1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// [64 channels][kTok tokens] bf16 tile starting at token n0 into shared
// memory with row stride kStride, by kThreads threads; tokens >= lim -> 0.
// 2-byte loads coalesced along tokens: any stride and any N work.
template <int kTok, int kStride, int kThreads>
__device__ __forceinline__ void stage_tile(uint16_t* __restrict__ s,
                                           const uint16_t* __restrict__ g,
                                           long long sd, long long sn, int n0,
                                           int lim, int tid) {
#pragma unroll 8
  for (int i = 0; i < (64 * kTok) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int d = e / kTok;
    const int t = e % kTok;
    const int n = n0 + t;
    s[d * kStride + t] = n < lim ? g[d * sd + n * sn] : uint16_t(0);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device (`done` is
// the caller's static per-device flag array of kMaxDevices entries).
constexpr int kMaxDevices = 16;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

}  // namespace mhmr
