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

// 2^x on the special-function unit (ex2.approx.ftz: ~2^-22 relative error,
// results below 2^-126 flushed to 0, 2^-inf = 0), for the bf16 flash paths,
// whose outputs round to 2^-8. exp2f's accurate sequence is several
// instructions: with it K3 takes 1.02 ms in place of 0.60 at 896_L
// (tools/kernel_timing.py variants, H100). The fp32 precision paths keep
// exp2f.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// ---- 16-byte asynchronous copies (cp.async) into 128-byte-swizzled tiles
//
// K1 and K3 stage [64 channel][64 token] bf16 tiles of a channels-major
// [.., 64, N] operand whose token rows are 16-byte aligned (N and the
// strides multiples of 8: the caller checks). A tile is 64 rows of 128
// bytes, 8 KB, 1024-byte aligned, with the 16-byte chunk c of row r stored
// at chunk c ^ (r % 8): the layout a 128-byte-swizzled TMA copy writes and
// wgmma's 128-byte-swizzle descriptors read. ldmatrix reads it without bank
// conflicts (the 8 rows of one 8x8 matrix fall in 8 different chunks).

constexpr int kTileElems = 64 * 64;  // one swizzled tile, elements

// element offset of (row r, token t) inside a swizzled tile
__device__ __forceinline__ int swz(int r, int t) {
  return r * 64 + ((((t >> 3) ^ r) & 7) << 3) + (t & 7);
}

// 16 bytes global -> shared, asynchronously; !valid zero-fills and reads
// nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// make this thread's shared-memory writes (st.shared, cp.async) visible to
// the async proxy (wgmma, bulk copies); a barrier must follow
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the [64 ch][64 token] tile at token n0 of a [64, N] bf16 slab with channel
// stride sd into swizzled tile s, by kThreads threads (512 chunks; eight
// threads read one 128-byte row); tokens at or past N are zero-filled
template <int kThreads>
__device__ __forceinline__ void load_tile_async(uint16_t* s, const uint16_t* g,
                                                long long sd, int n0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < 512 / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int r = e >> 3, c = e & 7;
    const int n = n0 + 8 * c;
    const bool ok = n < N;
    cp_async16(s + swz(r, 8 * c), g + r * sd + (ok ? n : 0), ok);
  }
}

// the dynamic shared-memory base rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 8 rows of 128 bytes; launches ask for 1 KB extra)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- wgmma (sm_90a): a warpgroup's m64n64k16 product, A (64 x 16 bf16)
// from registers, B (16 x 64 bf16) from a swizzled tile through a
// descriptor, fp32 accumulators in registers.
//
// Register layouts are those of mma.sync.m16n8k16, per warp of the
// warpgroup (warp w holds rows 16w..16w+15): A is the 4-register A
// fragment, and accumulator d[j][i] holds row g + 8 * (i / 2), column
// 8j + 2tq + i % 2 (g = lane / 4, tq = lane % 4), as a C fragment of n-tile j.
//
// Descriptors of a swizzled [64 row][64 token] tile (128-byte swizzle):
//  * B K-major (rows = n, tokens = k): 8-row groups 1024 bytes apart; k-step
//    kk starts 32 * kk bytes into the rows;
//  * B MN-major (rows = k, tokens = n; imm-trans-b = 1): 8-row groups 1024
//    bytes apart; k-step ks starts at row 16 * ks. The 64 tokens are one
//    swizzle atom, so the stride between atoms along n is never used.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keep the compiler from moving reads or writes of d across an asynchronous
// wgmma (issued before, waited for after)
__device__ __forceinline__ void reg_fence(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

#define MHMR_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d = a * B + (accumulate ? d : 0) (kTransB = 1: B MN-major)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : MHMR_ACC4(0), MHMR_ACC4(1), MHMR_ACC4(2), MHMR_ACC4(3), MHMR_ACC4(4), MHMR_ACC4(5),
        MHMR_ACC4(6), MHMR_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// d = A * B + (accumulate ? d : 0), A (64 x 16) and B (16 x 64) both from
// swizzled tiles (kTransA, kTransB = 1: MN-major). An A fragment held in
// registers across loop iterations is not kept live by ptxas (it reuses
// them once the wgmma is issued), so a loop-invariant A comes from shared
// memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : MHMR_ACC4(0), MHMR_ACC4(1), MHMR_ACC4(2), MHMR_ACC4(3), MHMR_ACC4(4), MHMR_ACC4(5),
        MHMR_ACC4(6), MHMR_ACC4(7)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d = A * B + (accumulate ? d : 0) with a 16 x 32 B (n = 32), both from
// swizzled tiles; d[j][i] as above, for n-tiles j < 4
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[4][4], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : MHMR_ACC4(0), MHMR_ACC4(1), MHMR_ACC4(2), MHMR_ACC4(3)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void reg_fence(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

#undef MHMR_ACC4

inline bool is_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the rule of the bf16 K1 and K3 (ops/attention.py::_check_rows16): token
// stride 1, a token count and channel, head and batch strides that are
// multiples of 8 (batch and head strides of a size-1 dim are not used),
// 16-byte aligned base pointers
inline bool rows16(int B, int H, int N, const Strides& st, const void* const* ptrs, int n_ptrs) {
  bool ok = st.n == 1 && N % 8 == 0 && st.d % 8 == 0 && (H == 1 || st.h % 8 == 0) &&
            (B == 1 || st.b % 8 == 0);
  for (int i = 0; i < n_ptrs; ++i) ok = ok && is_aligned16(ptrs[i]);
  return ok;
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
