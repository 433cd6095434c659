// Shared helpers for the hand-written Hopper kernels of multihmr_tpu_torch.
//
// Storage types: bf16 tensors are passed as raw 16-bit words (uint16_t) and
// converted with the cuda_bf16.h intrinsics; fp32 tensors as float. Every
// kernel computes in fp32.
#pragma once

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled (no libcuda link)
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

// ---- register fragments and shared-memory addresses
//
// Accumulator and A-fragment layouts are those of mma.sync.m16n8k16 (see the
// wgmma section below): C element i of a 16 x 8 tile sits at row
// g + 8 * (i / 2), column 2 * tq + i % 2 (g = lane / 4, tq = lane % 4), and
// the C fragments of n-tiles 2j, 2j + 1 re-pack in registers into the A
// fragment of k-step j (c_to_a).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// 2^x on the FMA pipe, for x <= 0 (the exponent of an online softmax):
// Cody-Waite range reduction, x = n + f with n = floor(x) and f in [0, 1),
// then 2^f by a degree-4 polynomial with p(0) = 1, minimax in relative error
// on [0, 1], and n added to the exponent bits (n is the low bits of t; its
// shift leaves only n << 23). Relative error 2.9e-6 (2^-18.4) in exact
// arithmetic, 2.97e-6 with its fp32 steps on an H100 over [0, 1) and
// [-126, 0] (tools/kernel_timing.py exp2). About nine FMA- and integer-pipe
// instructions in place of one on the special-function unit (ex2.approx),
// so that a kernel whose exponentials keep the SFU as busy as its products
// keep the tensor cores can move a share of them off the SFU. x <= -127
// (and -inf) gives 0, x in (-127, -126) a number below 2^-126; x = n + 1 -
// ulp may come out as 2^n * p(1), and p(1) is 2 within the same error.
__device__ __forceinline__ float poly_exp2(float x) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: x + kMagic holds n in its low bits
  x = fmaxf(x, -127.f);
  const float t = __fadd_rd(x, kMagic);  // kMagic + floor(x), exactly
  const float f = x - (t - kMagic);
  const float p = fmaf(fmaf(fmaf(fmaf(1.3425155e-2f, f, 5.2245375e-2f), f, 2.4127856e-1f), f,
                            6.9304514e-1f), f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

// A fragment of k-step j from the C fragments of n-tiles 2j and 2j + 1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---- 16-byte asynchronous copies (cp.async) into 128-byte-swizzled tiles
//
// The bf16 flash kernels stage [64 channel][64 token] bf16 tiles of a channels-major
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

// the descriptor of the address `bytes` (a multiple of 16) further on: the
// start-address field (address / 16, 14 bits) moves, the strides stay
__device__ __forceinline__ uint64_t desc_plus(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
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
template <int kN>
__device__ __forceinline__ void reg_fence(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
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

// the same with a 16 x 16 B (n = 16), for n-tiles j < 2
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[2][4], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : MHMR_ACC4(0), MHMR_ACC4(1)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// the same with a 16 x 128 B (n = 128), for n-tiles j < 16. An MN-major B
// spans two 64-token swizzle atoms: its descriptor's leading byte offset is
// the distance from the first atom to the second
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : MHMR_ACC4(0), MHMR_ACC4(1), MHMR_ACC4(2), MHMR_ACC4(3), MHMR_ACC4(4), MHMR_ACC4(5),
        MHMR_ACC4(6), MHMR_ACC4(7), MHMR_ACC4(8), MHMR_ACC4(9), MHMR_ACC4(10), MHMR_ACC4(11),
        MHMR_ACC4(12), MHMR_ACC4(13), MHMR_ACC4(14), MHMR_ACC4(15)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

#undef MHMR_ACC4

// keep the compiler from reusing the registers of a wgmma A fragment before
// the wgmma that reads them has been waited for
template <int kN>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// ---- mbarriers and TMA (sm_90)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA); a
// block-wide barrier must follow
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more from copies that complete on this barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` of the barrier has completed. A
// wait that lasts ~2^32 cycles (seconds) traps, so that a barrier that can
// never complete ends the kernel with an error in place of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-dim tensor map into
// shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// a barrier of the kThreads threads that use id `id` (1..15; 0 is
// __syncthreads)
template <int kThreads>
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// arrive at barrier `id` of kThreads threads without waiting
template <int kThreads>
__device__ __forceinline__ void named_barrier_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

inline bool is_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, resolved through the runtime's entry-point query
// (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-dim bf16 tensor map (dims and boxes innermost first, the byte strides
// of dims 1-3) with the 128-byte swizzle: the box's inner 128 bytes land as
// one swizzled row; elements past a dim's extent read as zeros
inline cudaError_t encode_bf16_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                                  const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the rule of the bf16 K1, K3, K4a and K4b (ops/attention.py::_check_rows16): token
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
