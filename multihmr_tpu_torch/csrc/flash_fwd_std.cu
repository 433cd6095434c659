// Flash-attention forward in the standard layout (K5).
//
// out[b,h,n,:] = softmax_m(scale * q[b,h,n,:] . k[b,h,m,:]) v[b,h,m,:] over
// all N keys, plus the natural-log LSE of every query row. q, k and v are
// [B, H, N, 64] views given by element strides (batch, head, token; the
// channel stride is 1), as the qkv projection of the [B, N, D] residual
// stream makes them; out is a [B, H, N, 64] view given by its own element
// strides in q's dtype, lse a contiguous fp32 [B, H, N].
//
// Replaces the Pallas TPU kernel multihmr_tpu/ops/attention.py::_fwd_kernel
// (called from _flash_fwd_impl), which the standard-stream ViT
// (tp_mode="ring") runs once per block.
//
// Bound: compute. At 896_L (H = 16, N = 4097, Dh = 64) one call does
// 4 * N^2 * Dh * H = 68.7 GFLOP (0.069 ms at 989 TFLOP/s) on 4 * 8.4 MB of
// bf16 operands and output, some two thousand flops per byte, so the tensor
// cores are the limit, and the N^2 score matrix must never reach device
// memory.
//
// Design (bf16), FA3's shape (hopper-kernels guide section 1). One block of
// three warpgroups per (batch*head, 128-query tile):
//  * warpgroup 0 is the producer: it gives its registers to the consumers
//    (setmaxnreg) and one thread issues every copy by TMA. Each of q, k and v
//    is a tensor map over its own strided view, dims (64 channels, N, H, B)
//    with the view's byte strides, boxes of 64 channels x 64 tokens with the
//    128-byte swizzle (encoded on the host per call). Every token row of a
//    head is 128 contiguous bytes; rows past N come back as zeros, which
//    handles the ragged tail (4,097 = 64 * 64 + 1). The two q tiles are
//    loaded once; k/v tile pairs go through a ring of kStages stages with
//    full and empty mbarriers;
//  * warpgroups 1 and 2 are the consumers, 64 queries each. Products are
//    wgmma m64n64k16 with fp32 accumulators: S = q k^T with A = the q tile
//    [query][channel] and B = the k tile [key][channel], both from shared
//    memory and K-major (q stays in shared memory for the whole walk: a
//    loop-invariant register A fragment is not kept live by ptxas); O += P v
//    with A = P re-packed to bf16 in registers from S's accumulators (as the
//    TPU kernel rounds it) and B = the v tile [key][channel], MN-major;
//  * overlap, as FA3 within a warpgroup: tile j's S product is issued with
//    tile j-1's P.V behind it, and tile j's softmax (SFU ex2.approx, scale *
//    log2(e) folded in) runs while P.V is on the tensor cores; the output is
//    rescaled once P.V has been waited for, and only then is the stage of
//    tile j-1 released to the producer. Between the warpgroups, as FA3's
//    ping-pong: they take turns to issue their products (two named
//    barriers), so that one's softmax runs while the other's products are on
//    the tensor cores.
// The online softmax keeps a running max and sum per row in fp32, in exp2
// units. Keys at or past N are masked to -inf in the last tile (their k and
// v rows are zeros). The output tile goes through shared memory (the
// warpgroup's own q tile, swizzled): with channel stride 1 and 16-byte
// aligned strides (the [B, N, H, 64] merged layout or [B, H, N, 64]) each
// row is stored with 16-byte vector stores; any other output strides (e.g.
// [B, H, 64, N]) element by element, coalesced along tokens when their
// stride is 1.
//
// Design (fp32, the --amp 0 and precision-check mode): one thread per query
// row, the scaled q row and the output row in registers, 64-key k/v tiles
// staged [key][channel] with 16-byte loads and read as broadcasts, and the
// same online softmax on chunks of 16 keys, in plain fp32 FMAs (no TF32).
#include <chrono>

#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;

// element strides of a [B, H, N, 64] view: batch, head, token, channel
struct StdStrides {
  long long b, h, n, d;
};

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 128;  // query rows per block (2 consumer warpgroups x 64)
constexpr int kBlockN = 64;   // keys per kv tile
constexpr int kThreads = 384;  // warpgroup 0: producer; 1 and 2: consumers
constexpr int kStages = 4;     // k/v tile pairs in the ring
constexpr int kTileBytes = kTileElems * 2;  // one [64 token][64 channel] bf16 tile
// two q tiles, the k/v ring, and slack to align the base to 1024 bytes
constexpr int kSmemBf16 = (2 + 2 * kStages) * kTileBytes + 1024;

// S = q k^T for a warpgroup's 64 queries x 64 keys: k-step kk is 32 bytes
// further along the rows of both K-major tiles
__device__ __forceinline__ void s_product(float (&s)[8][4], const uint16_t* sQw,
                                          const uint16_t* sK) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss<0, 0>(s, wgmma_desc(sQw + 16 * kk, 0, 1024),
                             wgmma_desc(sK + 16 * kk, 0, 1024), kk > 0);
}

// O += P v for kv tile `tile`: P's accumulators of n-tiles 2kk, 2kk+1 are the
// A fragment of k-step kk (keys 16kk..16kk+15); B = the v tile, MN-major,
// k-step kk at row 16kk
__device__ __forceinline__ void pv_product(float (&o)[8][4], const uint32_t (&pf)[4][4],
                                           const uint16_t* sV, int tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16<1>(o, pf[kk], wgmma_desc(sV + 16 * kk * 64, 1024, 1024), 1);
}

// scale a tile's scores into log2 units (keys >= N to -inf), fold them into
// the running max and sum of rows g (r = 0) and g + 8 (r = 1) and leave
// p = 2^(s - max) in s; corr[r] is the factor for the output so far
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&row_max)[2],
                                             float (&row_sum)[2], float (&corr)[2], int n0,
                                             int N, int tq, float scale_log2) {
  const bool tail = n0 + kBlockN > N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = n0 + 8 * nt + 2 * tq + (i % 2);
      s[nt][i] = (tail && key >= N) ? -INFINITY : s[nt][i] * scale_log2;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = row_max[r];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // mx is finite: every tile holds at least one key < N
    corr[r] = fast_exp2(row_max[r] - mx);
    row_max[r] = mx;
    float sum = row_sum[r] * corr[r];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][2 * r] = fast_exp2(s[nt][2 * r] - mx);
      s[nt][2 * r + 1] = fast_exp2(s[nt][2 * r + 1] - mx);
      sum += s[nt][2 * r] + s[nt][2 * r + 1];
    }
    row_sum[r] = sum;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_std_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          uint16_t* __restrict__ out, float* __restrict__ lse, int H, int N,
                          StdStrides os, int vec_out, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(align1024(smem_raw));  // 2 tiles
  uint16_t* sKV = sQ + 2 * kTileElems;  // stage s: k tile 2s, v tile 2s + 1
  __shared__ uint64_t bar_q, full[kStages], empty[kStages];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (N + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the tile's bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {  // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(&bar_q, 2 * kTileBytes);
      tma_load_4d(sQ, &map_q, &bar_q, 0, m0, h, b);
      tma_load_4d(sQ + kTileElems, &map_q, &bar_q, 0, m0 + 64, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);  // round 0 passes at once
        uint16_t* dst = sKV + 2 * st * kTileElems;
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_4d(dst, &map_k, &full[st], 0, j * kBlockN, h, b);
        tma_load_4d(dst + kTileElems, &map_v, &full[st], 0, j * kBlockN, h, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups 1 and 2: queries m0 + 64 * cw ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int warp = (tid / 32) % 4;  // warp of the warpgroup: rows 16 * warp ..
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int tq = lane % 4;  // accumulator columns 2tq, 2tq + 1
  const uint16_t* sQw = sQ + cw * kTileElems;
  // ping-pong: warpgroup cw issues its products between a wait at barrier
  // 3 + cw and an arrive at the other's; warpgroup 0 goes first, and
  // warpgroup 1 skips its last arrive, so both barriers end balanced
  const auto my_turn = [&] { named_barrier<256>(3 + cw); };
  const auto your_turn = [&](bool last) {
    if (!(last && cw == 1)) named_barrier_arrive<256>(4 - cw);
  };
  if (cw == 1) named_barrier_arrive<256>(3);

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // log2 units
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only
  float corr[2];
  float s[8][4];
  uint32_t pf[4][4];

  // tile 0: S, softmax, P
  mbar_wait(&bar_q, 0);
  mbar_wait(&full[0], 0);
  my_turn();
  reg_fence(s);
  wgmma_fence();
  s_product(s, sQw, sKV);
  wgmma_commit();
  your_turn(false);
  wgmma_wait<0>();
  reg_fence(s);
  softmax_tile(s, row_max, row_sum, corr, 0, N, tq, scale_log2);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int sp = (j - 1) % kStages;  // the stage of tile j - 1
    mbar_wait(&full[st], (j / kStages) & 1);
    my_turn();
    reg_fence(s);
    reg_fence(o);
    reg_fence(pf);
    wgmma_fence();
    s_product(s, sQw, sKV + 2 * st * kTileElems);  // tile j's scores, with ...
    wgmma_commit();
    pv_product(o, pf, sKV + (2 * sp + 1) * kTileElems, j - 1);  // ... tile j - 1's P.V
    wgmma_commit();
    your_turn(false);
    wgmma_wait<1>();  // S of tile j has landed; P.V runs on
    reg_fence(s);
    softmax_tile(s, row_max, row_sum, corr, j * kBlockN, N, tq, scale_log2);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    if (lane == 0) mbar_arrive(&empty[sp]);  // this warp is done with tile j - 1
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[d][i] *= corr[i / 2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
  }
  my_turn();
  reg_fence(o);
  reg_fence(pf);
  wgmma_fence();
  pv_product(o, pf, sKV + (2 * ((n_tiles - 1) % kStages) + 1) * kTileElems, n_tiles - 1);
  wgmma_commit();
  your_turn(true);
  wgmma_wait<0>();
  reg_fence(o);

  // epilogue: normalise, LSE, stage the [query][channel] tile swizzled in
  // this warpgroup's q tile (its S products have completed)
  const int q0 = m0 + 64 * cw;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    const int qrow = q0 + 16 * warp + g + 8 * r;
    if (tq == 0 && qrow < N)
      lse[static_cast<long long>(bh) * N + qrow] = (row_max[r] + log2f(l)) * kLn2;
  }
  uint16_t* sO = sQ + cw * kTileElems;
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(&sO[swz(16 * warp + g + 8 * r, 8 * d + 2 * tq)]) =
          pack_bf16(o[d][2 * r] * inv[r], o[d][2 * r + 1] * inv[r]);
  named_barrier<128>(1 + cw);
  const int t = tid % 128;
  uint16_t* ob = out + b * os.b + h * os.h;
  if (vec_out) {  // channel stride 1, 16-byte aligned rows
#pragma unroll
    for (int i = 0; i < (64 * 8) / 128; ++i) {
      const int e = i * 128 + t;
      const int r = e / 8;
      const int c = e % 8;
      if (q0 + r < N)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * os.n + 8 * c) =
            *reinterpret_cast<const uint4*>(&sO[swz(r, 8 * c)]);
    }
  } else {  // any strides, tokens fastest
#pragma unroll 8
    for (int i = 0; i < (kDh * 64) / 128; ++i) {
      const int e = i * 128 + t;
      const int d = e / 64;
      const int r = e % 64;
      if (q0 + r < N) ob[d * os.d + (q0 + r) * os.n] = sO[swz(r, d)];
    }
  }
}

// a [B, H, N, 64] bf16 view with element strides st (channel stride 1) as a
// tensor map over dims (64, N, H, B), innermost first: boxes of 64 channels
// x kBlockN tokens, 128-byte swizzle, rows past N read as zeros. The stride
// of a size-1 dim is never used: it is given as 128 bytes
cudaError_t encode_view(CUtensorMap* map, const void* base, int B, int H, int N,
                        const StdStrides& st) {
  const cuuint64_t dims[4] = {kDh, static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.n) * 2,
                                 H == 1 ? 128u : static_cast<cuuint64_t>(st.h) * 2,
                                 B == 1 ? 128u : static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kDh, kBlockN, 1, 1};
  return encode_bf16_4d(map, base, dims, strides, box);
}

// ---------------------------------------------------------------- fp32 path
constexpr int kRowsF32 = 128;  // query rows (threads) per block
constexpr int kKeysF32 = 64;   // keys per kv tile
constexpr int kChunkF32 = 16;  // keys per online-softmax update

__global__ void __launch_bounds__(kRowsF32)
flash_fwd_std_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int H, int N, StdStrides st,
                         StdStrides os, float scale_log2) {
  __shared__ __align__(16) float sK[kKeysF32][kDh];
  __shared__ __align__(16) float sV[kKeysF32][kDh];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRowsF32 + tid;
  const bool row_ok = row < N;
  const long long base = (bh / H) * st.b + (bh % H) * st.h;

  float qr[kDh], acc[kDh];
#pragma unroll
  for (int c = 0; c < kDh / 4; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) x = *reinterpret_cast<const float4*>(q + base + row * st.n + 4 * c);
    qr[4 * c] = x.x * scale_log2;
    qr[4 * c + 1] = x.y * scale_log2;
    qr[4 * c + 2] = x.z * scale_log2;
    qr[4 * c + 3] = x.w * scale_log2;
  }
#pragma unroll
  for (int d = 0; d < kDh; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < N; n0 += kKeysF32) {
    __syncthreads();
    for (int e = tid; e < kKeysF32 * (kDh / 4); e += kRowsF32) {
      const int t = e / (kDh / 4), c = e % (kDh / 4), n = n0 + t;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (n < N) {
        kx = *reinterpret_cast<const float4*>(k + base + n * st.n + 4 * c);
        vx = *reinterpret_cast<const float4*>(v + base + n * st.n + 4 * c);
      }
      *reinterpret_cast<float4*>(&sK[t][4 * c]) = kx;
      *reinterpret_cast<float4*>(&sV[t][4 * c]) = vx;
    }
    __syncthreads();
    const int valid = min(kKeysF32, N - n0);
    for (int c0 = 0; c0 < kKeysF32; c0 += kChunkF32) {
      float sc[kChunkF32];
      float mx = m;
#pragma unroll
      for (int i = 0; i < kChunkF32; ++i) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) x = fmaf(qr[d], sK[c0 + i][d], x);
        sc[i] = c0 + i < valid ? x : -INFINITY;
        mx = fmaxf(mx, sc[i]);
      }
      // mx is finite: key 0 of the first tile is always valid
      const float corr = exp2f(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < kChunkF32; ++i) {
        const float p = exp2f(sc[i] - mx);
        l += p;
#pragma unroll
        for (int d = 0; d < kDh; ++d) acc[d] = fmaf(p, sV[c0 + i][d], acc[d]);
      }
    }
  }
  if (!row_ok) return;
  float* ob = out + (bh / H) * os.b + (bh % H) * os.h + row * os.n;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kDh; ++d) ob[d * os.d] = acc[d] * inv;
  lse[static_cast<long long>(bh) * N + row] = (m + log2f(l)) * kLn2;
}

}  // namespace
}  // namespace mhmr

// Returns cudaErrorInvalidValue for inputs the kernel does not take (the
// Python wrapper checks the same and raises first): Dh != 64, a channel
// stride other than 1, a q/k/v stride or base pointer that is not 16-byte
// aligned; cudaErrorNotSupported if cuTensorMapEncodeTiled cannot be resolved.
extern "C" int mhmr_flash_fwd_std(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int Dh,
                                  int N, long long stride_b, long long stride_h,
                                  long long stride_n, long long stride_d,
                                  long long out_b, long long out_h,
                                  long long out_n, long long out_d, float scale,
                                  int dtype, void* stream) {
  using namespace mhmr;
  if (Dh != kDh || N < 1 || stride_d != 1) return cudaErrorInvalidValue;
  const long long vec = dtype == kBFloat16 ? 8 : 4;  // elements per 16 bytes
  if (stride_b % vec || stride_h % vec || stride_n % vec || !is_aligned16(q) ||
      !is_aligned16(k) || !is_aligned16(v))
    return cudaErrorInvalidValue;
  const StdStrides st{stride_b, stride_h, stride_n, stride_d};
  const StdStrides os{out_b, out_h, out_n, out_d};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    CUtensorMap maps[3];
    const void* views[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      const cudaError_t err = encode_view(&maps[i], views[i], B, H, N, st);
      if (err != cudaSuccess) return err;
    }
    static int smem_allowed[kMaxDevices] = {};
    const cudaError_t err = allow_smem(flash_fwd_std_bf16_kernel, kSmemBf16, smem_allowed);
    if (err != cudaSuccess) return err;
    const int vec_out = out_d == 1 && out_b % vec == 0 && out_h % vec == 0 &&
                        out_n % vec == 0 && is_aligned16(out);
    dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    flash_fwd_std_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        maps[0], maps[1], maps[2], static_cast<uint16_t*>(out), static_cast<float*>(lse), H, N,
        os, vec_out, scale_log2);
  } else if (dtype == kFloat32) {
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, B * H);
    flash_fwd_std_f32_kernel<<<grid, kRowsF32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), H, N, st, os, scale_log2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Host nanoseconds per bf16 K5 launch spent encoding its three tensor maps
// (the mean over `iters` encodings of q, k and v); -1 if encoding fails.
extern "C" double mhmr_flash_fwd_std_encode_ns(const void* q, const void* k, const void* v,
                                               int B, int H, int N, long long stride_b,
                                               long long stride_h, long long stride_n,
                                               int iters) {
  using namespace mhmr;
  const StdStrides st{stride_b, stride_h, stride_n, 1};
  const void* views[3] = {q, k, v};
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int it = 0; it < iters; ++it)
    for (int i = 0; i < 3; ++i)
      if (encode_view(&map, views[i], B, H, N, st) != cudaSuccess) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}
