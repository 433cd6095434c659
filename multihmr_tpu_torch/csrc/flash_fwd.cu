// Flash-attention forward in the channels-major layout (K1).
//
// out[b,h,:,n] = softmax_m(scale * q[b,h,:,n] . k[b,h,:,m]) v[b,h,:,m] over
// keys m < kv_len, plus the natural-log LSE of every query row. q, k and v
// are [B, H, 64, N] views given by element strides (batch, head, channel,
// token); out is a contiguous [B, H, 64, N] in q's dtype, lse a contiguous
// fp32 [B, H, N].
//
// Replaces the Pallas TPU kernel multihmr_tpu/ops/attention.py::_fwd_kernel_t
// (called from _flash_fwd_impl_t), which the ViT runs once per block.
//
// Bound: compute. At 896_L (H = 16, kv_len = 4097, Dh = 64) one call does
// 4 * N^2 * Dh * H = 68.7 GFLOP (0.069 ms at 989 TFLOP/s) on 3 * 8.4 MB of
// bf16 operands, several thousand flops per byte, so the tensor cores are
// the limit, and the N^2 score matrix must never reach device memory. On
// the H100 the kernel reads 0.22 ms against that 0.069: each warpgroup's
// chain (wait for a tile, S, softmax, P.V) runs in series, and removing any
// one part saves at most 0.044 ms (tools/kernel_timing.py variants). The
// next step is FA3's overlap of one tile's softmax with the next's products.
//
// Design (bf16; the token count and the strides are multiples of 8, as the
// ViT's pre-padded stream has them, and the wrapper checks). One block of two
// warpgroups per (batch*head, 128-query tile); warpgroup w owns queries
// 64w..64w+63, each of its warps 16 of them. Every copy is a 16-byte
// cp.async of part of a 128-byte channel row into a 128-byte-swizzled
// [64 channel][64 token] tile (common.cuh): the q tiles once, then a ring of
// kStages k/v tile pairs, so that tiles j+1 and j+2 are in flight while tile
// j is multiplied. Products are wgmma m64n64k16 with fp32 accumulators:
//  * S = q k^T: A = the warpgroup's q tile, [channel = depth][query], and B
//    = the k tile, [channel = depth][key], both from shared memory and both
//    MN-major (imm-trans-a, imm-trans-b). q stays there for the whole walk:
//    held in registers as a loop-invariant A fragment, it is not kept live
//    by ptxas once the first wgmma is issued;
//  * O += P v: A = P re-packed to bf16 in registers from S's accumulators
//    (as the TPU kernel rounds it), B = the v tile [channel][key], K-major.
// The online softmax keeps a running max and sum per row in fp32, in exp2
// units with scale * log2(e) folded in. Keys at or past kv_len are masked to
// -inf before the max, and their v entries are zeroed in shared memory (last
// tile only), so junk or NaN in a pre-padded stream cannot leak in. The
// output goes through shared memory as [channel][query] tiles and out with
// 16-byte stores.
//
// Design (fp32, the precision-check mode): one thread per query row, the
// scaled q row and the output row in registers, 64-key k/v tiles in shared
// memory read as broadcasts, and the same online softmax on chunks of 16
// keys, in plain fp32 FMAs (no TF32: the fp32 path exists to be exact). It
// takes any N and strides.
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 128;  // query rows per block (2 warpgroups x 64)
constexpr int kBlockN = 64;   // keys per kv tile
constexpr int kThreads = 256;
constexpr int kStages = 3;    // k/v tile pairs in the ring
// two q tiles, the k/v ring, and slack to align the base to 1024 bytes
constexpr int kSmemBf16 = (2 + 2 * kStages) * kTileElems * 2 + 1024;

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_t_bf16_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        uint16_t* __restrict__ out, float* __restrict__ lse,
                        int H, int N, int kv_len, Strides st,
                        float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(align1024(smem_raw));  // 2 tiles
  uint16_t* sKV = sQ + 2 * kTileElems;  // stage s: k tile 2s, v tile 2s + 1

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int tq = lane % 4;  // accumulator columns 2tq, 2tq + 1
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const long long base = (bh / H) * st.b + (bh % H) * st.h;
  const uint16_t* qb = q + base;
  const uint16_t* kb = k + base;
  const uint16_t* vb = v + base;
  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;

  // q once, then the first kStages - 1 k/v tiles: one commit group each
  load_tile_async<kThreads>(sQ, qb, st.d, m0, N, tid);
  load_tile_async<kThreads>(sQ + kTileElems, qb, st.d, m0 + 64, N, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile_async<kThreads>(sKV + 2 * s * kTileElems, kb, st.d, s * kBlockN, N, tid);
      load_tile_async<kThreads>(sKV + (2 * s + 1) * kTileElems, vb, st.d, s * kBlockN, N, tid);
    }
    cp_async_commit();
  }
  // q stays in shared memory: this warpgroup's 64 queries are one tile, the
  // A operand of S = q k^T ([channel = depth][query], MN-major)
  const uint16_t* sQw = sQ + (warp / 4) * kTileElems;

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // log2 units
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j have landed
    fence_async_shared();
    __syncthreads();  // ... every thread's; and all are done with tile j - 1
    {
      const int jn = j + kStages - 1;  // refill the stage tile j - 1 used
      if (jn < n_tiles) {
        uint16_t* st_k = sKV + 2 * (jn % kStages) * kTileElems;
        load_tile_async<kThreads>(st_k, kb, st.d, jn * kBlockN, N, tid);
        load_tile_async<kThreads>(st_k + kTileElems, vb, st.d, jn * kBlockN, N, tid);
      }
      cp_async_commit();
    }
    const uint16_t* sK = sKV + 2 * (j % kStages) * kTileElems;
    uint16_t* sV = const_cast<uint16_t*>(sK) + kTileElems;
    const int n0 = j * kBlockN;
    const bool tail = n0 + kBlockN > kv_len;
    if (tail) {  // v entries of keys at or past kv_len -> exact zeros
      for (int e = tid; e < kTileElems; e += kThreads) {
        const int t = e % kBlockN;
        if (n0 + t >= kv_len) sV[swz(e / kBlockN, t)] = 0;
      }
      fence_async_shared();
      __syncthreads();
    }

    // S = q k^T for this warpgroup's 64 queries x 64 keys (the warp's 16
    // rows: 8 n-tiles of 8 keys); k-step ks is rows 16ks.. of both tiles
    float s[8][4];
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sQw + 16 * ks * 64, 1024, 1024),
                               wgmma_desc(sK + 16 * ks * 64, 1024, 1024), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // scale into log2 units, mask keys >= kv_len in the last tile
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * tq + (i % 2);
        s[nt][i] = (tail && key >= kv_len) ? -INFINITY : s[nt][i] * scale_log2;
      }

    // online softmax; rows g (i = 0, 1) and g + 8 (i = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mx is finite: every tile holds at least one key < kv_len
      const float corr = fast_exp2(row_max[r] - mx);
      row_max[r] = mx;
      float sum = row_sum[r] * corr;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * r] = fast_exp2(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = fast_exp2(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      row_sum[r] = sum;
    }

    // O += P v: P's accumulators of n-tiles 2kk, 2kk+1 are the A fragment of
    // k-step kk (16 keys); B = the v tile, K-major, 32 bytes further per step
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(o, pf[kk], wgmma_desc(sV + 16 * kk, 0, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
  }

  // epilogue: normalise, LSE, stage the [channel][query] tiles in sQ (each
  // warpgroup's own tile: its wgmmas reading sQw have completed)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    const int qrow = m0 + 16 * warp + g + 8 * r;
    if (tq == 0 && qrow < N)
      lse[static_cast<long long>(bh) * N + qrow] = (row_max[r] + log2f(l)) * kLn2;
  }
  uint16_t* sO = sQ + (warp / 4) * kTileElems;
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int col = 16 * (warp % 4) + g + 8 * (i / 2);
      sO[swz(ch, col)] = BF16::store(o[d][i] * inv[i / 2]);
    }
  __syncthreads();
  uint16_t* ob = out + static_cast<long long>(bh) * kDh * N;
#pragma unroll
  for (int i = 0; i < (kDh * kBlockM / 8) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int ch = e / (kBlockM / 8);
    const int t = 8 * (e % (kBlockM / 8));
    if (m0 + t < N)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(ch) * N + m0 + t) =
          *reinterpret_cast<const uint4*>(sQ + (t >> 6) * kTileElems + swz(ch, t & 63));
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int kRowsF32 = 128;  // query rows (threads) per block
constexpr int kKeysF32 = 64;   // keys per kv tile
constexpr int kChunkF32 = 16;  // keys per online-softmax update

__global__ void __launch_bounds__(kRowsF32)
flash_fwd_t_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int H, int N, int kv_len,
                       Strides st, float scale_log2) {
  __shared__ float sK[kDh][kKeysF32];
  __shared__ float sV[kDh][kKeysF32];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kRowsF32 + tid;
  const bool row_ok = row < N;
  const long long base = (bh / H) * st.b + (bh % H) * st.h;

  float qr[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = row_ok ? q[base + d * st.d + row * st.n] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += kKeysF32) {
    __syncthreads();
    for (int e = tid; e < kDh * kKeysF32; e += kRowsF32) {
      const int d = e / kKeysF32, t = e % kKeysF32, n = n0 + t;
      const bool ok = n < kv_len;
      sK[d][t] = ok ? k[base + d * st.d + n * st.n] : 0.f;
      sV[d][t] = ok ? v[base + d * st.d + n * st.n] : 0.f;
    }
    __syncthreads();
    const int valid = min(kKeysF32, kv_len - n0);
    for (int c0 = 0; c0 < kKeysF32; c0 += kChunkF32) {
      float sc[kChunkF32];
      float mx = m;
#pragma unroll
      for (int i = 0; i < kChunkF32; ++i) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d) x = fmaf(qr[d], sK[d][c0 + i], x);
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
        for (int d = 0; d < kDh; ++d) acc[d] = fmaf(p, sV[d][c0 + i], acc[d]);
      }
    }
  }
  if (!row_ok) return;
  float* ob = out + static_cast<long long>(bh) * kDh * N;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kDh; ++d) ob[static_cast<long long>(d) * N + row] = acc[d] * inv;
  lse[static_cast<long long>(bh) * N + row] = (m + log2f(l)) * kLn2;
}

}  // namespace
}  // namespace mhmr

// Returns cudaErrorInvalidValue for inputs the kernel does not take (the
// Python wrapper checks the same and raises first): Dh != 64, kv_len outside
// [1, N]; in bf16, a token stride other than 1, or a token count, stride or
// base pointer that is not 16-byte aligned.
extern "C" int mhmr_flash_fwd_t(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int H, int Dh,
                                int N, int kv_len, long long stride_b,
                                long long stride_h, long long stride_d,
                                long long stride_n, float scale, int dtype,
                                void* stream) {
  using namespace mhmr;
  if (Dh != kDh || kv_len < 1 || kv_len > N) return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_d, stride_n};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const void* ptrs[] = {q, k, v, out, lse};
    if (!rows16(B, H, N, st, ptrs, 5)) return cudaErrorInvalidValue;
    static int smem_allowed[kMaxDevices] = {};
    const cudaError_t err = allow_smem(flash_fwd_t_bf16_kernel, kSmemBf16, smem_allowed);
    if (err != cudaSuccess) return err;
    dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    flash_fwd_t_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
        static_cast<float*>(lse), H, N, kv_len, st, scale_log2);
  } else if (dtype == kFloat32) {
    dim3 grid((N + kRowsF32 - 1) / kRowsF32, B * H);
    flash_fwd_t_f32_kernel<<<grid, kRowsF32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), H, N, kv_len, st, scale_log2);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* mhmr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
