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
// 4 * N^2 * Dh * H = 68.7 GFLOP on 4 * 8.4 MB of bf16 operands and output,
// some two thousand flops per byte, so the tensor cores are the limit, and
// the N^2 score matrix must never reach device memory.
//
// Design (bf16): one block of eight warps per (batch*head, 128-query tile);
// each warp owns 16 query rows, and all eight share each staged k/v tile.
// Every token's 64 channels are one contiguous 128-byte row, so the q, k and
// v tiles are staged [token][channel] in shared memory with 16-byte vector
// loads: eight threads read one row, whatever the token stride (6 KB on the
// [B, N, 3, H, 64] projection output). The rows are padded to 144 bytes so
// the 8 rows an ldmatrix phase reads fall in distinct banks. q ([query]
// [channel]) and k ([key][channel]) are already in the row/col order of the
// mma.sync.m16n8k16 A and B operands and go through plain ldmatrix; v
// ([key][channel]) is the B operand of P.V with keys as the depth and goes
// through ldmatrix.trans. The q tile stays in registers as A fragments for
// the whole kv walk. Scores and the output accumulate in fp32 registers; the
// online softmax keeps a running max and sum per row in fp32, in exp2 units
// with scale * log2(e) folded in. The score fragments are re-packed to bf16
// in registers as the A operand of P.V, so P never touches shared memory.
// Keys at or past N are masked to -inf in the last tile and staged as zeros.
// The output tile goes through shared memory: with channel stride 1 (the
// [B, N, H, 64] merged layout or [B, H, N, 64]) each row is stored with
// 16-byte vector stores; any other output strides (e.g. [B, H, 64, N]) are
// stored element by element, coalesced along tokens when their stride is 1.
//
// Design (fp32, the --amp 0 and precision-check mode): one thread per query
// row, the scaled q row and the output row in registers, 64-key k/v tiles
// staged [key][channel] with 16-byte loads and read as broadcasts, and the
// same online softmax on chunks of 16 keys, in plain fp32 FMAs (no TF32).
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;

// element strides of a [B, H, N, 64] view: batch, head, token, channel
struct StdStrides {
  long long b, h, n, d;
};

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 128;  // query rows per block (8 warps x 16)
constexpr int kBlockN = 64;   // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLd = kDh + 8;  // smem row stride (elements) of every tile: 144 B

// [kRows tokens][64 channels] bf16 tile starting at token n0 into shared
// memory with row stride kLd, by kThreads threads; tokens >= lim -> 0.
// Each thread moves 16-byte chunks: 8 per token row.
template <int kRows>
__device__ __forceinline__ void stage_rows(uint16_t* __restrict__ s,
                                           const uint16_t* __restrict__ g,
                                           long long sn, int n0, int lim,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < (kRows * 8) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int r = e / 8;
    const int c = e % 8;
    const int n = n0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < lim) val = *reinterpret_cast<const uint4*>(g + n * sn + 8 * c);
    *reinterpret_cast<uint4*>(s + r * kLd + 8 * c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_std_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          uint16_t* __restrict__ out, float* __restrict__ lse,
                          int H, int N, StdStrides st, StdStrides os,
                          int vec_out, float scale_log2) {
  __shared__ __align__(16) uint16_t sQ[kBlockM * kLd];
  __shared__ __align__(16) uint16_t sK[kBlockN * kLd];
  __shared__ __align__(16) uint16_t sV[kBlockN * kLd];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mi = lane / 8;  // which 8x8 matrix this lane addresses in ldmatrix.x4
  const int mr = lane % 8;  // which row of it
  const int g = lane / 4;   // mma group: rows g and g + 8
  const int tq = lane % 4;  // thread in group: columns 2tq, 2tq + 1
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const long long base = (bh / H) * st.b + (bh % H) * st.h;

  stage_rows<kBlockM>(sQ, q + base, st.n, m0, N, tid);
  __syncthreads();

  // q as A fragments (row = query, col = channel) from the [query][channel]
  // tile: 4 k-steps of 16 channels
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qf[ks], &sQ[(16 * warp + (mi % 2) * 8 + mr) * kLd + 16 * ks +
                        (mi / 2) * 8]);

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // log2 units
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only

  const int n_tiles = (N + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_rows<kBlockN>(sK, k + base, st.n, n0, N, tid);
    stage_rows<kBlockN>(sV, v + base, st.n, n0, N, tid);
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys);
    // k's [key][channel] tile is the B operand's [n][k] order: no .trans
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, &sK[(8 * (2 * np + mi / 2) + mr) * kLd + 16 * ks +
                       (mi % 2) * 8]);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale into log2 units, mask keys >= N in the last tile
    const bool tail = n0 + kBlockN > N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * tq + (i % 2);
        s[nt][i] = (tail && key >= N) ? -INFINITY : s[nt][i] * scale_log2;
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
      // mx is finite: every tile holds at least one key < N
      const float corr = exp2f(row_max[r] - mx);
      row_max[r] = mx;
      float sum = row_sum[r] * corr;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      row_sum[r] = sum;
    }

    // O += P v: P's C fragments of n-tiles 2kk, 2kk+1 are the A fragment of
    // k-step kk (16 keys); v's [key][channel] tile is the B operand's [k][n]
    // order: .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, &sV[(16 * kk + (mi % 2) * 8 + mr) * kLd +
                             8 * (2 * dp + mi / 2)]);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // epilogue: normalise, LSE, stage the [query][channel] tile in sQ
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
  __syncthreads();  // all warps are past their reads of sQ
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(&sQ[row * kLd + 8 * d + 2 * tq]) =
          pack_bf16(o[d][2 * r] * inv[r], o[d][2 * r + 1] * inv[r]);
    }
  __syncthreads();
  uint16_t* ob = out + (bh / H) * os.b + (bh % H) * os.h;
  if (vec_out) {  // channel stride 1, 16-byte aligned rows
#pragma unroll
    for (int i = 0; i < (kBlockM * 8) / kThreads; ++i) {
      const int e = i * kThreads + tid;
      const int r = e / 8;
      const int c = e % 8;
      if (m0 + r < N)
        *reinterpret_cast<uint4*>(ob + (m0 + r) * os.n + 8 * c) =
            *reinterpret_cast<const uint4*>(&sQ[r * kLd + 8 * c]);
    }
  } else {  // any strides, tokens fastest
#pragma unroll 8
    for (int i = 0; i < (kDh * kBlockM) / kThreads; ++i) {
      const int e = i * kThreads + tid;
      const int d = e / kBlockM;
      const int t = e % kBlockM;
      if (m0 + t < N) ob[d * os.d + (m0 + t) * os.n] = sQ[t * kLd + d];
    }
  }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace mhmr

// Returns cudaErrorInvalidValue for inputs the kernel does not take (the
// Python wrapper checks the same and raises first): Dh != 64, a channel
// stride other than 1, a q/k/v stride or base pointer that is not 16-byte
// aligned.
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
  if (stride_b % vec || stride_h % vec || stride_n % vec || !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return cudaErrorInvalidValue;
  const StdStrides st{stride_b, stride_h, stride_n, stride_d};
  const StdStrides os{out_b, out_h, out_n, out_d};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const int vec_out = out_d == 1 && out_b % vec == 0 && out_h % vec == 0 &&
                        out_n % vec == 0 && aligned16(out);
    dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    flash_fwd_std_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
        static_cast<float*>(lse), H, N, st, os, vec_out, scale_log2);
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
