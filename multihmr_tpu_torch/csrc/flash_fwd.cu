// Flash-attention forward in the channels-major layout.
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
// Bound: compute. At 896_L (H = 16, N = 4097, Dh = 64) one call does
// 4 * N^2 * Dh * H = 68.7 GFLOP on 3 * 8.4 MB of bf16 operands, several
// thousand flops per byte, so the tensor cores are the limit, and the N^2
// score matrix must never reach device memory.
//
// Design (bf16): one block of eight warps per (batch*head, 128-query tile);
// each warp owns 16 query rows, and all eight share each staged k/v tile.
// The q tile stays in registers as mma A-fragments for the whole kv walk. Each 64-key tile of k and v is staged in
// shared memory in the global [channel][token] layout (so the staging loads
// are coalesced along tokens for any N, including odd ones), and ldmatrix
// (.trans for q and k) turns it into mma.sync.m16n8k16 fragments. Scores and
// the output accumulate in fp32 registers; the online softmax keeps a running
// max and sum per row in fp32, in exp2 units with scale * log2(e) folded in.
// The score fragments are re-packed to bf16 in registers as the A operand of
// P.V, so P never touches shared memory. Keys at or past kv_len are masked to
// -inf in the last tile and their k/v entries are staged as zeros, so junk
// past kv_len cannot leak in. The output tile goes through shared memory to
// be stored coalesced along tokens.
//
// Design (fp32, the precision-check mode): one thread per query row, the
// scaled q row and the output row in registers, 64-key k/v tiles in shared
// memory read as broadcasts, and the same online softmax on chunks of 16
// keys, in plain fp32 FMAs (no TF32: the fp32 path exists to be exact).
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;

// ---------------------------------------------------------------- bf16 path
constexpr int kBlockM = 128;  // query rows per block (8 warps x 16)
constexpr int kBlockN = 64;   // keys per kv tile
constexpr int kThreads = 256;
// smem row strides (elements) of the [channel][token] tiles, padded by 8 so
// that the 8 rows an ldmatrix phase reads fall in distinct banks
constexpr int kLdQ = kBlockM + 8;  // 272 B
constexpr int kLd = kBlockN + 8;   // 144 B

__global__ void __launch_bounds__(kThreads)
flash_fwd_t_bf16_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        uint16_t* __restrict__ out, float* __restrict__ lse,
                        int H, int N, int kv_len, Strides st,
                        float scale_log2) {
  __shared__ __align__(16) uint16_t sQ[kDh * kLdQ];
  __shared__ __align__(16) uint16_t sK[kDh * kLd];
  __shared__ __align__(16) uint16_t sV[kDh * kLd];

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

  stage_tile<kBlockM, kLdQ, kThreads>(sQ, q + base, st.d, st.n, m0, N, tid);
  __syncthreads();

  // q as A fragments (row = query, col = channel): 4 k-steps of 16 channels
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4_trans(qf[ks], &sQ[(16 * ks + (mi / 2) * 8 + mr) * kLdQ +
                              16 * warp + (mi % 2) * 8]);

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // log2 units
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only

  const int n_tiles = (kv_len + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_tile<kBlockN, kLd, kThreads>(sK, k + base, st.d, st.n, n0, kv_len, tid);
    stage_tile<kBlockN, kLd, kThreads>(sV, v + base, st.d, st.n, n0, kv_len, tid);
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
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
        ldsm_x4_trans(b, &sK[(16 * ks + (mi % 2) * 8 + mr) * kLd +
                             8 * (2 * np + mi / 2)]);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale into log2 units, mask keys >= kv_len in the last tile
    const bool tail = n0 + kBlockN > kv_len;
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
    // k-step kk (16 keys); v^T fragments come from the [channel][key] tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4(b, &sV[(8 * (2 * dp + mi / 2) + mr) * kLd + 16 * kk +
                       (mi % 2) * 8]);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // epilogue: normalise, LSE, stage the [channel][query] tile in sQ
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
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int col = 16 * warp + g + 8 * (i / 2);
      sQ[ch * kLdQ + col] = BF16::store(o[d][i] * inv[i / 2]);
    }
  __syncthreads();
  uint16_t* ob = out + static_cast<long long>(bh) * kDh * N;
#pragma unroll 8
  for (int i = 0; i < (kDh * kBlockM) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int d = e / kBlockM;
    const int t = e % kBlockM;
    if (m0 + t < N) ob[static_cast<long long>(d) * N + m0 + t] = sQ[d * kLdQ + t];
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
    dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    flash_fwd_t_bf16_kernel<<<grid, kThreads, 0, s>>>(
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
