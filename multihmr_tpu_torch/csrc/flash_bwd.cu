// Flash-attention backward in the channels-major layout: K3 (fused) and
// K4a + K4b (two-pass).
//
// Given q, k, v, dO [B, H, 64, N] (q, k and v views sharing one set of
// element strides, dO its own), the forward's natural-log lse [B, H, N] and
// D = rowsum(dO * o) [B, H, N] (fp32, computed by the caller), with queries
// n, keys m < kv_len and s = scale * q_n . k_m:
//   p = exp(s - lse_n),  dp = dO_n . v_m,  ds = p * (dp - D_n),
//   dv_m = sum_n p dO_n,  dk_m = scale sum_n ds q_n,  dq_n = scale sum_m ds k_m.
// Keys at or past kv_len are masked (p = 0), so their dk and dv are exact
// zeros whatever junk a pre-padded stream holds there. dq, dk and dv are
// [B, H, 64, N] in q's dtype, contiguous within each head, at the batch and
// head strides the caller gives (so they can be slices of one packed qkv
// gradient).
//
// Replaces the Pallas TPU kernels of multihmr_tpu/ops/attention.py, called
// from _flash_bwd_impl_t, which runs once per ViT block in a train step:
//   K3  _bwd_fused_kernel_t  (fused=True)  -> mode 0 below;
//   K4a _bwd_dq_kernel_t     (fused=False) -> mode 1;
//   K4b _bwd_dkv_kernel_t    (fused=False) -> mode 2.
//
// Bound: compute. At 896_L ([1, 16, 64, 4097]) the fused backward does five
// N^2 * 64 products per head, 171.9 GFLOP, 0.174 ms at 989 TFLOP/s, against
// ~67 MB of operands (0.020 ms at 3.35 TB/s). The two-pass form recomputes s
// and dp in both passes: 7 products, 240.6 GFLOP for the same function.
//
// What changes from the TPU kernel: the TPU grid runs in order without
// atomics, so K3 there writes one fp32 dq partial per kv block
// ([B*H, kv_steps, 64, Np], 1.1 GB per call at 896_L) and sums it outside.
// Here K3's blocks add their scaled dq partials with fp32 atomics into one
// [B, H, 64, N] fp32 accumulator (16.8 MB at batch 1, resident in the 50 MB
// L2) that the caller zeroes before and casts after; the summation order of
// dq therefore varies from run to run (fp32 rounding, ~1e-7 relative).
// K4a/K4b keep the deterministic two-pass form.
//
// Design (bf16, mma.sync m16n8k16, fp32 accumulators):
//  * K3 / K4b: one block of 8 warps per (batch*head, 128-key tile); warp w
//    owns keys 16w..16w+15, holds k^T and v^T of its keys as A fragments and
//    its dk, dv rows as fp32 accumulators for the whole walk over 64-query
//    tiles. Per query tile: S^T = k^T q and dP^T = v^T dO (B fragments by
//    ldmatrix.trans from [channel][query] tiles), p and ds in registers,
//    then dv += p dO^T and dk += ds q^T with p and ds re-packed to bf16 as A
//    fragments (the rounding points of the TPU kernel: p before dO p^T, ds
//    before the dk and dq products). K3 also writes ds^T (bf16) to shared
//    memory and the 8 warps compute the tile's dq partial over all 128 keys
//    (warp: 16 queries x 32 channels), added atomically.
//  * K4a: one block of 8 warps per (batch*head, 128-query tile), walking
//    64-key tiles, q and dO held as A fragments: s = q k^T, dp = dO v^T,
//    ds, dq += ds k; dq goes out through shared memory, coalesced.
//  * Tiles are staged with 2-byte loads coalesced along tokens (any N and
//    stride: N = 4097 is odd), as in K1.
//
// Design (fp32, the precision-check mode: no TF32): scalar FMA kernels.
// dq: one thread per query row, as K1's fp32 path. dk/dv: two threads per
// key (32 channels each, partial dot products joined by a shuffle). Mode 0
// runs both.
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;
constexpr int kThreads = 256;  // 8 warps

// ------------------------------------------------- bf16 K3 / K4b (kv-major)
constexpr int kKeys = 128;        // keys per block (8 warps x 16)
constexpr int kQry = 64;          // queries per step
constexpr int kLdK = kKeys + 8;   // [channel][key] row stride (272 B)
constexpr int kLdQ = kQry + 8;    // [channel][query] row stride (144 B)
constexpr int kLdS = kQry + 8;    // [key][query] ds row stride (144 B)
// dynamic shared memory: sK, sQ, sDO, sDS (also v at the start), lse2 and D
constexpr int kSmemKV = 2 * (kDh * kLdK + 2 * kDh * kLdQ + kKeys * kLdS) + 2 * 4 * kQry;

struct OutStrides {
  long long b, h;  // channel stride N, token stride 1
};

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         float* __restrict__ dq_acc,
                         uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                         int H, int N, int kv_len, Strides st, Strides sdo,
                         OutStrides os, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);  // [64][kLdK]
  uint16_t* sQ = sK + kDh * kLdK;                          // [64][kLdQ]
  uint16_t* sDO = sQ + kDh * kLdQ;                         // [64][kLdQ]
  uint16_t* sDS = sDO + kDh * kLdQ;                        // [128][kLdS]
  float* sLse = reinterpret_cast<float*>(sDS + kKeys * kLdS);  // log2 units
  float* sD = sLse + kQry;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mi = lane / 8;
  const int mr = lane % 8;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * kKeys;
  const long long base = b * st.b + h * st.h;
  const long long base_do = b * sdo.b + h * sdo.h;

  // k and v as [channel][key] (v in the sDS area until its fragments are
  // loaded); keys >= kv_len are zeros
  stage_tile<kKeys, kLdK, kThreads>(sK, k + base, st.d, st.n, key0, kv_len, tid);
  stage_tile<kKeys, kLdK, kThreads>(sDS, v + base, st.d, st.n, key0, kv_len, tid);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];  // A fragments: row = key, col = channel
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int off = (16 * ks + (mi / 2) * 8 + mr) * kLdK + 16 * warp + (mi % 2) * 8;
    ldsm_x4_trans(kf[ks], &sK[off]);
    ldsm_x4_trans(vf[ks], &sDS[off]);
  }

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[d][i] = dv_acc[d][i] = 0.f;

  const int krow = key0 + 16 * warp + g;  // this thread's keys: krow, krow + 8
  const bool kmask[2] = {krow >= kv_len, krow + 8 >= kv_len};

  const int n_tiles = (N + kQry - 1) / kQry;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kQry;
    __syncthreads();  // every warp is done with the previous tile (and v)
    stage_tile<kQry, kLdQ, kThreads>(sQ, q + base, st.d, st.n, q0, N, tid);
    stage_tile<kQry, kLdQ, kThreads>(sDO, dout + base_do, sdo.d, sdo.n, q0, N, tid);
    if (tid < kQry) {
      const int n = q0 + tid;
      // queries past N: zero q and dO, lse = +inf so that p = 0
      sLse[tid] = n < N ? lse[static_cast<long long>(bh) * N + n] * kLog2e : INFINITY;
      sD[tid] = n < N ? dd[static_cast<long long>(bh) * N + n] : 0.f;
    }
    __syncthreads();

    // S^T = k^T q and dP^T = v^T dO: 16 keys x 64 queries per warp
    float s[8][4], ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = ds[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (16 * ks + (mi % 2) * 8 + mr) * kLdQ + 8 * (2 * np + mi / 2);
        uint32_t bq[4], bo[4];
        ldsm_x4_trans(bq, &sQ[off]);
        ldsm_x4_trans(bo, &sDO[off]);
        mma_bf16(s[2 * np], kf[ks], bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], kf[ks], bq[2], bq[3]);
        mma_bf16(ds[2 * np], vf[ks], bo[0], bo[1]);
        mma_bf16(ds[2 * np + 1], vf[ks], bo[2], bo[3]);
      }
    }
    // p = exp2(s * scale * log2(e) - lse2), ds = p * (dp - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * nt + 2 * tq + (i % 2);
        const float p = kmask[i / 2] ? 0.f : exp2f(s[nt][i] * scale_log2 - sLse[c]);
        s[nt][i] = p;
        ds[nt][i] = p * (ds[nt][i] - sD[c]);
      }

    // dv += p dO^T, dk += ds q^T (k-steps of 16 queries; B from [ch][query])
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(as, ds[2 * kk], ds[2 * kk + 1]);
      if (kFused) {  // ds^T to shared memory for the dq partial
        uint16_t* row = &sDS[(16 * warp + g) * kLdS + 16 * kk + 2 * tq];
        *reinterpret_cast<uint32_t*>(row) = as[0];
        *reinterpret_cast<uint32_t*>(row + 8 * kLdS) = as[1];
        *reinterpret_cast<uint32_t*>(row + 8) = as[2];
        *reinterpret_cast<uint32_t*>(row + 8 * kLdS + 8) = as[3];
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        const int off = (8 * (2 * dp + mi / 2) + mr) * kLdQ + 16 * kk + (mi % 2) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4(bo, &sDO[off]);
        ldsm_x4(bq, &sQ[off]);
        mma_bf16(dv_acc[2 * dp], ap, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dp + 1], ap, bo[2], bo[3]);
        mma_bf16(dk_acc[2 * dp], as, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dp + 1], as, bq[2], bq[3]);
      }
    }

    if (kFused) {
      __syncthreads();  // ds^T of all 128 keys is in sDS
      // dq partial = ds k over this block's keys: warp -> 16 queries (wq)
      // x 32 channels (wc); A from the [key][query] tile (.trans), B from
      // the [channel][key] tile
      const int wq = warp % 4, wc = warp / 4;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4_trans(a, &sDS[(16 * ks + (mi / 2) * 8 + mr) * kLdS + 16 * wq + (mi % 2) * 8]);
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t bk[4];
          ldsm_x4(bk, &sK[(32 * wc + 8 * (2 * dp + mi / 2) + mr) * kLdK + 16 * ks +
                          (mi % 2) * 8]);
          mma_bf16(acc[2 * dp], a, bk[0], bk[1]);
          mma_bf16(acc[2 * dp + 1], a, bk[2], bk[3]);
        }
      }
      float* dqb = dq_acc + static_cast<long long>(bh) * kDh * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = q0 + 16 * wq + g + 8 * (i / 2);
          const int ch = 32 * wc + 8 * nt + 2 * tq + (i % 2);
          if (n < N) atomicAdd(&dqb[static_cast<long long>(ch) * N + n], acc[nt][i] * scale);
        }
    }
  }

  // epilogue: dk (scaled) and dv as [channel][key] tiles in sK / sDS, then
  // stores coalesced along keys
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int key = 16 * warp + g + 8 * (i / 2);
      sK[ch * kLdK + key] = BF16::store(dk_acc[d][i] * scale);
      sDS[ch * kLdK + key] = BF16::store(dv_acc[d][i]);
    }
  __syncthreads();
  const long long ob = b * os.b + h * os.h;
#pragma unroll 8
  for (int i = 0; i < (kDh * kKeys) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int d = e / kKeys;
    const int t = e % kKeys;
    if (key0 + t < N) {
      const long long o = ob + static_cast<long long>(d) * N + key0 + t;
      dk[o] = sK[d * kLdK + t];
      dv[o] = sDS[d * kLdK + t];
    }
  }
}

// ----------------------------------------------------- bf16 K4a (q-major)
constexpr int kQBlk = 128;          // queries per block (8 warps x 16)
constexpr int kKBlk = 64;           // keys per kv tile
constexpr int kLdQB = kQBlk + 8;    // 272 B
constexpr int kLdKB = kKBlk + 8;    // 144 B

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         uint16_t* __restrict__ dq, int H, int N, int kv_len,
                         Strides st, Strides sdo, OutStrides os, float scale,
                         float scale_log2) {
  __shared__ __align__(16) uint16_t sX[kDh * kLdQB];  // q, then dO, then dq
  __shared__ __align__(16) uint16_t sK[kDh * kLdKB];
  __shared__ __align__(16) uint16_t sV[kDh * kLdKB];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mi = lane / 8;
  const int mr = lane % 8;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kQBlk;
  const long long base = b * st.b + h * st.h;

  // q and dO as A fragments (row = query, col = channel), one staging buffer
  uint32_t qf[4][4], of[4][4];
  stage_tile<kQBlk, kLdQB, kThreads>(sX, q + base, st.d, st.n, m0, N, tid);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4_trans(qf[ks], &sX[(16 * ks + (mi / 2) * 8 + mr) * kLdQB + 16 * warp + (mi % 2) * 8]);
  __syncthreads();
  stage_tile<kQBlk, kLdQB, kThreads>(sX, dout + b * sdo.b + h * sdo.h, sdo.d, sdo.n, m0, N, tid);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4_trans(of[ks], &sX[(16 * ks + (mi / 2) * 8 + mr) * kLdQB + 16 * warp + (mi % 2) * 8]);

  float lse2[2], dr[2];  // rows g and g + 8; past N: p = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = m0 + 16 * warp + g + 8 * r;
    lse2[r] = n < N ? lse[static_cast<long long>(bh) * N + n] * kLog2e : INFINITY;
    dr[r] = n < N ? dd[static_cast<long long>(bh) * N + n] : 0.f;
  }

  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.f;

  const int n_tiles = (kv_len + kKBlk - 1) / kKBlk;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kKBlk;
    __syncthreads();
    stage_tile<kKBlk, kLdKB, kThreads>(sK, k + base, st.d, st.n, n0, kv_len, tid);
    stage_tile<kKBlk, kLdKB, kThreads>(sV, v + base, st.d, st.n, n0, kv_len, tid);
    __syncthreads();

    float s[8][4], ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = ds[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (16 * ks + (mi % 2) * 8 + mr) * kLdKB + 8 * (2 * np + mi / 2);
        uint32_t bk[4], bv[4];
        ldsm_x4_trans(bk, &sK[off]);
        ldsm_x4_trans(bv, &sV[off]);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
        mma_bf16(ds[2 * np], of[ks], bv[0], bv[1]);
        mma_bf16(ds[2 * np + 1], of[ks], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * tq + (i % 2);
        const float p = key >= kv_len ? 0.f : exp2f(s[nt][i] * scale_log2 - lse2[i / 2]);
        ds[nt][i] = p * (ds[nt][i] - dr[i / 2]);
      }
    // dq += ds k: B from the [channel][key] tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bk[4];
        ldsm_x4(bk, &sK[(8 * (2 * dp + mi / 2) + mr) * kLdKB + 16 * kk + (mi % 2) * 8]);
        mma_bf16(acc[2 * dp], a, bk[0], bk[1]);
        mma_bf16(acc[2 * dp + 1], a, bk[2], bk[3]);
      }
    }
  }

  // epilogue: scale, stage the [channel][query] tile, store coalesced
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int col = 16 * warp + g + 8 * (i / 2);
      sX[ch * kLdQB + col] = BF16::store(acc[d][i] * scale);
    }
  __syncthreads();
  uint16_t* ob = dq + b * os.b + h * os.h;
#pragma unroll 8
  for (int i = 0; i < (kDh * kQBlk) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int d = e / kQBlk;
    const int t = e % kQBlk;
    if (m0 + t < N) ob[static_cast<long long>(d) * N + m0 + t] = sX[d * kLdQB + t];
  }
}

// ---------------------------------------------------------------- fp32 path
constexpr int kRowsF32 = 128;  // dq: query rows (threads) per block
constexpr int kTileF32 = 64;   // tokens per staged tile

__global__ void __launch_bounds__(kRowsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        float* __restrict__ dq, int H, int N, int kv_len,
                        Strides st, Strides sdo, OutStrides os, float scale,
                        float scale_log2) {
  __shared__ float sK[kDh][kTileF32];
  __shared__ float sV[kDh][kTileF32];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * kRowsF32 + tid;
  const bool row_ok = row < N;
  const long long base = b * st.b + h * st.h;
  const long long base_do = b * sdo.b + h * sdo.h;

  float qr[kDh], orow[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = row_ok ? q[base + d * st.d + row * st.n] : 0.f;
    orow[d] = row_ok ? dout[base_do + d * sdo.d + row * sdo.n] : 0.f;
    acc[d] = 0.f;
  }
  const float lse2 = row_ok ? lse[static_cast<long long>(bh) * N + row] * kLog2e : INFINITY;
  const float dr = row_ok ? dd[static_cast<long long>(bh) * N + row] : 0.f;

  for (int n0 = 0; n0 < kv_len; n0 += kTileF32) {
    __syncthreads();
    for (int e = tid; e < kDh * kTileF32; e += kRowsF32) {
      const int d = e / kTileF32, t = e % kTileF32, n = n0 + t;
      const bool ok = n < kv_len;
      sK[d][t] = ok ? k[base + d * st.d + n * st.n] : 0.f;
      sV[d][t] = ok ? v[base + d * st.d + n * st.n] : 0.f;
    }
    __syncthreads();
    const int valid = min(kTileF32, kv_len - n0);
    for (int j = 0; j < valid; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) {
        s = fmaf(qr[d], sK[d][j], s);
        dp = fmaf(orow[d], sV[d][j], dp);
      }
      const float ds = exp2f(s * scale_log2 - lse2) * (dp - dr);
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] = fmaf(ds, sK[d][j], acc[d]);
    }
  }
  if (!row_ok) return;
  float* ob = dq + b * os.b + h * os.h;
#pragma unroll
  for (int d = 0; d < kDh; ++d) ob[static_cast<long long>(d) * N + row] = acc[d] * scale;
}

constexpr int kKeysF32 = 64;  // dk/dv: keys per block, two threads each

__global__ void __launch_bounds__(2 * kKeysF32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
                         int N, int kv_len, Strides st, Strides sdo,
                         OutStrides os, float scale, float scale_log2) {
  constexpr int kHalf = kDh / 2;
  __shared__ float sQ[kDh][kTileF32];
  __shared__ float sDO[kDh][kTileF32];
  __shared__ float sLse[kTileF32];
  __shared__ float sD[kTileF32];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int key = blockIdx.x * kKeysF32 + tid / 2;
  const int c0 = kHalf * (tid % 2);  // this thread's channels c0 .. c0 + 31
  const bool key_ok = key < kv_len;  // keys past kv_len: p = 0, zero grads
  const long long base = b * st.b + h * st.h;
  const long long base_do = b * sdo.b + h * sdo.h;

  float kr[kHalf], vr[kHalf], dka[kHalf], dva[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    kr[c] = key_ok ? k[base + (c0 + c) * st.d + key * st.n] : 0.f;
    vr[c] = key_ok ? v[base + (c0 + c) * st.d + key * st.n] : 0.f;
    dka[c] = dva[c] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kTileF32) {
    __syncthreads();
    for (int e = tid; e < kDh * kTileF32; e += 2 * kKeysF32) {
      const int d = e / kTileF32, t = e % kTileF32, n = q0 + t;
      const bool ok = n < N;
      sQ[d][t] = ok ? q[base + d * st.d + n * st.n] : 0.f;
      sDO[d][t] = ok ? dout[base_do + d * sdo.d + n * sdo.n] : 0.f;
    }
    if (tid < kTileF32) {
      const int n = q0 + tid;
      sLse[tid] = n < N ? lse[static_cast<long long>(bh) * N + n] * kLog2e : INFINITY;
      sD[tid] = n < N ? dd[static_cast<long long>(bh) * N + n] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileF32; ++j) {  // uniform trip count: the shuffles
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        s = fmaf(kr[c], sQ[c0 + c][j], s);
        dp = fmaf(vr[c], sDO[c0 + c][j], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = key_ok ? exp2f(s * scale_log2 - sLse[j]) : 0.f;
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        dva[c] = fmaf(p, sDO[c0 + c][j], dva[c]);
        dka[c] = fmaf(ds, sQ[c0 + c][j], dka[c]);
      }
    }
  }
  if (key >= N) return;
  const long long ob = b * os.b + h * os.h;
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const long long o = ob + static_cast<long long>(c0 + c) * N + key;
    dk[o] = dka[c] * scale;
    dv[o] = dva[c];
  }
}

template <bool kFused>
cudaError_t launch_kv_bf16(dim3 grid, cudaStream_t s, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* dd, float* dq_acc, void* dk, void* dv,
                           int H, int N, int kv_len, Strides st, Strides sdo,
                           OutStrides os, float scale, float scale_log2) {
  auto kernel = flash_bwd_kv_bf16_kernel<kFused>;
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, kSmemKV, smem_allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemKV, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout), lse, dd,
      dq_acc, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H, N, kv_len,
      st, sdo, os, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mhmr

// mode 0: fused (K3) -> dq, dk, dv; bf16 adds dq into the zeroed fp32
//         dq_acc [B, H, 64, N] (already scaled; the caller casts it), fp32
//         writes dq directly and leaves dq_acc unused;
// mode 1: two-pass dq (K4a); mode 2: two-pass dk, dv (K4b).
extern "C" int mhmr_flash_bwd_t(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* dd,
                                void* dq, void* dq_acc, void* dk, void* dv, int B,
                                int H, int Dh, int N, int kv_len, long long stride_b,
                                long long stride_h, long long stride_d,
                                long long stride_n, long long do_stride_b,
                                long long do_stride_h, long long do_stride_d,
                                long long do_stride_n, long long out_stride_b,
                                long long out_stride_h, float scale, int dtype,
                                int mode, void* stream) {
  using namespace mhmr;
  if (Dh != kDh || kv_len < 1 || kv_len > N || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_d, stride_n};
  const Strides sdo{do_stride_b, do_stride_h, do_stride_d, do_stride_n};
  const OutStrides os{out_stride_b, out_stride_h};
  const float scale_log2 = scale * kLog2e;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_dq = mode != 2, want_dkv = mode != 1;
  if (dtype == kBFloat16) {
    if (mode == 0) {
      const dim3 grid((N + kKeys - 1) / kKeys, B * H);
      return launch_kv_bf16<true>(grid, s, q, k, v, dout, l, d, static_cast<float*>(dq_acc),
                                  dk, dv, H, N, kv_len, st, sdo, os, scale, scale_log2);
    }
    if (want_dkv) {
      const dim3 grid((N + kKeys - 1) / kKeys, B * H);
      return launch_kv_bf16<false>(grid, s, q, k, v, dout, l, d, nullptr, dk, dv, H, N,
                                   kv_len, st, sdo, os, scale, scale_log2);
    }
    const dim3 grid((N + kQBlk - 1) / kQBlk, B * H);
    flash_bwd_dq_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout), l, d,
        static_cast<uint16_t*>(dq), H, N, kv_len, st, sdo, os, scale, scale_log2);
    return cudaGetLastError();
  }
  if (dtype != kFloat32) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  if (want_dq) {
    const dim3 grid((N + kRowsF32 - 1) / kRowsF32, B * H);
    flash_bwd_dq_f32_kernel<<<grid, kRowsF32, 0, s>>>(
        qf, kf, vf, of, l, d, static_cast<float*>(dq), H, N, kv_len, st, sdo, os,
        scale, scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (want_dkv) {
    const dim3 grid((N + kKeysF32 - 1) / kKeysF32, B * H);
    flash_bwd_dkv_f32_kernel<<<grid, 2 * kKeysF32, 0, s>>>(
        qf, kf, vf, of, l, d, static_cast<float*>(dk), static_cast<float*>(dv), H, N,
        kv_len, st, sdo, os, scale, scale_log2);
  }
  return cudaGetLastError();
}
