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
// and dp in both passes: 7 products, 240.6 GFLOP for the same function, K4a
// three of them (0.104 ms) and K4b four (0.139 ms). On the H100, K3 reads
// 0.59-0.61 ms, K4a 0.20-0.21 and K4b 0.35-0.37: each warpgroup runs its
// per-tile chain (copy wait, products, p and ds) in series, and removing
// K3's dq reduce saves 0.09 ms (tools/kernel_timing.py ab, variants).
//
// What changes from the TPU kernel: the TPU grid runs in order without
// atomics, so K3 there writes one fp32 dq partial per kv block
// ([B*H, kv_steps, 64, Np], 1.1 GB per call at 896_L) and sums it outside.
// Here each K3 block adds its scaled 64 x 64 fp32 dq partial per query tile
// (over its 128 keys) into one fp32 accumulator that the caller zeroes
// before and casts after, with bulk reduces from shared memory
// (cp.reduce.async.bulk .add.f32; 0.56 GB of adds per call at 896_L). The
// accumulator is laid out by query tile, [B, H, ceil(N / 64), 64 channel,
// 68] (17.8 MB at batch 1, resident in the 50 MB L2; the row pad of 4 keeps
// the shared staging free of bank conflicts), so a warpgroup's 32 rows are
// one contiguous copy rather than 32 row copies of 256 bytes. The order of
// the adds varies from run to run, so dq's fp32 sum does too (rounding,
// ~1e-7 relative). K4a/K4b are the deterministic form: every output is one
// thread's fp32 register sum, added in a fixed order, so two calls give
// bitwise-equal gradients.
//
// Every bf16 kernel here takes only 16-byte token rows: the token count and
// every stride are multiples of 8 and the bases 16-byte aligned, as the
// ViT's pre-padded stream and the standard stream's padded copy have them
// (the wrapper and the C entry check; nothing pads). Every copy is a
// 16-byte cp.async into a 128-byte-swizzled [64 channel][64 token] tile
// (common.cuh), and every product a wgmma m64n64k16 (or m64n32k16) with
// fp32 accumulators.
//
// Design of K3 and K4b (one kernel, flash_bwd_dkv_bf16_kernel<kDq>; K3 is
// kDq = true, K4b kDq = false): one block of two warpgroups per
// (batch*head, 128-key tile); warpgroup w owns keys 64w..64w+63 (each of
// its warps 16 of them) and holds their dk, dv as fp32 accumulators for the
// whole walk over 64-query tiles: k and v once, then the q and dO tiles
// with their lse and D, double-buffered, so that tile t+1 is in flight
// while tile t is multiplied. Per query tile and warpgroup:
//  * S^T = k^T q and dP^T = v^T dO: A = the k or v tile, B = the q or dO
//    tile, all [channel = depth][token] in shared memory (MN-major; k and v
//    stay there for the walk: a loop-invariant register A fragment is not
//    kept live by ptxas);
//  * p and ds in registers, re-packed to bf16 as A fragments (the rounding
//    points of the TPU kernel: p before dO p^T, ds before the dk and dq
//    products); dv += p dO^T and dk += ds q^T with B = the dO and q tiles
//    read K-major;
//  * K3 only: ds^T (bf16) to shared memory, then the block's dq partial over
//    its 128 keys, dq = ds k (A = the ds^T tiles, MN-major; B = the k tiles,
//    K-major; warpgroup w takes channels 32w..32w+31, m64n32k16), staged as
//    fp32 and added by one bulk reduce per warpgroup, which runs behind the
//    next tile's math. (One partial per warpgroup, over its 64 keys, needs
//    no barrier between the warpgroups but doubles the adds, and read slower
//    on the card.) K4b has none of this: no ds^T tiles, no dq product, no
//    fp32 dq tile and no reduce, so its shared memory is 8 tiles, not 10
//    plus the dq tile.
//
// Design of K4a (flash_bwd_dq_bf16_kernel): K1's shape of work without the
// online softmax. One block of two warpgroups per (batch*head, 128-query
// tile); warpgroup w owns queries 64w..64w+63. The q and dO tiles are
// copied once; a ring of kStages k/v tile pairs over 64-key tiles keeps
// tiles j+1 and j+2 in flight while tile j is multiplied. Per kv tile:
//  * S = q k^T and dP = dO v^T: A = the warpgroup's q or dO tile, B = the k
//    or v tile, all [channel = depth][token] in shared memory (MN-major);
//  * p = exp2(s * scale * log2(e) - lse * log2(e)) and ds = p (dp - D) in
//    registers; ds re-packed to bf16 as an A fragment (the TPU kernel's
//    rounding point);
//  * dq += ds k: B = the k tile [channel][key], K-major (K1's P.V with k in
//    place of v).
// Keys at or past kv_len get p = 0, and the last tile's k and v entries
// there are zeroed in shared memory, so junk or NaN in a pre-padded stream
// cannot reach dq. dq is scaled once at the end and goes out through shared
// memory as [channel][query] tiles with 16-byte stores.
//
// Design (fp32, the precision-check mode: no TF32): scalar FMA kernels.
// dq: one thread per query row, as K1's fp32 path. dk/dv: two threads per
// key (32 channels each, partial dot products joined by a shuffle). Mode 0
// runs both. They take any N and strides.
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;
constexpr int kThreads = 256;  // 8 warps

constexpr int kKeys = 128;  // K3/K4b: keys per block (2 warpgroups x 64)
constexpr int kQry = 64;    // K3/K4b: queries per step

struct OutStrides {
  long long b, h;  // channel stride N, token stride 1
};

// ------------------------------------------- bf16 K3 (kDq) and K4b (!kDq)
constexpr int kLdDQ = kQry + 4;  // fp32 [channel][query] dq row stride (272 B)
// dynamic shared memory: k and v (2 tiles each), K3's ds^T (2 tiles), q and
// dO (2 stages each), lse and D (2 stages each), K3's fp32 dq tile, and
// slack to align the base to 1024 bytes
constexpr int smem_dkv(bool dq) {
  return (dq ? 10 : 8) * kTileElems * 2 + 2 * 2 * kQry * 4 + (dq ? kDh * kLdDQ * 4 : 0) + 1024;
}

// queue the query tile at q0 (q, dO, lse, D) into one stage
__device__ __forceinline__ void load_query_tile(uint16_t* sQ, uint16_t* sDO, float* sLse,
                                                float* sD, const uint16_t* qb,
                                                const uint16_t* dob, const float* lse_b,
                                                const float* dd_b, long long sd,
                                                long long sdo_d, int q0, int N, int tid) {
  load_tile_async<kThreads>(sQ, qb, sd, q0, N, tid);
  load_tile_async<kThreads>(sDO, dob, sdo_d, q0, N, tid);
  if (tid < 32) {  // 64 fp32 each of lse and D: 16 chunks each
    const int c = tid % 16, n = q0 + 4 * c;
    const bool ok = n < N;  // queries past N: zeros (q = dO = 0, so p = 1, ds = 0)
    const float* src = (tid < 16 ? lse_b : dd_b) + (ok ? n : 0);
    cp_async16((tid < 16 ? sLse : sD) + 4 * c, src, ok);
  }
}

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src, int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// barrier of warpgroup wg's 128 threads (id 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// this thread's bulk copies have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// kDq: K3 (dk, dv and the dq partials); !kDq: K4b (dk and dv alone, dq_acc
// unused)
template <bool kDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd,
                          float* __restrict__ dq_acc,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int H, int N, int kv_len, Strides st, Strides sdo,
                          OutStrides os, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(align1024(smem_raw));  // keys 0-63, 64-127
  uint16_t* sV = sK + 2 * kTileElems;    // [ch][key], as sK
  uint16_t* sDS = sV + 2 * kTileElems;   // K3: ds^T [key][query], keys 0-63, 64-127
  uint16_t* sQ = sDS + (kDq ? 2 : 0) * kTileElems;  // stage s: sQ + s * kTileElems
  uint16_t* sDO = sQ + 2 * kTileElems;   // stage s: sDO + s * kTileElems
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kTileElems);  // stage s: + s * kQry
  float* sD = sLse + 2 * kQry;
  float* sDQ = sD + 2 * kQry;            // K3: [64 channel][kLdDQ]; warpgroup w: rows 32w..

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * kKeys;
  const uint16_t* qb = q + b * st.b + h * st.h;
  const uint16_t* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + static_cast<long long>(bh) * N;
  const float* dd_b = dd + static_cast<long long>(bh) * N;
  const int n_tiles = (N + kQry - 1) / kQry;

  // k and v as [channel][key], then the first query tile: one commit group
  // each
  {
    const uint16_t* kb = k + b * st.b + h * st.h;
    const uint16_t* vb = v + b * st.b + h * st.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      load_tile_async<kThreads>(sK + half * kTileElems, kb, st.d, key0 + 64 * half, N, tid);
      load_tile_async<kThreads>(sV + half * kTileElems, vb, st.d, key0 + 64 * half, N, tid);
    }
  }
  cp_async_commit();
  load_query_tile(sQ, sDO, sLse, sD, qb, dob, lse_b, dd_b, st.d, sdo.d, 0, N, tid);
  cp_async_commit();
  if (key0 + kKeys > kv_len) {  // keys at or past kv_len -> exact zeros
    cp_async_wait<1>();  // k and v have landed
    __syncthreads();
    for (int e = tid; e < kDh * kKeys; e += kThreads) {
      const int t = e % kKeys;
      if (key0 + t >= kv_len) {
        const int o = (t >> 6) * kTileElems + swz(e / kKeys, t & 63);
        sK[o] = 0;
        sV[o] = 0;
      }
    }
  }
  // this warpgroup's 64 keys: the A operands of S^T = k^T q and dP^T = v^T
  // dO stay in shared memory ([channel = depth][key], MN-major) for the walk
  const int wg = warp / 4;
  const uint16_t* sKw = sK + wg * kTileElems;
  const uint16_t* sVw = sV + wg * kTileElems;
  uint16_t* sDSw = sDS + wg * kTileElems;   // this warpgroup's ds^T [key][query]
  float* wDQ = sDQ + 32 * wg * kLdDQ;      // this warpgroup's 32 channels

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[d][i] = dv_acc[d][i] = 0.f;

  const int krow = key0 + 16 * warp + g;  // this thread's keys: krow, krow + 8
  const bool kmask[2] = {krow >= kv_len, krow + 8 >= kv_len};
  // this head's dq tiles: [query tile][64 channel][kLdDQ] fp32
  float* dqb = dq_acc + static_cast<long long>(bh) * n_tiles * kDh * kLdDQ;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kQry;
    const int cur = t & 1;
    cp_async_wait<0>();  // this thread's copies of tile t have landed
    fence_async_shared();
    __syncthreads();     // ... every thread's; all are done with tile t - 1
    if (t + 1 < n_tiles)
      load_query_tile(sQ + (cur ^ 1) * kTileElems, sDO + (cur ^ 1) * kTileElems,
                      sLse + (cur ^ 1) * kQry, sD + (cur ^ 1) * kQry, qb, dob, lse_b, dd_b,
                      st.d, sdo.d, q0 + kQry, N, tid);
    cp_async_commit();
    const uint16_t* tQ = sQ + cur * kTileElems;
    const uint16_t* tDO = sDO + cur * kTileElems;
    const float* tLse = sLse + cur * kQry;
    const float* tD = sD + cur * kQry;

    // S^T = k^T q and dP^T = v^T dO: this warpgroup's 64 keys x 64 queries
    // (the warp's 16 keys); B = the [channel = depth][query] q and dO tiles,
    // MN-major; k-step ks is rows 16ks.. of every tile
    float s[8][4], ds[8][4];
    reg_fence(s);
    reg_fence(ds);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sKw + 16 * ks * 64, 1024, 1024),
                               wgmma_desc(tQ + 16 * ks * 64, 1024, 1024), ks > 0);
      wgmma_m64n64k16_ss<1, 1>(ds, wgmma_desc(sVw + 16 * ks * 64, 1024, 1024),
                               wgmma_desc(tDO + 16 * ks * 64, 1024, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(ds);
    // p = exp2(s * scale * log2(e) - lse * log2(e)), ds = p * (dp - D)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * nt + 2 * tq + (i % 2);
        const float p =
            kmask[i / 2] ? 0.f : fast_exp2(fmaf(s[nt][i], scale_log2, -tLse[c] * kLog2e));
        s[nt][i] = p;
        ds[nt][i] = p * (ds[nt][i] - tD[c]);
      }

    // dv += p dO^T, dk += ds q^T: A = p and ds re-packed to bf16 (k-steps of
    // 16 queries), B = the dO and q tiles, K-major ([channel][query]), 32
    // bytes further per step; K3: ds^T to shared memory for the dq partial
    uint32_t ap[4][4], as[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      c_to_a(ap[kk], s[2 * kk], s[2 * kk + 1]);
      c_to_a(as[kk], ds[2 * kk], ds[2 * kk + 1]);
      if constexpr (kDq) {
        const int r = 16 * (warp % 4) + g, c = 16 * kk + 2 * tq;
        *reinterpret_cast<uint32_t*>(sDSw + swz(r, c)) = as[kk][0];
        *reinterpret_cast<uint32_t*>(sDSw + swz(r + 8, c)) = as[kk][1];
        *reinterpret_cast<uint32_t*>(sDSw + swz(r, c + 8)) = as[kk][2];
        *reinterpret_cast<uint32_t*>(sDSw + swz(r + 8, c + 8)) = as[kk][3];
      }
    }
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16<0>(dv_acc, ap[kk], wgmma_desc(tDO + 16 * kk, 0, 1024), 1);
      wgmma_m64n64k16<0>(dk_acc, as[kk], wgmma_desc(tQ + 16 * kk, 0, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);

    if constexpr (!kDq) continue;  // K4b: no dq partial
    // the block's dq partial over its 128 keys, dq = ds k, warpgroup w taking
    // channels 32w..32w+31: A = the ds^T tiles ([key = depth][query],
    // MN-major), B = rows 32w.. of the k tiles ([channel][key], K-major);
    // each warpgroup adds its rows with one bulk reduce
    if (tid % 128 == 0) bulk_wait_read();  // its last reduce is done with wDQ
    fence_async_shared();                  // ds^T (st.shared) before the wgmma reads it
    __syncthreads();                       // ds^T of all 128 keys is in sDS
    float dqa[4][4];
    reg_fence(dqa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      const int half = ks / 4, kk = ks % 4;  // keys 64 * half + 16 * kk..
      wgmma_m64n32k16_ss<1, 0>(
          dqa, wgmma_desc(sDS + half * kTileElems + 16 * kk * 64, 1024, 1024),
          wgmma_desc(sK + half * kTileElems + 32 * wg * 64 + 16 * kk, 0, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dqa);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = 8 * j + 2 * tq + (i % 2);
        wDQ[ch * kLdDQ + 16 * (warp % 4) + g + 8 * (i / 2)] = dqa[j][i] * scale;
      }
    fence_async_shared();
    warpgroup_sync(wg);       // its 32 rows are in wDQ
    if (tid % 128 == 0) {     // one contiguous 8.7 KB add (the tile layout)
      bulk_reduce_add_f32(dqb + static_cast<long long>(t) * kDh * kLdDQ + 32 * wg * kLdDQ, wDQ,
                          32 * kLdDQ * 4);
      bulk_commit();
    }
  }

  // epilogue: dk (scaled) and dv as [channel][key] tiles in sK and sDS (K4b:
  // sV), then 16-byte stores along keys
  uint16_t* sDV = kDq ? sDS : sV;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int key = 16 * warp + g + 8 * (i / 2);
      const int o = (key >> 6) * kTileElems + swz(ch, key & 63);
      sK[o] = BF16::store(dk_acc[d][i] * scale);
      sDV[o] = BF16::store(dv_acc[d][i]);
    }
  __syncthreads();
  const long long ob = b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < (kDh * kKeys / 8) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int ch = e / (kKeys / 8);
    const int t = 8 * (e % (kKeys / 8));
    if (key0 + t < N) {
      const long long o = ob + static_cast<long long>(ch) * N + key0 + t;
      const int so = (t >> 6) * kTileElems + swz(ch, t & 63);
      *reinterpret_cast<uint4*>(dk + o) = *reinterpret_cast<const uint4*>(sK + so);
      *reinterpret_cast<uint4*>(dv + o) = *reinterpret_cast<const uint4*>(sDV + so);
    }
  }
  if (kDq && tid % 128 == 0) bulk_wait();  // the dq reduces have completed
}

// ------------------------------------------------------- bf16 K4a (q-major)
constexpr int kQBlk = 128;  // queries per block (2 warpgroups x 64)
constexpr int kKBlk = 64;   // keys per kv tile
constexpr int kStages = 3;  // k/v tile pairs in the ring
// the q and dO tiles (2 each), the k/v ring, and slack to align the base to
// 1024 bytes
constexpr int kSmemDq = (4 + 2 * kStages) * kTileElems * 2 + 1024;

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         uint16_t* __restrict__ dq, int H, int N, int kv_len,
                         Strides st, Strides sdo, OutStrides os, float scale,
                         float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(align1024(smem_raw));  // 2 tiles
  uint16_t* sDO = sQ + 2 * kTileElems;   // 2 tiles
  uint16_t* sKV = sDO + 2 * kTileElems;  // stage s: k tile 2s, v tile 2s + 1

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int tq = lane % 4;  // accumulator columns 2tq, 2tq + 1
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kQBlk;
  const uint16_t* qb = q + b * st.b + h * st.h;
  const uint16_t* kb = k + b * st.b + h * st.h;
  const uint16_t* vb = v + b * st.b + h * st.h;
  const uint16_t* dob = dout + b * sdo.b + h * sdo.h;
  const int n_tiles = (kv_len + kKBlk - 1) / kKBlk;

  // q and dO once, then the first kStages - 1 k/v tiles: one commit group
  // each
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    load_tile_async<kThreads>(sQ + half * kTileElems, qb, st.d, m0 + 64 * half, N, tid);
    load_tile_async<kThreads>(sDO + half * kTileElems, dob, sdo.d, m0 + 64 * half, N, tid);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile_async<kThreads>(sKV + 2 * s * kTileElems, kb, st.d, s * kKBlk, N, tid);
      load_tile_async<kThreads>(sKV + (2 * s + 1) * kTileElems, vb, st.d, s * kKBlk, N, tid);
    }
    cp_async_commit();
  }
  // this warpgroup's 64 queries: the A operands of S = q k^T and dP = dO v^T
  // stay in shared memory ([channel = depth][query], MN-major)
  const int wg = warp / 4;
  const uint16_t* sQw = sQ + wg * kTileElems;
  const uint16_t* sDOw = sDO + wg * kTileElems;

  // this thread's query rows: lse in log2 units and D; rows past N get
  // p = 0 (their q and dO are zero-filled and their dq is not stored)
  float lse2[2], dr[2];
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

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j have landed
    fence_async_shared();
    __syncthreads();  // ... every thread's; and all are done with tile j - 1
    {
      const int jn = j + kStages - 1;  // refill the stage tile j - 1 used
      if (jn < n_tiles) {
        uint16_t* st_k = sKV + 2 * (jn % kStages) * kTileElems;
        load_tile_async<kThreads>(st_k, kb, st.d, jn * kKBlk, N, tid);
        load_tile_async<kThreads>(st_k + kTileElems, vb, st.d, jn * kKBlk, N, tid);
      }
      cp_async_commit();
    }
    uint16_t* sK = sKV + 2 * (j % kStages) * kTileElems;
    uint16_t* sV = sK + kTileElems;
    const int n0 = j * kKBlk;
    const bool tail = n0 + kKBlk > kv_len;
    if (tail) {  // k and v entries of keys at or past kv_len -> exact zeros
      for (int e = tid; e < kTileElems; e += kThreads) {
        const int t = e % kKBlk;
        if (n0 + t >= kv_len) {
          sK[swz(e / kKBlk, t)] = 0;
          sV[swz(e / kKBlk, t)] = 0;
        }
      }
      fence_async_shared();
      __syncthreads();
    }

    // S = q k^T and dP = dO v^T for this warpgroup's 64 queries x 64 keys
    // (the warp's 16 rows: 8 n-tiles of 8 keys); k-step ks is rows 16ks..
    // of every tile
    float s[8][4], dp[8][4];
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(sQw + 16 * ks * 64, 1024, 1024),
                               wgmma_desc(sK + 16 * ks * 64, 1024, 1024), ks > 0);
      wgmma_m64n64k16_ss<1, 1>(dp, wgmma_desc(sDOw + 16 * ks * 64, 1024, 1024),
                               wgmma_desc(sV + 16 * ks * 64, 1024, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // p = exp2(s * scale * log2(e) - lse * log2(e)), 0 for keys >= kv_len;
    // ds = p * (dp - D), in place of dp
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * tq + (i % 2);
        const float p = (tail && key >= kv_len)
                            ? 0.f
                            : fast_exp2(fmaf(s[nt][i], scale_log2, -lse2[i / 2]));
        dp[nt][i] = p * (dp[nt][i] - dr[i / 2]);
      }

    // dq += ds k: ds's accumulators of n-tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk (16 keys); B = the k tile, K-major, 32 bytes further per
    // step
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) c_to_a(af[kk], dp[2 * kk], dp[2 * kk + 1]);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16<0>(acc, af[kk], wgmma_desc(sK + 16 * kk, 0, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(af);
  }

  // epilogue: scale, stage the [channel][query] tiles in sQ (each
  // warpgroup's own tile: its wgmmas reading sQw have completed), then
  // 16-byte stores along queries
  uint16_t* sO = sQ + wg * kTileElems;
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 8 * d + 2 * tq + (i % 2);
      const int col = 16 * (warp % 4) + g + 8 * (i / 2);
      sO[swz(ch, col)] = BF16::store(acc[d][i] * scale);
    }
  __syncthreads();
  uint16_t* ob = dq + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < (kDh * kQBlk / 8) / kThreads; ++i) {
    const int e = i * kThreads + tid;
    const int ch = e / (kQBlk / 8);
    const int t = 8 * (e % (kQBlk / 8));
    if (m0 + t < N)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(ch) * N + m0 + t) =
          *reinterpret_cast<const uint4*>(sQ + (t >> 6) * kTileElems + swz(ch, t & 63));
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

template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, int smem, int (&allowed)[kMaxDevices], dim3 grid,
                        cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mhmr

// mode 0: fused (K3) -> dq, dk, dv; bf16 adds dq into the zeroed fp32
//         dq_acc [B, H, ceil(N / 64), 64, 68] (query tile, channel, query in
//         the tile, 4 pad; already scaled; the caller casts it), fp32 writes
//         dq directly and leaves dq_acc unused;
// mode 1: two-pass dq (K4a); mode 2: two-pass dk, dv (K4b).
// Returns cudaErrorInvalidValue for inputs the kernels do not take (the
// Python wrapper checks the same and raises first); in bf16, that is any
// operand without 16-byte token rows (token stride 1, a token count and
// strides that are multiples of 8, 16-byte aligned bases).
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
    const Strides out4{out_stride_b, out_stride_h, N, 1};
    const void* in_ptrs[] = {q, k, v, lse, dd, dq_acc};  // dq_acc: null outside mode 0
    const void* do_ptr[] = {dout};
    const void* out_ptrs[] = {mode == 1 ? dq : dk, mode == 1 ? dq : dv};
    if (!rows16(B, H, N, st, in_ptrs, 6) || !rows16(B, H, N, sdo, do_ptr, 1) ||
        !rows16(B, H, N, out4, out_ptrs, 2))
      return cudaErrorInvalidValue;
    const uint16_t* qh = static_cast<const uint16_t*>(q);
    const uint16_t* kh = static_cast<const uint16_t*>(k);
    const uint16_t* vh = static_cast<const uint16_t*>(v);
    const uint16_t* oh = static_cast<const uint16_t*>(dout);
    uint16_t* dkh = static_cast<uint16_t*>(dk);
    uint16_t* dvh = static_cast<uint16_t*>(dv);
    const dim3 kv_grid((N + kKeys - 1) / kKeys, B * H);
    if (mode == 0) {
      static int allowed[kMaxDevices] = {};
      return launch_smem(flash_bwd_dkv_bf16_kernel<true>, smem_dkv(true), allowed, kv_grid, s,
                         qh, kh, vh, oh, l, d, static_cast<float*>(dq_acc), dkh, dvh, H, N,
                         kv_len, st, sdo, os, scale, scale_log2);
    }
    if (mode == 2) {
      static int allowed[kMaxDevices] = {};
      return launch_smem(flash_bwd_dkv_bf16_kernel<false>, smem_dkv(false), allowed, kv_grid,
                         s, qh, kh, vh, oh, l, d, static_cast<float*>(nullptr), dkh, dvh, H, N,
                         kv_len, st, sdo, os, scale, scale_log2);
    }
    static int allowed[kMaxDevices] = {};
    const dim3 q_grid((N + kQBlk - 1) / kQBlk, B * H);
    return launch_smem(flash_bwd_dq_bf16_kernel, kSmemDq, allowed, q_grid, s, qh, kh, vh, oh,
                       l, d, static_cast<uint16_t*>(dq), H, N, kv_len, st, sdo, os, scale,
                       scale_log2);
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
