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
// the limit, and the N^2 score matrix must never reach device memory.
//
// Why the exponentials matter at Dh = 64. Each score costs 2 * 2 * 64 = 256
// flops of wgmma; an SM does 4,096 a clock, so 1/16 of a clock. Each score
// also takes one exp2, and the SM's special-function units (SFU) do 16
// ex2.approx a clock: 1/16 of a clock too, so with every exp2 on the SFU
// the exponentials alone take as long as the products. The rest of the
// softmax (the scaled subtract, the max, the sum, the bf16 pack: about 4
// operations a score) runs on the FP32 pipes at 128 a clock. By pipe
// throughput alone a share phi of the exp2 done as a polynomial on the FMA
// pipe (common.cuh poly_exp2, about 9 instructions) balances SFU and FMA
// near phi = 1/4. But each SM sub-partition issues one instruction a clock,
// and a warp issues in order: one ex2.approx takes one issue slot, one
// polynomial nine, and ptxas schedules a tile's polynomials ahead of its
// SFU exponentials, so the two pipes hardly overlap within a warp. On the
// card (H100, 700 W; A/B turns against the kernel at 4/16, four calls) the
// share 2/16 read 3-6 % faster than 4/16 and 1-2 % faster than 0/16 (every
// exp2 on the SFU); 6/16 and 8/16 read slower than 4/16. kPolyTiles is 2 of
// the 16 n-tiles (1/8), the fastest share measured.
//
// Design (bf16; the token count and the strides are multiples of 8, as the
// ViT's pre-padded stream has them, and the wrapper checks). One block of
// three warpgroups per (batch*head, 128-query tile), one block an SM:
//  * warpgroup 0 is the producer: it gives its registers to the consumers
//    (setmaxnreg) and one thread issues every copy by TMA. q, k and v are
//    tensor maps over their strided views, dims (N, 64 channels, H, B),
//    tokens innermost, boxes of 64 tokens x 64 channels with the 128-byte
//    swizzle: one box is one [64 channel][64 token] swizzled atom (common.cuh
//    swz). The k and v maps end at kv_len, so TMA reads keys past kv_len as
//    zeros (junk or NaN in a pre-padded stream never reaches shared memory);
//    q's ends at N. The two q atoms are loaded once; 128-key tiles (k atoms
//    0 and 1, v atoms 0 and 1) go through a ring of kStages = 6 stages with
//    full and empty mbarriers (4 read 3-5 % slower, 2 twice as slow: every
//    block streams all of its head's k and v from L2);
//  * warpgroups 1 and 2 are the consumers, 64 queries each. Products are
//    wgmma with fp32 accumulators: S = q k^T is m64n128k16, A = the
//    warpgroup's q atom [channel = depth][query] and B = the stage's two k
//    atoms [channel][key], both from shared memory and MN-major (q stays
//    there for the whole walk: a loop-invariant register A fragment is not
//    kept live by ptxas); O += P v is m64n64k16 per 16 keys, A = P re-packed
//    to bf16 in registers from S's accumulators (as the TPU kernel rounds
//    it), B = a v atom [channel][key], K-major;
//  * overlap, as FA3: within a warpgroup, tile j's S is issued, then the
//    output is rescaled to tile j - 1's max (skipped by a warp whose rows'
//    maxima all held) and tile j - 1's P.V issued behind S; tile j's
//    softmax follows, and tile j - 1's stage is released once P.V has been
//    waited for. (ptxas moves that wait ahead of the softmax's row-max
//    shuffles, so the softmax does not overlap the warpgroup's own P.V.)
//    Between the warpgroups, the ping-pong: they take turns to issue their
//    products (named barriers 4 + warpgroup), so that one's softmax runs
//    while the other's products run;
//  * 128-key tiles halve, per key, the q re-reads, the barrier round trips,
//    the output rescales and the row-max shuffles of 64-key tiles. The last
//    tile is ragged at every length the ViT runs (kv_len = 1 + g^2: 2,305,
//    4,097 and 8,465 leave 1, 1 and 17 keys): it runs at the narrowest wgmma
//    width that covers its keys (16, 32, 64 or 128; the producer loads one
//    atom of k and of v where 64 keys cover it), not as a whole tile;
//  * the exponentials: the scores stay raw; the row max is taken on them and
//    scale * log2(e) folds into one FMA a score. The n-tiles (8 keys) that
//    kPolyTiles marks take exp2 as poly_exp2 on the FMA pipe, the rest
//    ex2.approx on the SFU. poly_exp2 is degree 4 (relative error 2^-18.4):
//    a degree-3 minimax (2^-13.5) meets the 2^-12 that bf16's P rounding
//    (2^-9) hides, but its error enters the fp32 row sum, and with q scaled
//    x8 (rows led by a few keys) it moved the LSE by 4.3e-5 against the
//    tests' 5e-5 (a simulation at [2, 4, 64, 2312]). The row sum adds the
//    same fp32 values as before.
// The online softmax keeps a running max (in log2 units) and sum per row in
// fp32. Keys at or past kv_len are masked to -inf before the max (last tile
// only). A negative scale negates the q atoms in shared memory once, so that
// the max of the raw scores times |scale| is the max of the scaled ones.
// The output goes through shared memory as [channel][query] atoms and out
// with 16-byte stores.
//
// Measured (H100 80GB HBM3, 700 W, CUDA events with the host queued ahead):
// [1, 16, 64, 4104] with kv_len 4097 in 0.169-0.172 ms against the 0.0695 ms
// bound (41 %; SDPA's forward on the same keys 0.171-0.175 ms; this kernel
// before, one chain of tile wait, S, softmax and P.V per warpgroup, 0.212-
// 0.215 ms); at batch 8 1.307 ms (42.5 %). What holds it there, from clock64
// stamps inside a block: per warpgroup and tile about 1,300 clocks issuing
// its 12 wgmmas (an issue waits until the tensor cores take it) and 1,000
// in the softmax, whose SFU exponentials ptxas schedules after the
// polynomials. Without the softmax K1 reads 0.103 ms, and S alone 0.091 ms,
// most of it waiting for k and v: each block streams its head's k and v
// (1 MB at 4,097 keys) from L2.
//
// Design (fp32, the precision-check mode): one thread per query row, the
// scaled q row and the output row in registers, 64-key k/v tiles in shared
// memory read as broadcasts, and the same online softmax on chunks of 16
// keys, in plain fp32 FMAs (no TF32: the fp32 path exists to be exact). It
// takes any N and strides.
#include <type_traits>

#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kDh = 64;

// ---------------------------------------------------------------- bf16 path
// consumer warpgroups, 64 queries each (three, at 160 registers a thread,
// spill and serialize their wgmmas)
constexpr int kConsumers = 2;
constexpr int kBlockM = 64 * kConsumers;  // query rows per block
constexpr int kBlockN = 128;   // keys per kv tile: two 64-token atoms
constexpr int kNTiles = kBlockN / 8;  // n-tiles of 8 keys in a row of S
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0: the producer
// registers a thread of the producer keeps and a consumer's takes
// (setmaxnreg; 128 x 24 + 256 x 240 of the SM's 65,536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 6;     // kv tiles in the ring (208 KB with the q atoms)
constexpr int kTileBytes = kTileElems * 2;   // one [64 channel][64 token] bf16 atom
constexpr int kStageElems = 4 * kTileElems;  // k atoms 0 and 1, then v atoms 0 and 1
// the q atoms, the ring, and slack to align the base to 1024 bytes
constexpr int kSmemBf16 = (kConsumers * kTileElems + kStages * kStageElems) * 2 + 1024;
// the n-tiles of S (bit nt: keys 8nt..8nt+7 of a tile) whose exp2 runs as a
// polynomial on the FMA pipe; the others take ex2.approx on the SFU
constexpr uint32_t kPolyTiles = 0x0808;

// S = q k^T for a warpgroup's 64 queries x 8 * kNT keys, from the
// descriptors of the q atom (dq) and of the stage's first k atom (dk): k-step
// ks is rows 16ks.. (channels, 2 KB further) of both, MN-major; the second k
// atom lies kTileBytes after the first (dk's leading byte offset)
template <int kNT>
__device__ __forceinline__ void s_product(float (&s)[kNT][4], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = desc_plus(dq, 2048 * ks);
    const uint64_t db = desc_plus(dk, 2048 * ks);
    if constexpr (kNT == 16) wgmma_m64n128k16_ss<1, 1>(s, da, db, ks > 0);
    if constexpr (kNT == 8) wgmma_m64n64k16_ss<1, 1>(s, da, db, ks > 0);
    if constexpr (kNT == 4) wgmma_m64n32k16_ss<1, 1>(s, da, db, ks > 0);
    if constexpr (kNT == 2) wgmma_m64n16k16_ss<1, 1>(s, da, db, ks > 0);
  }
}

// O += P v for kv tile `tile` over its first 16 * kKS keys: P's accumulators
// of n-tiles 2kk, 2kk+1 are the A fragment of k-step kk (keys 16kk..); B =
// the v atom of those keys (dv: the stage's first), K-major, 32 bytes
// further per k-step
template <int kKS>
__device__ __forceinline__ void pv_product(float (&o)[8][4], const uint32_t (&pf)[kKS][4],
                                           uint64_t dv, int tile) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
    wgmma_m64n64k16<0>(o, pf[kk], desc_plus(dv, (kk / 4) * kTileBytes + 32 * (kk % 4)), 1);
}

// P as the A fragments of P.V: n-tiles 2kk and 2kk + 1 -> k-step kk
template <int kNT>
__device__ __forceinline__ void p_to_a(uint32_t (&pf)[kNT / 2][4], const float (&s)[kNT][4]) {
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
}

// fold a tile's raw scores into the running max m (log2 units) and sum l of
// rows g (r = 0) and g + 8 (r = 1), leave p = 2^(c s - m) in s, and the
// factor for the output so far in corr; c = |scale| * log2(e). kMask: keys
// at or past `valid` (of this tile) are masked
template <int kNT, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int valid, int tq, float c) {
  if constexpr (kMask) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (8 * nt + 2 * tq + (i % 2) >= valid) s[nt][i] = -INFINITY;
  }
  // each row's max in four partial maxes (short chains), then across the
  // four threads of the row
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[0][i] = mx[1][i] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float& part = mx[i / 2][(2 * nt + i) % 4];
      part = fmaxf(part, s[nt][i]);
    }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
    // finite: every tile holds at least one key < kv_len
    mc[r] = fmaxf(m[r], mc[r] * c);
    corr[r] = fast_exp2(m[r] - mc[r]);
    m[r] = mc[r];
  }
  float sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r][0] = l[r] * corr[r];
    sum[r][1] = sum[r][2] = sum[r][3] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = fmaf(s[nt][i], c, -mc[i / 2]);
      if (kMask && 8 * nt + 2 * tq + (i % 2) >= valid) x = -INFINITY;
      s[nt][i] = (kPolyTiles >> nt & 1) ? poly_exp2(x) : fast_exp2(x);
      sum[i / 2][(2 * nt + i) % 4] += s[nt][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_t_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        uint16_t* __restrict__ out, float* __restrict__ lse, int H, int N,
                        int kv_len, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(align1024(smem_raw));  // kConsumers atoms
  uint16_t* sKV = sQ + kConsumers * kTileElems;  // stage s at sKV + s * kStageElems
  __shared__ uint64_t bar_q, full[kStages], empty[kStages];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kBlockM;
  const int last = (kv_len - 1) / kBlockN;         // the last kv tile
  const int last_keys = kv_len - last * kBlockN;  // its keys, 1..128

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the tile's bytes
      mbar_init(&empty[s], 4 * kConsumers);  // one arrive per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {  // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (tid == 0) {
      mbar_expect_tx(&bar_q, kConsumers * kTileBytes);
      for (int w = 0; w < kConsumers; ++w)
        tma_load_4d(sQ + w * kTileElems, &map_q, &bar_q, m0 + 64 * w, 0, h, b);
      for (int j = 0; j <= last; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);  // round 0 passes at once
        uint16_t* dst = sKV + st * kStageElems;
        const int atoms = j == last && last_keys <= 64 ? 1 : 2;  // one covers a short tile
        mbar_expect_tx(&full[st], 2 * atoms * kTileBytes);
        for (int a = 0; a < atoms; ++a) {
          tma_load_4d(dst + a * kTileElems, &map_k, &full[st], j * kBlockN + 64 * a, 0, h, b);
          tma_load_4d(dst + (2 + a) * kTileElems, &map_v, &full[st], j * kBlockN + 64 * a, 0,
                      h, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups 1 .. kConsumers: queries m0 + 64 * cw ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int cw = tid / 128 - 1;
  const int warp = (tid / 32) % 4;  // warp of the warpgroup: rows 16 * warp ..
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int tq = lane % 4;  // accumulator columns 2tq, 2tq + 1
  uint16_t* sQw = sQ + cw * kTileElems;
  // ping-pong: warpgroup cw issues its products between a wait at barrier
  // 4 + cw and an arrive at the next one's, in turn; warpgroup 0 goes
  // first, and the last skips its last arrive, so every barrier ends
  // balanced (barriers 1 + cw are the warpgroups' own)
  const auto my_turn = [&] { named_barrier<256>(4 + cw); };
  const auto your_turn = [&](bool final_turn) {
    if (!(final_turn && cw == kConsumers - 1))
      named_barrier_arrive<256>(4 + (cw + 1) % kConsumers);
  };
  if (cw == kConsumers - 1) named_barrier_arrive<256>(4);

  mbar_wait(&bar_q, 0);
  float c = scale_log2;
  if (c < 0.f) {  // negate this warpgroup's q atom: then c = |scale| log2(e)
    c = -c;
    uint4* w = reinterpret_cast<uint4*>(sQw);
#pragma unroll
    for (int i = 0; i < kTileElems / 8 / 128; ++i) {
      uint4 x = w[i * 128 + tid % 128];
      x.x ^= 0x80008000u;
      x.y ^= 0x80008000u;
      x.z ^= 0x80008000u;
      x.w ^= 0x80008000u;
      w[i * 128 + tid % 128] = x;
    }
    fence_async_shared();
    named_barrier<128>(1 + cw);
  }

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // of c * s, log2 units
  float row_sum[2] = {0.f, 0.f};              // this thread's columns only
  float corr[2] = {1.f, 1.f};
  float s[kNTiles][4];
  uint32_t pf[kNTiles / 2][4];  // P of the tile before, bf16, as P.V's A fragments
  // descriptors: the q atom, and stage j's first k and v atoms
  const uint64_t dq = wgmma_desc(sQw, 1024, 1024);
  const uint64_t dk0 = wgmma_desc(sKV, kTileBytes, 1024);
  const uint64_t dv0 = wgmma_desc(sKV + 2 * kTileElems, 0, 1024);
  const auto dk = [&](int j) { return desc_plus(dk0, (j % kStages) * kStageElems * 2); };
  const auto dv = [&](int j) { return desc_plus(dv0, (j % kStages) * kStageElems * 2); };
  // O to the new running max before the next P.V adds to it; skipped by a
  // warp whose rows' maxima all held (corr = 1)
  const auto rescale = [&] {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int d = 0; d < 8; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[d][i] *= corr[i / 2];
    }
  };

  if (last > 0) {  // tile 0: S, softmax, P
    mbar_wait(&full[0], 0);
    my_turn();
    reg_fence(s);
    wgmma_fence();
    s_product(s, dq, dk(0));
    wgmma_commit();
    your_turn(false);
    wgmma_wait<0>();
    reg_fence(s);
    softmax_tile<kNTiles, false>(s, row_max, row_sum, corr, kBlockN, tq, c);
    p_to_a(pf, s);
  }
  // tile j: S_j issued, O rescaled, P_{j-1}.V issued; the softmax of S_j
  // runs beside P_{j-1}.V and the other warpgroup's products
  for (int j = 1; j < last; ++j) {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    my_turn();
    reg_fence(s);
    wgmma_fence();
    s_product(s, dq, dk(j));
    wgmma_commit();
    rescale();
    reg_fence(o);
    reg_fence(pf);
    wgmma_fence();
    pv_product(o, pf, dv(j - 1), j - 1);
    wgmma_commit();
    your_turn(false);
    wgmma_wait<1>();  // S of tile j has landed; P.V runs on
    reg_fence(s);
    softmax_tile<kNTiles, false>(s, row_max, row_sum, corr, kBlockN, tq, c);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);  // this warp is done with j - 1
    p_to_a(pf, s);
  }
  // the last tile at the narrowest width that covers its keys (8 * kNT),
  // beside tile last - 1's P.V where there is one (kBeside), then its own
  // P.V. Each pipeline stage (fence .. wait) issues its wgmmas
  // unconditionally: a wgmma under a branch inside a stage makes ptxas
  // serialize every wgmma of the kernel
  const auto last_tile = [&](auto width, auto beside) {
    constexpr int kNT = decltype(width)::value;
    constexpr bool kBeside = decltype(beside)::value;
    float sl[kNT][4];
    uint32_t pl[kNT / 2][4];
    mbar_wait(&full[last % kStages], (last / kStages) & 1);
    my_turn();
    reg_fence(sl);
    wgmma_fence();
    s_product(sl, dq, dk(last));
    wgmma_commit();
    if constexpr (kBeside) {
      rescale();
      reg_fence(o);
      reg_fence(pf);
      wgmma_fence();
      pv_product(o, pf, dv(last - 1), last - 1);
      wgmma_commit();
    }
    your_turn(false);
    wgmma_wait<kBeside ? 1 : 0>();
    reg_fence(sl);
    softmax_tile<kNT, true>(sl, row_max, row_sum, corr, last_keys, tq, c);
    p_to_a(pl, sl);
    wgmma_wait<0>();
    reg_fence(o);
    my_turn();
    rescale();
    reg_fence(o);
    reg_fence(pl);
    wgmma_fence();
    pv_product(o, pl, dv(last), last);
    wgmma_commit();
    your_turn(true);
    wgmma_wait<0>();
    reg_fence(o);
  };
  const auto last_tile_at = [&](auto beside) {
    if (last_keys <= 16) {
      last_tile(std::integral_constant<int, 2>{}, beside);
    } else if (last_keys <= 32) {
      last_tile(std::integral_constant<int, 4>{}, beside);
    } else if (last_keys <= 64) {
      last_tile(std::integral_constant<int, 8>{}, beside);
    } else {
      last_tile(std::integral_constant<int, kNTiles>{}, beside);
    }
  };
  if (last > 0) {
    last_tile_at(std::true_type{});
  } else {
    last_tile_at(std::false_type{});
  }

  // epilogue: normalise, LSE, stage the [channel][query] atom in this
  // warpgroup's q atom (its S products have completed), 16-byte stores
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
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sQw[swz(8 * d + 2 * tq + (i % 2), 16 * warp + g + 8 * (i / 2))] =
          BF16::store(o[d][i] * inv[i / 2]);
  named_barrier<128>(1 + cw);
  uint16_t* ob = out + static_cast<long long>(bh) * kDh * N;
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / 128; ++i) {
    const int e = i * 128 + tid % 128;
    const int ch = e / 8;
    const int t = 8 * (e % 8);
    if (q0 + t < N)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(ch) * N + q0 + t) =
          *reinterpret_cast<const uint4*>(sQw + swz(ch, t));
  }
}

// q, k or v, a [B, H, 64, N] bf16 view with element strides st (token stride
// 1), as a tensor map over dims (n_tok, 64, H, B), innermost first: boxes of
// 64 tokens x 64 channels, 128-byte swizzle, tokens past n_tok read as zeros.
// The stride of a size-1 dim is never used: it is given as 128 bytes
cudaError_t encode_cm(CUtensorMap* map, const void* base, int B, int H, int n_tok,
                      const Strides& st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n_tok), kDh, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.d) * 2,
                                 H == 1 ? 128u : static_cast<cuuint64_t>(st.h) * 2,
                                 B == 1 ? 128u : static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, kDh, 1, 1};
  return encode_bf16_4d(map, base, dims, strides, box);
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
// base pointer that is not 16-byte aligned; cudaErrorNotSupported if
// cuTensorMapEncodeTiled cannot be resolved.
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
    CUtensorMap maps[3];
    const void* views[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {  // q over all N tokens, k and v over the first kv_len
      const cudaError_t err = encode_cm(&maps[i], views[i], B, H, i == 0 ? N : kv_len, st);
      if (err != cudaSuccess) return err;
    }
    static int smem_allowed[kMaxDevices] = {};
    const cudaError_t err = allow_smem(flash_fwd_t_bf16_kernel, kSmemBf16, smem_allowed);
    if (err != cudaSuccess) return err;
    dim3 grid((N + kBlockM - 1) / kBlockM, B * H);
    flash_fwd_t_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        maps[0], maps[1], maps[2], static_cast<uint16_t*>(out), static_cast<float*>(lse), H, N,
        kv_len, scale_log2);
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
