// Channels-major LayerNorm forward (K2): y[b, :, n] = LN(x[b, :, n]) over D.
//
// Replaces the Pallas TPU kernel multihmr_tpu/ops/norm.py::_ln_kernel
// (called from _ln_fwd_pallas), which the ViT runs twice per block on its
// [B, D, N] residual stream.
//
// Bound: memory. At the 896_L shape (D = 1024, N = 4104 on the pre-padded
// stream, bf16 in and out) one call moves 2 * 1024 * 4104 * 2 B = 16.8 MB,
// 0.0050 ms at 3.35 TB/s, and does ~10 flops per element, far below the
// H100's ~295 flop/byte ridge. The levers are to touch each byte once and to
// keep enough bytes in flight: at ~0.7 us of latency the card needs ~18 KB
// in flight per SM.
//
// Design: every channel row is 16-byte aligned (N times the element size is
// a multiple of 16 bytes, 16-byte aligned bases: ops/norm.py checks, and so
// does the C entry). A block of D threads (D / 32 warps) owns a tile of 32
// tokens across all D channels. A lane moves 16 bytes along tokens (8 bf16
// or 4 fp32 tokens), so 4 (bf16) or 8 (fp32) lanes cover one channel's
// tile row and a warp covers 8 or 4 channels per load instruction; warp w
// owns channels 32w..32w+31, 4 (bf16) or 8 (fp32) loads per thread. Each
// thread issues all of its loads before it uses any (at D = 1024: 64 KB in
// flight per SM against the 4 KB of the 8-warp, 2-byte-load design before)
// and keeps the values in registers: no shared-memory slab. The fp32
// statistics are two-pass from registers, as the reference: the mean, then
// the variance of the centred values; each is a shuffle reduction across
// the lanes that share a token chunk, then a reduction across warps through
// a [warps][32] buffer in shared memory. Each thread loads the scale and
// bias of its own channels once, and writes y once with 16-byte stores in
// the output dtype (8-byte stores for fp32 in and bf16 out: 4 tokens).
//
// Wide path (1024 < D <= 2048, D a multiple of 32; DINOv2 ViT-g/14's
// D = 1536): a block holds at most 32 warps, so each warp owns two groups
// of 32 channels, w and w + W (W = ceil(D / 64) warps: 768 threads at
// D = 1536), the second absent in the last warp where D / 32 is odd. It is
// a separate instantiation of the same tile code, picked at launch, with
// the same loads-first order and two-pass fp32 statistics; a thread then
// holds twice the tile in registers, so it reads its channels' scale and
// bias at the store instead of holding them across the variance pass. At
// D = 1536 bf16 one call of the 896 px stream moves 2 * 1536 * 4104 * 2 B =
// 25.2 MB a batch element.
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kTok = 32;       // token columns per block
constexpr int kMaxWarps = 32;  // D / 32 warps, D <= 1024
constexpr int kWideGroups = 2;  // wide path: two groups of 32 channels a warp
constexpr int kMaxWideD = 32 * kWideGroups * kMaxWarps;  // 2048

// the lane layout of one 16-byte load of an In tile row
template <typename In>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(typename In::T));  // tokens per lane
  static constexpr int kLanesPerCh = kTok / kVec;  // lanes that cover one channel's tile row
  static constexpr int kChPerLoad = 32 / kLanesPerCh;  // channels a warp covers per load
  static constexpr int kLoads = 32 / kChPerLoad;  // loads per thread (32 channels per warp)
};

template <typename In>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[Tile<In>::kVec]) {
  if constexpr (sizeof(typename In::T) == 2) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
}

// V tokens of y in the output dtype: 16-byte stores (one 8-byte store for
// V = 4 in bf16)
template <typename Out, int V>
__device__ __forceinline__ void store(typename Out::T* p, const float (&v)[V]) {
  if constexpr (sizeof(typename Out::T) == 2) {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// acc[t]: this thread's partial sum of token t of its chunk -> the sum over
// all D channels, in every thread (two barriers)
template <int V, int kLanesPerCh>
__device__ __forceinline__ void block_sum(float (&acc)[V], float (*red)[kTok], float* tot,
                                          int warp, int lane, int n_warps) {
#pragma unroll
  for (int m = kLanesPerCh; m < 32; m <<= 1)  // lanes of one token chunk
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], m);
  if (lane < kLanesPerCh) {
#pragma unroll
    for (int t = 0; t < V; ++t) red[warp][lane * V + t] = acc[t];
  }
  __syncthreads();
  if (threadIdx.x < kTok) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  const int chunk = lane % kLanesPerCh;
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = tot[chunk * V + t];
}

// One block's tile of kTok tokens across all D channels. kGroups: the
// groups of 32 channels a warp owns, w, w + W, ... (W = blockDim.x / 32
// warps); a group at or past D is absent (zeros, left out of the sums).
template <typename In, typename Out, int kGroups>
__device__ __forceinline__ void layernorm_cm_tile(const typename In::T* __restrict__ x,
                                                  const float* __restrict__ scale,
                                                  const float* __restrict__ bias,
                                                  typename Out::T* __restrict__ y, int D, int N,
                                                  float eps) {
  using L = Tile<In>;
  constexpr int V = L::kVec;
  __shared__ float red[kMaxWarps][kTok];
  __shared__ float tot[kTok];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int n = blockIdx.x * kTok + (lane % L::kLanesPerCh) * V;  // this lane's first token
  const bool in_range = n < N;  // N % V == 0: all V tokens or none
  // group g, load i: channel c0[g] + i * kChPerLoad
  int c0[kGroups];
  bool has[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    c0[g] = 32 * (warp + g * n_warps) + lane / L::kLanesPerCh;
    has[g] = kGroups == 1 || 32 * (warp + g * n_warps) < D;
  }
  const long long plane = static_cast<long long>(blockIdx.y) * D * N;

  // every load first: 16 bytes of one channel row each
  uint4 raw[kGroups][L::kLoads];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      const long long off = plane + static_cast<long long>(c0[g] + i * L::kChPerLoad) * N + n;
      raw[g][i] = in_range && has[g] ? __ldg(reinterpret_cast<const uint4*>(x + off))
                                     : make_uint4(0, 0, 0, 0);
    }

  // mean (an absent group's zeros add nothing)
  float acc[V], mu[V];
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      float v[V];
      unpack<In>(raw[g][i], v);
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] += v[t];
    }
  block_sum<V, L::kLanesPerCh>(acc, red, tot, warp, lane, n_warps);
#pragma unroll
  for (int t = 0; t < V; ++t) mu[t] = acc[t] / D;

  // one group: this thread's channels' scale and bias, once
  float sc[L::kLoads], bi[L::kLoads];
  if constexpr (kGroups == 1) {
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      sc[i] = __ldg(scale + c0[0] + i * L::kChPerLoad);
      bi[i] = __ldg(bias + c0[0] + i * L::kChPerLoad);
    }
  }

  // variance of the centred values
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (!has[g]) continue;
#pragma unroll
    for (int i = 0; i < L::kLoads; ++i) {
      float v[V];
      unpack<In>(raw[g][i], v);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const float d = v[t] - mu[t];
        acc[t] = fmaf(d, d, acc[t]);
      }
    }
  }
  block_sum<V, L::kLanesPerCh>(acc, red, tot, warp, lane, n_warps);
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = rsqrtf(acc[t] / D + eps);

  // normalise, affine, cast, store
  if (in_range) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (!has[g]) continue;
#pragma unroll
      for (int i = 0; i < L::kLoads; ++i) {
        const int c = c0[g] + i * L::kChPerLoad;
        float s_c, b_c;
        if constexpr (kGroups == 1) {
          s_c = sc[i];
          b_c = bi[i];
        } else {
          s_c = __ldg(scale + c);
          b_c = __ldg(bias + c);
        }
        float v[V];
        unpack<In>(raw[g][i], v);
#pragma unroll
        for (int t = 0; t < V; ++t) v[t] = fmaf((v[t] - mu[t]) * acc[t], s_c, b_c);
        const long long off = plane + static_cast<long long>(c) * N + n;
        store<Out, V>(y + off, v);
      }
    }
  }
}

// D <= 1024: one group a warp, D / 32 warps
template <typename In, typename Out>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
layernorm_cm_kernel(const typename In::T* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    typename Out::T* __restrict__ y, int D, int N, float eps) {
  layernorm_cm_tile<In, Out, 1>(x, scale, bias, y, D, N, eps);
}

// 1024 < D <= 2048: two groups a warp, ceil(D / 64) warps
template <typename In, typename Out>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
layernorm_cm_wide_kernel(const typename In::T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         typename Out::T* __restrict__ y, int D, int N, float eps) {
  layernorm_cm_tile<In, Out, kWideGroups>(x, scale, bias, y, D, N, eps);
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, int B, int D,
                   int N, float eps, cudaStream_t stream) {
  // 16-byte channel rows of x and y, one warp per 32 channels (two past 1024)
  if (D % 32 || D < 32 || D > kMaxWideD || (N * sizeof(typename In::T)) % 16 ||
      (N * sizeof(typename Out::T)) % 16 || !is_aligned16(x) || !is_aligned16(y))
    return cudaErrorInvalidValue;
  dim3 grid((N + kTok - 1) / kTok, B);
  const auto* xi = static_cast<const typename In::T*>(x);
  auto* yo = static_cast<typename Out::T*>(y);
  if (D <= 32 * kMaxWarps)
    layernorm_cm_kernel<In, Out><<<grid, D, 0, stream>>>(xi, scale, bias, yo, D, N, eps);
  else
    layernorm_cm_wide_kernel<In, Out>
        <<<grid, 32 * ((D / 32 + kWideGroups - 1) / kWideGroups), 0, stream>>>(
            xi, scale, bias, yo, D, N, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mhmr

// Returns cudaErrorInvalidValue for inputs the kernel does not take (the
// Python wrapper checks the same and raises first): D not a multiple of 32
// in [32, 2048], a channel row of x or y that is not a multiple of 16
// bytes, or a base pointer that is not 16-byte aligned.
extern "C" int mhmr_layernorm_cm(const void* x, const void* scale,
                                 const void* bias, void* y, int B, int D,
                                 int N, float eps, int in_dtype, int out_dtype,
                                 void* stream) {
  using namespace mhmr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return launch<BF16, BF16>(x, sc, bi, y, B, D, N, eps, s);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return launch<BF16, F32>(x, sc, bi, y, B, D, N, eps, s);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return launch<F32, BF16>(x, sc, bi, y, B, D, N, eps, s);
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return launch<F32, F32>(x, sc, bi, y, B, D, N, eps, s);
  return cudaErrorInvalidValue;
}
