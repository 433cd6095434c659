// Channels-major LayerNorm forward: y[b, :, n] = LN(x[b, :, n]) over D.
//
// Replaces the Pallas TPU kernel multihmr_tpu/ops/norm.py::_ln_kernel
// (called from _ln_fwd_pallas), which the ViT runs twice per block on its
// [B, D, N] residual stream.
//
// Bound: memory. At the 896_L shape (D = 1024, N = 4097, bf16 in and out)
// one call moves 2 * 1024 * 4097 * 2 B = 16.8 MB and does ~10 flops per
// element, far below the H100's ~295 flop/byte ridge. The only lever is to
// touch each byte once.
//
// Design: the reduction runs over D, whose stride is N. A block owns a tile
// of 32 token columns; warp w walks channels w, w + 8, ... with its 32 lanes
// on 32 neighbouring tokens, so every global load and store is coalesced
// along N. Each value is read from device memory once into a [D, 32] slab
// of dynamic shared memory (in the input dtype: 64 KB for bf16 at D = 1024),
// the fp32 mean and then the fp32 variance of the centred values come from
// that slab (two-pass, as the reference does), and the affine + cast pass
// writes y once.
#include "common.cuh"

namespace mhmr {
namespace {

constexpr int kTok = 32;    // token columns per block (one per lane)
constexpr int kGroups = 8;  // warps per block, interleaved over channels

template <typename In, typename Out>
__global__ void __launch_bounds__(kTok * kGroups)
layernorm_cm_kernel(const typename In::T* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    typename Out::T* __restrict__ y, int D, int N, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename In::T* slab = reinterpret_cast<typename In::T*>(smem_raw);  // [D][kTok]
  __shared__ float part[kGroups][kTok];
  __shared__ float stat[kTok];

  const int tok = threadIdx.x % kTok;
  const int grp = threadIdx.x / kTok;
  const int n = blockIdx.x * kTok + tok;
  const bool in_range = n < N;
  const long long plane = static_cast<long long>(blockIdx.y) * D * N;
  const typename In::T* xb = x + plane;
  typename Out::T* yb = y + plane;

  // pass 1: global -> slab, partial sums
  float s = 0.f;
#pragma unroll 8  // keep several loads in flight per thread
  for (int c = grp; c < D; c += kGroups) {
    typename In::T v = in_range ? xb[static_cast<long long>(c) * N + n]
                                : typename In::T(0);
    slab[c * kTok + tok] = v;
    s += In::load(v);
  }
  part[grp][tok] = s;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) t += part[i][tok];
    stat[tok] = t / D;
  }
  __syncthreads();
  const float mu = stat[tok];

  // pass 2: variance of the centred values (each thread re-reads only the
  // slab entries it wrote, so no barrier is needed for the slab itself)
  float q = 0.f;
  for (int c = grp; c < D; c += kGroups) {
    const float d = In::load(slab[c * kTok + tok]) - mu;
    q += d * d;
  }
  part[grp][tok] = q;
  __syncthreads();
  if (grp == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) t += part[i][tok];
    stat[tok] = rsqrtf(t / D + eps);
  }
  __syncthreads();
  const float rstd = stat[tok];

  // pass 3: normalise, affine, cast
  if (in_range) {
    for (int c = grp; c < D; c += kGroups) {
      const float v = (In::load(slab[c * kTok + tok]) - mu) * rstd;
      yb[static_cast<long long>(c) * N + n] = Out::store(v * scale[c] + bias[c]);
    }
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, int B, int D, int N, float eps,
                   cudaStream_t stream) {
  const int smem = D * kTok * static_cast<int>(sizeof(typename In::T));
  auto kernel = layernorm_cm_kernel<In, Out>;
  // raise the dynamic shared-memory limit once per instantiation, device
  // and size (a host-side call that would otherwise cost every launch)
  static int smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTok - 1) / kTok, B);
  kernel<<<grid, kTok * kGroups, smem, stream>>>(
      static_cast<const typename In::T*>(x), scale, bias,
      static_cast<typename Out::T*>(y), D, N, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mhmr

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
